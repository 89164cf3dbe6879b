"""CLI: python -m fast_plaid_tpu_torch.serving --index /path [--port 8080]."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(prog="fast_plaid_tpu_torch.serving")
    ap.add_argument("--index", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument(
        "--device",
        default=None,
        help='"cpu", "cuda" or "cuda:N"; default every CUDA device',
    )
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    args = ap.parse_args()

    from fast_plaid_tpu_torch.serving.server import make_server

    httpd, core = make_server(
        args.index,
        host=args.host,
        port=args.port,
        device=args.device,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
    )
    print(
        f"fast_plaid_tpu_torch serving {args.index} on "
        f"http://{args.host}:{args.port} ({core.health()['n_docs']} docs)",
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        core.close()


if __name__ == "__main__":
    main()
