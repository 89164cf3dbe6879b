"""Minimal production search server over a FastPlaid index.

The port's counterpart of ``fast_plaid_tpu/serving/server.py``: the same
endpoints and response JSON over ``fast_plaid_tpu_torch``'s FastPlaid.
Stdlib-only HTTP (ThreadingHTTPServer). Concurrent requests are
micro-batched into shared query tiles (serving/batcher.py): the engine is
batch-first, so the server's throughput follows batched search, not
single-query latency. ``device=None`` opens the index on every CUDA device
and raises without one; ``device="cpu"`` runs on the CPU.

Endpoints (JSON bodies):
  POST /v1/search   {"queries": [[[f32]]] , "top_k": 10, ...}
                    or {"queries_b64": <base64 f32 bytes>,
                        "shape": [n, q_len, dim], ...}
                    optional "subset": [[doc ids]] per query;
                    optional "priority": "interactive" (default) |
                    "batch" — batch-lane requests never delay
                    interactive ones (serving/batcher.py lanes).
  GET  /healthz     index + batcher stats.
  GET  /metrics     Prometheus text format (request/query/dispatch
                    counters, per-lane counts, latency histogram).
  POST /v1/update   {"documents_b64"/"documents": ..., "lengths": [...]}
  POST /v1/delete   {"subset": [ids]}

Start:  python -m fast_plaid_tpu_torch.serving --index /path/to/index [--port 8080]
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fast_plaid_tpu_torch.search import FastPlaid
from fast_plaid_tpu_torch.serving.batcher import LANES, MicroBatcher

__all__ = ["SearchServer", "make_server"]


def _decode_queries(payload: dict) -> list[np.ndarray]:
    if "queries_b64" in payload:
        shape = payload["shape"]
        buf = base64.b64decode(payload["queries_b64"])
        arr = np.frombuffer(buf, np.float32).reshape(shape)
        return [arr[i] for i in range(arr.shape[0])]
    qs = payload["queries"]
    return [np.asarray(q, np.float32) for q in qs]


def _decode_documents(payload: dict) -> list[np.ndarray]:
    if "documents_b64" in payload:
        dim = int(payload["dim"])
        lengths = payload["lengths"]
        buf = np.frombuffer(
            base64.b64decode(payload["documents_b64"]), np.float32
        ).reshape(-1, dim)
        out, off = [], 0
        for ln in lengths:
            out.append(buf[off : off + int(ln)])
            off += int(ln)
        return out
    return [np.asarray(d, np.float32) for d in payload["documents"]]


class SearchServer:
    """Engine + batcher wiring; exposes a ready ThreadingHTTPServer."""

    def __init__(
        self,
        index_path: str,
        *,
        device=None,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        **engine_kwargs,
    ):
        self.engine = FastPlaid(
            index=index_path, device=device, **engine_kwargs
        )
        self._write_lock = threading.Lock()
        self.batcher = MicroBatcher(
            self._run_search, max_batch=max_batch, max_wait_ms=max_wait_ms
        )

    def _run_search(self, queries, subsets, key: tuple):
        top_k, probe, n_full, approx = key[:4]
        has_subset = key[4]
        return self.engine.search(
            queries,
            top_k=top_k,
            n_ivf_probe=probe,
            n_full_scores=n_full,
            approx_mode=approx,
            subset=subsets if has_subset else None,
            show_progress=False,
        )

    def search(self, payload: dict):
        queries = _decode_queries(payload)
        subset = payload.get("subset")
        key = (
            int(payload.get("top_k", 10)),
            int(payload.get("n_ivf_probe", 8)),
            int(payload.get("n_full_scores", 4096)),
            str(payload.get("approx_mode", "auto")),
            subset is not None,
        )
        lane = LANES.get(str(payload.get("priority", "interactive")), 0)
        fut = self.batcher.submit(queries, key, subsets=subset, lane=lane)
        rows = fut.result(timeout=float(payload.get("timeout_s", 120)))
        return {
            "results": [
                [{"id": int(p), "score": float(s)} for p, s in row]
                for row in rows
            ]
        }

    def update(self, payload: dict):
        docs = _decode_documents(payload)
        with self._write_lock:
            self.engine.update(
                documents_embeddings=docs, metadata=payload.get("metadata")
            )
        return {"added": len(docs), "n_docs": self._n_docs()}

    def delete(self, payload: dict):
        ids = [int(i) for i in payload["subset"]]
        with self._write_lock:
            self.engine.delete(subset=ids)
        return {"deleted": len(ids), "n_docs": self._n_docs()}

    def _n_docs(self) -> int:
        for loaded in self.engine.indices.values():
            if loaded is not None:
                return int(loaded.ispec.n_docs)
        return 0

    def health(self) -> dict:
        return {
            "status": "ok",
            "n_docs": self._n_docs(),
            "devices": [str(d) for d in self.engine.devices],
            "batcher": self.batcher.stats.snapshot(),
        }

    def close(self) -> None:
        self.batcher.close()


def make_server(
    index_path: str, host: str = "127.0.0.1", port: int = 8080, **kwargs
) -> tuple[ThreadingHTTPServer, SearchServer]:
    """Build the HTTP server (caller runs serve_forever / shutdown)."""
    core = SearchServer(index_path, **kwargs)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, core.health())
            elif self.path == "/metrics":
                body = core.batcher.stats.prometheus().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._reply(400, {"error": "invalid JSON"})
                return
            try:
                if self.path == "/v1/search":
                    self._reply(200, core.search(payload))
                elif self.path == "/v1/update":
                    self._reply(200, core.update(payload))
                elif self.path == "/v1/delete":
                    self._reply(200, core.delete(payload))
                else:
                    self._reply(404, {"error": "not found"})
            except (KeyError, ValueError, TypeError) as exc:
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception as exc:  # engine-level failure
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd, core
