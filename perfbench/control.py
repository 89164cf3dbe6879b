"""The precision control: the reference put in the program's place at a
lower precision than the configuration states, judged as the program is.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 [--precision float8_e4m3fn]

For each seed it builds the cell's inputs, builds the index with the
reference (k-means, codec, codes, residuals, IVF) and answers the judged
calls' queries with the reference's search, every rounded input in
``--precision``; then ``judge.judge`` reads that side as it reads the
program's and prints one JSON line of numbers a seed. A sound yardstick
reads these numbers above the configuration's limits. The benchmark's own
runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_control(workload: str, seed: int, precision: str, *, device=None, spec=None,
                bench_dir=None) -> dict:
    import numpy as np
    import torch

    from perfbench import corpus, harness, judge
    from perfbench import reference as ref

    bench_dir = harness.HERE if bench_dir is None else bench_dir
    spec = harness.load_spec(bench_dir.parent) if spec is None else spec
    _, _, cfg, mix = harness.cell_files(spec, workload, bench_dir)
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_gpu = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    rnd = ref.ROUNDINGS[precision]
    nbits = int(cfg["create"]["nbits"])
    qn, pool_n = int(mix["queries_per_call"]), int(mix["query_pool"])

    data = corpus.generate(cfg, pool_n, seed, device)
    tokens, lengths = data.tokens, data.lengths.cpu().numpy()
    pool = data.queries.cpu().numpy()
    lens_t = data.lengths
    create_seed = int(cfg["create"]["seed"])
    cent = ref.kmeans(tokens, lengths, seed=create_seed, niters=int(cfg["create"]["kmeans_niters"]), rnd=rnd)
    cut, wts = ref.train_codec(tokens, lengths, cent, seed=create_seed, nbits=nbits, rnd=rnd)
    codes = ref.assign(tokens, cent, rnd)
    packed = ref.pack(tokens, cent, codes, cut, nbits)
    side = ref.Index(cent, cut, wts, codes, packed, lens_t, *ref.build_ivf(codes, lens_t, cent.shape[0]))
    mem_budget = (torch.cuda.get_device_properties(device).total_memory // 8
                  if on_gpu else 256 * 1024 * 1024)
    wire = np.float16 if on_gpu else np.float32
    cap = ref.round_up(int(lengths.max()), 16)
    p = judge.search_params(side.ivf_lengths.cpu().numpy(), len(lengths), mix,
                            ref.round_up(cfg["query_maxlen"], 8), doc_cap=cap,
                            pd=int(packed.shape[1]), mem_budget=mem_budget, route=cfg["stage6_route"])
    picks = np.random.default_rng([seed, 0x5A3B]).choice(pool_n // qn, int(mix["judged_calls"]), replace=False)
    calls = []
    for b in picks:
        batch = pool[b * qn : (b + 1) * qn]
        pids, scores = judge.reference_answers(side, batch, p, wire=wire, route=cfg["stage6_route"],
                                               cap=cap, nbits=nbits, rnd=rnd, device=device)
        calls.append((batch, [[(int(i), float(s)) for i, s in zip(pr, sr) if i >= 0]
                              for pr, sr in zip(pids.tolist(), scores.tolist())]))
    numbers = judge.judge(tokens, lengths, side, calls, cfg=cfg, mix=mix,
                          mem_budget=mem_budget, wire=wire)
    limits = cfg["limits"]
    numbers["fails"] = sorted(k for k in limits if numbers[k] > limits[k])
    return numbers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="float8_e4m3fn")
    args = ap.parse_args()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_control(args.workload, seed, args.precision)
        out["seed"], out["seconds"] = seed, time.perf_counter() - t0
        print(json.dumps({"control": args.precision, "workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
