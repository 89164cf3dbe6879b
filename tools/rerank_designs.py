#!/usr/bin/env python3
"""Time the per-query rerank kernels beside an earlier design of the same
kernels, in one process on one CUDA card, in turns (old, new, new, old).

    python3 tools/rerank_designs.py --old-csrc DIR [--n-docs 57638] [--reps 10]

DIR holds the earlier ``rerank_kernel.cu`` and ``q4_rerank_kernel.cu`` (for
example unpacked from a commit with ``git archive``). They are built with the
package's nvcc flags into a library of their own; both designs export the
same ``fp_maxsim_gather`` / ``fp_maxsim_q4_gather`` entry points. The new
design runs through the package's wrappers.

Pools, at the main path's shapes (B 256, R 2048, Q 32, D 128, doc_cap 160,
caph 80, over ``--n-docs`` documents):

- ``distinct_per_row``: each query row holds 2,048 distinct documents, as
  stage 5 hands them over; lengths are the documents' own, uniform in
  [80, 160];
- ``random_slots``: pids drawn with replacement, a length in [80, 160] per
  slot (chip_smoke.py phase 2's pool).

Prints the card, then one JSON line per kernel and pool: both designs' ms,
their max abs difference, GB/s on both byte counts, the bound and the
share of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_old(old_dir: str) -> ctypes.CDLL:
    from fast_plaid_tpu_torch.ops import _build

    names = ("rerank_kernel.cu", "q4_rerank_kernel.cu")
    sources = [Path(old_dir) / n for n in names]
    out_dir = Path(ROOT) / "build" / "rerank_designs_old"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libold_rerank.so"
    _build._compile(sources, out_dir, lib_path, out_dir / "nvcc.log")
    for line in (out_dir / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"# old ptxas: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("fp_maxsim_gather", "fp_maxsim_q4_gather"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--n-docs", type=int, default=57_638)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rerank_designs: no CUDA device available")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fast_plaid_tpu_torch.ops._build import check, load_library
    from fast_plaid_tpu_torch.ops.rerank_kernel import (
        maxsim_gather_scores,
        maxsim_q4_gather_scores,
    )

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# card: {smi}", flush=True)
    load_library()
    old = build_old(args.old_csrc)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def old_bf16(emb, pids, lens, qb):
        out = torch.empty(pids.shape, dtype=torch.float32, device=dev)
        n, cap, d = emb.shape
        b, r = pids.shape
        check(old.fp_maxsim_gather(emb.data_ptr(), n, cap, d, pids.data_ptr(), lens.data_ptr(),
                                   qb.data_ptr(), b, r, qb.shape[1], out.data_ptr(), stream),
              "old fp_maxsim_gather")
        return out

    def old_q4(emb_q4, scale, pids, lens, qb):
        out = torch.empty(pids.shape, dtype=torch.float32, device=dev)
        npd, d = scale.shape[0], emb_q4.shape[1]
        b, r = pids.shape
        check(old.fp_maxsim_q4_gather(emb_q4.data_ptr(), scale.data_ptr(), npd,
                                      emb_q4.shape[0] // npd, d, pids.data_ptr(),
                                      lens.data_ptr(), qb.data_ptr(), b, r, qb.shape[1],
                                      out.data_ptr(), stream),
              "old fp_maxsim_q4_gather")
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    n_docs, b, r, cap, d = args.n_docs, 256, 2048, 160, cs.DIM
    npd = (n_docs + 1 + 7) // 8 * 8
    doc_lengths = torch.randint(80, cap + 1, (npd,), generator=g, device=dev, dtype=torch.int32)
    qb = torch.randn((b, cs.Q_LEN, d), generator=g, device=dev)
    qb = (qb / qb.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    rank = torch.argsort(torch.rand((b, n_docs), generator=g, device=dev), dim=-1)
    distinct = rank[:, :r].to(torch.int32).contiguous()
    del rank
    rand = torch.randint(0, n_docs, (b, r), generator=g, device=dev, dtype=torch.int32)
    pools = {
        "distinct_per_row": (distinct, doc_lengths[distinct.long()]),
        "random_slots": (rand, torch.randint(80, cap + 1, (b, r), generator=g, device=dev,
                                             dtype=torch.int32)),
    }
    emb = torch.randn((npd, cap, d), generator=g, device=dev).to(torch.bfloat16)
    emb_q4 = torch.randint(0, 256, (npd * cap // 2, d), generator=g, device=dev).to(torch.uint8)
    scale = torch.rand((npd,), generator=g, device=dev) / 7
    kernels = {
        "maxsim_gather_scores": (
            lambda p, ln: old_bf16(emb, p, ln, qb),
            lambda p, ln: maxsim_gather_scores(emb, p, ln, qb),
            lambda p, ln: cs.rerank_work(p, ln, qb, npd, cap, d),
        ),
        "maxsim_q4_gather_scores": (
            lambda p, ln: old_q4(emb_q4, scale, p, ln, qb),
            lambda p, ln: maxsim_q4_gather_scores(emb_q4, scale, p, ln, qb),
            lambda p, ln: cs.rerank_work(p, ln, qb, npd, cap, d, q4_half=cap // 2),
        ),
    }
    for name, (f_old, f_new, work) in kernels.items():
        for pool, (p, ln) in pools.items():
            err = cs.check_close(f_new(p, ln), f_old(p, ln), f"{name} {pool}: new vs old")
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                fn = f_old if which == "old" else f_new
                times[which].append(cs.cuda_time_ms(lambda fn=fn: fn(p, ln), args.reps))
            rec = {"kernel": name, "pool": pool, "max_abs_diff_new_vs_old": err,
                   "old_ms": times["old"], "new_ms": times["new"],
                   "ms": sum(times["new"]) / 2, "old_mean_ms": sum(times["old"]) / 2}
            cs.add_rates(rec, work(p, ln))
            rec["speedup"] = rec["old_mean_ms"] / rec["ms"]
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
