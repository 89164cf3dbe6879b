#!/usr/bin/env python3
"""Time the port's kernels beside an earlier design of the same kernels, in
one process on one CUDA card, in turns (old, new, new, old).

    python3 tools/rerank_designs.py --old DIR [--n-docs 57638] [--reps 10]

DIR holds an earlier ``fast_plaid_tpu_torch`` package, or at least its
``csrc/`` and ``ops/`` (for example unpacked from a commit with ``git
archive <commit> fast_plaid_tpu_torch``, into a directory that ``.gitignore``
lists). Its sources are built with the package's nvcc flags into a library
of their own, and its wrapper modules (``ops/estimate_kernel.py``,
``ops/rerank_kernel.py``, ``ops/rerank_dedup.py``) are loaded from their
files and run against that library, so each design is timed with the glue
of its own wrapper. The new design runs through the package's wrappers.

Pools, at the main path's shapes (B 256, Q 32, D 128):

- kernels 2 and 3 (R 2048, doc_cap 160, caph 80, over ``--n-docs``
  documents): ``distinct_per_row``, 2,048 distinct documents per query row
  as stage 5 hands them over, lengths the documents' own, uniform in
  [80, 160]; ``random_slots``, pids drawn with replacement and a length in
  [80, 160] per slot;
- kernel 4, the dedup rerank: ``distinct_per_row`` as above (the resident
  path's pool), and ``long_docs``, 4,096 pages of 1,000-1,030 tokens
  (doc_cap 1,040) with 2,048 distinct pages per query row; the earlier
  design refused doc_cap 1,040 there, so that pool holds the new dedup
  kernel against kernel 2 instead;
- kernel 1, the stage-4 estimate: W 12,152 slots a row (the main path's
  slot budget), pid-sorted rows whose last 30% is one sentinel run, a
  [256, 32] table a row (C 256).

Prints the card, then one JSON line per kernel and pool: both designs' ms
(wrapper calls, CUDA events), the kernel's own device ms (torch.profiler),
their max abs difference, GB/s on both byte counts, the bound and the
share of it.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_old(old_dir: str):
    """Build the earlier package's kernels and load its wrapper modules."""
    from fast_plaid_tpu_torch.ops import _build

    pkg = Path(old_dir)
    if (pkg / "fast_plaid_tpu_torch").is_dir():
        pkg = pkg / "fast_plaid_tpu_torch"
    sources = sorted(p for p in (pkg / "csrc").iterdir() if p.suffix in (".cu", ".cuh"))
    out_dir = Path(ROOT) / "build" / "rerank_designs_old"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libold_kernels.so"
    _build._compile(sources, out_dir, lib_path, out_dir / "nvcc.log")
    for line in (out_dir / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"# old ptxas: {line.strip()}", flush=True)
    mods = {}
    for name in ("_build", "estimate_kernel", "rerank_kernel", "rerank_dedup"):
        spec = importlib.util.spec_from_file_location(f"old_{name}", pkg / "ops" / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in mods["_build"]._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib, mods


@contextlib.contextmanager
def old_library(lib):
    """The earlier wrappers import ``load_library`` at call time: point it at
    the earlier library while they run."""
    from fast_plaid_tpu_torch.ops import _build

    real = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = real


def kernel_ms(fn, reps: int, name: str) -> float:
    """Device ms of one call's kernels whose name holds ``name``
    (torch.profiler over ``reps`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and name in e.key:
            total += getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    return total / 1e3 / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--n-docs", type=int, default=57_638)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rerank_designs: no CUDA device available")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fast_plaid_tpu_torch.ops._build import load_library
    from fast_plaid_tpu_torch.ops.estimate_kernel import segmented_estimate
    from fast_plaid_tpu_torch.ops.rerank_dedup import maxsim_gather_scores_dedup
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
    old_lib, old = load_old(args.old)

    def run_old(fn):
        def call(*a):
            with old_library(old_lib):
                return fn(*a)
        return call

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
    rr, dd = old["rerank_kernel"], old["rerank_dedup"]
    cases = [  # (kernel, device-kernel name, pool, old fn, new fn, work, args)
        *[("maxsim_gather_scores", "maxsim_gather_kernel", pool,
           run_old(lambda p, ln: rr.maxsim_gather_scores(emb, p, ln, qb)),
           lambda p, ln: maxsim_gather_scores(emb, p, ln, qb),
           lambda p, ln: cs.rerank_work(p, ln, qb, npd, cap, d), pools[pool])
          for pool in pools],
        *[("maxsim_q4_gather_scores", "q4", pool,
           run_old(lambda p, ln: rr.maxsim_q4_gather_scores(emb_q4, scale, p, ln, qb)),
           lambda p, ln: maxsim_q4_gather_scores(emb_q4, scale, p, ln, qb),
           lambda p, ln: cs.rerank_work(p, ln, qb, npd, cap, d, q4_half=cap // 2),
           pools[pool]) for pool in pools],
        ("maxsim_gather_scores_dedup", "dedup", "distinct_per_row",
         run_old(lambda p, ln: dd.maxsim_gather_scores_dedup(emb, p, ln, qb)),
         lambda p, ln: maxsim_gather_scores_dedup(emb, p, ln, qb),
         lambda p, ln: cs.rerank_work(p, ln, qb, npd, cap, d), pools["distinct_per_row"]),
    ]
    for name, dev_name, pool, f_old, f_new, work, (p, ln) in cases:
        err = cs.check_close(f_new(p, ln), f_old(p, ln), f"{name} {pool}: new vs old")
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = f_old if which == "old" else f_new
            times[which].append(cs.cuda_time_ms(lambda fn=fn: fn(p, ln), args.reps))
        rec = {"kernel": name, "pool": pool, "max_abs_diff_new_vs_old": err,
               "old_ms": times["old"], "new_ms": times["new"],
               "ms": sum(times["new"]) / 2, "old_mean_ms": sum(times["old"]) / 2,
               "old_kernel_ms": kernel_ms(lambda: f_old(p, ln), args.reps, dev_name),
               "new_kernel_ms": kernel_ms(lambda: f_new(p, ln), args.reps, dev_name)}
        cs.add_rates(rec, work(p, ln))
        rec["speedup"] = rec["old_mean_ms"] / rec["ms"]
        print(json.dumps(rec), flush=True)
    del emb, emb_q4

    # Long documents: the new dedup kernel against kernel 2 (the earlier dedup
    # design refused doc_cap 1,040), in turns.
    n_long, cap_l = 4096, 1040
    emb_l = torch.randn((n_long + 1, cap_l, d), generator=g, device=dev).to(torch.bfloat16)
    len_l = torch.randint(1000, 1031, (n_long + 1,), generator=g, device=dev, dtype=torch.int32)
    len_l[-1] = 0
    p_l = torch.argsort(torch.rand((b, n_long), generator=g, device=dev), dim=-1)[:, :r]
    p_l = p_l.to(torch.int32).contiguous()
    l_l = len_l[p_l.long()]
    k2 = lambda: maxsim_gather_scores(emb_l, p_l, l_l, qb)  # noqa: E731
    k4 = lambda: maxsim_gather_scores_dedup(emb_l, p_l, l_l, qb)  # noqa: E731
    err = cs.check_close(k4(), k2(), "dedup long_docs: dedup vs kernel 2")
    times = {"kernel2": [], "dedup": []}
    for which in ("kernel2", "dedup", "dedup", "kernel2"):
        times[which].append(cs.cuda_time_ms(k2 if which == "kernel2" else k4, 3))
    rec = {"kernel": "maxsim_gather_scores_dedup", "pool": "long_docs",
           "max_abs_diff_vs_kernel2": err, "kernel2_ms": times["kernel2"],
           "dedup_ms": times["dedup"], "ms": sum(times["dedup"]) / 2,
           "kernel2_mean_ms": sum(times["kernel2"]) / 2,
           "new_kernel_ms": kernel_ms(k4, 3, "dedup")}
    cs.add_rates(rec, cs.rerank_work(p_l, l_l, qb, n_long + 1, cap_l, d))
    rec["speedup_vs_kernel2"] = rec["kernel2_mean_ms"] / rec["ms"]
    print(json.dumps(rec), flush=True)
    del emb_l

    # Stage 4: W 12,152 (the main path's slot budget), C 256, Q 32.
    w, c = 12_152, 256
    pid = torch.sort(torch.randint(0, n_docs, (b, w), generator=g, device=dev,
                                   dtype=torch.int32), dim=-1).values
    pid[:, int(0.7 * w):] = n_docs  # the sentinel run that ends every row
    own = torch.randint(0, c, (b, w), generator=g, device=dev, dtype=torch.int32)
    tbl = torch.randn((b, c, cs.Q_LEN), generator=g, device=dev).to(torch.bfloat16)
    ek = old["estimate_kernel"]
    f_old = run_old(lambda: ek.segmented_estimate(pid, own, tbl))
    f_new = lambda: segmented_estimate(pid, own, tbl)  # noqa: E731
    err = cs.max_err(f_new(), f_old())
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(cs.cuda_time_ms(f_old if which == "old" else f_new, 20))
    nbytes = pid.numel() * 12 + tbl.numel() * 2
    ms = sum(times["new"]) / 2
    bound_ms, bound_by = cs.bound(nbytes, pid.numel() * cs.Q_LEN, cs.F32_OPS)
    rec = {"kernel": "segmented_estimate", "pool": "main_width_sentinel_tail",
           "max_abs_diff_new_vs_old": err, "old_ms": times["old"], "new_ms": times["new"],
           "ms": ms, "old_mean_ms": sum(times["old"]) / 2,
           "new_kernel_ms": kernel_ms(f_new, 20, "estimate"),
           "kernel_GBps": nbytes / ms / 1e6, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms}
    rec["speedup"] = rec["old_mean_ms"] / ms
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
