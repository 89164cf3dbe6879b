#!/usr/bin/env python3
"""Time the port's C++ host kernels against their torch / numpy paths.

    python3 tools/native_host_bench.py [--out build/native_host_bench.json]

Builds ``fast_plaid_tpu_torch/native/fastplaid_native.cpp`` with g++ (the
package's flags) at ``FP_MAX_THREADS`` 1, 4, 8 and 16 into
``build/native_host_bench/`` and times, on seeded data at the shapes of
``chip_smoke.py``'s paths, each variant beside the path it replaces:

* the low_memory row gather of one 256-query tile (a 40-row rescue pool a
  query; residual rows of 64 bytes and int32 codes): doc_cap 160 over 57,638
  documents of 80-160 tokens (phase 4) and doc_cap 1,040 over 4,096 of
  1,000-1,030 (phase 7), by one caller, and by four callers at once, each
  over its own quarter of the corpus (phase 13b's four ``load_sharded_lm``
  shards); beside the torch ``index_select`` gather
  (``searcher._gather_windows(use_native=False)``); into pinned memory where
  a CUDA device exists, as the path gathers;
* ``build_ivf`` of 57,638 documents at K 32,768 (80-160 and 200-300 tokens
  a document) against its ``np.unique`` path.

Every output is checked equal to the torch / numpy one. Prints one JSON
object (medians of 5 rounds, variants in turn) and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fast_plaid_tpu_torch import native  # noqa: E402
from fast_plaid_tpu_torch.index.ivf import build_ivf_numpy  # noqa: E402
from fast_plaid_tpu_torch.search import searcher  # noqa: E402

THREADS = (1, 4, 8, 16)
P, I64 = ctypes.c_void_p, ctypes.c_int64


def build_variant(n_threads: int) -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "build", "native_host_bench")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libfastplaid_native_t{n_threads}.so")
    cmd = ["g++", *native._FLAGS, f"-DFP_MAX_THREADS={n_threads}", str(native._SRC), "-o", lib]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    dll = ctypes.CDLL(lib)
    dll.fp_gather_windows_u8.restype = None
    dll.fp_gather_windows_u8.argtypes = [P, I64, I64, P, P, I64, I64, P]
    dll.fp_build_ivf.restype = I64
    dll.fp_build_ivf.argtypes = [P, I64, P, I64, I64, P, P]
    return dll


def corpus(rng, n_docs: int, lo: int, hi: int):
    lens = rng.integers(lo, hi + 1, n_docs)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    t = int(lens.sum())
    res = np.frombuffer(rng.bytes(t * 64), np.uint8).reshape(t, 64)
    codes = rng.integers(0, 32_768, t).astype(np.int32)
    return lens, offs, res, codes


def gather_native(dll, src, offs, lens, cap, pin):
    out = torch.empty((len(offs), cap, *src.shape[1:]), dtype=torch.from_numpy(src[:1]).dtype,
                      pin_memory=pin)
    u8 = src.view(np.uint8).reshape(src.shape[0], -1)
    offs = np.ascontiguousarray(offs, np.int64)
    lens32 = np.ascontiguousarray(lens, np.int32)
    dll.fp_gather_windows_u8(u8.ctypes.data, u8.shape[0], u8.shape[1], offs.ctypes.data,
                             lens32.ctypes.data, len(offs), cap, out.data_ptr())
    return out


def tile_jobs(rng, lens, offs, cap: int, n_callers: int):
    """A tile's windows (256 x 40) for each caller, over its own quarter."""
    n = len(lens)
    per = n // n_callers
    jobs = []
    for c in range(n_callers):
        pids = rng.integers(c * per, (c + 1) * per, 256 * 40)
        jobs.append((offs[pids], np.minimum(lens[pids], cap)))
    return jobs


def time_gathers(label, dlls, res, codes, jobs, cap, pin) -> dict:
    def run(fn):
        def one(job):
            return fn(res, job, cap), fn(codes, job, cap)

        t0 = time.perf_counter()
        if len(jobs) == 1:
            outs = [one(jobs[0])]
        else:
            with ThreadPoolExecutor(len(jobs)) as pool:
                outs = list(pool.map(one, jobs))
        return (time.perf_counter() - t0) * 1e3, outs

    variants = {"torch": lambda s, j, c: searcher._gather_windows(s, j[0], j[1], c, pin, False)}
    for n, dll in dlls.items():
        variants[f"native_t{n}"] = (lambda d: lambda s, j, c: gather_native(d, s, j[0], j[1], c, pin))(dll)
    ms = {k: [] for k in variants}
    want = None
    for _ in range(5):
        for name, fn in variants.items():
            t, outs = run(fn)
            ms[name].append(t)
            if name == "torch":
                want = outs
            elif not all(torch.equal(a, b) for o, w in zip(outs, want) for a, b in zip(o, w)):
                raise AssertionError(f"{label}: {name} differs from the torch gather")
    mb = sum(t.numel() * t.element_size() for o in want for t in o) / 1e6
    out = {"callers": len(jobs), "doc_cap": cap, "mb": mb,
           "ms": {k: float(np.median(v)) for k, v in ms.items()}}
    print(f"# {label}: {mb:.1f} MB, " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["ms"].items()),
          flush=True)
    return out


def time_ivf(label, dlls, codes, lens) -> dict:
    k = 32_768
    want = build_ivf_numpy(codes, lens, k)
    ms = {"numpy": []}
    ms.update({f"native_t{n}": [] for n in dlls})
    for _ in range(5):
        t0 = time.perf_counter()
        build_ivf_numpy(codes, lens, k)
        ms["numpy"].append((time.perf_counter() - t0) * 1e3)
        for n, dll in dlls.items():  # one thread: the thread cap does not apply
            t0 = time.perf_counter()
            n_pairs = dll.fp_build_ivf(codes.ctypes.data, codes.size, lens.ctypes.data, lens.size,
                                       k, None, None)
            ivf, ivf_len = np.empty(n_pairs, np.int32), np.empty(k, np.int64)
            dll.fp_build_ivf(codes.ctypes.data, codes.size, lens.ctypes.data, lens.size, k,
                             ivf.ctypes.data, ivf_len.ctypes.data)
            ms[f"native_t{n}"].append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(ivf, want[0]) and np.array_equal(ivf_len, want[1])):
                raise AssertionError(f"{label}: native IVF differs from np.unique's")
    out = {"codes": int(codes.size), "k": k, "ms": {n: float(np.median(v)) for n, v in ms.items()}}
    print(f"# {label}: " + ", ".join(f"{n} {v:.1f} ms" for n, v in out["ms"].items()), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "native_host_bench.json"))
    args = ap.parse_args()
    pin = torch.cuda.is_available()
    card = None
    if pin:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dlls = {n: build_variant(n) for n in THREADS}
    rng = np.random.default_rng(0)
    result = {"host_cpus": os.cpu_count(), "card": card, "torch_threads": torch.get_num_threads(),
              "pinned": pin, "gather": {}, "build_ivf": {}}
    lens, offs, res, codes = corpus(rng, 57_638, 80, 160)
    for callers in (1, 4):
        jobs = tile_jobs(rng, lens, offs, 160, callers)
        result["gather"][f"doc_cap_160_x{callers}"] = time_gathers(
            f"gather, doc_cap 160, {callers} caller(s)", dlls, res, codes, jobs, 160, pin)
    result["build_ivf"]["80_160"] = time_ivf("build_ivf, 80-160 tokens", dlls, codes, lens)
    del res
    lens, offs, res, codes = corpus(rng, 4_096, 1_000, 1_030)
    for callers in (1, 4):
        jobs = tile_jobs(rng, lens, offs, 1_040, callers)
        result["gather"][f"doc_cap_1040_x{callers}"] = time_gathers(
            f"gather, doc_cap 1,040, {callers} caller(s)", dlls, res, codes, jobs, 1_040, pin)
    del res
    lens = rng.integers(200, 301, 57_638)
    codes = rng.integers(0, 32_768, int(lens.sum())).astype(np.int32)
    result["build_ivf"]["200_300"] = time_ivf("build_ivf, 200-300 tokens", dlls, codes, lens)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
