#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py [--n-docs 57638] [--n-queries 1280] [--seed 0]

Phases, each of which raises (non-zero exit) on failure:

0. Require CUDA; print the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``fast_plaid_tpu_torch/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge cases (empty rows, sentinel and
   out-of-range pids, one run spanning a row, ragged widths), and time both.
3. The main path: ``FastPlaid(index, device="cuda", low_memory=False)
   .create(docs)`` over a synthetic corpus (unit-norm tokens, lengths
   uniform in [80, 160], d=128, seeded), then ``.search`` of random queries
   plus 64 planted probes (verbatim 32-token prefixes of documents). Both
   kernels' launch counters must rise during the search, planted hit@1 must
   be 1.0, and the same tiles run through the engine with the plain versions
   must give the same top-10 except for ties. The kernels are compared once
   more on the inputs the main path handed them.
4. Print the kernels' JSON record, then the contract line
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
Q_LEN, DIM, TOP_K = 32, 128, 10
N_PROBE, N_FULL = 8, 4096
EST_ATOL = 1e-4
RERANK_TOL = 1e-3  # rtol and atol: tensor-core accumulation order
TIE_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want) -> float:
    """Max |got - want| over finite entries; raises if -inf patterns differ."""
    import torch

    g, w = got.float().cpu(), want.float().cpu()
    if not torch.equal(torch.isneginf(g), torch.isneginf(w)):
        raise AssertionError("-inf entries differ between kernel and plain version")
    if torch.isnan(g).any() or torch.isnan(w).any():
        raise AssertionError("NaN in kernel or plain output")
    fin = torch.isfinite(w)
    return float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0


def check_estimate(pid, own, tbl, name: str, timing: bool = False) -> dict:
    import torch

    from fast_plaid_tpu_torch.ops.estimate_kernel import (
        segmented_estimate,
        segmented_estimate_plain,
    )

    got = segmented_estimate(pid, own, tbl)
    want = segmented_estimate_plain(pid, own, tbl)
    torch.cuda.synchronize()
    err = max_err(got, want)
    rec = {"case": name, "shape": list(tbl.shape) + [pid.shape[1]], "max_abs_err": err}
    if err > EST_ATOL:
        raise AssertionError(f"segmented_estimate {name}: max abs err {err} > {EST_ATOL}")
    if timing:
        rec["ms"] = cuda_time_ms(lambda: segmented_estimate(pid, own, tbl), 20)
        rec["plain_ms"] = cuda_time_ms(lambda: segmented_estimate_plain(pid, own, tbl), 3)
        # Bytes the kernel must move: pid + own read, out written (4 B each).
        rec["kernel_GBps"] = pid.numel() * 12 / rec["ms"] / 1e6
    log(f"# estimate {json.dumps(rec)}")
    return rec


def check_rerank(emb, pids, lens, qs, name: str, timing: bool = False) -> dict:
    import torch

    from fast_plaid_tpu_torch.ops.rerank_kernel import (
        maxsim_gather_scores,
        maxsim_gather_scores_plain,
    )

    got = maxsim_gather_scores(emb, pids, lens, qs)
    want = maxsim_gather_scores_plain(emb, pids, lens, qs)
    torch.cuda.synchronize()
    err = max_err(got, want)
    fin = torch.isfinite(want)
    bound = float((RERANK_TOL + RERANK_TOL * want[fin].abs()).min()) if fin.any() else 1.0
    rel_ok = bool(
        ((got[fin] - want[fin]).abs() <= RERANK_TOL + RERANK_TOL * want[fin].abs()).all()
    )
    rec = {
        "case": name,
        "B": pids.shape[0],
        "R": pids.shape[1],
        "Q": qs.shape[1],
        "doc_cap": emb.shape[1],
        "max_abs_err": err,
        "empty_rows": int((~fin).sum()),
    }
    if not rel_ok:
        raise AssertionError(
            f"maxsim_gather_scores {name}: max abs err {err} beyond rtol/atol "
            f"{RERANK_TOL} (tightest bound {bound})"
        )
    if timing:
        rec["ms"] = cuda_time_ms(lambda: maxsim_gather_scores(emb, pids, lens, qs), 10)
        rec["plain_ms"] = cuda_time_ms(
            lambda: maxsim_gather_scores_plain(emb, pids, lens, qs), 2
        )
        # Bytes the kernel must move: the valid rows of every candidate.
        ok = (pids >= 0) & (pids < emb.shape[0])
        rows = torch.where(ok, lens.clamp(0, emb.shape[1]), 0).sum().item()
        rec["kernel_GBps"] = rows * emb.shape[2] * 2 / rec["ms"] / 1e6
    log(f"# rerank {json.dumps(rec)}")
    return rec


def phase_kernels(dev: "torch.device", n_docs: int) -> None:
    """Phase 2: synthetic main-path shapes and edge cases."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)

    def sorted_pids(b, w, hi):
        return torch.sort(
            torch.randint(0, hi, (b, w), generator=g, device=dev, dtype=torch.int32), dim=-1
        ).values

    # Estimate: main-path shape (B 256, slot width ~24k, ~90 cells, Q 32).
    b, w, c, q = 256, 24064, 90, 32
    pid = sorted_pids(b, w, n_docs + 1)
    own = torch.randint(0, c, (b, w), generator=g, device=dev, dtype=torch.int32)
    tbl = torch.randn((b, c, q), generator=g, device=dev).to(torch.bfloat16)
    check_estimate(pid, own, tbl, "main_shape_random", timing=True)
    # Runs of several slots: pids drawn from a narrow range.
    check_estimate(sorted_pids(b, w, w // 4), own, tbl, "main_shape_runs")
    # One run spanning the whole row, width not a multiple of the tile.
    w2 = 3000 + 37
    pid2 = torch.zeros((3, w2), dtype=torch.int32, device=dev)
    own2 = torch.randint(0, 7, (3, w2), generator=g, device=dev, dtype=torch.int32)
    tbl2 = torch.randn((3, 7, 8), generator=g, device=dev)
    check_estimate(pid2, own2, tbl2, "single_run_ragged")
    # Q not a multiple of 32, sentinel tail run.
    pid3 = sorted_pids(5, 1037, 300)
    pid3[:, -40:] = n_docs
    own3 = torch.randint(0, 12, (5, 1037), generator=g, device=dev, dtype=torch.int32)
    tbl3 = torch.randn((5, 12, 24), generator=g, device=dev)
    check_estimate(pid3, own3, tbl3, "q24_sentinel_tail")

    # Rerank: main-path shape (B 256, R 2048, doc_cap 160, Q 32, D 128).
    npd = ((n_docs + 1 + 7) // 8) * 8
    emb = torch.randn((npd, 160, DIM), generator=g, device=dev).to(torch.bfloat16)
    b, r = 256, 2048
    pids = torch.randint(0, n_docs, (b, r), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(80, 161, (b, r), generator=g, device=dev, dtype=torch.int32)
    qs = torch.randn((b, Q_LEN, DIM), generator=g, device=dev)
    qs = qs / qs.norm(dim=-1, keepdim=True)
    check_rerank(emb, pids, lens, qs, "main_shape_random", timing=True)
    del emb
    # Edge cases: empty rows, sentinel and out-of-range pids, ragged R and Q.
    emb_s = torch.randn((500, 48, DIM), generator=g, device=dev).to(torch.bfloat16)
    pids_s = torch.randint(0, 500, (9, 130), generator=g, device=dev, dtype=torch.int32)
    lens_s = torch.randint(0, 49, (9, 130), generator=g, device=dev, dtype=torch.int32)
    pids_s[0, :5] = 499
    lens_s[0, :5] = 0  # sentinel row: length 0
    pids_s[1, :3] = torch.tensor([-1, 500, 10_000], dtype=torch.int32, device=dev)
    lens_s[2, :4] = 0
    lens_s[3, :4] = 48
    qs_s = torch.randn((9, 24, DIM), generator=g, device=dev)
    rec = check_rerank(emb_s, pids_s, lens_s, qs_s, "edge_cases")
    if rec["empty_rows"] < 12:
        raise AssertionError("edge case: empty / out-of-range rows did not score -inf")


def planted_corpus(n_docs: int, seed: int):
    """Unit-norm tokens, lengths uniform in [80, 160]; one flat array."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(80, 161, size=n_docs)
    total = int(lens.sum())
    flat = np.empty((total, DIM), np.float32)
    block = 1 << 20
    for s in range(0, total, block):
        x = rng.standard_normal((min(block, total - s), DIM), dtype=np.float32)
        flat[s : s + x.shape[0]] = x / np.linalg.norm(x, axis=-1, keepdims=True)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    docs = [flat[offsets[i] : offsets[i + 1]] for i in range(n_docs)]
    return docs, rng


def same_topk(a_ids, a_sc, b_ids, b_sc) -> tuple[bool, float]:
    """Top-k lists agree except for score ties at the boundary."""
    err = float(np.abs(a_sc - b_sc).max())
    if err > TIE_TOL:
        return False, err
    for ids_a, sc_a, ids_b, sc_b in zip(a_ids, a_sc, b_ids, b_sc):
        for ids, sc, other in ((ids_a, sc_a, ids_b), (ids_b, sc_b, ids_a)):
            for j, pid in enumerate(ids.tolist()):
                # A document only one list holds must tie the k-th score.
                if pid not in other and abs(sc[j] - sc[-1]) > TIE_TOL:
                    return False, err
    return True, err


def phase_main_path(dev, n_docs: int, n_queries: int, seed: int) -> dict:
    import torch

    from fast_plaid_tpu_torch.ops.estimate_kernel import segmented_estimate
    from fast_plaid_tpu_torch.ops.rerank_kernel import maxsim_gather_scores
    from fast_plaid_tpu_torch.search import FastPlaid, engine
    from fast_plaid_tpu_torch.search.searcher import last_search_stats

    t0 = time.perf_counter()
    docs, rng = planted_corpus(n_docs, seed)
    probe_rng = np.random.default_rng(7)
    probe_pids = probe_rng.integers(0, n_docs, 64)
    probes = np.stack([docs[p][:Q_LEN] for p in probe_pids])
    rand_q = rng.standard_normal((n_queries, Q_LEN, DIM), dtype=np.float32)
    rand_q /= np.linalg.norm(rand_q, axis=-1, keepdims=True)
    queries = np.concatenate([rand_q, probes])
    log(f"# corpus: {n_docs} docs, {sum(len(d) for d in docs)} tokens in "
        f"{time.perf_counter() - t0:.1f} s")

    index_dir = os.path.join(ROOT, "build", "chip_smoke_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    try:
        fp = FastPlaid(index_dir, device=str(dev), low_memory=False)
        t0 = time.perf_counter()
        fp.create(docs, show_progress=False)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        loaded = fp.indices[str(dev)]
        ispec = loaded.ispec
        log(f"# create: {create_s:.2f} s, {ispec}")
        if loaded.dev.emb_cache is None:
            raise AssertionError("the bf16 corpus cache is not resident")
        log(f"# emb_cache resident: {tuple(loaded.dev.emb_cache.shape)} "
            f"{loaded.dev.emb_cache.dtype}")

        fp.search(queries[:256], top_k=TOP_K, n_full_scores=N_FULL,
                  n_ivf_probe=N_PROBE, show_progress=False)  # warm-up
        torch.cuda.synchronize()
        segmented_estimate.launches = 0
        maxsim_gather_scores.launches = 0
        t0 = time.perf_counter()
        results = fp.search(queries, top_k=TOP_K, n_full_scores=N_FULL,
                            n_ivf_probe=N_PROBE, show_progress=False)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        launches = {
            "segmented_estimate": segmented_estimate.launches,
            "maxsim_gather_scores": maxsim_gather_scores.launches,
        }
        stats = last_search_stats()
        log(f"# search: {len(queries)} queries in {search_s:.3f} s = "
            f"{len(queries) / search_s:.1f} QPS; launches {launches}; stats {stats}")
        if stats["approx_mode"] != "cells" or stats["rank_admit"] < 1:
            raise AssertionError(f"expected cells with rank_admit >= 1, got {stats}")
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"{name} was not launched during the search")
        if len(results) != len(queries) or any(len(r) != TOP_K for r in results):
            raise AssertionError("search returned the wrong number of results")
        scores = np.asarray([[s for _, s in r] for r in results])
        if not np.isfinite(scores).all():
            raise AssertionError("non-finite scores in the results")
        hits = [results[n_queries + i][0][0] == int(p) for i, p in enumerate(probe_pids)]
        hit1 = float(np.mean(hits))
        log(f"# planted hit@1: {hit1:.4f} over {len(hits)} probes")
        if hit1 != 1.0:
            raise AssertionError(f"planted hit@1 {hit1} != 1.0")

        # The same tiles through the engine: kernels vs plain versions.
        q_cap = Q_LEN
        n_cells = min(q_cap * N_PROBE, ispec.n_partitions)
        cand_cap = engine.candidate_capacity(loaded.ivf_lengths_host, n_cells, N_FULL)
        mode, rank_admit, slot_budget = engine.resolve_approx_mode(
            "auto",
            loaded.ivf_lengths_host,
            q_cap=q_cap,
            n_ivf_probe=N_PROBE,
            n_full_scores=N_FULL,
            n_partitions=ispec.n_partitions,
            cand_cap=cand_cap,
            slot_budget=engine.suggest_slot_budget(loaded.ivf_lengths_host, N_FULL),
            n_docs=ispec.n_docs,
        )
        log(f"# resolved: approx_mode={mode} rank_admit={rank_admit} "
            f"slot_budget={slot_budget} cand_cap={cand_cap}")
        kw = dict(
            ispec=ispec, top_k=TOP_K, n_ivf_probe=N_PROBE, n_full_scores=N_FULL,
            mem_budget=fp.mem_budget, cand_cap=cand_cap, approx_mode=mode,
            slot_budget=slot_budget, rank_admit=rank_admit,
        )
        captured: dict = {}

        def recorder(fn, key):
            def inner(*args):
                captured[key] = args
                return fn(*args)
            return inner

        worst = 0.0
        for t_start in (0, len(queries) - 256):
            tile = torch.from_numpy(queries[t_start : t_start + 256].astype(np.float16)).to(dev)
            with torch.inference_mode():
                if t_start == 0:
                    engine.segmented_estimate = recorder(segmented_estimate, "est")
                    engine.maxsim_gather_scores = recorder(maxsim_gather_scores, "rr")
                try:
                    k_ids, k_sc = engine.search_impl(
                        loaded.dev, tile, None, use_estimate_kernel=True,
                        use_rerank_kernel=True, **kw)
                finally:
                    engine.segmented_estimate = segmented_estimate
                    engine.maxsim_gather_scores = maxsim_gather_scores
                p_ids, p_sc = engine.search_impl(
                    loaded.dev, tile, None, use_estimate_kernel=False,
                    use_rerank_kernel=False, **kw)
            ok, err = same_topk(k_ids.cpu().numpy(), k_sc.cpu().numpy(),
                                p_ids.cpu().numpy(), p_sc.cpu().numpy())
            worst = max(worst, err)
            if not ok:
                raise AssertionError(
                    f"kernel-path and plain-path top-{TOP_K} differ beyond ties "
                    f"(tile at {t_start}, max score diff {err})")
        log(f"# kernel path vs plain path: top-{TOP_K} equal up to ties, "
            f"max score diff {worst:.3e}")

        # Latency of one 256-query tile through the engine with the kernels,
        # host clock around work that ends in a device synchronize.
        tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)
        lat = []
        with torch.inference_mode():
            for _ in range(30):
                t0 = time.perf_counter()
                engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                                   use_rerank_kernel=True, **kw)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
        p50, p99 = (float(np.percentile(lat, p)) for p in (50, 99))
        log(f"# 256-query tile latency over 30 tiles: p50 {p50:.3f} ms, "
            f"p99 {p99:.3f} ms")

        est = check_estimate(*captured["est"], "main_path_inputs", timing=True)
        rr = check_rerank(*captured["rr"], "main_path_inputs", timing=True)
        return {
            "launches": launches,
            "est": est,
            "rr": rr,
            "qps": len(queries) / search_s,
            "tile_ms": (p50, p99),
            "create_s": create_s,
            "hit1": hit1,
        }
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=57_638)
    ap.add_argument("--n-queries", type=int, default=1280)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available; nothing to check")
    sys.path.insert(0, ROOT)
    from fast_plaid_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"# card: {smi}")
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    info = _build.build_info()
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"# ptxas: {line.strip()}")
    log(f"# kernels built in {build_s:.2f} s: {info['path']}")

    phase_kernels(dev, args.n_docs)
    torch.cuda.empty_cache()
    main = phase_main_path(dev, args.n_docs, args.n_queries, args.seed)
    log(f"# build {build_s:.2f} s, create {main['create_s']:.2f} s, "
        f"search {main['qps']:.1f} QPS (top_k {TOP_K}, 256-query tiles), "
        f"tile p50/p99 {main['tile_ms'][0]:.3f}/{main['tile_ms'][1]:.3f} ms, "
        f"planted hit@1 {main['hit1']}, on {smi}")

    kernels = [
        {
            "name": "segmented_estimate",
            "route": "cuda",
            "source": "fast_plaid_tpu_torch/csrc/estimate_kernel.cu",
            "replaces": "fast_plaid_tpu/ops/estimate_kernel.py:46",
            "launches": main["launches"]["segmented_estimate"],
            "max_abs_err": main["est"]["max_abs_err"],
            "ms": main["est"]["ms"],
            "plain_ms": main["est"]["plain_ms"],
        },
        {
            "name": "maxsim_gather_scores",
            "route": "cuda",
            "source": "fast_plaid_tpu_torch/csrc/rerank_kernel.cu",
            "replaces": "fast_plaid_tpu/ops/rerank_kernel.py:37",
            "launches": main["launches"]["maxsim_gather_scores"],
            "max_abs_err": main["rr"]["max_abs_err"],
            "ms": main["rr"]["ms"],
            "plain_ms": main["rr"]["plain_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
