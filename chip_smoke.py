#!/usr/bin/env python3
"""Drive the PyTorch port's search paths once on one CUDA card.

    python3 chip_smoke.py [--n-docs 57638] [--n-queries 1280] [--seed 0]

Phases, each of which raises (non-zero exit) on failure:

0. Require CUDA; print the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``fast_plaid_tpu_torch/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at edge cases, and time both: the stages 1-2
   probe (8,192 query tokens x 32,768 cells, k 8, timed beside
   ``torch.matmul`` + ``torch.topk``; ragged N, Kp 33,000, k_real < Kp,
   all-zero rows, k 1 and 32, k_real below k; scores within one bf16 ulp,
   the same cells in the same order wherever cells and scores agree), the
   stage-4
   estimate (empty rows, one run spanning a row, ragged widths, a 256 KB
   table at W 12,152), the per-query rerank (empty rows, sentinel and
   out-of-range pids), the q4 rerank (B 256, R 2048, caph 80; lens 0,
   sentinel and out-of-range pids, caph 24, lens <= caph) and the dedup
   rerank (B 256, R 2048 pools of the main path's overlap; one pid for every
   slot, runs of exactly G and G + 1, all sentinel; the long-document pool,
   4,096 pages at doc_cap 1,040, timed; D 256, 384 and 512), the dedup kernel
   against the per-query kernel as well. The three rerank kernels also at
   the direct-subset pool's ragged widths R 8, 24, 256 and 3,608 (sorted
   pids, sentinel tail); kernels 2 and 3 at doc_cap 336, 1,040 and 2,048
   (ragged lengths with 0, <= caph and doc_cap, sentinel and out-of-range
   pids). Each timed kernel prints its ms, GB/s on two byte counts (every
   slot's rows; each distinct row once), its bound and the share of it;
   the build prints ptxas's registers.
3. The device-resident path: ``FastPlaid(index, device="cuda",
   low_memory=False).create(docs, metadata=...)`` over a synthetic corpus
   (unit-norm tokens, lengths uniform in [80, 160], d=128, seeded; metadata
   ``cat``, ``day``, ``title`` for every document), then ``.search`` of
   random queries plus 64 planted probes (verbatim 32-token prefixes of
   documents). Stages 1-2 take the probe kernel (32,768 cells) and stage 6
   the dedup kernel where ``dedup_viable`` holds (it does at this shape);
   the probe, estimate and dedup launch counters must rise, planted hit@1
   must be 1.0, and the same tiles run through the engine with the plain
   versions must give the same top-10 except for ties. The kernels are
   compared once more on the inputs this path handed them, and the probe
   kernel against ``torch.topk`` over the plain table on every tile (the
   same cells in the same order wherever cells and scores agree; the tiles
   then searched through the table route too where any row differs). 3b
   repeats the search with ``FASTPLAID_RERANK_DEDUP=0``, the stage 6 that
   corpora past the gate take, so the per-query kernel runs.
4. The default constructor, ``FastPlaid(index, device="cuda")`` (low_memory:
   residuals in host RAM, the q4 prefilter cache on the card), reopens the
   same index and searches the same queries: the estimate and q4 counters
   must rise, planted hit@1 must be 1.0, no result may be empty, and a tile
   run with the plain versions must give the same top-10 except for ties.
   The host row gather is timed.
5. The resident q4 tier: the same index reopened with ``low_memory=False``
   and ``emb_cache_budget_bytes`` between the q4 cache's and the bf16
   cache's size. Scale cut: at these widths the tier engages by itself
   only past about 1.4M documents on an 80 GB card, beyond this run's
   time, so the budget is forced. Planted hit@1 must be 1.0 with the q4
   kernel launched.
6. The mutable index, on the same index: subset searches (``where("cat =
   3")``, the direct pool on the resident instance; ``where("cat < 8")``,
   the density-scaled cascade; per-query subsets of 256 ids) on the resident
   instance and the default constructor, each checked for membership,
   planted hit@1 over the probes inside the subset, kernel path = plain path
   on one tile and the kernels' counters; ``search_token_scores`` and
   ``get_embeddings`` on both; then, on the default constructor, ``update``
   with 50 documents (buffered) and 2,000 more (the buffer trips: new
   centroids), and ``delete`` of 1,000 documents, each followed by planted
   probes at the documents' new ids and by the metadata's ``where``; last,
   the index reopened resident.
7. Long documents: 4,096 documents of 1,000 to 1,030 tokens (doc_cap
   1,040, as ColPali's ~1,030 patch vectors a page), d 128, seeded, through
   ``create`` and ``search`` on the resident instance (stage 6 is the dedup
   kernel: the pool is dedup-viable and the kernel's shared memory does not
   depend on doc_cap; then the same searches and tile with
   ``FASTPLAID_RERANK_DEDUP=0``, so kernel 2 runs there too) and on the
   default constructor (kernel 3 prefilters). Planted hit@1 1.0, the
   kernel's counter risen, one tile's kernel path = plain path.
   Phase 3 also counts, over every tile, the query-token rows whose probed
   cells from ``torch.topk`` differ from a stable sort's (the probe's tie
   order on the card), and where any do, whether a stable probe moves a
   top-10.
8. A length-skewed corpus: 57,638 documents of synthetic lognormal lengths
   (median 90, sigma 0.6) in [8, 300], d 128, seeded, through ``create``
   and the resident instance, where the loader picks the layout by the
   cache budget. At the default budget it keeps the single cap of 304 with
   its bf16 cache. At a budget of the bucketed bf16 caches' size it buckets
   (caps 96 / 176 / 304), and stage 6 runs once per bucket a tile: the
   dedup kernel where its gate holds (all three buckets here), kernel 2
   with ``FASTPLAID_RERANK_DEDUP=0``. At a budget of the q4 cache's size
   it keeps the single cap with the q4 tier. Each: planted hit@1 1.0, the
   launches of one tile counted, kernel = plain up to ties on the tile (and
   on each bucket's inputs), the quota drops printed.
9. ``approx_mode="tokens"`` on the main index (run inside phase 3, before
   the index is mutated): 256 random queries and the 64 probes, the tile
   timed beside ``cells``; and a small coarse index (128 documents, 32
   partitions) on which ``auto`` resolves to ``tokens``. Planted hit@1 1.0.
10. Builds: ``build_memory_index_flat`` of the main corpus as a tensor on
   the card (the device build), held against the host build given its
   centroids and codec (codes equal except at bf16 near-ties, residuals
   equal at equal codes, IVF cells equal as sets), then searched resident
   (planted hit@1 1.0, the create index's planted top-1, top-10 lists of
   equal exact quality), its seconds beside ``create``'s;
   ``build_memory_index_streaming`` of 522,931 documents (lengths uniform
   in [80, 160]) from a chunk generator that draws on the card, searched
   resident (kernel 2 at stage 6: the dedup gate fails there), with its
   seconds and peak device memory.
11. Quality at BEIR shape through ``tools/quality_parity_torch.run``: the
   JAX package's committed corpus (``colbert_proxy_corpus``, seed 0, 57,638
   documents capped at 300 tokens, 200 queries), its exhaustive MaxSim
   truth on the card (the first 2 queries held against the numpy host path
   within the bf16 input-rounding tolerance), ``create``, exhaustive search
   over ``get_embeddings``, the default constructor's cascade (kernels 1
   and 3 launched) at top_k 100 and pool divisors 4, 8, 16, then a
   resident reopen (kernels 1 and 4; one tile of kernels against plain).
   nDCG@10 may fall below the committed JAX figures (``JAX_BEIR_RESULT``)
   by no more than 0.03 (exact) and 0.05 (cascade). Then 5,000 documents,
   graded and plain, at pool divisors 2, 4, 8, 16.
12. The HTTP server, ``serving.make_server(index, port=0)``, over the
   phase-11 index opened as the CLI opens it (default constructor, every
   CUDA device): /healthz; the 200 queries as single-query JSON requests
   from 32 client threads (requests/s, latency p50 / p99, dispatches, mean
   batch; coalescing required); the same 200 in one b64 request; a subset
   request; /metrics; /v1/update of 50 documents and /v1/delete of them,
   each followed by a search showing the membership. Every result must
   equal ``FastPlaid.search`` up to ties; kernels 1 and 3 must launch.
13. Multi-device search (``fast_plaid_tpu_torch/parallel``), four shards
   on cuda:0 (one shard a card where there are several). 13a, after 10b:
   ``build_sharded_index_streaming`` over 10b's corpus with its centroids
   and codec (no second k-means), beside 10b's single-device index;
   ``sharded_search`` of 10b's 256 random + 64 planted queries in tiles of
   256 (kernel 1 once a shard a tile; stage 6 the codec rerank, as in the
   JAX package: sharded indexes carry no bf16 cache), with the JAX default
   working budget of 256 MiB; planted hit@1 1.0, every planted top-1 and
   every common document's score equal to the single device's, no random
   query's top-1 below it, kernel = plain up to ties on one tile, the tile
   timed; ``query_sharded_search``
   of 10b's index (a tile split four ways, kernels 1 and 2 once a part)
   and ``sharded_search_2d`` on a 2 x 2 mesh over a 2-shard build, a tile
   each. 13b, after phase 6 on its mutated index directory:
   ``ShardedFastPlaid`` at 4 shards, then ``load_sharded_lm`` at 4 shards
   (kernels 1 and 3 once a shard a tile), each against the default
   constructor's ``FastPlaid.search`` on the same queries, planted hit@1
   1.0; each again with the single device's ``rank_admit``, where no random
   query's top-1 may score below the single device's ("auto" resolves per
   shard, and a shard's quarter of the corpus can resolve to no rank
   admission).
14. Text-free encode -> index -> search at colbertv2.0 width: seeded random
   weights of colbert-ir/colbertv2.0's shape (bert-base-uncased, 768 -> 128
   head) written as an HF ``pytorch_model.bin`` and loaded through the
   port's ``load_bert_checkpoint``; 16,384 documents of 64-180 seeded ids,
   1,024 random queries of 32 ids and 64 planted ones (the forward of a
   document's first 32 ids) encoded on the card (tokens/s, TFLOP/s and its
   share of the bf16 peak, peak memory); the bf16 forward within a token
   cosine of 0.99 of the float32 one on 16 sequences;
   ``FastPlaid(device="cuda").create``; the default constructor (kernels 1
   and 3, the native host gather) and a resident reopen (kernels 1 and 4
   where ``dedup_viable``), each: kernel = plain up to ties on one tile,
   planted hit@1 no more than 0.02 below exhaustive MaxSim's on the same
   embeddings, recall@10 against the exhaustive top-10 printed.
15. Print the native host kernels' JSON record (``{"native": [...]}``), the
   kernels' JSON record, then the contract line
   ``{"ok": true, "device": {...}}`` as the last line.

The native host kernels (``fast_plaid_tpu_torch/native``): phases 4, 7, 13b
(four shards' threads at once) and 14 gather the same pids through the C++
gather and the torch ``index_select`` gather, byte-identical, and print both
times; phases 4, 13b and 14 require the native gather to have run in the
search; phase 6 times ``build_ivf`` native against ``np.unique`` on the
mutated index's codes, arrays equal.

Every tile timed per path also gets its device time by kernel
(torch.profiler).

A "search failed" RuntimeWarning (a tile whose device work raised, a failed
kernel launch included) is an error for the whole run.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from perfbench import work as perf_work
from perfbench.work import BF16_OPS, F32_OPS, HBM_BPS, bound  # noqa: F401 (tools/rerank_designs.py reads them here)

ROOT = os.path.dirname(os.path.abspath(__file__))
Q_LEN, DIM, TOP_K = 32, 128, 10
N_PROBE, N_FULL = 8, 4096
EST_ATOL = 1e-4
RERANK_TOL = 1e-3  # rtol and atol: tensor-core accumulation order
TIE_TOL = 1e-3
RAGGED_R = (8, 24, 256, 3608)


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


def check_close(got, want, what: str) -> float:
    """rtol = atol = RERANK_TOL on finite entries, identical -inf patterns."""
    import torch

    err = max_err(got, want)
    g, w = got.float().cpu(), want.float().cpu()
    fin = torch.isfinite(w)
    if not bool(((g[fin] - w[fin]).abs() <= RERANK_TOL + RERANK_TOL * w[fin].abs()).all()):
        raise AssertionError(f"{what}: max abs err {err} beyond rtol/atol {RERANK_TOL}")
    return err


def rerank_work(pids, lens, queries, n_docs: int, cap: int, d: int, q4_half: int = 0) -> dict:
    """``perfbench.work.rerank_work`` (``bytes``: each distinct document's
    rows once, with the pids, lens, queries and scores), and
    ``slot_row_bytes``: the rows of every slot, as a kernel without reuse
    reads them."""
    import torch

    if q4_half:
        rows, row_bytes = lens.clamp(0, cap).clamp(max=q4_half), d
    else:
        ok = (pids >= 0) & (pids < n_docs)
        rows, row_bytes = torch.where(ok, lens.clamp(0, cap), 0), 2 * d
    work = perf_work.rerank_work(pids, lens, queries, n_docs, cap, d, q4_half)
    return {**work, "slot_row_bytes": int(rows.sum()) * row_bytes}


def add_rates(rec: dict, work: dict) -> None:
    """GB/s on both byte counts and the share of the bound, beside ms."""
    rec.update(work)
    rec["GBps_slot_rows"] = work["slot_row_bytes"] / rec["ms"] / 1e6
    rec["GBps_distinct_rows"] = work["bytes"] / rec["ms"] / 1e6
    rec["share_of_bound"] = work["bound_ms"] / rec["ms"]


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
        work = perf_work.estimate_work(pid, own, tbl)
        rec["kernel_GBps"] = work["bytes"] / rec["ms"] / 1e6
        rec["bound_ms"], rec["bound_by"] = work["bound_ms"], work["bound_by"]
    log(f"# estimate {json.dumps(rec)}")
    return rec


def bf16_ulp(x) -> "torch.Tensor":
    """One bf16 ulp above |x| (x finite), as float32."""
    import torch

    a = x.float().abs().to(torch.bfloat16)
    return (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()


def probe_near(table, k: int) -> "torch.Tensor":
    """Rows of a masked probe table whose k-th and (k+1)-th scores lie within
    one bf16 ulp (an exact tie included): there alone may the kernel's cell
    set differ from the plain version's."""
    import torch

    top = torch.topk(table, k + 1, dim=-1).values
    return (top[:, k - 1].float() - top[:, k].float()).abs() <= bf16_ulp(top[:, k - 1])


def probe_diff(vals, cells, pv, pc) -> dict:
    """Row masks of the kernel's probe (vals, cells) against the table
    route's (pv, pc): ``agree`` (the same scores), ``same_set`` (the same
    cells), ``same`` (the same cells in the same order); -inf slots left
    out."""
    import torch

    fin = torch.isfinite(pv)
    mine, theirs = torch.where(fin, cells, -1), torch.where(fin, pc.int(), -1)
    return {"agree": (vals == pv).all(dim=-1),
            "same_set": (torch.sort(mine, dim=-1).values
                         == torch.sort(theirs, dim=-1).values).all(dim=-1),
            "same": (mine == theirs).all(dim=-1)}


def check_probe(q, cent, k_real: int, k: int, name: str, timing: bool = False) -> dict:
    """The probe kernel against its plain version (``torch.topk`` over the
    table): -inf patterns equal, scores within one bf16 ulp, the same cell
    set but at a near-tie at the k-th place, and the same order (ties
    included) wherever cells and scores agree; timed beside the plain
    version and beside ``torch.matmul`` + ``torch.topk`` on bf16 inputs
    (``library_ms``: a pair the port never calls)."""
    import torch

    from fast_plaid_tpu_torch.ops.probe_kernel import (
        probe_table,
        probe_topk,
        probe_topk_plain,
    )

    vals, cells = probe_topk(q, cent, k_real, k)
    pv, pc = probe_topk_plain(q, cent, k_real, k)
    torch.cuda.synchronize()
    err = max_err(vals, pv)
    fin = torch.isfinite(pv)
    beyond = int(((vals.float() - pv.float()).abs()[fin] > bf16_ulp(pv)[fin]).sum())
    diff = probe_diff(vals, cells, pv, pc)
    n, d = q.shape
    rec = {"case": name, "shape": [n, cent.shape[0], d, k], "k_real": k_real,
           "max_abs_err": err, "beyond_ulp": beyond,
           "rows_other_scores": int((~diff["agree"]).sum()),
           "rows_other_set": int((~diff["same_set"]).sum()),
           "rows_other_cells": int((~diff["same"]).sum())}
    if beyond:
        raise AssertionError(f"probe_topk {name}: {beyond} scores beyond one bf16 ulp")
    if bool((diff["agree"] & diff["same_set"] & ~diff["same"]).any()):
        raise AssertionError(f"probe_topk {name}: the order differs where cells and scores agree")
    if rec["rows_other_set"]:
        _, table = probe_table(q, cent, k_real)
        far = ~diff["same_set"] & ~probe_near(table, k) & fin[:, k - 1]
        del table
        if bool(far.any()):
            raise AssertionError(f"probe_topk {name}: cell sets differ away from a near-tie")
    if timing:
        rec["ms"] = cuda_time_ms(lambda: probe_topk(q, cent, k_real, k), 20)
        rec["plain_ms"] = cuda_time_ms(lambda: probe_topk_plain(q, cent, k_real, k), 5)
        qb = q.to(torch.bfloat16)
        rec["library_ms"] = cuda_time_ms(
            lambda: torch.topk(torch.matmul(qb, cent.t()), k, dim=-1), 5)
        nbytes = 4.0 * n * d + 2.0 * k_real * d + 6.0 * n * k
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * n * k_real * d, BF16_OPS)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    log(f"# probe {json.dumps(rec)}")
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
    err = check_close(got, want, f"maxsim_gather_scores {name}")
    rec = {
        "case": name,
        "B": pids.shape[0],
        "R": pids.shape[1],
        "Q": qs.shape[1],
        "doc_cap": emb.shape[1],
        "max_abs_err": err,
        "empty_rows": int((~torch.isfinite(want)).sum()),
    }
    if timing:
        rec["ms"] = cuda_time_ms(lambda: maxsim_gather_scores(emb, pids, lens, qs), 10)
        rec["plain_ms"] = cuda_time_ms(
            lambda: maxsim_gather_scores_plain(emb, pids, lens, qs), 2
        )
        add_rates(rec, rerank_work(pids, lens, qs, emb.shape[0], emb.shape[1], emb.shape[2]))
    log(f"# rerank {json.dumps(rec)}")
    return rec


def check_q4(emb_q4, scale, pids, lens, qs, name: str, timing: bool = False) -> dict:
    import torch

    from fast_plaid_tpu_torch.ops.rerank_kernel import (
        maxsim_q4_gather_scores,
        maxsim_q4_gather_scores_plain,
    )

    got = maxsim_q4_gather_scores(emb_q4, scale, pids, lens, qs)
    want = maxsim_q4_gather_scores_plain(emb_q4, scale, pids, lens, qs)
    torch.cuda.synchronize()
    err = check_close(got, want, f"maxsim_q4_gather_scores {name}")
    caph = emb_q4.shape[0] // scale.shape[0]
    rec = {
        "case": name,
        "B": pids.shape[0],
        "R": pids.shape[1],
        "Q": qs.shape[1],
        "caph": caph,
        "max_abs_err": err,
        "empty_rows": int((~torch.isfinite(want)).sum()),
    }
    if timing:
        rec["ms"] = cuda_time_ms(
            lambda: maxsim_q4_gather_scores(emb_q4, scale, pids, lens, qs), 10
        )
        rec["plain_ms"] = cuda_time_ms(
            lambda: maxsim_q4_gather_scores_plain(emb_q4, scale, pids, lens, qs), 2
        )
        add_rates(rec, rerank_work(pids, lens, qs, scale.shape[0], 2 * caph, emb_q4.shape[1],
                                   q4_half=caph))
    log(f"# q4 {json.dumps(rec)}")
    return rec


def check_dedup(emb, pids, lens, qs, name: str, timing: bool = False) -> dict:
    """The dedup kernel against its plain version and the per-query kernel."""
    import torch

    from fast_plaid_tpu_torch.ops.rerank_dedup import (
        group_pool,
        maxsim_gather_scores_dedup,
        maxsim_gather_scores_dedup_plain,
    )
    from fast_plaid_tpu_torch.ops.rerank_kernel import maxsim_gather_scores

    got = maxsim_gather_scores_dedup(emb, pids, lens, qs)
    want = maxsim_gather_scores_dedup_plain(emb, pids, lens, qs)
    per_query = maxsim_gather_scores(emb, pids, lens, qs)
    torch.cuda.synchronize()
    err = check_close(got, want, f"maxsim_gather_scores_dedup {name} vs plain")
    err_k2 = check_close(got, per_query, f"maxsim_gather_scores_dedup {name} vs kernel 2")
    b, r = pids.shape
    n = b * r
    e_cap = min(n, n // 8 + emb.shape[0])
    n_entries = int(group_pool(pids, lens, 8, e_cap)[4])
    rec = {
        "case": name,
        "B": b,
        "R": r,
        "Q": qs.shape[1],
        "doc_cap": emb.shape[1],
        "D": emb.shape[2],
        "entries": n_entries,
        "slots": n,
        "max_abs_err": err,
        "max_abs_err_vs_kernel2": err_k2,
        "empty_rows": int((~torch.isfinite(want)).sum()),
    }
    if timing:
        rec["ms"] = cuda_time_ms(lambda: maxsim_gather_scores_dedup(emb, pids, lens, qs), 10)
        rec["kernel2_ms"] = cuda_time_ms(lambda: maxsim_gather_scores(emb, pids, lens, qs), 10)
        rec["plain_ms"] = cuda_time_ms(
            lambda: maxsim_gather_scores_dedup_plain(emb, pids, lens, qs), 2
        )
        add_rates(rec, rerank_work(pids, lens, qs, emb.shape[0], emb.shape[1], emb.shape[2]))
    log(f"# dedup {json.dumps(rec)}")
    return rec


def phase_kernels(dev: "torch.device", n_docs: int) -> None:
    """Phase 2: synthetic main-path shapes and edge cases."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)

    def sorted_pids(b, w, hi):
        return torch.sort(
            torch.randint(0, hi, (b, w), generator=g, device=dev, dtype=torch.int32), dim=-1
        ).values

    # Probe (stages 1-2): the cells' shape (8,192 query tokens, 32,768 cells,
    # D 128, k 8), then ragged N, Kp not a multiple of the tile, k_real < Kp,
    # all-zero rows, k 1 and 32, k_real below k (a generator of its own, so
    # the other kernels' inputs stay as they were).
    gp = torch.Generator(device=dev).manual_seed(5)
    qp = torch.randn((256 * Q_LEN, DIM), generator=gp, device=dev)
    qp[::97] = 0.0
    cp = torch.randn((32768, DIM), generator=gp, device=dev).to(torch.bfloat16)
    check_probe(qp, cp, 32768, N_PROBE, "cells_shape", timing=True)
    cp2 = torch.randn((33000, DIM), generator=gp, device=dev).to(torch.bfloat16)
    for k in (1, 32):
        check_probe(qp[:1000], cp2, 32900, k, f"ragged_k{k}")
    check_probe(qp[:257], cp2, 20, 32, "k_real_below_k")
    del qp, cp, cp2

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
    # A [C, Q] table past one block's shared memory (C 4,000, Q 32: 256 KB a
    # row), at the main path's width W 12,152.
    own4 = torch.randint(0, 4000, (4, 12152), generator=g, device=dev, dtype=torch.int32)
    tbl4 = torch.randn((4, 4000, 32), generator=g, device=dev)
    check_estimate(sorted_pids(4, 12152, 20000), own4, tbl4, "table_256KB_w12152")

    # Rerank: main-path shape (B 256, R 2048, doc_cap 160, Q 32, D 128).
    npd = ((n_docs + 1 + 7) // 8) * 8
    emb = torch.randn((npd, 160, DIM), generator=g, device=dev).to(torch.bfloat16)
    b, r = 256, 2048
    pids = torch.randint(0, n_docs, (b, r), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(80, 161, (b, r), generator=g, device=dev, dtype=torch.int32)
    qs = torch.randn((b, Q_LEN, DIM), generator=g, device=dev)
    qs = qs / qs.norm(dim=-1, keepdim=True)
    check_rerank(emb, pids, lens, qs, "main_shape_random", timing=True)
    # Dedup at the main shape: each query's pool is 2048 distinct pids drawn
    # from a 57k-doc corpus, as stage 5 hands them over.
    pool = torch.argsort(torch.rand((b, n_docs), generator=g, device=dev), dim=-1)
    pids_d = pool[:, :r].to(torch.int32).contiguous()
    del pool
    doc_lengths = torch.randint(80, 161, (npd,), generator=g, device=dev, dtype=torch.int32)
    doc_lengths[n_docs:] = 0
    check_dedup(emb, pids_d, doc_lengths[pids_d.long()], qs, "main_shape_random")
    # The direct-subset pool's widths: sorted pids, sentinel padding at the
    # tail (R any multiple of 8; 3,608 is the shared where("cat = 3") pool).
    ragged = {}
    for r_w in RAGGED_R:
        p = sorted_pids(b, r_w, n_docs)
        p[:, -min(r_w, 5):] = n_docs
        ragged[r_w] = (p.contiguous(), doc_lengths[p.long()])
        check_rerank(emb, *ragged[r_w], qs, f"ragged_R{r_w}")
        check_dedup(emb, *ragged[r_w], qs, f"ragged_R{r_w}")
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

    # q4 rerank: main shape (B 256, R 2048, caph 80, Q 32, D 128).
    caph = 80
    emb_q4 = torch.randint(0, 256, (npd * caph, DIM), generator=g, device=dev).to(torch.uint8)
    scale = torch.rand((npd,), generator=g, device=dev) / 7
    check_q4(emb_q4, scale, pids, lens, qs, "main_shape_random", timing=True)
    for r_w in RAGGED_R:
        check_q4(emb_q4, scale, *ragged[r_w], qs, f"ragged_R{r_w}")
    del emb_q4
    # Edges: lens 0, sentinel and out-of-range pids, caph 24, lens <= caph.
    caph_s = 24
    q4_s = torch.randint(0, 256, (500 * caph_s, DIM), generator=g, device=dev).to(torch.uint8)
    scale_s = torch.rand((500,), generator=g, device=dev)
    lens_q = torch.randint(0, 2 * caph_s + 1, (9, 130), generator=g, device=dev,
                           dtype=torch.int32)
    lens_q[0, :5] = 0
    lens_q[1, :3] = 30
    lens_q[4] = torch.randint(1, caph_s + 1, (130,), generator=g, device=dev,
                              dtype=torch.int32)
    rec = check_q4(q4_s, scale_s, pids_s, lens_q, qs_s, "edge_cases_caph24")
    if rec["empty_rows"] < 5:
        raise AssertionError("q4 edge case: zero-length rows did not score -inf")

    # Long documents: kernels 2 and 3 stream 64-row tiles, so any doc_cap.
    # Ragged lengths over [0, doc_cap] with 0, 1, 63-65, caph +- 1 and doc_cap
    # spelled out, one row of lengths <= caph, one of doc_cap, sentinel and
    # out-of-range pids; doc_cap 1,040 (ColPali's ~1,030 patches a page) timed.
    for cap in (336, 1040, 2048):
        n_l, b_l, r_l = 2000, 64, 256
        caph_l = cap // 2
        p_l = torch.randint(0, n_l, (b_l, r_l), generator=g, device=dev, dtype=torch.int32)
        l_l = torch.randint(0, cap + 1, (b_l, r_l), generator=g, device=dev, dtype=torch.int32)
        edge = [0, 1, 63, 64, 65, caph_l - 1, caph_l, caph_l + 1, cap - 1, cap]
        l_l[0, : len(edge)] = torch.tensor(edge, dtype=torch.int32, device=dev)
        l_l[1] = torch.randint(1, caph_l + 1, (r_l,), generator=g, device=dev, dtype=torch.int32)
        l_l[2] = cap
        p_l[3, :4] = torch.tensor([-1, n_l, n_l + 5000, n_l - 1], dtype=torch.int32, device=dev)
        emb_l = torch.randn((n_l, cap, DIM), generator=g, device=dev).to(torch.bfloat16)
        rec = check_rerank(emb_l, p_l, l_l, qs[:b_l], f"long_doc_cap{cap}", timing=cap == 1040)
        if rec["empty_rows"] < 4:
            raise AssertionError(f"doc_cap {cap}: empty / out-of-range rows did not score -inf")
        del emb_l
        q4_l = torch.randint(0, 256, (n_l * caph_l, DIM), generator=g, device=dev).to(torch.uint8)
        sc_l = torch.rand((n_l,), generator=g, device=dev) + 0.05
        check_q4(q4_l, sc_l, p_l, l_l, qs[:b_l], f"long_doc_cap{cap}", timing=cap == 1040)
        del q4_l

    # Dedup edges: one pid for every slot, runs of exactly G and G + 1, all
    # sentinel (doc_cap 48, Q 16).
    emb_d = torch.randn((301, 48, DIM), generator=g, device=dev).to(torch.bfloat16)
    dl = torch.randint(1, 49, (301,), generator=g, device=dev, dtype=torch.int32)
    dl[-1] = 0
    ar = torch.arange(200, dtype=torch.int32, device=dev)
    cases = {
        "one_pid_every_slot": torch.full((12, 200), 7, dtype=torch.int32, device=dev),
        "runs_of_G": ar.repeat(8, 1),
        "runs_of_G_plus_1": ar.repeat(9, 1),
        "all_sentinel": torch.full((12, 200), 300, dtype=torch.int32, device=dev),
    }
    for name, p in cases.items():
        qd = torch.randn((p.shape[0], 16, DIM), generator=g, device=dev)
        rec = check_dedup(emb_d, p, dl[p.long()], qd, name)
        if name == "all_sentinel" and rec["empty_rows"] != p.numel():
            raise AssertionError("dedup all-sentinel rows did not score -inf")

    # Dedup on the long-document pool: 4,096 pages of 1,000-1,030 tokens
    # (doc_cap 1,040), B 256, R 2048 distinct pages a row; timed, and held
    # against kernel 2 as well. Its shared memory does not depend on doc_cap.
    n_l = 4096
    emb_l = torch.randn((n_l + 1, 1040, DIM), generator=g, device=dev).to(torch.bfloat16)
    len_l = torch.randint(1000, 1031, (n_l + 1,), generator=g, device=dev, dtype=torch.int32)
    len_l[-1] = 0
    p_l = torch.argsort(torch.rand((256, n_l), generator=g, device=dev), dim=-1)[:, :2048]
    p_l = p_l.to(torch.int32).contiguous()
    check_dedup(emb_l, p_l, len_l[p_l.long()], qs, "long_doc_pool_cap1040", timing=True)
    del emb_l
    # Wider rows: D 256, 384 and 512 (doc_cap 160, B 64, R 512 over 5,000
    # documents); past 384 the query rows stream with the row tiles.
    for d_w in (256, 384, 512):
        emb_w = torch.randn((5001, 160, d_w), generator=g, device=dev).to(torch.bfloat16)
        len_w = torch.randint(1, 161, (5001,), generator=g, device=dev, dtype=torch.int32)
        len_w[-1] = 0
        p_w = torch.randint(0, 5001, (64, 512), generator=g, device=dev, dtype=torch.int32)
        q_w = torch.randn((64, Q_LEN, d_w), generator=g, device=dev)
        check_dedup(emb_w, p_w, len_w[p_w.long()], q_w, f"D{d_w}")
        del emb_w


def planted_corpus(n_docs: int, seed: int, lo: int = 80, hi: int = 160):
    """Unit-norm tokens, lengths uniform in [lo, hi]; one flat array."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n_docs)
    lens[0] = hi  # the longest length is always present: doc_cap is fixed
    return corpus_of_lengths(lens, rng), rng


def skewed_lengths(n_docs: int, rng, median: int = 90, sigma: float = 0.6,
                   lo: int = 8, hi: int = 300) -> np.ndarray:
    """Lognormal document lengths (median 90 tokens, sigma 0.6) clipped to
    [8, 300], the longest always present. A synthetic skew that drives the
    length-bucketed layout; it is not taken from any public corpus."""
    lens = np.clip(np.round(median * np.exp(sigma * rng.standard_normal(n_docs))), lo, hi)
    lens = lens.astype(np.int64)
    lens[0] = hi
    return lens


def corpus_of_lengths(lens: np.ndarray, rng) -> list:
    """Unit-norm tokens for documents of these lengths, views of one flat
    array."""
    total = int(lens.sum())
    flat = np.empty((total, DIM), np.float32)
    block = 1 << 20
    for s in range(0, total, block):
        x = rng.standard_normal((min(block, total - s), DIM), dtype=np.float32)
        flat[s : s + x.shape[0]] = x / np.linalg.norm(x, axis=-1, keepdims=True)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offsets[i] : offsets[i + 1]] for i in range(len(lens))]


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


class Counters:
    """The kernel wrappers' launch counters, zeroed just before a path runs
    and read just after."""

    def __init__(self):
        from fast_plaid_tpu_torch.ops.estimate_kernel import segmented_estimate
        from fast_plaid_tpu_torch.ops.probe_kernel import probe_topk
        from fast_plaid_tpu_torch.ops.rerank_dedup import maxsim_gather_scores_dedup
        from fast_plaid_tpu_torch.ops.rerank_kernel import (
            maxsim_gather_scores,
            maxsim_q4_gather_scores,
        )

        self.fns = {
            "segmented_estimate": segmented_estimate,
            "maxsim_gather_scores": maxsim_gather_scores,
            "maxsim_q4_gather_scores": maxsim_q4_gather_scores,
            "maxsim_gather_scores_dedup": maxsim_gather_scores_dedup,
            "probe_topk": probe_topk,
        }

    def zero(self) -> None:
        from fast_plaid_tpu_torch import native

        for fn in self.fns.values():
            fn.launches = 0
        native.gather_windows_u8.calls = 0
        native.build_ivf_native.calls = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}

    @staticmethod
    def native_calls() -> dict:
        """The C++ host kernels' calls since ``zero``."""
        from fast_plaid_tpu_torch import native

        return {"gather_windows_u8": native.gather_windows_u8.calls,
                "build_ivf": native.build_ivf_native.calls}


def api_search(fp, queries, counters, n_queries, probe_pids, label, need,
               expect_cells: bool = True, min_hit1: float = 1.0) -> dict:
    """One timed ``FastPlaid.search`` of every query: launch counts (and the
    native host kernels' calls) read around it, QPS, planted hit@1 (at least
    ``min_hit1``: 1.0 unless the caller holds it to another reference), no
    empty result."""
    import torch

    from fast_plaid_tpu_torch.search.searcher import last_search_stats

    kw = dict(top_k=TOP_K, n_full_scores=N_FULL, n_ivf_probe=N_PROBE, show_progress=False)
    fp.search(queries[:256], **kw)  # warm-up
    torch.cuda.synchronize()
    counters.zero()
    t0 = time.perf_counter()
    results = fp.search(queries, **kw)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = counters.read()
    native_calls = counters.native_calls()
    stats = last_search_stats()
    log(f"# [{label}] search: {len(queries)} queries in {search_s:.3f} s = "
        f"{len(queries) / search_s:.1f} QPS; launches {launches}; native host calls "
        f"{native_calls}; stats {stats}")
    if expect_cells and (stats["approx_mode"] != "cells" or stats["rank_admit"] < 1):
        raise AssertionError(f"{label}: expected cells with rank_admit >= 1, got {stats}")
    for name in need:
        if launches[name] < 1:
            raise AssertionError(f"{label}: {name} was not launched during the search")
    if len(results) != len(queries) or any(len(r) != TOP_K for r in results):
        raise AssertionError(f"{label}: an empty or short result came back")
    scores = np.asarray([[s for _, s in r] for r in results])
    if not np.isfinite(scores).all():
        raise AssertionError(f"{label}: non-finite scores in the results")
    hits = [results[n_queries + i][0][0] == int(p) for i, p in enumerate(probe_pids)]
    hit1 = float(np.mean(hits))
    log(f"# [{label}] planted hit@1: {hit1:.4f} over {len(hits)} probes")
    if hit1 < min_hit1:
        raise AssertionError(f"{label}: planted hit@1 {hit1} < {min_hit1}")
    return {
        "launches": launches,
        "native_calls": native_calls,
        "qps": len(queries) / search_s,
        "hit1": hit1,
        "ids": np.asarray([[p for p, _ in r] for r in results]),
        "scores": scores,
        "stats": stats,
    }


def engine_kwargs(loaded, mem_budget) -> dict:
    from fast_plaid_tpu_torch.search import engine

    ispec = loaded.ispec
    n_cells = min(Q_LEN * N_PROBE, ispec.n_partitions)
    cand_cap = engine.candidate_capacity(loaded.ivf_lengths_host, n_cells, N_FULL)
    mode, rank_admit, slot_budget = engine.resolve_approx_mode(
        "auto",
        loaded.ivf_lengths_host,
        q_cap=Q_LEN,
        n_ivf_probe=N_PROBE,
        n_full_scores=N_FULL,
        n_partitions=ispec.n_partitions,
        cand_cap=cand_cap,
        slot_budget=engine.suggest_slot_budget(loaded.ivf_lengths_host, N_FULL),
        n_docs=ispec.n_docs,
    )
    log(f"# resolved: approx_mode={mode} rank_admit={rank_admit} "
        f"slot_budget={slot_budget} cand_cap={cand_cap}")
    return dict(
        ispec=ispec, top_k=TOP_K, n_ivf_probe=N_PROBE, n_full_scores=N_FULL,
        mem_budget=mem_budget, cand_cap=cand_cap, approx_mode=mode,
        slot_budget=slot_budget, rank_admit=rank_admit,
    )


def lm_steps(loaded, tile, sub, kernels: bool, kw: dict):
    """One tile through ``searcher.search_on_device``'s low_memory steps, not
    pipelined: the cascade, the q4 prefilter, the host packing (timed), the
    expansion and the rerank. ``kw`` is ``engine_kwargs``'. Returns ((pids,
    scores, stats), the pool's pids on the host, the packing's ms)."""
    from fast_plaid_tpu_torch.search import engine, searcher

    ispec = loaded.ispec
    p2, stats = engine.candidates_impl(
        loaded.dev, tile, sub, ispec=ispec, n_ivf_probe=N_PROBE, n_full_scores=N_FULL,
        mem_budget=kw["mem_budget"], cand_cap=kw["cand_cap"], approx_mode=kw["approx_mode"],
        with_stats=True, slot_budget=kw["slot_budget"], use_estimate_kernel=kernels,
        rank_admit=kw["rank_admit"])
    p2 = engine.q4_prefilter(
        loaded.dev, p2, tile, sentinel_pid=ispec.sentinel_pid, pool=engine.rescue_pool(TOP_K),
        mem_budget=kw["mem_budget"], use_kernel=kernels)
    host = p2.cpu().numpy()
    t0 = time.perf_counter()
    rows = searcher._pack_rows(loaded, host, pin=True)
    pack_ms = (time.perf_counter() - t0) * 1e3
    out = searcher._lm_finish(loaded, tile, p2, stats, rows, top_k=TOP_K,
                              mem_budget=kw["mem_budget"])
    return out, host, pack_ms


def tile_latency(run, label: str, n: int = 30) -> tuple[float, float]:
    """p50 / p99 of one 256-query tile: host clock around work that ends in a
    device synchronize."""
    import torch

    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = (float(np.percentile(lat, p)) for p in (50, 99))
    log(f"# [{label}] 256-query tile latency over {n} tiles: p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms")
    device_profile(run, label)
    return p50, p99


def device_profile(run, label: str, top: int = 8) -> None:
    """Device time of one tile by kernel (torch.profiler, CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)) / 1e3

    evs = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    evs.sort(key=dev_ms, reverse=True)
    total = sum(dev_ms(e) for e in evs)
    items = "; ".join(f"{e.key[:60]} x{e.count} {dev_ms(e):.3f}" for e in evs[:top])
    log(f"# [{label}] device time of one tile {total:.3f} ms; largest: {items}")


def gather_rows_both(jobs, reps: int = 5) -> dict:
    """The native host row gather against the torch ``index_select`` gather,
    on the same pids: ``jobs`` is [(loaded, pids)], run together on a
    thread each (one job: on this thread), into pinned memory as the
    low_memory path gathers. The two alternate, ``reps`` rounds each; the
    outputs must be byte-identical. Returns the median ms of a round."""
    import torch

    from fast_plaid_tpu_torch import native
    from fast_plaid_tpu_torch.search import searcher

    def one(job, use_native):
        return searcher.host_gather_rows(job[0], job[1], pin=True, use_native=use_native)

    ms: dict = {True: [], False: []}
    outs: dict = {}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for _ in range(reps):
            for use_native in (True, False):
                t0 = time.perf_counter()
                if len(jobs) == 1:
                    outs[use_native] = [one(jobs[0], use_native)]
                else:
                    outs[use_native] = list(pool.map(lambda j: one(j, use_native), jobs))
                ms[use_native].append((time.perf_counter() - t0) * 1e3)
    if not native.AVAILABLE:
        raise AssertionError("the native host gather is not built")
    for got, want in zip(outs[True], outs[False]):
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError("native and torch host gathers differ")
    rows = sum(int(np.asarray(p).size) for _, p in jobs)
    nbytes = sum(sum(t.numel() * t.element_size() for t in o) for o in outs[True])
    return {"native_ms": float(np.median(ms[True])), "torch_ms": float(np.median(ms[False])),
            "threads": len(jobs), "windows": rows, "mb": nbytes / 1e6, "identical": True}


def log_gathers(label: str, r: dict) -> None:
    log(f"# [{label}] host row gather, native vs torch on the same pids ({r['threads']} "
        f"thread(s), {r['windows']} windows, {r['mb']:.1f} MB): native {r['native_ms']:.3f} ms, "
        f"torch {r['torch_ms']:.3f} ms ({r['torch_ms'] / r['native_ms']:.2f}x), outputs "
        f"byte-identical")


def build_ivf_both(label: str, codes, doc_lengths, k: int, reps: int = 1) -> dict:
    """``build_ivf``'s native path against its ``np.unique`` path on the same
    codes: arrays equal, median seconds of each."""
    from fast_plaid_tpu_torch import native
    from fast_plaid_tpu_torch.index.ivf import build_ivf_numpy

    codes = np.ascontiguousarray(codes, np.int32)
    doc_lengths = np.asarray(doc_lengths, np.int64)
    secs: dict = {"native": [], "numpy": []}
    res: dict = {}
    for _ in range(reps):
        for name, fn in (("native", native.build_ivf_native), ("numpy", build_ivf_numpy)):
            t0 = time.perf_counter()
            res[name] = fn(codes, doc_lengths, k)
            secs[name].append(time.perf_counter() - t0)
    if res["native"] is None:
        raise AssertionError("the native IVF build is not built")
    for a, b in zip(res["native"], res["numpy"]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label}: native and np.unique IVF builds differ")
    out = {"native_s": float(np.median(secs["native"])), "numpy_s": float(np.median(secs["numpy"])),
           "codes": int(codes.size), "docs": int(doc_lengths.size), "k": int(k)}
    log(f"# [{label}] build_ivf of {out['codes']} codes, {out['docs']} docs, K {k}: native "
        f"{out['native_s']:.3f} s, np.unique {out['numpy_s']:.3f} s "
        f"({out['numpy_s'] / out['native_s']:.2f}x); arrays equal")
    return out


class Recorder:
    """Wrap a module-level kernel wrapper to keep the arguments of its last
    call (the inputs a path handed it)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.calls: list = []  # the arguments of every call

    def __enter__(self):
        def inner(*args, **kwargs):
            self.args = args
            self.calls.append(args)
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, inner)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Stopwatch:
    """Add up the seconds spent in module-level functions between
    ``start()`` and ``stop()``; ``take()`` returns and clears the sums.
    Calls nest: an outer function's seconds include its inner ones'."""

    def __init__(self, targets):  # [(module, function name, label)]
        self.targets = targets
        self.seconds = {label: 0.0 for _, _, label in targets}
        self.saved: list = []

    def start(self) -> "Stopwatch":
        for module, name, label in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def timed(*args, _fn=fn, _label=label, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.seconds[_label] += time.perf_counter() - t0

            setattr(module, name, timed)
        return self

    def stop(self) -> None:
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved.clear()

    def take(self) -> dict:
        out = {k: round(v, 3) for k, v in self.seconds.items() if v}
        self.seconds = dict.fromkeys(self.seconds, 0.0)
        return out


def meta_row(i: int) -> dict:
    """Metadata of the document inserted i-th."""
    return {
        "cat": i % 16,
        "day": datetime.date(2024, 1, 1) + datetime.timedelta(days=i % 365),
        "title": f"doc{i}",
    }


def probe_ties(dev, loaded, queries, kw) -> dict:
    """The probe kernel on the card against ``torch.topk`` over the plain
    table (the table route), over every tile of these queries: rows with an
    exact tie inside the top k, rows whose scores differ (by one bf16 ulp at
    most), and rows whose cells or their order differ (raises where cells
    and scores agree but the order does not, or where the cell sets differ
    away from a near-tie at the k-th place). Where any row differs, every tile is searched again
    through the table route and the top-10 compared."""
    import torch

    from fast_plaid_tpu_torch.ops.probe_kernel import probe_table, probe_topk
    from fast_plaid_tpu_torch.search import engine

    k_real = loaded.ispec.n_partitions
    diffs = rows = ties = other_scores = 0
    tiles = [torch.from_numpy(queries[s : s + 256].astype(np.float16)).to(dev)
             for s in range(0, len(queries), 256)]
    with torch.inference_mode():
        for tile in tiles:
            flat = tile.float().reshape(-1, tile.shape[-1])
            _, ps = probe_table(flat, loaded.dev.centroids, k_real)
            tv, ti = torch.topk(ps, N_PROBE, dim=-1)
            near = probe_near(ps, N_PROBE)
            del ps
            kv, kc = probe_topk(flat, loaded.dev.centroids.to(torch.bfloat16), k_real,
                                N_PROBE)
            d = probe_diff(kv, kc, tv, ti)
            if bool((d["agree"] & d["same_set"] & ~d["same"]).any()):
                raise AssertionError("probe kernel: the order differs from torch.topk's "
                                     "where cells and scores agree")
            if bool((~d["same_set"] & ~near & torch.isfinite(tv[:, -1])).any()):
                raise AssertionError("probe kernel: cell sets differ away from a near-tie")
            diffs += int((~d["same"]).sum())
            other_scores += int((~d["agree"]).sum())
            ties += int((tv[:, 1:] == tv[:, :-1]).any(dim=-1).sum())
            rows += flat.shape[0]
    moved = 0
    if diffs:
        with torch.inference_mode():
            for tile in tiles:
                a = engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                                       use_rerank_kernel=True, **kw)
                real = engine._fused_probe
                engine._fused_probe = lambda *args: False
                try:
                    b = engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                                           use_rerank_kernel=True, **kw)
                finally:
                    engine._fused_probe = real
                moved += int((a[0] != b[0]).any(dim=-1).sum())
    log(f"# [probe ties] {rows} query-token rows (Kp {loaded.dev.centroids.shape[0]}): "
        f"{ties} with an exact tie inside the top {N_PROBE}; {other_scores} whose kernel "
        f"scores differ by an ulp, {diffs} whose cells differ from torch.topk's; queries "
        f"whose top-{TOP_K} moves under the table route: {moved}")
    return {"rows": rows, "ties": ties, "other_scores": other_scores, "diffs": diffs,
            "top10_moved": moved}


def phase_tokens(dev, fp, loaded, queries, n_queries, probe_pids, counters, cells_tile_ms,
                 seed) -> dict:
    """Phase 9: ``approx_mode="tokens"`` on the main index (256 random queries
    and the 64 planted probes, timed beside ``cells``), and a small coarse
    index on which ``auto`` resolves to ``tokens`` (128 documents of 32-64
    tokens, 32 partitions, ``n_full_scores=128``; every document probes for
    itself). Planted hit@1 must be 1.0 on both."""
    import torch

    from fast_plaid_tpu_torch import testing
    from fast_plaid_tpu_torch.search import engine
    from fast_plaid_tpu_torch.search.searcher import last_search_stats
    from fast_plaid_tpu_torch.testing import MemoryIndex

    kw = dict(top_k=TOP_K, n_full_scores=N_FULL, n_ivf_probe=N_PROBE, show_progress=False)
    sel = np.concatenate([queries[:256], queries[n_queries:]])
    fp.search(sel[:8], approx_mode="tokens", **kw)  # warm-up
    torch.cuda.synchronize()
    counters.zero()
    t0 = time.perf_counter()
    results = fp.search(sel, approx_mode="tokens", **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = last_search_stats()
    if stats["approx_mode"] != "tokens":
        raise AssertionError(f"tokens: the search ran {stats['approx_mode']}")
    hit1 = float(np.mean([results[256 + i][0][0] == int(p) for i, p in enumerate(probe_pids)]))
    log(f"# [tokens] {len(sel)} queries in {dt:.3f} s = {len(sel) / dt:.1f} QPS; planted hit@1 "
        f"{hit1:.4f}; launches {counters.read()}; stats {stats}")
    if hit1 != 1.0:
        raise AssertionError(f"tokens: planted hit@1 {hit1} != 1.0")
    ekw = dict(engine_kwargs(loaded, fp.mem_budget), approx_mode="tokens", rank_admit=0)
    tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)

    def run_tile():
        with torch.inference_mode():
            return engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                                      use_rerank_kernel=True, **ekw)

    tile_ms = tile_latency(run_tile, "tokens", n=3)
    log(f"# [tokens] tile p50 {tile_ms[0]:.3f} ms against cells {cells_tile_ms[0]:.3f} ms")

    rng = np.random.default_rng(seed + 31)
    docs = testing.random_documents(rng, 128, 64, DIM, variable=True)
    dev_s, spec_s = testing.build_memory_index(docs, seed=3, k=32, device=dev, emb_cache=True)
    small = MemoryIndex(dev_s, spec_s, dev)
    res_s = small.search(docs, top_k=5, n_full_scores=128, n_ivf_probe=N_PROBE)
    stats_s = last_search_stats()
    hit_s = float(np.mean([r[0][0] == i for i, r in enumerate(res_s)]))
    log(f"# [tokens, auto] coarse index ({spec_s.n_docs} docs, K {spec_s.n_partitions}, p90 cell "
        f"{np.quantile(small.loaded.ivf_lengths_host, 0.9):.0f} docs): auto -> "
        f"{stats_s['approx_mode']}; planted hit@1 {hit_s:.4f} over {len(docs)} documents")
    if stats_s["approx_mode"] != "tokens" or hit_s != 1.0:
        raise AssertionError(f"tokens via auto: {stats_s['approx_mode']}, hit@1 {hit_s}")
    return {"qps": len(sel) / dt, "hit1": hit1, "tile_ms": tile_ms, "auto_hit1": hit_s}


def bucket_kernel_checks(dd_calls, k2_calls) -> list:
    """The stage-6 kernels against their plain versions on each bucket's
    inputs of one tile (timed for the largest bucket)."""
    out = []
    for i, args in enumerate(dd_calls):
        out.append(check_dedup(*args, f"bucket{i}_cap{args[0].shape[1]}", timing=i == 0))
    for i, args in enumerate(k2_calls):
        out.append(check_rerank(*args, f"bucket{i}_cap{args[0].shape[1]}", timing=i == 0))
    return out


def phase_skewed(dev, counters, seed: int, n_docs: int = 57_638, n_queries: int = 1280) -> dict:
    """Phase 8: a length-skewed corpus on the resident instance. Synthetic
    lengths (lognormal, median 90, sigma 0.6, in [8, 300]), d 128, seeded.
    The loader picks the layout by the cache budget
    (``load.choose_length_buckets``): at the default budget the single cap
    of 304 with its bf16 cache; at a budget of the bucketed bf16 caches'
    size, length buckets, searched with the dedup kernel once per bucket a
    tile and then with ``FASTPLAID_RERANK_DEDUP=0`` (kernel 2 once per
    bucket); at a budget of the q4 cache's size, below the bucketed caches',
    the single cap with the q4 tier. Planted hit@1 1.0 and kernel = plain
    up to ties on each."""
    import torch

    from fast_plaid_tpu_torch.index.layout import emb_cache_bytes
    from fast_plaid_tpu_torch.search import FastPlaid, engine
    from fast_plaid_tpu_torch.search.load import layout_cache_bytes

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    lens = skewed_lengths(n_docs, rng)
    docs = corpus_of_lengths(lens, rng)
    probe_pids = rng.choice(np.nonzero(lens >= Q_LEN)[0], 64)
    rand_q = rng.standard_normal((n_queries, Q_LEN, DIM), dtype=np.float32)
    rand_q /= np.linalg.norm(rand_q, axis=-1, keepdims=True)
    probes = np.stack([docs[p][:Q_LEN] for p in probe_pids])
    queries = np.concatenate([rand_q, probes])
    sizes = layout_cache_bytes(lens, DIM, 4)
    index_dir = os.path.join(ROOT, "build", "chip_smoke_skewed_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)
    out: dict = {}

    def open_at(budget):
        fp = FastPlaid(index_dir, device=str(dev), low_memory=False,
                       emb_cache_budget_bytes=budget)
        loaded = fp.indices[str(dev)]
        kw = engine_kwargs(loaded, fp.mem_budget)

        def res_tile(k, with_stats=False):
            return engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=k,
                                      use_rerank_kernel=k, with_stats=with_stats, **kw)

        return fp, loaded, res_tile

    try:
        fp = FastPlaid(index_dir, device=str(dev), low_memory=False)
        fp.create(docs, show_progress=False)
        torch.cuda.synchronize()
        out["create_s"] = time.perf_counter() - t0
        fp.close()
        log(f"# [skewed] {n_docs} docs, {int(lens.sum())} tokens (lengths p50 "
            f"{np.median(lens):.0f}, p90 {np.quantile(lens, 0.9):.0f}, max {lens.max()}), "
            f"corpus + create {out['create_s']:.2f} s; caches: bf16 one cap "
            f"{sizes['bf16'] / 1e9:.3f} GB, bf16 buckets {sizes['bf16_buckets'] / 1e9:.3f} GB, "
            f"q4 {sizes['q4'] / 1e9:.3f} GB")
        if not sizes["q4"] < sizes["bf16_buckets"] < sizes["bf16"]:
            raise AssertionError(f"skewed: cache sizes out of order {sizes}")

        fp, loaded, res_tile = open_at(None)
        if loaded.ispec.bucket_caps or loaded.dev.emb_cache is None:
            raise AssertionError("skewed, default budget: not the single-cap bf16 cache")
        log(f"# [skewed, one cap] the default budget keeps doc_cap {loaded.ispec.doc_cap} "
            f"with the bf16 cache")
        res = api_search(fp, queries, counters, n_queries, probe_pids, "skewed, one cap",
                         ("segmented_estimate",), expect_cells=False)
        res["diff"], _ = compare_tile("skewed, one cap", res_tile)
        res["tile_ms"] = tile_latency(lambda: res_tile(True), "skewed, one cap")
        out["one_cap"] = res
        fp.close()
        torch.cuda.empty_cache()

        fp, loaded, res_tile = open_at(sizes["bf16_buckets"])
        ispec = loaded.ispec
        n_b = len(ispec.bucket_caps)
        log(f"# [skewed, bucketed] budget {sizes['bf16_buckets'] / 1e9:.3f} GB: buckets "
            f"{ispec.bucket_caps} with {ispec.bucket_counts} docs, bf16 caches "
            f"{emb_cache_bytes(ispec) / 1e9:.3f} GB")
        if not n_b or any(bk.emb is None for bk in loaded.dev.buckets):
            raise AssertionError("skewed: the bucketed budget did not bucket with caches")
        quotas = [engine._bucket_quota(N_FULL // 2, ispec, i) for i in range(n_b)]
        viable = [engine.dedup_viable(bk.emb.shape[0], 256, qb, Q_LEN, DIM)
                  for bk, qb in zip(loaded.dev.buckets, quotas)]
        log(f"# [skewed] quotas at R {N_FULL // 2}: {quotas}; dedup_viable {viable}")

        def one_tile_launches():
            counters.zero()
            with torch.inference_mode():
                stats = res_tile(True, with_stats=True)[-1]
            torch.cuda.synchronize()
            return counters.read(), int(stats[:, 1].sum())

        res = api_search(fp, queries, counters, n_queries, probe_pids, "skewed, bucketed",
                         ("segmented_estimate", "maxsim_gather_scores_dedup"), expect_cells=False)
        launches, drops = one_tile_launches()
        log(f"# [skewed, bucketed] one tile: launches {launches}; quota drops {drops} "
            f"(API search of {len(queries)} queries: cap_overflow_slots "
            f"{res['stats']['cap_overflow_slots']})")
        if launches["maxsim_gather_scores_dedup"] != sum(viable) or (
                launches["maxsim_gather_scores"] != n_b - sum(viable)):
            raise AssertionError(f"skewed: stage-6 launches {launches} for gates {viable}")
        res["diff"], _ = compare_tile("skewed, bucketed", res_tile)
        res["tile_ms"] = tile_latency(lambda: res_tile(True), "skewed, bucketed")
        res["quota_drops"] = drops
        with Recorder(engine, "maxsim_gather_scores_dedup") as dd, Recorder(
                engine, "maxsim_gather_scores") as k2:
            with torch.inference_mode():
                res_tile(True)
        res["kernels"] = bucket_kernel_checks(dd.calls, k2.calls)
        out["bucketed"] = res

        os.environ["FASTPLAID_RERANK_DEDUP"] = "0"
        try:
            res = api_search(fp, queries, counters, n_queries, probe_pids,
                             "skewed, bucketed, dedup off", ("maxsim_gather_scores",),
                             expect_cells=False)
            launches, _ = one_tile_launches()
            log(f"# [skewed, bucketed, dedup off] one tile: launches {launches}")
            if launches["maxsim_gather_scores"] != n_b or launches["maxsim_gather_scores_dedup"]:
                raise AssertionError(f"skewed, dedup off: stage-6 launches {launches}")
            res["diff"], _ = compare_tile("skewed, bucketed, dedup off", res_tile)
            res["tile_ms"] = tile_latency(lambda: res_tile(True), "skewed, bucketed, dedup off")
            with Recorder(engine, "maxsim_gather_scores") as k2:
                with torch.inference_mode():
                    res_tile(True)
            res["kernels"] = bucket_kernel_checks([], k2.calls)
        finally:
            del os.environ["FASTPLAID_RERANK_DEDUP"]
        out["bucketed_k2"] = res
        fp.close()
        torch.cuda.empty_cache()

        fp, loaded, res_tile = open_at(sizes["q4"])
        if (loaded.ispec.bucket_caps or loaded.dev.emb_cache is not None
                or loaded.dev.emb_q4 is None):
            raise AssertionError("skewed, q4 budget: not the single cap with the q4 tier")
        log(f"# [skewed, q4 tier] budget {sizes['q4'] / 1e9:.3f} GB: one cap with the q4 "
            f"cache {tuple(loaded.dev.emb_q4.shape)}")
        res = api_search(fp, queries, counters, n_queries, probe_pids, "skewed, q4 tier",
                         ("segmented_estimate", "maxsim_q4_gather_scores"), expect_cells=False)
        res["diff"], _ = compare_tile("skewed, q4 tier", res_tile)
        res["tile_ms"] = tile_latency(lambda: res_tile(True), "skewed, q4 tier", n=10)
        out["q4_tier"] = res
        fp.close()

        for name in ("bucketed", "q4_tier"):
            agree = float(np.mean([len(set(a) & set(b)) / TOP_K
                                   for a, b in zip(out[name]["ids"], out["one_cap"]["ids"])]))
            log(f"# [skewed] top-{TOP_K} overlap, {name} vs one cap: {agree:.4f}")
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)
    return out


def true_maxsim(flat_dev, starts, pids, queries_dev) -> "torch.Tensor":
    """Exact MaxSim in float32 of each query against documents of the
    original (uncompressed) corpus: [B, K] pids -> [B, K] scores."""
    import torch

    out = torch.empty(pids.shape, dtype=torch.float32)
    for b in range(pids.shape[0]):
        for j, p in enumerate(pids[b]):
            doc = flat_dev[starts[p] : starts[p + 1]]
            out[b, j] = (queries_dev[b] @ doc.t()).amax(dim=1).sum()
    return out


def ivf_keys(d, k: int, n_docs: int) -> np.ndarray:
    """An index's IVF as int64 keys cell * (n_docs + 1) + pid."""
    off = d.ivf_offsets[:k].cpu().numpy().astype(np.int64)
    ln = d.ivf_lengths[:k].cpu().numpy().astype(np.int64)
    first = np.repeat(np.cumsum(ln) - ln, ln)
    pos = np.repeat(off, ln) + np.arange(int(ln.sum())) - first
    pids = d.ivf.cpu().numpy()[pos].astype(np.int64)
    return np.repeat(np.arange(k, dtype=np.int64), ln) * (n_docs + 1) + pids


def same_build(got, want, spec, flat_dev, starts) -> dict:
    """Two builds of one corpus at the same centroids and codec: codes equal
    except where the two centroids' bf16 scores tie (1e-5), at most one
    token in 1,000; packed residuals equal byte for byte wherever the codes
    agree; IVF cells equal as sets except for the (cell, document) entries
    of differing codes."""
    import torch

    from fast_plaid_tpu_torch.ops import codec

    k, n = spec.n_partitions, spec.n_docs
    if got.codes.shape != want.codes.shape or not torch.equal(got.doc_lengths, want.doc_lengths):
        raise AssertionError("device build: layout differs from the host build")
    iota = torch.arange(got.codes.shape[1], device=got.codes.device)
    valid = iota[None, :] < got.doc_lengths[:, None]
    differ = (got.codes != want.codes) & valid
    n_tok, n_diff = int(valid.sum()), int(differ.sum())
    if n_diff > max(3, n_tok // 1000):
        raise AssertionError(f"device build: {n_diff} of {n_tok} codes differ from the host build")
    rows, cols = torch.nonzero(differ, as_tuple=True)
    tie = 0.0
    if n_diff:
        x = flat_dev[torch.from_numpy(starts[:-1]).to(flat_dev.device)[rows] + cols]
        sc = codec.bf16_matmul(x, got.centroids[:k].t())
        ca, cb = got.codes[rows, cols].long(), want.codes[rows, cols].long()
        tie = float((sc.gather(1, ca[:, None]) - sc.gather(1, cb[:, None])).abs().max())
        if tie > 1e-5:
            raise AssertionError(f"device build: a code differs off a near-tie ({tie})")
    shape = (*got.codes.shape, -1)
    res_off = int(((got.residuals.view(shape) != want.residuals.view(shape)).any(-1)
                   & valid & ~differ).sum())
    if res_off:
        raise AssertionError(f"device build: {res_off} tokens' residuals differ at equal codes")
    keys_got, keys_want = ivf_keys(got, k, n), ivf_keys(want, k, n)
    xor = np.setxor1d(keys_got, keys_want)
    pid = rows.cpu().numpy().astype(np.int64)
    allowed = np.concatenate([c.cpu().numpy().astype(np.int64) * (n + 1) + pid
                              for c in (got.codes[rows, cols], want.codes[rows, cols])])
    if not np.isin(xor, allowed).all():
        raise AssertionError("device build: IVF cells differ from the host build's as sets")
    return {"tokens": n_tok, "codes_differ": n_diff, "max_tie": tie,
            "ivf_entries": int(keys_got.size), "ivf_differ": int(xor.size)}


def phase_device_build(dev, docs, queries, n_queries, probe_pids, counters, create_res) -> dict:
    """Phase 10a: ``build_memory_index_flat`` of the main corpus as a tensor on
    the card (the device build), held against the host build of the same
    corpus given the device build's centroids and codec (``same_build``),
    then resident search: planted hit@1 1.0 with the ``create`` index's
    top-1. On the random queries, whose top scores are all near-ties, the
    two indexes' top-10 lists must be of equal exact quality: their mean
    exact float32 MaxSim over the original tokens within twice the create
    index's largest codec error of a returned score."""
    import torch

    from fast_plaid_tpu_torch import testing
    from fast_plaid_tpu_torch.index import device_build
    from fast_plaid_tpu_torch.index import ivf as ivf_mod
    from fast_plaid_tpu_torch.index.builder import compress_tokens
    from fast_plaid_tpu_torch.index.layout import to_device
    from fast_plaid_tpu_torch.testing import MemoryIndex

    lens = np.asarray([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    flat = np.concatenate(docs)
    flat_dev = torch.from_numpy(flat).to(dev)
    trained = []
    real_codec = device_build.train_codec_device

    def keep_codec(*args, **kwargs):
        trained.append(real_codec(*args, **kwargs))
        return trained[-1]

    device_build.train_codec_device = keep_codec
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, ispec = testing.build_memory_index_flat(flat_dev, lens, nbits=4, seed=0,
                                                     emb_cache=True, verbose=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        device_build.train_codec_device = real_codec
    log(f"# [device build] {len(docs)} docs in {build_s:.2f} s (bf16 cache included; create "
        f"took {create_res['create_s']:.2f} s); {ispec}")

    t0 = time.perf_counter()
    cent = idx.centroids[: ispec.n_partitions].cpu().numpy()
    cutoffs = trained[0].bucket_cutoffs.cpu().numpy()
    codes_h, packed_h = compress_tokens(flat, cent, cutoffs, 4, device=dev)
    ivf_h, ivf_len_h = ivf_mod.build_ivf(codes_h, lens, ispec.n_partitions)
    host, hspec = to_device(
        centroids=cent, bucket_weights=trained[0].bucket_weights.cpu().numpy(),
        codes=codes_h, residuals=packed_h, doc_lengths=lens, ivf=ivf_h,
        ivf_lengths=ivf_len_h, nbits=4, device=dev)
    del codes_h, packed_h, ivf_h
    host_s = time.perf_counter() - t0
    if dataclasses.replace(hspec, cell_cap=0) != dataclasses.replace(ispec, cell_cap=0):
        raise AssertionError(f"device build: spec {ispec} differs from the host build's {hspec}")
    same = same_build(idx, host, ispec, flat_dev, starts)
    log(f"# [device build] against the host build at its centroids and codec ({host_s:.2f} s): "
        f"{same['codes_differ']} of {same['tokens']} codes differ (largest bf16 score gap "
        f"{same['max_tie']:.2e}), residuals equal at equal codes, {same['ivf_differ']} of "
        f"{same['ivf_entries']} IVF entries differ")
    del host
    torch.cuda.empty_cache()

    mem = MemoryIndex(idx, ispec, dev)
    res = api_search(mem, queries, counters, n_queries, probe_pids, "device build",
                     ("segmented_estimate", "maxsim_gather_scores_dedup"))
    if not np.array_equal(res["ids"][n_queries:, 0], create_res["ids"][n_queries:, 0]):
        raise AssertionError("device build: planted top-1 differs from the create index")
    nq = min(256, n_queries)
    q_dev = torch.from_numpy(queries[:nq]).to(dev)
    a_ids, b_ids = res["ids"][:nq], create_res["ids"][:nq]
    ta = true_maxsim(flat_dev, starts, a_ids, q_dev).numpy()
    tb = true_maxsim(flat_dev, starts, b_ids, q_dev).numpy()
    err = float(np.abs(tb - create_res["scores"][:nq]).max())
    gap = float(ta.mean() - tb.mean())
    agree = float(np.mean([len(set(a) & set(b)) / TOP_K for a, b in zip(a_ids, b_ids)]))
    log(f"# [device build] over {nq} random queries: top-{TOP_K} overlap with the create index "
        f"{agree:.4f}; mean exact MaxSim of the top-{TOP_K} {ta.mean():.4f} (device build) vs "
        f"{tb.mean():.4f} (create), gap {gap:+.4f}; the create index's codec error of a "
        f"returned score <= {err:.4f}")
    if abs(gap) > 2 * err:
        raise AssertionError(f"device build: top-{TOP_K} quality differs beyond near-ties ({gap})")
    del mem, idx, flat_dev
    torch.cuda.empty_cache()
    return {"build_s": build_s, "qps": res["qps"], "hit1": res["hit1"], "overlap": agree,
            "gap": gap, "same": same}


def phase_streaming(dev, counters, seed: int, n_docs: int = 522_931) -> dict:
    """Phase 10b: ``build_memory_index_streaming`` at 522,931 documents
    (quora scale; lengths uniform in [80, 160], d 128) from a chunk generator
    that draws each 4,096-document block on the card from its own seed, then
    resident search (stage 6 is kernel 2: the dedup gate fails at this
    corpus). Planted hit@1 1.0; build seconds and peak device memory."""
    import torch

    from fast_plaid_tpu_torch.index.streaming import (
        build_memory_index_streaming,
        train_global_codec,
    )
    from fast_plaid_tpu_torch.testing import MemoryIndex

    rng = np.random.default_rng(seed + 51)
    lens = rng.integers(80, 161, size=n_docs).astype(np.int64)
    lens[0] = 160
    starts = np.concatenate([[0], np.cumsum(lens)])
    blk = 4096

    def block(bi):
        d0, d1 = bi * blk, min((bi + 1) * blk, n_docs)
        g = torch.Generator(device=dev).manual_seed(seed * 100_003 + bi)
        x = torch.randn((int(starts[d1] - starts[d0]), DIM), generator=g, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def chunk_gen(d0, d1):
        parts = []
        for bi in range(d0 // blk, (d1 - 1) // blk + 1):
            base = starts[bi * blk]
            lo, hi = max(d0, bi * blk), min(d1, (bi + 1) * blk)
            parts.append(block(bi)[starts[lo] - base : starts[hi] - base])
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # The codec is trained apart from the build (the same call the build
    # makes), so that phase 13's sharded builds reuse it.
    cent, codec, _ = train_global_codec(chunk_gen, lens, nbits=4, seed=seed)
    idx, ispec = build_memory_index_streaming(chunk_gen, lens, centroids=cent,
                                              codec_params=codec, emb_cache=True, verbose=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"# [streaming] {n_docs} docs, {int(lens.sum())} tokens built in {build_s:.2f} s "
        f"(bf16 cache included), peak device memory {peak / 1e9:.2f} GB; {ispec}")
    probe_pids = rng.integers(0, n_docs, 64)
    probes = torch.stack([chunk_gen(int(p), int(p) + 1)[:Q_LEN] for p in probe_pids]).cpu().numpy()
    rand_q = rng.standard_normal((256, Q_LEN, DIM), dtype=np.float32)
    rand_q /= np.linalg.norm(rand_q, axis=-1, keepdims=True)
    queries = np.concatenate([rand_q, probes])
    mem = MemoryIndex(idx, ispec, dev)
    res = api_search(mem, queries, counters, 256, probe_pids, "streaming index",
                     ("segmented_estimate", "maxsim_gather_scores"))
    if res["launches"]["maxsim_gather_scores_dedup"]:
        raise AssertionError("streaming index: the dedup kernel ran past its gate")
    from fast_plaid_tpu_torch.search import engine

    kw = engine_kwargs(mem.loaded, mem.mem_budget)
    tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)
    res["diff"], _ = compare_tile("streaming index", lambda k: engine.search_impl(
        idx, tile, None, use_estimate_kernel=k, use_rerank_kernel=k, **kw))
    res["tile_ms"] = tile_latency(lambda: engine.search_impl(
        idx, tile, None, use_estimate_kernel=True, use_rerank_kernel=True, **kw),
        "streaming index", n=10)
    # Phase 13a takes the index, its corpus and codec, and frees them.
    shared = {"idx": idx, "ispec": ispec, "chunk_gen": chunk_gen, "lens": lens, "cent": cent,
              "codec": codec, "queries": queries, "probe_pids": probe_pids, "kw": kw,
              "ivf_lengths_host": mem.loaded.ivf_lengths_host}
    del mem
    return {"build_s": build_s, "peak_gb": peak / 1e9, "shared": shared, **res}


# Phase 13: multi-device search (fast_plaid_tpu_torch/parallel). The JAX
# package's default working budget (256 MiB) for the sharded searches, as
# ShardedFastPlaid has it: stage 6's codec rerank then chunks the pool to
# about 12 candidates a step at 256 queries.
SHARD_MEM_BUDGET = 256 * 1024 * 1024
N_SHARDS_ONE_CARD = 4


def shard_devices(n: int) -> list:
    """``n`` mesh slots over the cards: all on cuda:0 on a one-card machine,
    one card a slot where there are several."""
    import torch

    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(n)]


def n_shards_here() -> int:
    import torch

    n_cards = torch.cuda.device_count()
    return N_SHARDS_ONE_CARD if n_cards == 1 else n_cards


class plain_kernels:
    """Within the block, every parallel/ path runs the plain versions (the
    kernel flags are read per shard through ``sharded.kernel_flags``)."""

    def __enter__(self):
        from fast_plaid_tpu_torch.parallel import sharded

        self.real = sharded.kernel_flags
        sharded.kernel_flags = lambda dev: (False, False)
        return self

    def __exit__(self, *exc):
        from fast_plaid_tpu_torch.parallel import sharded

        sharded.kernel_flags = self.real


def in_tiles(run, queries, tile: int = 256):
    """``run(tile) -> (ids, scores)`` over the queries in tiles; numpy."""
    ids, scores = [], []
    for s in range(0, len(queries), tile):
        i, sc = run(queries[s : s + tile])[:2]
        ids.append(np.asarray(i.cpu() if hasattr(i, "cpu") else i))
        scores.append(np.asarray(sc.cpu() if hasattr(sc, "cpu") else sc))
    return np.concatenate(ids), np.concatenate(scores)


def rows_to_arrays(rows):
    return (np.asarray([[p for p, _ in r] for r in rows]),
            np.asarray([[s for _, s in r] for r in rows]))


def against_single(label, got_ids, got_sc, ref_ids, ref_sc, n_rand: int,
                   lower_ok: bool = False) -> dict:
    """A sharded top-k against one device's on the same queries (random
    first, then planted probes from ``n_rand`` on).

    Each shard runs the whole cascade over its own documents: its budget,
    rank admission and stage-5 pool of R = n_full_scores / 2 apply a shard,
    so the sharded lists are the top-k of other pools, neither a superset
    nor a subset of the single device's. What must hold: a document of both
    lists has one score (within TIE_TOL: exact MaxSim of the same codes),
    every planted probe's top-1 is the single device's up to ties, and,
    unless ``lower_ok``, no random query's sharded top-1 scores below the
    single device's beyond TIE_TOL. The random queries' top-1 agreement
    (equal up to ties, higher, lower) and the top-k overlap are printed."""
    same = higher = lower = 0
    worst = 0.0
    for qi, (gi, gs, ri, rs) in enumerate(zip(got_ids, got_sc, ref_ids, ref_sc)):
        tie = gi[0] == ri[0] or abs(gs[0] - rs[0]) <= TIE_TOL
        if qi >= n_rand and not tie:
            raise AssertionError(f"{label}: planted probe {qi - n_rand}: top-1 {gi[0]} "
                                 f"({gs[0]}) against the single device's {ri[0]} ({rs[0]})")
        if qi < n_rand:
            same += tie
            higher += not tie and gs[0] > rs[0]
            lower += not tie and gs[0] < rs[0]
        g = dict(zip(gi.tolist(), gs.tolist()))
        for pid, sc in zip(ri.tolist(), rs.tolist()):
            if pid in g:
                worst = max(worst, abs(g[pid] - sc))
    if worst > TIE_TOL:
        raise AssertionError(f"{label}: a common document's scores differ by {worst}")
    if lower and not lower_ok:
        raise AssertionError(f"{label}: {lower} random queries' top-1 score below the "
                             f"single device's")
    overlap = float(np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(got_ids, ref_ids)]))
    log(f"# [{label}] against one device: planted top-1 equal on all {len(got_ids) - n_rand}; "
        f"random queries' top-1 equal up to ties {same}/{n_rand}, higher {higher}, lower "
        f"{lower}; common documents' scores within {worst:.2e}; top-{TOP_K} overlap "
        f"{overlap:.4f}")
    return {"top1_same": same, "top1_higher": higher, "top1_lower": lower, "max_diff": worst,
            "overlap": overlap}


def planted_hit1(label, ids, want) -> float:
    hit = float(np.mean([int(r[0]) == int(p) for r, p in zip(ids, want)]))
    log(f"# [{label}] planted hit@1: {hit:.4f} over {len(want)} probes")
    if hit != 1.0:
        raise AssertionError(f"{label}: planted hit@1 {hit} != 1.0")
    return hit


def need_launches(label, launches, need: dict) -> None:
    for name, n in need.items():
        if launches[name] < n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                 f"fewer than {n} (once a shard a tile)")


def phase_sharded(dev, counters, shared: dict, single: dict) -> dict:
    """Phase 13a: ``build_sharded_index_streaming`` over phase 10b's corpus,
    codec and centroids (no second k-means), 4 shards on cuda:0, then
    ``sharded_search`` of 10b's 256 random + 64 planted queries in tiles of
    256 (stage 6 is the codec rerank: sharded indexes carry no bf16 cache);
    ``query_sharded_search`` of 10b's single-device index and
    ``sharded_search_2d`` on a 2 x 2 mesh, a tile each. 10b's index is
    freed at the end."""
    import torch

    from fast_plaid_tpu_torch.index.streaming import build_sharded_index_streaming
    from fast_plaid_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        query_sharded_search,
        replicate_sharded_index,
        sharded_search,
        sharded_search_2d,
    )
    from fast_plaid_tpu_torch.search import engine

    # The queries as the single-device search received them (float16 wire).
    queries = shared["queries"].astype(np.float16)
    probe_pids = shared["probe_pids"]
    n_rand = len(queries) - len(probe_pids)
    n_sh = n_shards_here()
    mesh = make_mesh(devices=shard_devices(n_sh))
    out: dict = {"n_shards": n_sh, "mem_budget": SHARD_MEM_BUDGET}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = build_sharded_index_streaming(
        shared["chunk_gen"], shared["lens"], mesh, centroids=shared["cent"],
        codec_params=shared["codec"], verbose=True)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["index_gb"] = (torch.cuda.memory_allocated(dev) - base_mem) / 1e9
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"# [sharded] {sharded.n_docs_total} docs over {n_sh} shards on "
        f"{[str(d) for d in mesh.device_list()]} built in {out['build_s']:.2f} s (10b's codec), "
        f"{out['index_gb']:.2f} GB of shards, peak {out['peak_gb']:.2f} GB with 10b's index "
        f"resident; {sharded.ispec}; doc_base {sharded.doc_base.tolist()}")
    kw = dict(top_k=TOP_K, n_ivf_probe=N_PROBE, n_full_scores=N_FULL, mem_budget=SHARD_MEM_BUDGET)

    def run(q):
        return sharded_search(sharded, q, **kw)

    in_tiles(run, queries[:256])  # warm-up
    torch.cuda.synchronize()
    counters.zero()
    t0 = time.perf_counter()
    ids, scores = in_tiles(run, queries)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    out["launches"] = counters.read()
    n_tiles = -(-len(queries) // 256)
    out["qps"] = len(queries) / search_s
    log(f"# [sharded] sharded_search of {len(queries)} queries in tiles of 256: "
        f"{search_s:.3f} s = {out['qps']:.1f} QPS (mem_budget {SHARD_MEM_BUDGET} B); "
        f"launches {out['launches']}")
    need_launches("sharded", out["launches"], {"segmented_estimate": n_sh * n_tiles})
    if not np.isfinite(scores).all() or (ids < 0).any():
        raise AssertionError("sharded: an empty or non-finite result")
    out["hit1"] = planted_hit1("sharded", ids[n_rand:], probe_pids)
    out["vs_single"] = against_single("sharded", ids, scores, single["ids"], single["scores"],
                                      n_rand)
    tile = queries[-256:]
    tile_dev = torch.from_numpy(tile).to(dev)

    def run_tile(k):
        if k:
            return sharded_search(sharded, tile_dev, **kw)
        with plain_kernels():
            return sharded_search(sharded, tile_dev, **kw)

    # Kernel path against plain path (no timing: tile_latency times it).
    with torch.inference_mode():
        k_ids, k_sc = run_tile(True)
        p_ids, p_sc = run_tile(False)
    ok, out["diff"] = same_topk(k_ids.cpu().numpy(), k_sc.cpu().numpy(),
                                p_ids.cpu().numpy(), p_sc.cpu().numpy())
    if not ok:
        raise AssertionError(f"sharded: kernel path and plain path differ beyond ties "
                             f"({out['diff']})")
    log(f"# [sharded] kernel path vs plain path on one tile: top-{TOP_K} equal up to ties, "
        f"max score diff {out['diff']:.3e}")
    out["tile_ms"] = tile_latency(lambda: sharded_search(sharded, tile_dev, **kw),
                                  "sharded (4 shards, one tile)", n=10)
    del sharded
    torch.cuda.empty_cache()

    # Query sharding: 10b's single-device index (bf16 cache: kernel 2 at
    # stage 6) over the same mesh slots, the tile split four ways.
    idx, ispec = shared["idx"], shared["ispec"]
    qkw = dict(shared["kw"])
    qkw.pop("ispec")
    for name in ("cand_cap", "slot_budget"):
        qkw.pop(name)
    qkw["approx_mode"] = "auto"
    qkw["rank_admit"] = None
    counters.zero()
    with torch.inference_mode():
        q_ids, q_sc = query_sharded_search(idx, ispec, tile_dev, mesh,
                                           ivf_lengths_host=shared["ivf_lengths_host"], **qkw)
        torch.cuda.synchronize()
        out["query_launches"] = counters.read()
        r_ids, r_sc = engine.search_impl(idx, tile_dev, None,
                                         use_estimate_kernel=True, use_rerank_kernel=True,
                                         **shared["kw"])
    need_launches("query-sharded", out["query_launches"],
                  {"segmented_estimate": n_sh, "maxsim_gather_scores": n_sh})
    ok, err = same_topk(q_ids.cpu().numpy(), q_sc.cpu().numpy(), r_ids.cpu().numpy(),
                        r_sc.cpu().numpy())
    if not ok:
        raise AssertionError(f"query-sharded: differs from one device beyond ties ({err})")
    out["query_hit1"] = planted_hit1("query-sharded", q_ids.cpu().numpy()[-len(probe_pids):],
                                     probe_pids)
    log(f"# [query-sharded] one tile split over {n_sh} slots: equal to one device up to ties "
        f"(max diff {err:.2e}); launches {out['query_launches']}")
    out["query_diff"] = err

    # 2-D: a 2-shard build laid on a 2 x 2 mesh (replica rows split the tile).
    t0 = time.perf_counter()
    sharded2 = build_sharded_index_streaming(
        shared["chunk_gen"], shared["lens"], make_mesh(devices=shard_devices(2)),
        centroids=shared["cent"], codec_params=shared["codec"])
    torch.cuda.synchronize()
    out["build2_s"] = time.perf_counter() - t0
    rep = replicate_sharded_index(sharded2, make_mesh_2d(2, 2, shard_devices(4)))
    counters.zero()
    with torch.inference_mode():
        t0 = time.perf_counter()
        d_ids, d_sc = sharded_search_2d(rep, tile_dev, **kw)
        torch.cuda.synchronize()
        out["tile2d_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches_2d"] = counters.read()
    need_launches("2-D", out["launches_2d"], {"segmented_estimate": 4})
    d_ids, d_sc = d_ids.cpu().numpy(), d_sc.cpu().numpy()
    out["hit1_2d"] = planted_hit1("2-D", d_ids[-len(probe_pids):], probe_pids)
    out["vs_single_2d"] = against_single("2-D", d_ids, d_sc, single["ids"][-len(tile):],
                                         single["scores"][-len(tile):],
                                         len(tile) - len(probe_pids))
    log(f"# [2-D] 2-shard build {out['build2_s']:.2f} s; one tile on the 2 x 2 mesh "
        f"{out['tile2d_ms']:.3f} ms (first call); launches {out['launches_2d']}")
    del rep, sharded2, shared["idx"], idx
    torch.cuda.empty_cache()
    return out


def phase_sharded_disk(dev, counters, index_dir, queries, probe_q, probe_ids) -> dict:
    """Phase 13b, on phase 3's index directory after phase 6's mutations:
    ``ShardedFastPlaid`` at 4 shards against ``FastPlaid.search`` (the
    default constructor) on the directory, then ``load_sharded_lm`` at 4
    shards (low_memory + q4 prefilter a shard). Tiles of 256: 256 random
    queries and the surviving planted probes at their current ids."""
    import torch

    from fast_plaid_tpu_torch.parallel import ShardedFastPlaid, load_sharded_lm, make_mesh, sharded
    from fast_plaid_tpu_torch.search import FastPlaid, searcher
    from fast_plaid_tpu_torch.search.fast_plaid import default_mem_budget

    # Rounded to float16 as the single-device search sends them.
    n_rand = min(256, len(queries))
    qs = np.concatenate([queries[:n_rand], probe_q]).astype(np.float16).astype(np.float32)
    n_sh = n_shards_here()
    n_tiles = -(-len(qs) // 256)
    kw = dict(top_k=TOP_K, n_full_scores=N_FULL, n_ivf_probe=N_PROBE)
    out: dict = {"n_shards": n_sh}
    fp = FastPlaid(index_dir, device=str(dev))
    single = rows_to_arrays(fp.search(qs, show_progress=False, **kw))
    # "auto" over the whole corpus's IVF lengths; the shards resolve it over
    # theirs (the per-cell max of four quarters), which can drop the rank
    # admission the single device keeps: their top-1 may then score lower.
    # With the single device's rank_admit passed, it must not.
    out["single_rank_admit"] = searcher.last_search_stats()["rank_admit"]
    loaded = fp.indices[str(dev)]
    out["single_params"] = sharded._resolve_shard_params(
        loaded.ivf_lengths_host, loaded.ispec, Q_LEN, N_PROBE, N_FULL, "auto", None)
    single_docs, single_mean = loaded.ispec.n_docs, float(np.mean(loaded.ivf_lengths_host))
    fp.close()
    del fp, loaded
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sfp = ShardedFastPlaid(index_dir, mesh=make_mesh(devices=shard_devices(n_sh)),
                           mem_budget_bytes=SHARD_MEM_BUDGET)
    torch.cuda.synchronize()
    out["open_s"] = time.perf_counter() - t0
    sh = sfp.sharded
    out["shard_params"] = sharded._resolve_shard_params(
        sh.ivf_lengths_host, sh.ispec, Q_LEN, N_PROBE, N_FULL, "auto", None)
    log(f"# [ShardedFastPlaid] \"auto\" resolved (approx_mode, rank_admit, slot_budget, "
        f"cand_cap): one device {out['single_params']} over {single_docs} docs, mean "
        f"IVF length {single_mean:.2f}; a shard "
        f"{out['shard_params']} over {sh.ispec.n_docs} docs, mean of the per-cell max "
        f"{float(np.mean(sh.ivf_lengths_host)):.2f}")
    in_tiles(lambda q: rows_to_arrays(sfp.search(q, **kw)), qs[:256])  # warm-up
    counters.zero()
    t0 = time.perf_counter()
    ids, scores = in_tiles(lambda q: rows_to_arrays(sfp.search(q, **kw)), qs)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    out["launches"] = counters.read()
    out["qps"] = len(qs) / search_s
    log(f"# [ShardedFastPlaid] {sfp.sharded.n_docs_total} docs over {n_sh} shards, opened in "
        f"{out['open_s']:.2f} s; {len(qs)} queries in {search_s:.3f} s = {out['qps']:.1f} QPS "
        f"(mem_budget {SHARD_MEM_BUDGET} B); launches {out['launches']}; stats "
        f"{searcher.last_search_stats()}")
    need_launches("ShardedFastPlaid", out["launches"], {"segmented_estimate": n_sh * n_tiles})
    out["hit1"] = planted_hit1("ShardedFastPlaid", ids[n_rand:], probe_ids)
    out["vs_single"] = against_single("ShardedFastPlaid", ids, scores, *single, n_rand,
                                      lower_ok=True)
    admit = dict(kw, rank_admit=out["single_rank_admit"])
    ids, scores = in_tiles(lambda q: rows_to_arrays(sfp.search(q, **admit)), qs)
    out["vs_single_admit"] = against_single(
        f"ShardedFastPlaid, rank_admit {admit['rank_admit']}", ids, scores, *single, n_rand)
    del sfp
    torch.cuda.empty_cache()

    lm_budget = default_mem_budget(dev) // n_sh
    t0 = time.perf_counter()
    lm = load_sharded_lm(index_dir, shard_devices(n_sh))
    torch.cuda.synchronize()
    out["lm_open_s"] = time.perf_counter() - t0
    if any(s is None or not s.low_memory or s.dev.emb_q4 is None for s in lm.shards):
        raise AssertionError("load_sharded_lm: a shard is not low_memory with the q4 cache")
    lm.search(list(qs[:256]), mem_budget=lm_budget, **kw)  # warm-up
    torch.cuda.synchronize()
    counters.zero()
    with Recorder(searcher, "candidates_impl") as tiles:
        t0 = time.perf_counter()
        rows = lm.search(list(qs), mem_budget=lm_budget, **kw)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
    out["lm_launches"] = counters.read()
    out["lm_native_calls"] = counters.native_calls()
    out["lm_tiles"] = len(tiles.calls)
    out["lm_qps"] = len(qs) / search_s
    log(f"# [load_sharded_lm] {n_sh} shards opened in {out['lm_open_s']:.2f} s; {len(qs)} "
        f"queries in {search_s:.3f} s = {out['lm_qps']:.1f} QPS (mem_budget {lm_budget} B a "
        f"shard); {out['lm_tiles']} shard tiles; launches {out['lm_launches']}; native host "
        f"calls {out['lm_native_calls']}")
    need_launches("load_sharded_lm", out["lm_launches"],
                  {"segmented_estimate": max(out["lm_tiles"], n_sh),
                   "maxsim_q4_gather_scores": max(out["lm_tiles"], n_sh)})
    if any(len(r) != TOP_K for r in rows):
        raise AssertionError("load_sharded_lm: a short result came back")
    lm_ids, lm_sc = rows_to_arrays(rows)
    out["lm_hit1"] = planted_hit1("load_sharded_lm", lm_ids[n_rand:], probe_ids)
    out["lm_vs_single"] = against_single("load_sharded_lm", lm_ids, lm_sc, *single, n_rand,
                                         lower_ok=True)
    lm_ids, lm_sc = rows_to_arrays(lm.search(list(qs), mem_budget=lm_budget, **admit))
    out["lm_vs_single_admit"] = against_single(
        f"load_sharded_lm, rank_admit {admit['rank_admit']}", lm_ids, lm_sc, *single, n_rand)
    if out["lm_native_calls"]["gather_windows_u8"] < 1:
        raise AssertionError("load_sharded_lm: the native host gather did not run")
    # Each shard's last tile's pids, gathered on a thread a shard at once.
    with Recorder(searcher, "_pack_rows") as rec:
        lm.search(list(qs[:256]), mem_budget=lm_budget, **kw)
    jobs = list({id(a[0]): (a[0], a[1]) for a in rec.calls}.values())
    out["gather"] = gather_rows_both(jobs, reps=3)
    log_gathers(f"load_sharded_lm, {len(jobs)} shards at once", out["gather"])
    del lm
    torch.cuda.empty_cache()
    return out


def phase_resident(dev, index_dir, docs, queries, n_queries, probe_pids, counters, seed):
    """Phase 3 (dedup stage 6) and 3b (per-query stage 6)."""
    import torch

    from fast_plaid_tpu_torch.ops.rerank_dedup import dedup_viable
    from fast_plaid_tpu_torch.search import FastPlaid, engine

    fp = FastPlaid(index_dir, device=str(dev), low_memory=False)
    t0 = time.perf_counter()
    fp.create(docs, metadata=[meta_row(i) for i in range(len(docs))], show_progress=False)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    loaded = fp.indices[str(dev)]
    ispec = loaded.ispec
    log(f"# create (metadata database of {len(docs)} rows included): {create_s:.2f} s, "
        f"{ispec}")
    if loaded.dev.emb_cache is None or loaded.low_memory:
        raise AssertionError("the bf16 corpus cache is not resident")
    np_rows = loaded.dev.emb_cache.shape[0]
    viable = dedup_viable(np_rows, 256, N_FULL // 2, Q_LEN, DIM)
    log(f"# emb_cache resident: {tuple(loaded.dev.emb_cache.shape)} "
        f"{loaded.dev.emb_cache.dtype}; dedup_viable={viable}")
    if not viable:
        raise AssertionError("dedup_viable does not hold at this shape")
    res = api_search(fp, queries, counters, n_queries, probe_pids, "resident",
                     ("probe_topk", "segmented_estimate", "maxsim_gather_scores_dedup"))

    # The same tiles through the engine: kernels vs plain versions.
    kw = engine_kwargs(loaded, fp.mem_budget)
    worst = 0.0
    with Recorder(engine, "segmented_estimate") as est_rec, Recorder(
        engine, "maxsim_gather_scores_dedup"
    ) as dd_rec, Recorder(engine, "probe_topk") as pr_rec:
        for t_start in (0, len(queries) - 256):
            tile = torch.from_numpy(queries[t_start : t_start + 256].astype(np.float16)).to(dev)
            with torch.inference_mode():
                k_ids, k_sc = engine.search_impl(
                    loaded.dev, tile, None, use_estimate_kernel=True,
                    use_rerank_kernel=True, **kw)
                if t_start == 0:
                    est_args, dd_args, pr_args = est_rec.args, dd_rec.args, pr_rec.args
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
    log(f"# [resident] kernel path vs plain path: top-{TOP_K} equal up to ties, "
        f"max score diff {worst:.3e}")
    tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)

    def run_tile():
        with torch.inference_mode():
            engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                               use_rerank_kernel=True, **kw)

    res["tile_ms"] = tile_latency(run_tile, "resident")
    res["probe"] = check_probe(*pr_args, "main_path_inputs", timing=True)
    res["est"] = check_estimate(*est_args, "main_path_inputs", timing=True)
    res["dedup"] = check_dedup(*dd_args, "main_path_inputs", timing=True)
    res["rr"] = check_rerank(*dd_args, "main_path_inputs", timing=True)
    res["create_s"] = create_s
    res["ispec"] = ispec

    # 3b: the per-query stage 6 (dedup off), on the same index and queries.
    os.environ["FASTPLAID_RERANK_DEDUP"] = "0"
    try:
        res_k2 = api_search(fp, queries, counters, n_queries, probe_pids,
                            "resident, dedup off",
                            ("segmented_estimate", "maxsim_gather_scores"))
        res_k2["tile_ms"] = tile_latency(run_tile, "resident, dedup off")
    finally:
        del os.environ["FASTPLAID_RERANK_DEDUP"]
    agree = float(np.mean([len(set(a) & set(b)) / TOP_K
                           for a, b in zip(res["ids"], res_k2["ids"])]))
    log(f"# [resident] top-{TOP_K} overlap, dedup vs per-query stage 6: {agree:.4f}")
    res["probe_ties"] = probe_ties(dev, loaded, queries, kw)
    res_tok = phase_tokens(dev, fp, loaded, queries, n_queries, probe_pids, counters,
                           res["tile_ms"], seed)
    fp.close()
    return res, res_k2, res_tok


def phase_low_memory(dev, index_dir, queries, n_queries, probe_pids, counters, resident_ids):
    """Phase 4: the default constructor (low_memory + q4 prefilter)."""
    import torch

    from fast_plaid_tpu_torch.search import FastPlaid, engine, searcher

    t0 = time.perf_counter()
    fp = FastPlaid(index_dir, device=str(dev))  # the defaults: low_memory=True
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = fp.indices[str(dev)]
    d = loaded.dev
    if not loaded.low_memory or d.residuals is not None or d.emb_q4 is None:
        raise AssertionError(
            f"default constructor: low_memory={loaded.low_memory}, residuals "
            f"resident={d.residuals is not None}, emb_q4 resident={d.emb_q4 is not None}")
    log(f"# [low_memory] opened in {load_s:.2f} s: residuals in host RAM, emb_q4 "
        f"{tuple(d.emb_q4.shape)} {d.emb_q4.dtype} on {d.emb_q4.device}")
    res = api_search(fp, queries, counters, n_queries, probe_pids, "low_memory",
                     ("probe_topk", "segmented_estimate", "maxsim_q4_gather_scores"))
    agree = float(np.mean([len(set(a) & set(b)) / TOP_K
                           for a, b in zip(res["ids"], resident_ids)]))
    log(f"# [low_memory] top-{TOP_K} overlap with the resident path: {agree:.4f} "
        "(not gated: the q4 prefilter narrows the exact pool)")
    res["overlap_resident"] = agree

    # One tile through the low_memory steps with the kernels and with the
    # plain versions: the final top-10 must agree up to ties.
    kw = engine_kwargs(loaded, fp.mem_budget)
    ispec = loaded.ispec
    pool = engine.rescue_pool(TOP_K)
    gather_ms = []
    last_pids: list = []

    def lm_tile(tile, kernels: bool):
        out, host, pack_ms = lm_steps(loaded, tile, None, kernels, kw)
        last_pids[:] = [host]
        gather_ms.append(pack_ms)
        return out

    worst = 0.0
    with Recorder(engine, "maxsim_q4_gather_scores") as q4_rec:
        for t_start in (0, len(queries) - 256):
            tile = torch.from_numpy(queries[t_start : t_start + 256].astype(np.float16)).to(dev)
            with torch.inference_mode():
                k_ids, k_sc, _ = lm_tile(tile, True)
                if t_start == 0:
                    q4_args = q4_rec.args
                p_ids, p_sc, _ = lm_tile(tile, False)
            ok, err = same_topk(k_ids.cpu().numpy(), k_sc.cpu().numpy(),
                                p_ids.cpu().numpy(), p_sc.cpu().numpy())
            worst = max(worst, err)
            if not ok:
                raise AssertionError(
                    f"low_memory kernel path and plain path top-{TOP_K} differ beyond "
                    f"ties (tile at {t_start}, max score diff {err})")
    log(f"# [low_memory] kernel prefilter vs plain prefilter: top-{TOP_K} equal up "
        f"to ties, max score diff {worst:.3e}")
    tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)
    gather_ms.clear()

    def run_tile():
        with torch.inference_mode():
            lm_tile(tile, True)

    res["tile_ms"] = tile_latency(run_tile, "low_memory (unpipelined)")
    res["gather_ms"] = float(np.median(gather_ms))
    # Bytes a tile gathers: residuals, int32 codes and a valid flag per token.
    mb = 256 * pool * ispec.doc_cap * (loaded.host_residuals.shape[1] + 5) / 1e6
    log(f"# [low_memory] host row gather of one tile (256 x {pool} rows x "
        f"{ispec.doc_cap} tokens, {mb:.1f} MB): median {res['gather_ms']:.3f} ms, "
        f"max {max(gather_ms):.3f} ms over {len(gather_ms)} tiles")
    if res["native_calls"]["gather_windows_u8"] < 1:
        raise AssertionError("low_memory: the native host gather did not run in the search")
    res["gather"] = gather_rows_both([(loaded, last_pids[0])])
    log_gathers("low_memory", res["gather"])
    res["q4"] = check_q4(*q4_args, "main_path_inputs", timing=True)
    res["load_s"] = load_s
    fp.close()
    return res


def phase_q4_tier(dev, index_dir, ispec, queries, n_queries, probe_pids, counters):
    """Phase 5: the resident q4 tier, engaged by a forced budget halfway
    between the q4 cache's and the bf16 cache's size."""
    import torch

    from fast_plaid_tpu_torch.index.layout import emb_cache_bytes, q4_cache_bytes
    from fast_plaid_tpu_torch.search import FastPlaid, engine

    q4_b, emb_b = q4_cache_bytes(ispec), emb_cache_bytes(ispec)
    budget = (q4_b + emb_b) // 2
    log(f"# [q4 tier] q4 cache {q4_b / 1e9:.3f} GB, bf16 cache {emb_b / 1e9:.3f} GB, "
        f"forced budget {budget / 1e9:.3f} GB")
    t0 = time.perf_counter()
    fp = FastPlaid(index_dir, device=str(dev), low_memory=False,
                   emb_cache_budget_bytes=budget)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = fp.indices[str(dev)]
    if loaded.dev.emb_cache is not None or loaded.dev.emb_q4 is None:
        raise AssertionError("the q4 tier did not engage under the forced budget")
    log(f"# [q4 tier] opened in {load_s:.2f} s: emb_cache None, emb_q4 "
        f"{tuple(loaded.dev.emb_q4.shape)}")
    res = api_search(fp, queries, counters, n_queries, probe_pids, "q4 tier",
                     ("segmented_estimate", "maxsim_q4_gather_scores"))
    kw = engine_kwargs(loaded, fp.mem_budget)
    tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)
    with torch.inference_mode():
        k_ids, k_sc = engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                                         use_rerank_kernel=True, **kw)
        p_ids, p_sc = engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=False,
                                         use_rerank_kernel=False, **kw)
    ok, err = same_topk(k_ids.cpu().numpy(), k_sc.cpu().numpy(),
                        p_ids.cpu().numpy(), p_sc.cpu().numpy())
    if not ok:
        raise AssertionError(f"q4 tier kernel path and plain path differ (max {err})")
    log(f"# [q4 tier] kernel path vs plain path: top-{TOP_K} equal up to ties, "
        f"max score diff {err:.3e}")

    def run_tile():
        with torch.inference_mode():
            engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=True,
                               use_rerank_kernel=True, **kw)

    res["tile_ms"] = tile_latency(run_tile, "q4 tier")
    res["load_s"] = load_s
    fp.close()
    return res


def timed_reloads(fp) -> list:
    """Record the seconds of every reload of ``fp`` from now on."""
    import torch

    times: list = []
    real = fp._reload

    def reload():
        t0 = time.perf_counter()
        out = real()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    fp._reload = reload
    return times


def subset_search(fp, label, queries, subset, allowed, n_queries, probe_pids, counters,
                  need) -> dict:
    """One timed ``FastPlaid.search(subset=...)`` of every query: membership,
    planted hit@1 over the probes inside their subset, planted documents
    outside it never returned, the kernels' counters. Also times the host's
    share of the subset: ``normalize_subset`` and ``_pad_subsets`` of every
    tile, as the search runs them."""
    import torch

    from fast_plaid_tpu_torch.search import searcher

    n_docs = next(iter(fp.indices.values())).ispec.n_docs
    t0 = time.perf_counter()
    rows = searcher.normalize_subset(subset, len(queries))
    for start in range(0, len(queries), 256):
        searcher._pad_subsets(rows, n_docs, slice(start, start + 256))
    prep_s = time.perf_counter() - t0
    kw = dict(top_k=TOP_K, n_full_scores=N_FULL, n_ivf_probe=N_PROBE, show_progress=False)
    warm = subset if isinstance(subset[0], int) else subset[:256]
    fp.search(queries[:256], subset=warm, **kw)
    torch.cuda.synchronize()
    counters.zero()
    t0 = time.perf_counter()
    results = fp.search(queries, subset=subset, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counters.read()
    if len(results) != len(queries):
        raise AssertionError(f"{label}: {len(results)} result lists for {len(queries)} queries")
    for qi, row in enumerate(results):
        outside = {p for p, _ in row} - allowed(qi)
        if outside:
            raise AssertionError(f"{label}: query {qi} returned ids outside its subset: "
                                 f"{sorted(outside)[:5]}")
    inside = [i for i, p in enumerate(probe_pids) if int(p) in allowed(n_queries + i)]
    hits = [bool(results[n_queries + i]) and results[n_queries + i][0][0] == int(probe_pids[i])
            for i in inside]
    hit1 = float(np.mean(hits)) if hits else float("nan")
    for i, p in enumerate(probe_pids):
        if i not in inside and any(pid == int(p) for pid, _ in results[n_queries + i]):
            raise AssertionError(f"{label}: planted document {p} outside the subset came back")
    empty = sum(1 for r in results if not r)
    log(f"# [{label}] {len(queries)} queries in {dt:.3f} s = {len(queries) / dt:.1f} QPS "
        f"(host subset preparation alone {prep_s:.3f} s); "
        f"planted hit@1 {hit1:.4f} over {len(hits)} probes in their subset; "
        f"{len(probe_pids) - len(inside)} probes outside it never returned; "
        f"{empty} empty results; launches {launches}")
    if not hits or hit1 != 1.0:
        raise AssertionError(f"{label}: planted hit@1 {hit1} != 1.0")
    for name in need:
        if launches[name] < 1:
            raise AssertionError(f"{label}: {name} was not launched during the search")
    return {"qps": len(queries) / dt, "s": dt, "prep_s": prep_s, "hit1": hit1,
            "launches": launches}


def compare_tile(label, run) -> tuple[float, float]:
    """``run(kernels)`` -> (ids, scores) of one tile: the kernel path must
    equal the plain path up to ties. Returns the max score difference and
    the kernel path's ms for the tile (CUDA events; host steps inside the
    tile, such as low_memory's row gather, count)."""
    import torch

    with torch.inference_mode():
        k_ids, k_sc = run(True)
        p_ids, p_sc = run(False)
        tile_ms = cuda_time_ms(lambda: run(True), 3)
    ok, err = same_topk(k_ids.cpu().numpy(), k_sc.cpu().numpy(),
                        p_ids.cpu().numpy(), p_sc.cpu().numpy())
    if not ok:
        raise AssertionError(f"{label}: kernel path and plain path differ beyond ties ({err})")
    log(f"# [{label}] kernel path vs plain path on one tile: top-{TOP_K} equal up to ties, "
        f"max score diff {err:.3e}; kernel path {tile_ms:.3f} ms a tile")
    return err, tile_ms


def phase_mutable(dev, index_dir, docs, queries, n_queries, probe_pids, counters, seed):
    """Phase 6: subsets, token scores, get_embeddings, update and delete."""
    import torch

    from fast_plaid_tpu_torch import filtering, native
    from fast_plaid_tpu_torch.index import appender, ivf, storage
    from fast_plaid_tpu_torch.search import FastPlaid, engine, fast_plaid, searcher
    from fast_plaid_tpu_torch.search import update as update_mod

    n_docs = len(docs)
    out: dict = {}
    fp_res = FastPlaid(index_dir, device=str(dev), low_memory=False)
    fp_lm = FastPlaid(index_dir, device=str(dev))
    res_l, lm_l = fp_res.indices[str(dev)], fp_lm.indices[str(dev)]
    if res_l.dev.emb_cache is None or not lm_l.low_memory or lm_l.dev.emb_q4 is None:
        raise AssertionError("phase 6: the two instances are not resident bf16 / low_memory q4")

    # ---- 1. subsets
    cat3 = filtering.where(index_dir, "cat = ?", (3,))
    cat_lt8 = filtering.where(index_dir, "cat < ?", (8,))
    rng = np.random.default_rng(seed + 11)
    per_query = []
    for qi in range(len(queries)):
        ids = set(rng.choice(n_docs, 300, replace=False).tolist())
        if qi >= n_queries:
            own = int(probe_pids[qi - n_queries])
            ids.discard(own)
            ids = [own, *sorted(ids)[:255]]
        else:
            ids = sorted(ids)[:256]
        per_query.append(ids)
    log(f"# [subsets] where('cat = 3'): {len(cat3)} ids; where('cat < 8'): {len(cat_lt8)} "
        f"ids; per-query subsets of {len(per_query[0])} ids")
    if len(cat3) != (n_docs + 12) // 16 or len(cat_lt8) != sum(1 for i in range(n_docs) if i % 16 < 8):
        raise AssertionError("where() counts differ from the metadata written at create")
    set3, set8 = set(cat3), set(cat_lt8)
    sets_q = [set(x) for x in per_query]
    forms = {
        "cat = 3": (cat3, lambda qi: set3),
        "cat < 8": (cat_lt8, lambda qi: set8),
        "per-query 256": (per_query, lambda qi: sets_q[qi]),
    }
    r_pool = N_FULL // 2
    nb = min(256, len(queries))  # one tile
    kw = engine_kwargs(res_l, fp_res.mem_budget)
    kw_lm = engine_kwargs(lm_l, fp_lm.mem_budget)
    subset_res = {}
    for name, (subset, allowed) in forms.items():
        rows = [subset] * nb if isinstance(subset[0], int) else subset[:nb]
        sub_tile = torch.from_numpy(searcher._pad_subsets(rows, n_docs, slice(0, nb))).to(dev)
        direct = sub_tile.shape[1] <= 2 * r_pool
        stage6 = ("maxsim_gather_scores_dedup"
                  if engine.dedup_viable(res_l.dev.emb_cache.shape[0], nb,
                                         sub_tile.shape[1] if direct else r_pool, Q_LEN, DIM)
                  else "maxsim_gather_scores")
        need = (stage6,) if direct else ("segmented_estimate", stage6)
        label = f"subset {name}, resident ({'direct pool' if direct else 'cascade'})"
        r = subset_search(fp_res, label, queries, subset, allowed, n_queries, probe_pids,
                          counters, need)
        tile = torch.from_numpy(queries[:nb].astype(np.float16)).to(dev)
        r["diff"], r["tile_ms"] = compare_tile(label, lambda k: engine.search_impl(
            res_l.dev, tile, sub_tile, use_estimate_kernel=k, use_rerank_kernel=k, **kw))
        subset_res[("resident", name)] = r

        label = f"subset {name}, low_memory (cascade)"
        r = subset_search(fp_lm, label, queries, subset, allowed, n_queries, probe_pids,
                          counters, ("segmented_estimate", "maxsim_q4_gather_scores"))

        def lm_tile(k, tile=tile, sub_tile=sub_tile):
            return lm_steps(lm_l, tile, sub_tile, k, kw_lm)[0][:2]

        r["diff"], r["tile_ms"] = compare_tile(label, lm_tile)
        subset_res[("low_memory", name)] = r
    out["subsets"] = subset_res

    # The subset's probe mask at the largest subset, on one tile of up to 256 queries.
    sub8 = torch.from_numpy(searcher._pad_subsets([cat_lt8] * nb, n_docs, slice(0, nb))).to(dev)
    kp = res_l.dev.centroids.shape[0]
    chunk = max(8, min(sub8.shape[1], fp_res.mem_budget // (24 * nb * res_l.ispec.doc_cap)))
    with torch.inference_mode():
        mask_ms = cuda_time_ms(lambda: engine._allowed_cells_mask(
            res_l.dev, sub8, res_l.ispec, kp, chunk), 5)
        tile = torch.from_numpy(queries[:nb].astype(np.float16)).to(dev)
        tile_ms = cuda_time_ms(lambda: engine.search_impl(
            res_l.dev, tile, sub8, use_estimate_kernel=True, use_rerank_kernel=True, **kw), 5)
    scatters = nb * sub8.shape[1] * res_l.ispec.doc_cap
    log(f"# [subsets] _allowed_cells_mask at S {sub8.shape[1]}, B {nb}, doc_cap "
        f"{res_l.ispec.doc_cap} ({scatters / 1e9:.2f} G scatters, chunk {chunk}): "
        f"{mask_ms:.3f} ms of a {tile_ms:.3f} ms resident tile with that subset")
    out["mask_ms"], out["mask_tile_ms"] = mask_ms, tile_ms

    # ---- 2. token scores of the planted probes, on both instances
    probes = queries[n_queries:]
    kw_api = dict(top_k=TOP_K, n_full_scores=N_FULL, n_ivf_probe=N_PROBE, show_progress=False)
    for label, fp in (("resident", fp_res), ("low_memory", fp_lm)):
        plain = fp.search(probes, **kw_api)
        t0 = time.perf_counter()
        tok = fp.search_token_scores(probes, **kw_api)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        worst = 0.0
        for row_a, row_b in zip(plain, tok):
            if [p for p, _ in row_a] != [p for p, _, _ in row_b]:
                raise AssertionError(f"token scores [{label}]: ids differ from search()")
            for (pid, sa), (_, sb, mat) in zip(row_a, row_b):
                if sa != sb:
                    raise AssertionError(f"token scores [{label}]: score {sb} != search()'s {sa}")
                if mat.shape != (Q_LEN, len(docs[pid])):
                    raise AssertionError(f"token scores [{label}]: matrix {mat.shape} for doc {pid}")
                worst = max(worst, abs(float(mat.max(axis=1).sum()) - sb))
        if worst > 1e-3:
            raise AssertionError(f"token scores [{label}]: MaxSim of the matrix off by {worst}")
        hit1 = float(np.mean([r[0][0] == int(p) for r, p in zip(tok, probe_pids)]))
        if hit1 != 1.0:
            raise AssertionError(f"token scores [{label}]: planted hit@1 {hit1}")
        log(f"# [token scores, {label}] {len(probes)} probes in {dt:.3f} s: ids and scores = "
            f"search()'s, matrices [{Q_LEN}, doc_len], sum of row maxima - score <= "
            f"{worst:.2e}, planted hit@1 {hit1}")

    # ---- 3. get_embeddings on both instances
    ids = [0, n_docs - 1, *np.random.default_rng(seed + 12).choice(n_docs, 510).tolist()]
    t0 = time.perf_counter()
    e_res = fp_res.get_embeddings(ids)
    t_res = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_lm = fp_lm.get_embeddings(ids)
    t_lm = time.perf_counter() - t0
    diff, cos = 0.0, []
    for i, a, b in zip(ids, e_res, e_lm):
        if a.shape != docs[i].shape or b.shape != docs[i].shape:
            raise AssertionError(f"get_embeddings: doc {i} shapes {a.shape} {b.shape}")
        diff = max(diff, float(np.abs(a - b).max()))
        cos.append(np.sum(a * docs[i], axis=-1))
    if diff > 1e-5:
        raise AssertionError(f"get_embeddings: resident and low_memory differ by {diff}")
    log(f"# [get_embeddings] {len(ids)} docs: resident {t_res:.3f} s, low_memory {t_lm:.3f} s, "
        f"max |difference| {diff:.2e}, mean cosine with the original tokens "
        f"{float(np.mean(np.concatenate(cos))):.4f}")
    fp_res.close()
    del fp_res, res_l
    torch.cuda.empty_cache()

    # ---- 4. update on the default constructor
    reloads = timed_reloads(fp_lm)
    sw = Stopwatch([
        (update_mod, "update_metadata_db", "sqlite insert"),
        (update_mod, "_min_dists_sq", "outlier scan"),
        (update_mod, "compute_kmeans", "k-means"),
        (update_mod, "update_index", "append"),
        (appender, "compress_documents", "append: compress"),
        (ivf, "splice_ivf", "append: ivf splice"),
        (fast_plaid, "delete_from_index", "index delete"),
        (filtering, "delete", "sqlite delete"),
    ]).start()
    new_docs, _ = planted_corpus(2050, seed + 1)
    k0 = fp_lm.indices[str(dev)].ispec.n_partitions
    where3 = len(filtering.where(index_dir, "cat = 3"))
    t0 = time.perf_counter()
    fp_lm.update(new_docs[:50], metadata=[meta_row(n_docs + i) for i in range(50)])
    torch.cuda.synchronize()
    out["update50_s"] = time.perf_counter() - t0
    if not os.path.exists(os.path.join(index_dir, "buffer.npy")):
        raise AssertionError("update of 50 documents: no buffer.npy")
    probe_new = np.stack([d[:Q_LEN] for d in new_docs[:50]])
    res = fp_lm.search(probe_new, **kw_api)
    hit = float(np.mean([r[0][0] == n_docs + i for i, r in enumerate(res)]))
    if hit != 1.0:
        raise AssertionError(f"update of 50: planted hit@1 {hit} at the new ids")
    out["update50_parts"] = sw.take()
    log(f"# [update 50] {out['update50_s']:.2f} s (reload {reloads[-1]:.2f} s; seconds in "
        f"{out['update50_parts']}); planted hit@1 {hit} at ids {n_docs}..{n_docs + 49}")
    n_reload = len(reloads)
    t0 = time.perf_counter()
    fp_lm.update(new_docs[50:], metadata=[meta_row(n_docs + i) for i in range(50, 2050)])
    torch.cuda.synchronize()
    out["update2000_s"] = time.perf_counter() - t0
    out["update2000_parts"] = sw.take()
    lm_l = fp_lm.indices[str(dev)]
    k1 = lm_l.ispec.n_partitions
    if os.path.exists(os.path.join(index_dir, "buffer.npy")) or k1 <= k0:
        raise AssertionError(f"update of 2,000: buffer not tripped (K {k0} -> {k1})")
    if lm_l.ispec.n_docs != n_docs + 2050:
        raise AssertionError(f"update: {lm_l.ispec.n_docs} documents")
    pick = np.concatenate([np.arange(50), 50 + np.random.default_rng(seed + 13).choice(
        2000, 206, replace=False)])
    probe_new = np.stack([new_docs[i][:Q_LEN] for i in pick])
    counters.zero()
    res = fp_lm.search(probe_new, **kw_api)
    launches = counters.read()
    hit = float(np.mean([r[0][0] == n_docs + i for i, r in zip(pick, res)]))
    if hit != 1.0 or launches["segmented_estimate"] < 1 or launches["maxsim_q4_gather_scores"] < 1:
        raise AssertionError(f"update of 2,000: planted hit@1 {hit}, launches {launches}")
    grown = len(filtering.where(index_dir, "cat = 3"))
    want3 = where3 + sum(1 for i in range(2050) if (n_docs + i) % 16 == 3)
    if grown != want3:
        raise AssertionError(f"where('cat = 3') after updates: {grown}, expected {want3}")
    log(f"# [update 2000] {out['update2000_s']:.2f} s, the buffer tripped: reloads "
        f"{', '.join(f'{t:.2f}' for t in reloads[n_reload:])} s; seconds in "
        f"{out['update2000_parts']}; K {k0} -> {k1}; planted "
        f"hit@1 {hit} over {len(pick)} new documents (the 50 re-appended among them); "
        f"launches {launches}; where('cat = 3') {where3} -> {grown}")
    out["K"] = (k0, k1)

    # ---- 5. delete every 57th document
    total = n_docs + 2050
    deleted = list(range(0, 57 * min(1000, total // 57), 57))
    gone = set(deleted)
    kept = [i for i in range(total) if i not in gone]
    new_id = {old: new for new, old in enumerate(kept)}
    ivf_calls = native.build_ivf_native.calls
    t0 = time.perf_counter()
    fp_lm.delete(deleted)
    torch.cuda.synchronize()
    out["delete_s"] = time.perf_counter() - t0
    out["delete_ivf_native_calls"] = native.build_ivf_native.calls - ivf_calls
    out["delete_parts"] = sw.take()
    sw.stop()
    lm_l = fp_lm.indices[str(dev)]
    left = total - len(deleted)
    if lm_l.ispec.n_docs != left or storage.load_metadata(index_dir)["num_documents"] != left:
        raise AssertionError(f"delete: {lm_l.ispec.n_docs} documents, expected {left}")

    def doc(old):
        return docs[old] if old < n_docs else new_docs[old - n_docs]

    gone_probe = deleted[::16]
    survivors = [o for o in [int(p) for p in probe_pids] + [n_docs + int(i) for i in pick[:32]]
                 if o not in gone]
    res = fp_lm.search(np.stack([doc(o)[:Q_LEN] for o in gone_probe + survivors]), **kw_api)
    back = {old: new for new, old in enumerate(kept)}
    inverse = dict(enumerate(kept))
    for row in res:
        if any(inverse[p] in gone for p, _ in row):
            raise AssertionError("delete: a deleted document came back")
    hit = float(np.mean([r[0][0] == back[o] for r, o in zip(res[len(gone_probe):], survivors)]))
    if hit != 1.0:
        raise AssertionError(f"delete: planted hit@1 {hit} at the shifted ids")
    want = [new_id[o] for o in kept if o % 16 == 3]
    if filtering.where(index_dir, "cat = 3") != want:
        raise AssertionError("delete: where('cat = 3') not re-sequenced")
    log(f"# [delete {len(deleted)}] {out['delete_s']:.2f} s (reload {reloads[-1]:.2f} s; "
        f"seconds in {out['delete_parts']}); "
        f"{lm_l.ispec.n_docs} documents; {len(gone_probe)} deleted documents' probes never "
        f"return one; planted hit@1 {hit} over {len(survivors)} survivors at their shifted "
        f"ids; where('cat = 3') re-sequenced ({len(want)} ids)")
    out["ivf"] = build_ivf_both("mutated index", lm_l.host_codes, lm_l.host_doc_lengths,
                                lm_l.ispec.n_partitions)
    fp_lm.close()
    torch.cuda.empty_cache()

    # ---- the mutated index reopened resident
    t0 = time.perf_counter()
    fp = FastPlaid(index_dir, device=str(dev), low_memory=False)
    torch.cuda.synchronize()
    out["reopen_s"] = time.perf_counter() - t0
    counters.zero()
    res = fp.search(np.stack([doc(o)[:Q_LEN] for o in survivors]), **kw_api)
    launches = counters.read()
    hit = float(np.mean([r[0][0] == back[o] for r, o in zip(res, survivors)]))
    stage6 = launches["maxsim_gather_scores_dedup"] + launches["maxsim_gather_scores"]
    if hit != 1.0 or stage6 < 1:
        raise AssertionError(f"reopened resident: planted hit@1 {hit}, launches {launches}")
    log(f"# [reopen resident] {out['reopen_s']:.2f} s; planted hit@1 {hit} over "
        f"{len(survivors)} survivors; launches {launches}")
    fp.close()
    out["reloads"] = reloads
    out["probe_q"] = np.stack([doc(o)[:Q_LEN] for o in survivors])
    out["probe_ids"] = [back[o] for o in survivors]
    return out


def phase_long_docs(dev, counters, seed: int, n_docs: int = 4096) -> dict:
    """Phase 7: long documents through the API. 4,096 documents of 1,000 to
    1,030 unit-norm tokens (doc_cap 1,040, as ColPali's ~1,030 patch vectors
    a page), d 128, seeded. The resident instance's stage 6 is the dedup
    kernel (the pool is dedup-viable and its shared memory does not depend on
    doc_cap); the same tile then runs with ``FASTPLAID_RERANK_DEDUP=0``, so
    kernel 2 runs there too. The default constructor's q4 prefilter is
    kernel 3. Each: planted hit@1 1.0, the kernel's counter risen, one
    tile's kernel path = plain path."""
    import torch

    from fast_plaid_tpu_torch.ops.rerank_dedup import dedup_viable
    from fast_plaid_tpu_torch.search import FastPlaid, engine, searcher

    t0 = time.perf_counter()
    docs, rng = planted_corpus(n_docs, seed + 21, lo=1000, hi=1030)
    probe_pids = rng.integers(0, n_docs, 64)
    rand_q = rng.standard_normal((256, Q_LEN, DIM), dtype=np.float32)
    rand_q /= np.linalg.norm(rand_q, axis=-1, keepdims=True)
    queries = np.concatenate([rand_q, np.stack([docs[p][:Q_LEN] for p in probe_pids])])
    index_dir = os.path.join(ROOT, "build", "chip_smoke_long_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    out: dict = {}
    try:
        fp = FastPlaid(index_dir, device=str(dev), low_memory=False)
        fp.create(docs, show_progress=False)
        torch.cuda.synchronize()
        out["create_s"] = time.perf_counter() - t0
        loaded = fp.indices[str(dev)]
        ispec = loaded.ispec
        cap = ispec.doc_cap
        viable = dedup_viable(loaded.dev.emb_cache.shape[0], 256, N_FULL // 2, Q_LEN, DIM)
        log(f"# [long docs] {n_docs} docs, {sum(len(d) for d in docs)} tokens, corpus + "
            f"create {out['create_s']:.2f} s; {ispec}; dedup_viable={viable}")
        if cap != 1040 or not viable:
            raise AssertionError(f"long docs: doc_cap {cap}, viable {viable}")
        kw = engine_kwargs(loaded, fp.mem_budget)
        tile = torch.from_numpy(queries[:256].astype(np.float16)).to(dev)

        def res_tile(k):
            return engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=k,
                                      use_rerank_kernel=k, **kw)

        res = api_search(fp, queries, counters, 256, probe_pids, "long docs, resident",
                         ("maxsim_gather_scores_dedup",), expect_cells=False)
        res["diff"], _ = compare_tile("long docs, resident", res_tile)
        res["tile_ms"] = tile_latency(lambda: res_tile(True), "long docs, resident", n=10)
        with Recorder(engine, "maxsim_gather_scores_dedup") as rec:
            with torch.inference_mode():
                res_tile(True)
        res["dedup"] = check_dedup(*rec.args, "long_docs_main_path_inputs", timing=True)
        out["resident"] = res

        # The same index and tile with the per-query stage 6 (kernel 2).
        os.environ["FASTPLAID_RERANK_DEDUP"] = "0"
        try:
            res = api_search(fp, queries, counters, 256, probe_pids,
                             "long docs, resident, dedup off", ("maxsim_gather_scores",),
                             expect_cells=False)
            res["diff"], _ = compare_tile("long docs, resident, dedup off", res_tile)
            res["tile_ms"] = tile_latency(lambda: res_tile(True),
                                          "long docs, resident, dedup off", n=10)
            with Recorder(engine, "maxsim_gather_scores") as rec:
                with torch.inference_mode():
                    res_tile(True)
            res["rr"] = check_rerank(*rec.args, "long_docs_main_path_inputs", timing=True)
        finally:
            del os.environ["FASTPLAID_RERANK_DEDUP"]
        out["resident_k2"] = res
        fp.close()
        torch.cuda.empty_cache()

        fp = FastPlaid(index_dir, device=str(dev))
        lm = fp.indices[str(dev)]
        if not lm.low_memory or lm.dev.emb_q4 is None:
            raise AssertionError("long docs: the default constructor is not low_memory + q4")
        res = api_search(fp, queries, counters, 256, probe_pids, "long docs, low_memory",
                         ("maxsim_q4_gather_scores",), expect_cells=False)
        kw = engine_kwargs(lm, fp.mem_budget)
        last_pids: list = []

        def lm_tile(k):
            out, host, _ = lm_steps(lm, tile, None, k, kw)
            last_pids[:] = [host]
            return out[:2]

        res["diff"], _ = compare_tile("long docs, low_memory", lm_tile)
        res["tile_ms"] = tile_latency(lambda: lm_tile(True), "long docs, low_memory", n=10)
        with Recorder(engine, "maxsim_q4_gather_scores") as rec:
            with torch.inference_mode():
                lm_tile(True)
        res["q4"] = check_q4(*rec.args, "long_docs_main_path_inputs", timing=True)
        res["gather"] = gather_rows_both([(lm, last_pids[0])], reps=3)
        log_gathers("long docs, low_memory", res["gather"])
        out["low_memory"] = res
        fp.close()
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)
    return out


# The committed JAX run at BEIR shape (the same corpus: colbert_proxy_corpus,
# seed 0, 57,638 docs, doc_len 300, 200 queries; exhaustive top-10 truth).
JAX_BEIR_RESULT = "docs/benchmark/results/quality_parity_beir_shape.json"
# The port may rank no worse than the JAX package on that corpus, by these
# margins below its nDCG@10 (one-sided).
EXACT_NDCG_MARGIN, CASCADE_NDCG_MARGIN = 0.03, 0.05
N_QUALITY_DOCS, N_QUALITY_QUERIES = 57_638, 200


def load_quality_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quality_parity_torch", os.path.join(ROOT, "tools", "quality_parity_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_line(m: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in m.items())


def check_truth_on_card(docs, queries, truth, n: int = 2) -> dict:
    """The card's exhaustive top-10 against the float32 numpy host path on
    the first ``n`` queries. bf16 input rounding moves a score by at most
    ``tol`` (``synthetic.bf16_score_tolerance``: 8-bit significands, 32
    per-token maxima), so a document's two scores agree within ``tol``, and
    a document in only one of the two top-10 lists lies within 2 tol of the
    host's 10th score (each list's 10th score is within tol of the other's)."""
    from fast_plaid_tpu_torch.evaluation.synthetic import (
        bf16_score_tolerance,
        exact_maxsim_topk,
    )

    t0 = time.perf_counter()
    host = exact_maxsim_topk(docs, queries[:n], top_k=100, device="cpu")
    host_s = time.perf_counter() - t0
    tol = bf16_score_tolerance(docs, queries[:n])
    worst = moved = 0
    for qi, (card_row, host_row) in enumerate(zip(truth[:n], host)):
        hs = dict(host_row)
        h10 = host_row[9][1]
        card10 = [p for p, _ in card_row[:10]]
        host10 = [p for p, _ in host_row[:10]]
        for pid, s in card_row[:10]:
            if pid not in hs:
                raise AssertionError(f"truth: query {qi} doc {pid} in the card's top-10, "
                                     "not in the host's top-100")
            worst = max(worst, abs(s - hs[pid]))
        for pid in set(card10) ^ set(host10):
            moved += 1
            if abs(hs[pid] - h10) > 2 * tol:
                raise AssertionError(f"truth: query {qi} doc {pid} (host score {hs[pid]}) "
                                     f"in one top-10 only, beyond 2 x {tol} of {h10}")
    if worst > tol:
        raise AssertionError(f"truth: card score off the host's by {worst} > {tol}")
    log(f"# [quality] truth on the card vs the numpy host path, {n} queries ({host_s:.1f} s "
        f"on the host): max score diff {worst:.3e} (bf16 tolerance {tol:.4f}); "
        f"{moved} top-10 ids in one list only, all within 2 x tol of the 10th score")
    return {"max_diff": worst, "tol": tol, "one_list_only": moved, "host_s": host_s}


def phase_quality(dev, counters, index_dir) -> dict:
    """Phase 11: retrieval quality at BEIR shape through
    ``tools/quality_parity_torch.run``: the JAX package's committed corpus
    (colbert_proxy_corpus, seed 0, 57,638 docs, doc_len 300, 200 queries),
    its exhaustive truth on the card (held against the host on 2 queries),
    ``create``, exact search over ``get_embeddings``, the default
    constructor's cascade at top_k 100 and pool divisors 4, 8, 16, then the
    cascade on a resident reopen (dedup stage 6) with one tile of kernels
    against plain; last the 5,000-document sweeps (divisors 2, 4, 8, 16),
    graded and plain."""
    import torch

    from fast_plaid_tpu_torch.ops.rerank_dedup import dedup_viable
    from fast_plaid_tpu_torch.search import FastPlaid, engine

    tool = load_quality_tool()
    with open(os.path.join(ROOT, JAX_BEIR_RESULT)) as f:
        ref = json.load(f)
    state: dict = {}
    counters.zero()
    t0 = time.perf_counter()
    out = tool.run(N_QUALITY_DOCS, N_QUALITY_QUERIES, DIM, 0, None, generator="colbert_proxy",
                   doc_len=300, sweep_divisors=[4, 8, 16], index_dir=index_dir, state=state)
    run_s = time.perf_counter() - t0
    launches = counters.read()
    docs, queries = state["docs"], state["queries"]
    res = {"out": out, "run_s": run_s, "launches": launches, "n_tokens": state["n_tokens"],
           **state["seconds"]}
    log(f"# [quality] BEIR shape: {len(docs)} docs, {state['n_tokens']} tokens (doc_len 300), "
        f"{len(queries)} queries; corpus {state['seconds']['corpus']:.1f} s, truth on the card "
        f"{state['seconds']['truth']:.2f} s, create {out['timing_s']['index_build']} s, "
        f"get_embeddings + exact {out['timing_s']['exact_decompressed_search']} s, cascade "
        f"{out['timing_s']['cascade_search']} s; run() {run_s:.1f} s; launches {launches}")
    for name in ("segmented_estimate", "maxsim_q4_gather_scores"):
        if launches[name] < 1:
            raise AssertionError(f"quality, default constructor: {name} was not launched")
    res["truth_check"] = check_truth_on_card(docs, queries, state["truth"])

    # The same cascade on a resident reopen: stage 6 is the dedup kernel.
    fp = FastPlaid(index_dir, device=str(dev), low_memory=False)
    loaded = fp.indices[str(dev)]
    viable = dedup_viable(loaded.dev.emb_cache.shape[0], 256, N_FULL // 2, Q_LEN, DIM)
    log(f"# [quality] resident reopen: {loaded.ispec}; emb_cache "
        f"{tuple(loaded.dev.emb_cache.shape)}; dedup_viable={viable}")
    if not viable:
        raise AssertionError("quality, resident: dedup_viable does not hold")
    counters.zero()
    t0 = time.perf_counter()
    rows = fp.search(queries, top_k=100, show_progress=False)
    res["resident_s"] = time.perf_counter() - t0
    res["launches_resident"] = counters.read()
    for name in ("segmented_estimate", "maxsim_gather_scores_dedup"):
        if res["launches_resident"][name] < 1:
            raise AssertionError(f"quality, resident: {name} was not launched")
    res["cascade_resident"] = tool.score(rows, state["qrels"], state["qids"])
    kw = engine_kwargs(loaded, fp.mem_budget)
    tile = torch.from_numpy(
        np.concatenate([queries, queries[: 256 - len(queries)]]).astype(np.float16)).to(dev)

    def run_tile(k):
        return engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=k,
                                  use_rerank_kernel=k, **kw)

    res["tile_diff"], res["tile_ms"] = compare_tile("quality, resident", run_tile)
    fp.close()

    for label, got, jax_key in (("exact_decompressed", out["exact_decompressed"], "exact_decompressed"),
                                ("cascade_default (low_memory + q4)", out["cascade_default"],
                                 "cascade_default"),
                                ("cascade resident (dedup)", res["cascade_resident"],
                                 "cascade_default")):
        log(f"# [quality] {label}: {metrics_line(got)} | JAX package, committed "
            f"({jax_key}): {metrics_line(ref[jax_key])}")
    for div, m in out["pool_divisor_sweep"].items():
        log(f"# [quality] pool divisor {div}: {metrics_line({k: m[k] for k in tool.METRICS})}, "
            f"{m['cascade_search_s']} s | JAX package: "
            f"{metrics_line({k: ref['pool_divisor_sweep'][div][k] for k in tool.METRICS})}")
    limits = (("exact_decompressed", out["exact_decompressed"], "exact_decompressed",
               EXACT_NDCG_MARGIN),
              ("cascade_default", out["cascade_default"], "cascade_default",
               CASCADE_NDCG_MARGIN),
              ("cascade resident", res["cascade_resident"], "cascade_default",
               CASCADE_NDCG_MARGIN))
    for label, got, jax_key, margin in limits:
        floor = ref[jax_key]["ndcg@10"] - margin
        if got["ndcg@10"] < floor:
            raise AssertionError(f"quality: {label} nDCG@10 {got['ndcg@10']:.4f} below the JAX "
                                 f"package's {ref[jax_key]['ndcg@10']:.4f} - {margin}")

    # The 5,000-document sweeps: graded qrels (relevance 5..1) and the plain
    # proxy against its exhaustive truth (the protocol of SCALE.md's cells).
    res["small"] = {}
    for generator in ("colbert_proxy_graded", "colbert_proxy"):
        t0 = time.perf_counter()
        small = tool.run(5000, N_QUALITY_QUERIES, DIM, 0, None, generator=generator,
                         sweep_divisors=[2, 4, 8, 16])
        small["run_s"] = time.perf_counter() - t0
        res["small"][generator] = small
        log(f"# [quality] {generator}, 5,000 docs ({small['run_s']:.1f} s): exact_raw "
            f"{small['exact_raw'] and metrics_line(small['exact_raw'])}; exact_decompressed "
            f"{metrics_line(small['exact_decompressed'])}; cascade "
            f"{metrics_line(small['cascade_default'])}")
        for div, m in small["pool_divisor_sweep"].items():
            log(f"# [quality] {generator}, 5,000 docs, divisor {div}: "
                f"{metrics_line({k: m[k] for k in tool.METRICS})}, gap vs exact "
                f"{m['ndcg10_gap_vs_exact_decompressed']}")
    res["queries"] = queries
    return res


def http_json(base: str, path: str, payload: dict | None = None):
    """GET (payload None) or POST JSON; any 4xx or 5xx raises."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        return json.loads(body) if r.headers["Content-Type"] == "application/json" else body.decode()


def same_rows(label, got_rows, want_rows) -> float:
    """Server rows ({id, score} dicts) against FastPlaid.search rows, up to ties."""
    worst = 0.0
    for qi, (g, w) in enumerate(zip(got_rows, want_rows)):
        if len(g) != len(w):
            raise AssertionError(f"{label}: query {qi} has {len(g)} results, search {len(w)}")
        if not g:
            continue
        ok, err = same_topk(np.asarray([[h["id"] for h in g]]), np.asarray([[h["score"] for h in g]]),
                            np.asarray([[p for p, _ in w]]), np.asarray([[s for _, s in w]]))
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"{label}: query {qi} differs from FastPlaid.search beyond ties")
    return worst


def http_clients(base: str, queries, n_threads: int) -> list:
    """One single-query JSON request a query from ``n_threads`` threads;
    returns (result row, seconds) a query."""

    def one(i):
        t = time.perf_counter()
        rows = http_json(base, "/v1/search", {"queries": [queries[i].tolist()], "top_k": TOP_K})
        return rows["results"][0], time.perf_counter() - t

    with ThreadPoolExecutor(n_threads) as pool:
        return list(pool.map(one, range(len(queries))))


def engine_batch_ms(engine, queries, kw, sizes=(1, 8, 32, 200)) -> dict:
    """``FastPlaid.search`` alone at each batch size: median ms of 3."""
    out = {}
    for n in sizes:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.search(queries[:n], **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        out[n] = float(np.median(times))
    return out


def phase_server(counters, index_dir, queries, seed: int) -> dict:
    """Phase 12: ``serving.make_server(index, port=0)`` over the phase-11 index
    opened as the CLI opens it (the default constructor, every CUDA device),
    on a thread. Traffic: /healthz; the 200 BEIR-shape queries as 200
    single-query JSON requests from 32 client threads; the same 200 in one b64
    request; a subset request; /metrics; /v1/update of 50 documents and
    /v1/delete of them, each followed by a search that shows the membership."""
    import base64
    import threading

    from fast_plaid_tpu_torch import serving
    from fast_plaid_tpu_torch.index import ivf
    from fast_plaid_tpu_torch.search import fast_plaid
    from fast_plaid_tpu_torch.search import update as update_mod

    t0 = time.perf_counter()
    httpd, core = serving.make_server(index_dir, port=0)
    open_s = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    res: dict = {"open_s": open_s}
    try:
        health = http_json(base, "/healthz")
        n_docs = health["n_docs"]
        log(f"# [server] opened in {open_s:.2f} s on {health['devices']}: {health}")
        if health["status"] != "ok" or n_docs != N_QUALITY_DOCS or not core.engine.low_memory:
            raise AssertionError(f"server: unexpected health {health}")
        kw = dict(top_k=TOP_K, show_progress=False)
        want = core.engine.search(queries, **kw)  # the reference, and a warm-up
        res["engine_ms"] = engine_batch_ms(core.engine, queries, kw)
        log(f"# [server] FastPlaid.search alone, ms by batch size (median of 3): "
            f"{res['engine_ms']}")

        # The clients run in a process of their own, as a deployment's would:
        # 32 client threads in the server's process would hold its GIL.
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as clients:
            clients.submit(http_json, base, "/healthz").result()  # the process is up
            counters.zero()
            t0 = time.perf_counter()
            answers = clients.submit(http_clients, base, queries, 32).result()
            wall = time.perf_counter() - t0
        res["launches"] = counters.read()
        lat_ms = np.asarray([a[1] for a in answers]) * 1e3
        res["single"] = {"requests": len(queries), "wall_s": wall, "rps": len(queries) / wall,
                         "p50_ms": float(np.percentile(lat_ms, 50)),
                         "p99_ms": float(np.percentile(lat_ms, 99))}
        res["single"]["diff"] = same_rows("server, single-query JSON", [a[0] for a in answers], want)
        stats = core.batcher.stats.snapshot()
        res["single"]["stats"] = stats
        log(f"# [server] {len(queries)} single-query JSON requests from 32 threads in {wall:.3f} s "
            f"= {res['single']['rps']:.1f} requests/s (= queries/s); request latency p50 "
            f"{res['single']['p50_ms']:.2f} ms, p99 {res['single']['p99_ms']:.2f} ms; "
            f"{stats['dispatches']} dispatches, mean batch {stats['avg_batch']}, merged "
            f"{stats['merged_batches']}; equal to FastPlaid.search up to ties (max diff "
            f"{res['single']['diff']:.2e}); launches {res['launches']}")
        for name in ("segmented_estimate", "maxsim_q4_gather_scores"):
            if res["launches"][name] < 1:
                raise AssertionError(f"server: {name} was not launched")
        if stats["merged_batches"] < 1 or stats["dispatches"] >= stats["requests"]:
            raise AssertionError(f"server: no coalescing: {stats}")

        b64 = {"queries_b64": base64.b64encode(queries.astype(np.float32).tobytes()).decode(),
               "shape": list(queries.shape), "top_k": TOP_K}
        t0 = time.perf_counter()
        rows = http_json(base, "/v1/search", b64)["results"]
        b64_s = time.perf_counter() - t0
        res["b64"] = {"s": b64_s, "qps": len(queries) / b64_s,
                      "diff": same_rows("server, b64", rows, want)}
        log(f"# [server] one b64 request of {len(queries)} queries: {b64_s * 1e3:.1f} ms = "
            f"{res['b64']['qps']:.1f} queries/s; equal to FastPlaid.search up to ties")

        rng = np.random.default_rng(seed + 12)
        allowed = sorted({int(p) for p in rng.choice(n_docs, min(2000, n_docs // 4), replace=False)}
                         | {w[0][0] for w in want[:8]})
        sub = {"queries": queries[:8].tolist(), "top_k": TOP_K, "subset": [allowed] * 8}
        rows = http_json(base, "/v1/search", sub)["results"]
        if any(h["id"] not in set(allowed) for r in rows for h in r):
            raise AssertionError("server: a subset search returned an id outside the subset")
        same_rows("server, subset", rows, core.engine.search(queries[:8], subset=[allowed] * 8, **kw))
        kept = sum(r[0]["id"] == w[0][0] for r, w in zip(rows, want[:8]))
        log(f"# [server] subset request (8 queries, {len(allowed)} ids each, holding each "
            f"query's unfiltered top-1): inside the subset, equal to FastPlaid.search up to "
            f"ties; unfiltered top-1 kept for {kept} of 8")

        text = http_json(base, "/metrics")
        n_req = len(queries) + 2
        for needle in (f"fastplaid_requests_total {n_req}", 'le="+Inf"} ' + str(n_req),
                       'fastplaid_lane_requests_total{lane="interactive"}'):
            if needle not in text:
                raise AssertionError(f"server: /metrics lacks {needle!r}")
        log(f"# [server] /metrics: {len(text.splitlines())} lines, {n_req} requests counted")

        new = corpus_of_lengths(np.full(50, 200), rng)
        flat = np.concatenate(new)
        sw = Stopwatch([
            (update_mod, "update_index", "append"),
            (fast_plaid, "delete_from_index", "index delete"),
            (ivf, "build_ivf", "index delete: build_ivf"),
            (fast_plaid, "reload_index", "reload"),
        ]).start()
        t0 = time.perf_counter()
        up = http_json(base, "/v1/update", {
            "documents_b64": base64.b64encode(flat.tobytes()).decode(), "dim": DIM,
            "lengths": [len(d) for d in new]})
        res["update_s"] = time.perf_counter() - t0
        res["update_parts"] = sw.take()
        probes = np.stack([d[:Q_LEN] for d in new])
        hits = http_json(base, "/v1/search", {"queries": probes.tolist(), "top_k": TOP_K})["results"]
        if up["n_docs"] != n_docs + 50 or [r[0]["id"] for r in hits] != list(range(n_docs, n_docs + 50)):
            raise AssertionError(f"server: after /v1/update {up}, probes top-1 "
                                 f"{[r[0]['id'] for r in hits][:8]}")
        t0 = time.perf_counter()
        gone = http_json(base, "/v1/delete", {"subset": list(range(n_docs, n_docs + 50))})
        res["delete_s"] = time.perf_counter() - t0
        res["delete_parts"] = sw.take()
        sw.stop()
        hits = http_json(base, "/v1/search", {"queries": probes.tolist(), "top_k": TOP_K})["results"]
        if gone["n_docs"] != n_docs or any(h["id"] >= n_docs for r in hits for h in r):
            raise AssertionError(f"server: after /v1/delete {gone}, an added id came back")
        log(f"# [server] /v1/update of 50 docs {res['update_s']:.2f} s (their probes top-1 at ids "
            f"{n_docs}..{n_docs + 49}), /v1/delete of them {res['delete_s']:.2f} s (n_docs "
            f"{gone['n_docs']}, none returned); seconds by step: update "
            f"{res['update_parts']}, delete {res['delete_parts']}")
        res["stats"] = core.batcher.stats.snapshot()
    finally:
        httpd.shutdown()
        core.close()
        thread.join(timeout=30)
    return res


# Phase 14: colbert-ir/colbertv2.0 at full width (https://huggingface.co/
# colbert-ir/colbertv2.0, config.json): a bert-base-uncased encoder, a 768 -> 128
# linear head, ColBERT's doc_maxlen 180 and query_maxlen 32. Random weights from
# a seed (neither machine holds the checkpoint); bert-base-uncased's [CLS] and
# [SEP] ids and ColBERT's [Q] / [D] markers ([unused0] / [unused1]).
COLBERT_V2 = {
    "architectures": ["HF_ColBERT"], "model_type": "bert", "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "vocab_size": 30522, "max_position_embeddings": 512,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}
COLBERT_DIM, DOC_MAXLEN, QUERY_MAXLEN = 128, 180, 32
CLS_ID, SEP_ID, Q_MARKER, D_MARKER = 101, 102, 1, 2
N_ENC_DOCS, N_ENC_QUERIES, N_ENC_PLANTED = 16_384, 1_024, 64
BF16_MIN_COS = 0.99  # token cosine of the bf16 forward to the float32 one (jax_encoder.py)
HIT1_SLACK = 0.02  # the cascade's planted hit@1 may trail exhaustive MaxSim's by this


def write_random_colbert(path: str, seed: int) -> int:
    """colbertv2.0-shaped weights in HF names (``bert.`` scope, ``linear.weight``)
    as ``pytorch_model.bin`` + ``config.json``: std 0.02 normal matrices,
    LayerNorm gains 1, biases 0. Returns the parameter count."""
    import torch

    rng = np.random.default_rng(seed)
    h, inter = COLBERT_V2["hidden_size"], COLBERT_V2["intermediate_size"]

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02))

    def linear(name, n_in, n_out):
        state[f"{name}.weight"] = normal(n_out, n_in)  # HF stores [out, in]
        state[f"{name}.bias"] = torch.zeros(n_out)

    def ln(name):
        state[f"{name}.weight"], state[f"{name}.bias"] = torch.ones(h), torch.zeros(h)

    state: dict = {
        "bert.embeddings.word_embeddings.weight": normal(COLBERT_V2["vocab_size"], h),
        "bert.embeddings.position_embeddings.weight": normal(
            COLBERT_V2["max_position_embeddings"], h),
        "bert.embeddings.token_type_embeddings.weight": normal(COLBERT_V2["type_vocab_size"], h),
    }
    ln("bert.embeddings.LayerNorm")
    for i in range(COLBERT_V2["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for part in ("query", "key", "value"):
            linear(f"{p}.attention.self.{part}", h, h)
        linear(f"{p}.attention.output.dense", h, h)
        ln(f"{p}.attention.output.LayerNorm")
        linear(f"{p}.intermediate.dense", h, inter)
        linear(f"{p}.output.dense", inter, h)
        ln(f"{p}.output.LayerNorm")
    state["linear.weight"] = normal(COLBERT_DIM, h)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(COLBERT_V2, f)
    return sum(t.numel() for t in state.values())


def encoder_flops(lens) -> float:
    """Operations (2 a multiply-add) of the forward on real tokens: the dense
    products, both attention products over each sequence's own length, the
    head. Padding is not counted."""
    h, inter, n_layers = 768, 3072, 12
    n = np.asarray(lens, np.float64)
    dense = 2.0 * (4 * h * h + 2 * h * inter) * n_layers * n.sum()
    attention = 2.0 * 2 * h * n_layers * float((n * n).sum())
    return dense + attention + 2.0 * h * COLBERT_DIM * n.sum()


def forward_check(enc, seqs) -> dict:
    """The card's bf16 forward against the float32 forward of the same module
    on the same padded batch (TF32 off): token cosines over real tokens."""
    import torch

    from fast_plaid_tpu_torch.models import bert_forward

    sl = max(len(x) for x in seqs)
    ids = torch.zeros((len(seqs), sl), dtype=torch.long)
    mask = torch.zeros((len(seqs), sl), dtype=torch.long)
    for i, x in enumerate(seqs):
        ids[i, : len(x)], mask[i, : len(x)] = torch.as_tensor(x), 1
    ids, mask = ids.to(enc.device), mask.to(enc.device)
    keep = mask.bool()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            bf16 = bert_forward(enc.model, ids, mask)[keep]
            f32 = bert_forward(enc.model, ids, mask, compute_dtype=torch.float32)[keep]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cos = (bf16 * f32).sum(-1).cpu().numpy()
    if not np.isfinite(cos).all():
        raise AssertionError("encoder: non-finite token vectors")
    out = {"min_cos": float(cos.min()), "mean_cos": float(cos.mean()), "tokens": int(cos.size)}
    log(f"# [encoder] bf16 forward vs float32 forward, {len(seqs)} sequences, {cos.size} "
        f"tokens: token cosine min {out['min_cos']:.6f}, mean {out['mean_cos']:.6f} "
        f"(bound {BF16_MIN_COS})")
    if out["min_cos"] < BF16_MIN_COS:
        raise AssertionError(f"encoder: bf16 min token cosine {out['min_cos']} < {BF16_MIN_COS}")
    return out


def recall_at_k(ids, truth_ids) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b)) / TOP_K for a, b in zip(ids, truth_ids)]))


def phase_encoder(dev, counters, seed: int) -> dict:
    """Phase 14: text-free encode -> create -> search at colbertv2.0 width.
    The weights are written as an HF checkpoint and loaded back through the
    port's loader (no ``safetensors`` or ``transformers``); 16,384 seeded
    documents of 64-180 ids, 1,024 random queries of 32 ids and 64 planted
    ones (the forward of a document's first 32 ids) are encoded on the card;
    ``FastPlaid(device="cuda").create`` indexes them; the default constructor
    (kernels 1 and 3, the native host gather) and a resident reopen (kernels
    1 and 4 where ``dedup_viable``) search them, each held to its plain path
    on one tile and its planted hit@1 to exhaustive MaxSim's."""
    import torch

    from fast_plaid_tpu_torch import native
    from fast_plaid_tpu_torch.evaluation.synthetic import exact_maxsim_topk
    from fast_plaid_tpu_torch.models import TorchColbertEncoder, torch_encoder
    from fast_plaid_tpu_torch.ops.rerank_dedup import dedup_viable
    from fast_plaid_tpu_torch.search import FastPlaid, engine, searcher

    work = os.path.join(ROOT, "build", "chip_smoke_encoder")
    shutil.rmtree(work, ignore_errors=True)
    ckpt = os.path.join(work, "colbertv2_random")
    os.makedirs(ckpt)
    out: dict = {}
    try:
        t0 = time.perf_counter()
        n_params = write_random_colbert(ckpt, seed + 14)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc = TorchColbertEncoder(ckpt, max_length=DOC_MAXLEN, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        log(f"# [encoder] colbertv2.0 shape, {n_params} random parameters: checkpoint written in "
            f"{out['write_s']:.2f} s, loaded onto {enc.device} in {out['load_s']:.2f} s; "
            f"products bf16 in, float32 out via "
            f"{'torch.mm/bmm(out_dtype=float32)' if torch_encoder.F32_OUT else 'a cast of the bf16 result'}")

        rng = np.random.default_rng(seed + 15)
        vocab = COLBERT_V2["vocab_size"]
        lens = rng.integers(64, DOC_MAXLEN + 1, N_ENC_DOCS)
        docs = [np.concatenate([[CLS_ID, D_MARKER], rng.integers(1000, vocab, n - 3), [SEP_ID]])
                for n in lens]
        planted = rng.choice(N_ENC_DOCS, N_ENC_PLANTED, replace=False)
        queries = [np.concatenate([[CLS_ID, Q_MARKER], rng.integers(1000, vocab, QUERY_MAXLEN - 3),
                                   [SEP_ID]]) for _ in range(N_ENC_QUERIES)]
        queries += [docs[p][:QUERY_MAXLEN] for p in planted]

        enc.encode_ids(docs[:256], batch_size=256)  # warm-up: cuBLAS plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        doc_embs = enc.encode_ids(docs, batch_size=256)
        out["encode_s"] = time.perf_counter() - t0
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["tokens"] = int(lens.sum())
        out["tokens_per_s"] = out["tokens"] / out["encode_s"]
        out["tflops"] = encoder_flops(lens) / out["encode_s"] / 1e12
        out["peak_share"] = out["tflops"] * 1e12 / BF16_OPS
        q_embs = np.stack(enc.encode_ids(queries, batch_size=256))
        if q_embs.shape != (len(queries), QUERY_MAXLEN, COLBERT_DIM) or any(
                e.shape != (n, COLBERT_DIM) for e, n in zip(doc_embs, lens)):
            raise AssertionError("encoder: embeddings of the wrong shape")
        norms = np.linalg.norm(doc_embs[0], axis=-1)
        if not (np.isfinite(q_embs).all() and np.allclose(norms, 1.0, atol=1e-4)):
            raise AssertionError("encoder: non-finite or non-unit vectors")
        log(f"# [encoder] {N_ENC_DOCS} documents, {out['tokens']} tokens in "
            f"{out['encode_s']:.2f} s: {out['tokens_per_s']:.0f} tokens/s, "
            f"{out['tflops']:.1f} TFLOP/s of bf16 forward on real tokens = "
            f"{100 * out['peak_share']:.1f}% of the {BF16_OPS / 1e12:.0f} TFLOP/s peak; peak "
            f"memory {out['peak_gb']:.2f} GB; then {len(queries)} queries of {QUERY_MAXLEN} ids")
        device_profile(lambda: enc.encode_ids(docs[:256], batch_size=256),
                       "encoder, one batch of 256 documents", top=16)
        out["check"] = forward_check(enc, docs[:8] + queries[:4] + queries[-4:])
        del enc
        torch.cuda.empty_cache()

        index_dir = os.path.join(work, "index")
        t0 = time.perf_counter()
        fp = FastPlaid(index=index_dir, device="cuda")
        fp.create(documents_embeddings=doc_embs, show_progress=False)
        torch.cuda.synchronize()
        out["create_s"] = time.perf_counter() - t0
        loaded = fp.indices[str(dev)]
        log(f"# [encoded index] create {out['create_s']:.2f} s: {loaded.ispec}")

        t0 = time.perf_counter()
        truth = exact_maxsim_topk(doc_embs, q_embs, TOP_K, device=dev)
        out["truth_s"] = time.perf_counter() - t0
        truth_ids = [[p for p, _ in r] for r in truth[:N_ENC_QUERIES]]
        out["exact_hit1"] = float(np.mean(
            [truth[N_ENC_QUERIES + i][0][0] == int(p) for i, p in enumerate(planted)]))
        log(f"# [encoded index] exhaustive MaxSim on the card: {out['truth_s']:.2f} s, planted "
            f"hit@1 {out['exact_hit1']:.4f}")

        def held(label, res):
            res["recall10"] = recall_at_k(res["ids"][:N_ENC_QUERIES], truth_ids)
            log(f"# [{label}] planted hit@1 {res['hit1']:.4f} (exhaustive "
                f"{out['exact_hit1']:.4f}); recall@{TOP_K} against the exhaustive top-{TOP_K} "
                f"over {N_ENC_QUERIES} random queries {res['recall10']:.4f}")
            if res["hit1"] < out["exact_hit1"] - HIT1_SLACK:
                raise AssertionError(f"{label}: planted hit@1 {res['hit1']} more than "
                                     f"{HIT1_SLACK} below exhaustive {out['exact_hit1']}")

        # The default constructor: low_memory + q4 prefilter, the native gather.
        if not loaded.low_memory or loaded.dev.emb_q4 is None:
            raise AssertionError("encoded index: the default constructor is not low_memory + q4")
        res = api_search(fp, q_embs, counters, N_ENC_QUERIES, planted,
                         "encoded, default constructor",
                         ("segmented_estimate", "maxsim_q4_gather_scores"),
                         expect_cells=False, min_hit1=0.0)
        if not native.AVAILABLE or res["native_calls"]["gather_windows_u8"] < 1:
            raise AssertionError("encoded, default constructor: the native host gather did "
                                 f"not run (AVAILABLE {native.AVAILABLE})")
        held("encoded, default constructor", res)
        kw = engine_kwargs(loaded, fp.mem_budget)
        tile = torch.from_numpy(q_embs[:256].astype(np.float16)).to(dev)
        last_pids: list = []

        def lm_tile(k):
            out, host, _ = lm_steps(loaded, tile, None, k, kw)
            last_pids[:] = [host]
            return out[:2]

        res["diff"], _ = compare_tile("encoded, default constructor", lm_tile)
        res["tile_ms"] = tile_latency(lambda: lm_tile(True), "encoded, default constructor",
                                      n=10)
        res["gather"] = gather_rows_both([(loaded, last_pids[0])])
        log_gathers("encoded, default constructor", res["gather"])
        out["default"] = res
        fp.close()
        del fp, loaded
        torch.cuda.empty_cache()

        # Reopened resident: the bf16 cache, stage 6 the dedup kernel where viable.
        fp = FastPlaid(index=index_dir, device=str(dev), low_memory=False)
        loaded = fp.indices[str(dev)]
        if loaded.dev.emb_cache is None:
            raise AssertionError("encoded index: the bf16 cache is not resident")
        viable = dedup_viable(loaded.dev.emb_cache.shape[0], 256, N_FULL // 2, Q_LEN,
                              COLBERT_DIM)
        stage6 = "maxsim_gather_scores_dedup" if viable else "maxsim_gather_scores"
        log(f"# [encoded, resident] emb_cache {tuple(loaded.dev.emb_cache.shape)}; "
            f"dedup_viable={viable}")
        res = api_search(fp, q_embs, counters, N_ENC_QUERIES, planted, "encoded, resident",
                         ("segmented_estimate", stage6), expect_cells=False, min_hit1=0.0)
        held("encoded, resident", res)
        kw = engine_kwargs(loaded, fp.mem_budget)

        def res_tile(k):
            return engine.search_impl(loaded.dev, tile, None, use_estimate_kernel=k,
                                      use_rerank_kernel=k, **kw)

        res["diff"], _ = compare_tile("encoded, resident", res_tile)
        res["tile_ms"] = tile_latency(lambda: res_tile(True), "encoded, resident", n=10)
        res["stage6"] = stage6
        out["resident"] = res
        fp.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=57_638)
    ap.add_argument("--n-queries", type=int, default=1280)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available; nothing to check")
    t_start = time.perf_counter()

    def phase_done(name: str) -> None:
        log(f"# phase {name} done at {time.perf_counter() - t_start:.1f} s")

    # A tile whose device work raised (a failed kernel launch included) is
    # contained by the searcher as empty results and a warning: fail instead.
    warnings.filterwarnings("error", message="search failed", category=RuntimeWarning)
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
        if any(k in line for k in ("Compiling entry", "registers", "smem", "spill")):
            log(f"# ptxas: {line.strip()}")
    lib = _build.load_library()
    log(f"# dynamic shared memory a block (D {DIM}, Q {Q_LEN}; any doc_cap): kernel 2 "
        f"{lib.fp_maxsim_gather_smem_bytes(DIM, Q_LEN)} B, kernel 3 "
        f"{lib.fp_maxsim_q4_gather_smem_bytes(DIM, Q_LEN)} B, kernel 4 "
        f"{lib.fp_maxsim_dedup_smem_bytes(DIM, Q_LEN)} B")
    log(f"# kernels built in {build_s:.2f} s: {info['path']}")

    phase_kernels(dev, args.n_docs)
    torch.cuda.empty_cache()
    phase_done("2")

    t0 = time.perf_counter()
    docs, rng = planted_corpus(args.n_docs, args.seed)
    probe_rng = np.random.default_rng(7)
    probe_pids = probe_rng.integers(0, args.n_docs, 64)
    probes = np.stack([docs[p][:Q_LEN] for p in probe_pids])
    rand_q = rng.standard_normal((args.n_queries, Q_LEN, DIM), dtype=np.float32)
    rand_q /= np.linalg.norm(rand_q, axis=-1, keepdims=True)
    queries = np.concatenate([rand_q, probes])
    log(f"# corpus: {args.n_docs} docs, {sum(len(d) for d in docs)} tokens in "
        f"{time.perf_counter() - t0:.1f} s")

    counters = Counters()
    index_dir = os.path.join(ROOT, "build", "chip_smoke_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    try:
        main_res, k2_res, tok_res = phase_resident(dev, index_dir, docs, queries,
                                                   args.n_queries, probe_pids, counters,
                                                   args.seed)
        torch.cuda.empty_cache()
        phase_done("3")
        lm_res = phase_low_memory(dev, index_dir, queries, args.n_queries, probe_pids,
                                  counters, main_res["ids"])
        torch.cuda.empty_cache()
        phase_done("4")
        q4_res = phase_q4_tier(dev, index_dir, main_res["ispec"], queries,
                               args.n_queries, probe_pids, counters)
        torch.cuda.empty_cache()
        phase_done("5")
        mut_res = phase_mutable(dev, index_dir, docs, queries, args.n_queries, probe_pids,
                                counters, args.seed)
        torch.cuda.empty_cache()
        phase_done("6")
        disk_res = phase_sharded_disk(dev, counters, index_dir, queries, mut_res["probe_q"],
                                      mut_res["probe_ids"])
        phase_done("13b")
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    dbuild_res = phase_device_build(dev, docs, queries, args.n_queries, probe_pids, counters,
                                    main_res)
    del docs
    torch.cuda.empty_cache()
    phase_done("10a")
    long_res = phase_long_docs(dev, counters, args.seed)
    torch.cuda.empty_cache()
    phase_done("7")
    skew_res = phase_skewed(dev, counters, args.seed)
    torch.cuda.empty_cache()
    phase_done("8")
    stream_res = phase_streaming(dev, counters, args.seed)
    phase_done("10b")
    shard_res = phase_sharded(dev, counters, stream_res.pop("shared"), stream_res)
    torch.cuda.empty_cache()
    phase_done("13a")
    quality_dir = os.path.join(ROOT, "build", "chip_smoke_quality_index")
    shutil.rmtree(quality_dir, ignore_errors=True)
    try:
        quality_res = phase_quality(dev, counters, quality_dir)
        torch.cuda.empty_cache()
        phase_done("11")
        server_res = phase_server(counters, quality_dir, quality_res["queries"], args.seed)
        phase_done("12")
    finally:
        shutil.rmtree(quality_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    enc_res = phase_encoder(dev, counters, args.seed)
    phase_done("14")

    for label, r in (("resident (dedup stage 6)", main_res),
                     ("resident, dedup off (per-query stage 6)", k2_res),
                     ("low_memory + q4 prefilter (default constructor)", lm_res),
                     ("resident q4 tier (forced budget)", q4_res)):
        log(f"# summary [{label}]: {r['qps']:.1f} API QPS (top_k {TOP_K}, 256-query "
            f"tiles), tile p50/p99 {r['tile_ms'][0]:.3f}/{r['tile_ms'][1]:.3f} ms, "
            f"planted hit@1 {r['hit1']}, on {smi}")
    for label, r in (("long docs, resident (dedup stage 6)", long_res["resident"]),
                     ("long docs, resident, dedup off (kernel 2 stage 6)",
                      long_res["resident_k2"]),
                     ("long docs, low_memory + q4 prefilter", long_res["low_memory"])):
        log(f"# summary [{label}]: {r['qps']:.1f} API QPS, tile p50/p99 "
            f"{r['tile_ms'][0]:.3f}/{r['tile_ms'][1]:.3f} ms, planted hit@1 {r['hit1']}, "
            f"kernel = plain up to ties (max diff {r['diff']:.2e}), on {smi}")
    for (path, name), r in mut_res["subsets"].items():
        log(f"# summary [subset {name}, {path}]: {r['qps']:.1f} API QPS ({r['s']:.3f} s, host "
            f"subset preparation {r['prep_s']:.3f} s), one tile {r['tile_ms']:.3f} ms, planted "
            f"hit@1 {r['hit1']}, kernel = plain up to ties (max diff {r['diff']:.2e}), on {smi}")
    log(f"# summary [mutable index]: update of 50 {mut_res['update50_s']:.2f} s, update of "
        f"2,000 (buffer trip, K {mut_res['K'][0]} -> {mut_res['K'][1]}) "
        f"{mut_res['update2000_s']:.2f} s, delete of 1,000 {mut_res['delete_s']:.2f} s, "
        f"reloads {', '.join(f'{t:.2f}' for t in mut_res['reloads'])} s, resident reopen "
        f"{mut_res['reopen_s']:.2f} s; subset mask {mut_res['mask_ms']:.3f} ms of a "
        f"{mut_res['mask_tile_ms']:.3f} ms tile, on {smi}")
    for op in ("update50", "update2000", "delete"):
        log(f"# summary [{op} seconds by step]: {mut_res[op + '_parts']}")
    for label, r in (("skewed, bucketed (dedup stage 6 a bucket)", skew_res["bucketed"]),
                     ("skewed, bucketed, dedup off (kernel 2 a bucket)", skew_res["bucketed_k2"]),
                     ("skewed, one cap (default budget)", skew_res["one_cap"]),
                     ("skewed, q4 tier (budget of the q4 cache)", skew_res["q4_tier"]),
                     ("streaming index, 522,931 docs (kernel 2 stage 6)", stream_res)):
        log(f"# summary [{label}]: {r['qps']:.1f} API QPS, tile p50/p99 "
            f"{r['tile_ms'][0]:.3f}/{r['tile_ms'][1]:.3f} ms, planted hit@1 {r['hit1']}, "
            f"kernel = plain up to ties (max diff {r['diff']:.2e}), on {smi}")
    log(f"# summary [skewed]: quota drops in one tile {skew_res['bucketed']['quota_drops']}, "
        f"corpus + create {skew_res['create_s']:.2f} s, on {smi}")
    log(f"# summary [tokens]: {tok_res['qps']:.1f} API QPS over 320 queries, tile p50/p99 "
        f"{tok_res['tile_ms'][0]:.3f}/{tok_res['tile_ms'][1]:.3f} ms (cells "
        f"{main_res['tile_ms'][0]:.3f} ms), planted hit@1 {tok_res['hit1']}; auto -> tokens "
        f"on the coarse index, hit@1 {tok_res['auto_hit1']}, on {smi}")
    log(f"# summary [builds]: device build {dbuild_res['build_s']:.2f} s against create "
        f"{main_res['create_s']:.2f} s at {args.n_docs} docs (top-{TOP_K} overlap "
        f"{dbuild_res['overlap']:.4f}, {dbuild_res['qps']:.1f} API QPS, hit@1 "
        f"{dbuild_res['hit1']}; against the host build {dbuild_res['same']}); streaming build "
        f"of 522,931 docs {stream_res['build_s']:.2f} s, "
        f"peak {stream_res['peak_gb']:.2f} GB, on {smi}")
    log(f"# summary [probe ties]: {main_res['probe_ties']}, on {smi}")
    q, qo = quality_res, quality_res["out"]
    log(f"# summary [quality, BEIR shape, {N_QUALITY_DOCS} docs, {q['n_tokens']} tokens]: nDCG@10 "
        f"exact_decompressed {qo['exact_decompressed']['ndcg@10']:.4f}, cascade default "
        f"{qo['cascade_default']['ndcg@10']:.4f}, cascade resident "
        f"{q['cascade_resident']['ndcg@10']:.4f}; recall@100 "
        f"{qo['exact_decompressed']['recall@100']:.4f} / {qo['cascade_default']['recall@100']:.4f}"
        f" / {q['cascade_resident']['recall@100']:.4f}; truth on the card "
        f"{q['truth']:.2f} s, corpus {q['corpus']:.1f} s, create "
        f"{qo['timing_s']['index_build']} s, on {smi}")
    s1 = server_res["single"]
    log(f"# summary [server]: {s1['rps']:.1f} requests/s of single-query JSON from 32 threads, "
        f"p50 {s1['p50_ms']:.2f} ms, p99 {s1['p99_ms']:.2f} ms, {s1['stats']['dispatches']} "
        f"dispatches, mean batch {s1['stats']['avg_batch']}; one b64 request of 200 queries "
        f"{server_res['b64']['qps']:.1f} queries/s; launches {server_res['launches']}, on {smi}")
    sh, sd = shard_res, disk_res
    log(f"# summary [sharded, 522,931 docs over {sh['n_shards']} shards on one card]: build "
        f"{sh['build_s']:.2f} s ({sh['index_gb']:.2f} GB of shards, peak {sh['peak_gb']:.2f} GB "
        f"beside the single-device index), {sh['qps']:.1f} QPS in tiles of 256, tile p50/p99 "
        f"{sh['tile_ms'][0]:.3f}/{sh['tile_ms'][1]:.3f} ms (mem_budget {sh['mem_budget']} B), "
        f"planted hit@1 {sh['hit1']}, kernel = plain up to ties (max diff {sh['diff']:.2e}), "
        f"top-1 vs one device {sh['vs_single']}, launches {sh['launches']}; query-sharded "
        f"launches {sh['query_launches']}; 2 x 2 mesh {sh['tile2d_ms']:.3f} ms a tile, "
        f"{sh['vs_single_2d']}, on {smi}")
    log(f"# summary [sharded from disk, {sd['n_shards']} shards]: ShardedFastPlaid open "
        f"{sd['open_s']:.2f} s, {sd['qps']:.1f} QPS, hit@1 {sd['hit1']}, vs FastPlaid "
        f"{sd['vs_single']}, launches {sd['launches']}; load_sharded_lm open "
        f"{sd['lm_open_s']:.2f} s, {sd['lm_qps']:.1f} QPS, hit@1 {sd['lm_hit1']}, "
        f"{sd['lm_tiles']} shard tiles, launches {sd['lm_launches']}, vs FastPlaid "
        f"{sd['lm_vs_single']}; with the single device's rank_admit "
        f"{sd['single_rank_admit']}: ShardedFastPlaid {sd['vs_single_admit']}, load_sharded_lm "
        f"{sd['lm_vs_single_admit']}, on {smi}")
    log(f"# build {build_s:.2f} s, create {main_res['create_s']:.2f} s (metadata included), low_memory "
        f"open {lm_res['load_s']:.2f} s, q4 tier open {q4_res['load_s']:.2f} s, "
        f"host gather {lm_res['gather_ms']:.3f} ms/tile")

    e, ed, er = enc_res, enc_res["default"], enc_res["resident"]
    log(f"# summary [encoder, colbertv2.0 width, random weights]: {e['tokens_per_s']:.0f} "
        f"tokens/s, {e['tflops']:.1f} TFLOP/s ({100 * e['peak_share']:.1f}% of the bf16 peak), "
        f"peak {e['peak_gb']:.2f} GB; bf16 vs float32 token cosine min "
        f"{e['check']['min_cos']:.6f}, mean {e['check']['mean_cos']:.6f}; create "
        f"{e['create_s']:.2f} s; on {smi}")
    for label, r in (("encoded, default constructor", ed), ("encoded, resident", er)):
        log(f"# summary [{label}]: {r['qps']:.1f} API QPS, tile p50/p99 "
            f"{r['tile_ms'][0]:.3f}/{r['tile_ms'][1]:.3f} ms, planted hit@1 {r['hit1']:.4f} "
            f"(exhaustive {e['exact_hit1']:.4f}), recall@{TOP_K} {r['recall10']:.4f}, kernel = "
            f"plain up to ties (max diff {r['diff']:.2e}), on {smi}")
    gathers = {"4": lm_res["gather"], "7": long_res["low_memory"]["gather"],
               "13b": disk_res["gather"], "14": ed["gather"]}
    for phase, r in gathers.items():
        log(f"# summary [host row gather, phase {phase}]: native {r['native_ms']:.3f} ms, torch "
            f"{r['torch_ms']:.3f} ms ({r['threads']} thread(s), {r['mb']:.1f} MB), on {smi}")
    iv = mut_res["ivf"]
    log(f"# summary [build_ivf, phase 6]: native {iv['native_s']:.3f} s, np.unique "
        f"{iv['numpy_s']:.3f} s ({iv['codes']} codes); the delete's native calls "
        f"{mut_res['delete_ivf_native_calls']}, on {smi}")
    native_line = [
        {"name": "gather_windows_u8", "source": "fast_plaid_tpu_torch/native/fastplaid_native.cpp",
         "replaces": "fast_plaid_tpu/native/fastplaid_native.cpp:76",
         "calls": {"4": lm_res["native_calls"]["gather_windows_u8"],
                   "13b": disk_res["lm_native_calls"]["gather_windows_u8"],
                   "14": ed["native_calls"]["gather_windows_u8"]},
         "ms": {k: {"native": r["native_ms"], "torch": r["torch_ms"], "threads": r["threads"],
                    "mb": r["mb"]} for k, r in gathers.items()}},
        {"name": "build_ivf", "source": "fast_plaid_tpu_torch/native/fastplaid_native.cpp",
         "replaces": "fast_plaid_tpu/native/fastplaid_native.cpp:33",
         "calls": {"6": mut_res["delete_ivf_native_calls"]},
         "s": {"6": {"native": iv["native_s"], "numpy": iv["numpy_s"], "codes": iv["codes"]}}},
    ]
    print(json.dumps({"native": native_line}), flush=True)

    def kernel(name, source, replaces, launches, rec):
        # library_ms is None for the four rerank and estimate kernels: no
        # single PyTorch call gathers rows by index and reduces a length-masked
        # (or run-segmented) max.
        return {"name": name, "route": "cuda", "source": f"fast_plaid_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None}

    probe_rec = kernel("probe_topk", "probe_kernel.cu",
                       "none (an XLA dot and approx_max_k, fast_plaid_tpu/search/engine.py:372)",
                       main_res["launches"]["probe_topk"], main_res["probe"])
    probe_rec["library_ms"] = main_res["probe"]["library_ms"]  # torch.matmul + torch.topk
    kernels = [
        kernel("segmented_estimate", "estimate_kernel.cu",
               "fast_plaid_tpu/ops/estimate_kernel.py:46",
               main_res["launches"]["segmented_estimate"], main_res["est"]),
        kernel("maxsim_gather_scores", "rerank_kernel.cu",
               "fast_plaid_tpu/ops/rerank_kernel.py:37",
               k2_res["launches"]["maxsim_gather_scores"], main_res["rr"]),
        kernel("maxsim_q4_gather_scores", "q4_rerank_kernel.cu",
               "fast_plaid_tpu/ops/rerank_kernel.py:198",
               lm_res["launches"]["maxsim_q4_gather_scores"], lm_res["q4"]),
        kernel("maxsim_gather_scores_dedup", "rerank_dedup_kernel.cu",
               "fast_plaid_tpu/ops/rerank_dedup.py:153",
               main_res["launches"]["maxsim_gather_scores_dedup"], main_res["dedup"]),
        probe_rec,
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
