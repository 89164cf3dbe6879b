"""Host-side search loop: query prep, tiling, result trimming.

Port of the device-resident branch of ``fast_plaid_tpu/search/searcher.py``.
Queries are padded to a static token cap, run through the cascade
(``search/engine.py``) in fixed-size tiles, and trimmed back to Python
result lists. On a GPU the cascade's stage 4 and stage 6 run the CUDA
kernels; on the CPU their plain PyTorch versions.
"""

from __future__ import annotations

import os
import threading
import warnings
from collections import deque

import numpy as np
import torch

from fast_plaid_tpu_torch.index.layout import round_up
from fast_plaid_tpu_torch.search.engine import (
    candidate_capacity,
    resolve_approx_mode,
    search_core,
    suggest_query_tile,
    suggest_slot_budget,
)
from fast_plaid_tpu_torch.search.load import LoadedIndex

__all__ = ["search_on_device", "normalize_queries", "last_search_stats"]

# Stats of the most recent search_on_device call, keyed by thread id.
_LAST_STATS: dict[int, dict] = {}


def last_search_stats() -> dict:
    """Stats from the most recent search on the calling thread.

    Keys: ``queries``, ``approx_mode`` (resolved), ``rank_admit``,
    ``budget_pruned_slots`` (pruned by design), ``cap_overflow_slots``
    (truncated by static buffers beyond the budget's intent) and
    ``dropped_candidate_slots`` (their sum).
    """
    return dict(
        _LAST_STATS.get(
            threading.get_ident(),
            {
                "dropped_candidate_slots": 0,
                "budget_pruned_slots": 0,
                "cap_overflow_slots": 0,
                "queries": 0,
            },
        )
    )


def normalize_queries(queries_embeddings) -> list[np.ndarray]:
    """Accept [B, Q, D] array, [Q, D] array, or list of [Q_i, D] arrays."""
    if isinstance(queries_embeddings, (list, tuple)):
        out = []
        for q in queries_embeddings:
            arr = np.asarray(q, dtype=np.float32)
            if arr.ndim == 3:
                arr = arr[0]
            out.append(arr)
        return out
    arr = np.asarray(queries_embeddings, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    return [arr[i] for i in range(arr.shape[0])]


def _pad_queries(
    queries: list[np.ndarray], dim: int
) -> tuple[np.ndarray, list[int]]:
    for q in queries:
        if q.ndim != 2 or q.shape[-1] != dim:
            msg = (
                f"Query embeddings must be [tokens, {dim}] to match the "
                f"index dimension; got shape {tuple(q.shape)}."
            )
            raise ValueError(msg)
    lens = [int(q.shape[0]) for q in queries]
    q_cap = round_up(max(lens + [1]), 8)
    batch = np.zeros((len(queries), q_cap, dim), dtype=np.float32)
    for i, q in enumerate(queries):
        if q.shape[0]:
            batch[i, : q.shape[0]] = q
    return batch, lens


def _tile_size(ispec, q_cap: int, mem_budget: int, n_queries: int) -> int:
    """Queries per device tile, sized so the [B, Q, Kp] score tensor fits."""
    kp = round_up(max(ispec.n_partitions, 1), 128)
    by_scores = max(1, mem_budget // max(1, q_cap * kp * 4 * 2))
    return int(max(1, min(256, by_scores, n_queries)))


def search_on_device(
    loaded: LoadedIndex,
    queries: list[np.ndarray],
    *,
    top_k: int,
    n_full_scores: int,
    n_ivf_probe: int,
    subsets: list[list[int]] | None = None,
    want_tokens: bool = False,
    mem_budget: int = 256 * 1024 * 1024,
    show_progress: bool = False,
    approx_mode: str = "cells",
    max_tile: int | None = None,
    pool_divisor: int | None = None,
    rank_admit: int | None = None,
) -> list:
    """Run the cascade for a list of queries on one device.

    Returns, per query, a list of (pid, score) tuples. A malformed or
    non-finite query yields an empty result; a tile whose device work fails
    yields empty results for its queries, with a RuntimeWarning.
    """
    ispec = loaded.ispec
    if subsets is not None:
        msg = "subset-restricted search is not ported yet (ROADMAP.md §1, subsets)"
        raise NotImplementedError(msg)
    if want_tokens:
        msg = "token-score matrices are not ported yet (ROADMAP.md §1)"
        raise NotImplementedError(msg)
    if not ispec.has_ivf:
        msg = (
            "This index was created with compress_only=True and has no IVF; "
            "search is unavailable (use get_embeddings)."
        )
        raise ValueError(msg)
    if not queries:
        return []
    bad_queries: set[int] = set()
    cleaned: list[np.ndarray] = []
    for qi, q in enumerate(queries):
        a = np.asarray(q, dtype=np.float32)
        if a.ndim != 2 or a.shape[-1] != ispec.dim or not np.isfinite(a).all():
            bad_queries.add(qi)
            cleaned.append(np.zeros((0, ispec.dim), np.float32))
        else:
            cleaned.append(a)
    if len(bad_queries) == len(queries):
        shapes = sorted({tuple(np.asarray(q).shape) for q in queries})
        msg = (
            f"All queries are invalid: expected [tokens, {ispec.dim}] "
            f"finite embeddings matching the index dimension; got shapes "
            f"{shapes[:4]}."
        )
        raise ValueError(msg)
    if bad_queries:
        preview = sorted(bad_queries)[:8]
        warnings.warn(
            f"{len(bad_queries)} quer{'y' if len(bad_queries) == 1 else 'ies'} "
            f"(indices {preview}{'...' if len(bad_queries) > 8 else ''}) had "
            f"non-finite values or a shape other than [tokens, {ispec.dim}]; "
            "returning empty results for them",
            RuntimeWarning,
            stacklevel=2,
        )
    batch, q_lens = _pad_queries(cleaned, ispec.dim)
    nq, q_cap, _ = batch.shape
    cand_cap = None
    slot_budget = None
    if loaded.ivf_lengths_host is not None:
        n_cells = min(q_cap * n_ivf_probe, ispec.n_partitions)
        cand_cap = candidate_capacity(
            loaded.ivf_lengths_host, n_cells, n_full_scores
        )
        slot_budget = suggest_slot_budget(loaded.ivf_lengths_host, n_full_scores)
    approx_mode, rank_admit, slot_budget = resolve_approx_mode(
        approx_mode,
        loaded.ivf_lengths_host,
        q_cap=q_cap,
        n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores,
        n_partitions=ispec.n_partitions,
        cand_cap=cand_cap,
        rank_admit=rank_admit,
        slot_budget=slot_budget,
        n_docs=ispec.n_docs,
    )
    b_tile = _tile_size(ispec, q_cap, mem_budget, nq)
    if cand_cap is not None:
        b_tile = min(
            b_tile,
            suggest_query_tile(ispec, q_cap, cand_cap, slot_budget=slot_budget),
        )
    if max_tile is not None:
        b_tile = min(b_tile, max(1, int(max_tile)))  # user memory hint
    if pool_divisor is None:
        pool_divisor = int(os.environ.get("FASTPLAID_POOL_DIV", "2"))
    pool_divisor = max(1, int(pool_divisor))
    b_tile = max(1, min(b_tile, nq))

    results: list = []
    pruned_total = 0
    overflow_total = 0
    iterator = range(0, nq, b_tile)
    if show_progress and nq > b_tile:
        try:
            from tqdm import tqdm  # type: ignore[import-not-found]

            iterator = tqdm(iterator, desc="Searching")
        except ImportError:
            pass

    on_gpu = loaded.device.type == "cuda"
    # Queries cross host->device at half width on a GPU (unit-norm values
    # lose ~5e-4 relative in float16; the engine upcasts on arrival), and
    # stay float32 on the CPU.
    wire_dtype = np.float16 if on_gpu else np.float32
    # Stage 6 runs the fused gather+MaxSim kernel whenever the bf16 corpus
    # cache is resident on a GPU; stage 4 runs its kernel on any GPU.
    use_kernel = on_gpu and loaded.dev.emb_cache is not None
    est_kernel = on_gpu

    def make_tile(start: int):
        end = min(start + b_tile, nq)
        tile = batch[start:end]
        if end - start < b_tile:  # pad the tile to the static size
            tile = np.concatenate(
                [tile, np.zeros((b_tile - (end - start), q_cap, ispec.dim), np.float32)]
            )
        tile_dev = torch.from_numpy(tile.astype(wire_dtype)).to(loaded.device)
        return end, tile_dev

    def emit(out, start: int, end: int) -> None:
        nonlocal pruned_total, overflow_total
        try:
            if isinstance(out, Exception):
                raise out
            pids, scores, stats = (t.cpu().numpy() for t in out)
        except RuntimeError as exc:  # device-side failure: contain to this tile
            warnings.warn(
                f"search failed for queries [{start}, {end}) — returning "
                f"empty results for them: {exc}",
                RuntimeWarning,
                stacklevel=2,
            )
            results.extend([[] for _ in range(end - start)])
            return
        pruned_total += int(stats[: end - start, 0].sum())
        overflow_total += int(stats[: end - start, 1].sum())
        pids_l = pids[: end - start].tolist()
        scores_l = scores[: end - start].tolist()
        for bi in range(end - start):
            if (start + bi) in bad_queries:
                results.append([])
                continue
            results.append(
                [
                    (pid, score)
                    for pid, score in zip(pids_l[bi], scores_l[bi])
                    if pid >= 0
                ]
            )

    # Dispatch ahead of conversion: the device->host copy in emit() waits
    # for the device, so tile i converts only after tile i+1 is enqueued.
    inflight: deque = deque()
    with torch.inference_mode():
        for start in iterator:
            end, tile_dev = make_tile(start)
            try:
                out = search_core(
                    loaded.dev,
                    tile_dev,
                    None,
                    ispec=ispec,
                    top_k=top_k,
                    n_ivf_probe=n_ivf_probe,
                    n_full_scores=n_full_scores,
                    mem_budget=mem_budget,
                    cand_cap=cand_cap,
                    approx_mode=approx_mode,
                    with_stats=True,
                    use_rerank_kernel=use_kernel,
                    slot_budget=slot_budget,
                    use_estimate_kernel=est_kernel,
                    pool_divisor=pool_divisor,
                    rank_admit=rank_admit,
                )
            except NotImplementedError:
                raise
            except RuntimeError as exc:  # e.g. out of device memory
                out = exc
            inflight.append((out, start, end))
            if len(inflight) >= 2:
                emit(*inflight.popleft())
        while inflight:
            emit(*inflight.popleft())

    live = {t.ident for t in threading.enumerate()}
    for ident in [k for k in _LAST_STATS if k not in live]:
        _LAST_STATS.pop(ident, None)
    _LAST_STATS[threading.get_ident()] = {
        "dropped_candidate_slots": pruned_total + overflow_total,
        "budget_pruned_slots": pruned_total,
        "cap_overflow_slots": overflow_total,
        "queries": nq,
        "approx_mode": approx_mode,
        "rank_admit": rank_admit,
    }
    if overflow_total:
        warnings.warn(
            f"candidate buffer overflow: {overflow_total} candidate slots "
            f"(lowest-priority cells) truncated across {nq} queries beyond "
            "the slot budget's own pruning; raise mem_budget or cand_cap "
            "if recall matters more than memory",
            RuntimeWarning,
            stacklevel=2,
        )
    return results
