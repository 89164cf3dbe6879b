"""Host-side search loop: query prep, tiling, result trimming.

Port of ``fast_plaid_tpu/search/searcher.py``. Queries are padded to a
static token cap, run through the cascade (``search/engine.py``) in
fixed-size tiles, and trimmed back to Python result lists. On a GPU the
cascade's kernels run (stage 4, the q4 prefilter, stage 6); on the CPU their
plain PyTorch versions.

Tiles run in one two-tile pipeline. A resident index enqueues a tile's
whole cascade (``engine.search_impl``). A low_memory index keeps codes and
residuals in host RAM: its tile enqueues the device candidate cascade (and,
with the q4 cache resident, the q4 prefilter down to ``rescue_pool(top_k)``
rows a query), then a host gather of only those rows on a worker thread
(each distinct document once, its valid tokens packed); their expansion and
the codec-exact rerank on the device follow when the tile leaves the
pipeline. Token-score matrices gather the winners' rows on the host a second
time. A low_memory search with a subset always takes the cascade, never the
direct-subset pool, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from fast_plaid_tpu_torch import native
from fast_plaid_tpu_torch.index.layout import DeviceIndex, round_up
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.search.engine import (
    _fused_probe,
    candidate_capacity,
    candidates_impl,
    final_topk,
    q4_prefilter,
    rerank_rows,
    rescue_pool,
    resolve_approx_mode,
    search_impl,
    suggest_query_tile,
    suggest_slot_budget,
    token_scores,
)
from fast_plaid_tpu_torch.search.load import LoadedIndex
from fast_plaid_tpu_torch.utils import tracing

__all__ = [
    "search_on_device",
    "normalize_queries",
    "normalize_subset",
    "last_search_stats",
    "host_gather_rows",
    "kernel_flags",
]

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


def kernel_flags(dev: DeviceIndex) -> tuple[bool, bool]:
    """(use_estimate_kernel, use_rerank_kernel) for the device ``dev`` lives
    on, never the process default device.

    Stage 4 runs its kernel on any GPU. Stage 6 runs its kernels (the fused
    gather+MaxSim or its dedup variant over the bf16 cache or the length
    buckets' caches, the q4 prefilter over the 4-bit cache) whenever one of
    the caches is resident on a GPU; without one it is the codec rerank in
    plain PyTorch.
    """
    on_gpu = dev.centroids.device.type == "cuda"
    rerank = on_gpu and (
        dev.emb_cache is not None
        or dev.emb_q4 is not None
        or any(bk.emb is not None for bk in dev.buckets)
    )
    return on_gpu, rerank


def normalize_queries(queries_embeddings) -> np.ndarray | list[np.ndarray]:
    """Accept [B, Q, D] array, [Q, D] array, or list of [Q_i, D] arrays.

    A batch of one shape stays whole, as one float32 [B, Q, D] array (a list
    whose items share one shape is stacked); anything else is a list of
    float32 arrays, one a query. Either way ``len`` is the number of queries
    and item ``i`` is query ``i``.
    """
    if isinstance(queries_embeddings, (list, tuple)):
        out = []
        for q in queries_embeddings:
            arr = np.asarray(q, dtype=np.float32)
            if arr.ndim == 3:
                arr = arr[0]
            out.append(arr)
        if out and all(a.ndim == 2 and a.shape == out[0].shape for a in out):
            return np.stack(out)
        return out
    arr = np.asarray(queries_embeddings, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim == 3:
        return arr
    return [arr[i] for i in range(arr.shape[0])]


def normalize_subset(subset, num_queries: int) -> list[list[int]] | None:
    """int -> the same list for all queries; flat list -> replicated; list of
    lists kept. An empty list means no subset."""
    if subset is None:
        return None
    if isinstance(subset, int):
        subset = [subset]
    if isinstance(subset, list) and len(subset) == 0:
        return None
    if isinstance(subset, list) and isinstance(subset[0], (int, np.integer)):
        subset = [list(subset)] * num_queries
    if len(subset) != num_queries:
        msg = "Subset length must match number of queries."
        raise ValueError(msg)
    return [list(map(int, s)) for s in subset]


def _pad_subsets(subsets: list[list[int]], n_docs: int, tile: slice) -> np.ndarray:
    """[rows, S] int32: each row's in-range ids sorted, ``n_docs`` padding
    (the sentinel pid), S the longest row rounded up to 8."""
    rows = subsets[tile]
    s_cap = round_up(max([len(s) for s in rows] + [1]), 8)
    out = np.full((len(rows), s_cap), n_docs, dtype=np.int32)
    for i, s in enumerate(rows):
        vals = np.asarray(sorted(v for v in s if 0 <= v < n_docs), dtype=np.int32)
        out[i, : len(vals)] = vals
    return out


def _pad_queries(
    queries: list[np.ndarray], dim: int
) -> tuple[np.ndarray, list[int]]:
    """[n, Q, dim] float32 zero-padded to the token cap, and each query's
    length, of [tokens, dim] queries."""
    lens = [int(q.shape[0]) for q in queries]
    q_cap = round_up(max(lens + [1]), 8)
    batch = np.zeros((len(queries), q_cap, dim), dtype=np.float32)
    for i, q in enumerate(queries):
        if q.shape[0]:
            batch[i, : q.shape[0]] = q
    return batch, lens


def _dense_batch(queries, dim: int) -> tuple[np.ndarray, list[int]] | None:
    """(padded batch, lengths) of a dense batch, else None.

    A float32 [B, Q, dim] array whose values are all finite is checked with
    one reduction and padded to the token cap with one slice assignment (not
    at all when Q is the cap already). Anything else (a list, another shape,
    a non-finite value) takes the per-query route, with its warnings.
    """
    if not (
        isinstance(queries, np.ndarray)
        and queries.dtype == np.float32
        and queries.ndim == 3
        and queries.shape[-1] == dim
        and np.isfinite(queries).all()
    ):
        return None
    nq, q_len, _ = queries.shape
    q_cap = round_up(max(q_len, 1), 8)
    batch = queries
    if q_len != q_cap:
        batch = np.zeros((nq, q_cap, dim), dtype=np.float32)
        batch[:, :q_len] = queries
    tracing.count("search.stage.dense", nq)
    return batch, [q_len] * nq


def _checked_batch(queries, dim: int) -> tuple[np.ndarray, list[int], set[int]]:
    """(padded batch, lengths, bad queries) of a batch, query by query.

    A query whose shape is not [tokens, dim] or that holds a non-finite
    value is bad: it stays in the batch as an empty query, with a
    RuntimeWarning; a batch of bad queries alone raises ValueError.
    """
    bad: set[int] = set()
    cleaned: list[np.ndarray] = []
    for qi, q in enumerate(queries):
        a = np.asarray(q, dtype=np.float32)
        if a.ndim != 2 or a.shape[-1] != dim or not np.isfinite(a).all():
            bad.add(qi)
            cleaned.append(np.zeros((0, dim), np.float32))
        else:
            cleaned.append(a)
    if len(bad) == len(queries):
        shapes = sorted({tuple(np.asarray(q).shape) for q in queries})
        msg = (
            f"All queries are invalid: expected [tokens, {dim}] "
            f"finite embeddings matching the index dimension; got shapes "
            f"{shapes[:4]}."
        )
        raise ValueError(msg)
    if bad:
        preview = sorted(bad)[:8]
        warnings.warn(
            f"{len(bad)} quer{'y' if len(bad) == 1 else 'ies'} "
            f"(indices {preview}{'...' if len(bad) > 8 else ''}) had "
            f"non-finite values or a shape other than [tokens, {dim}]; "
            "returning empty results for them",
            RuntimeWarning,
            stacklevel=3,
        )
    return (*_pad_queries(cleaned, dim), bad)


def _stage_tile(queries: np.ndarray, rows: int, device: torch.device, half: bool) -> torch.Tensor:
    """The float32 ``queries`` [n, Q, D], zero-padded to ``rows``, on ``device``.

    On a GPU the float32 bytes go through a pinned buffer of torch's caching
    host allocator (which holds the block until the copy has read it) and
    cross without blocking the host. With ``half`` they are rounded to
    float16 where they land: round to nearest even, bit for bit the host's
    ``astype(np.float16)``.
    """
    host = torch.empty(
        (rows, *queries.shape[1:]), dtype=torch.float32, pin_memory=device.type == "cuda"
    )
    buf = host.numpy()
    buf[: len(queries)] = queries
    buf[len(queries) :] = 0
    tracing.count("h2d.bytes", host.numel() * host.element_size())
    out = host.to(device, non_blocking=True)
    return out.half() if half else out


def _tile_size(ispec, q_cap: int, mem_budget: int) -> int:
    """Queries per device tile, sized so the [B, Q, Kp] score tensor fits."""
    kp = round_up(max(ispec.n_partitions, 1), 128)
    by_scores = max(1, mem_budget // max(1, q_cap * kp * 4 * 2))
    return int(max(1, min(256, by_scores)))


class SearchPlan(NamedTuple):
    """What a search resolves from the index and its parameters alone.

    ``tile`` is the query tile before it is cut to the call's query count.
    """

    cand_cap: int | None
    slot_budget: int | None
    approx_mode: str
    rank_admit: int
    tile: int
    lm_q4: bool


# Entries kept a LoadedIndex: distinct (q_cap, parameters) pairs are few.
_PLANS_MAX = 64


def _resolve_plan(
    loaded: LoadedIndex,
    q_cap: int,
    *,
    top_k: int,
    n_full_scores: int,
    n_ivf_probe: int,
    mem_budget: int,
    approx_mode: str,
    max_tile: int | None,
    pool_divisor: int,
    rank_admit: int | None,
    subset: bool = False,
) -> SearchPlan:
    """The engine's policies over the index's IVF lengths, as every call ran
    them: candidate capacity, slot budget, estimator, tile size. The tile
    budgets the probe's score table only where stages 1-2 write one (not
    the probe kernel's route, ``engine._fused_probe``; a subset call
    always writes it)."""
    ispec = loaded.ispec
    cand_cap = None
    slot_budget = None
    if loaded.ivf_lengths_host is not None:
        n_cells = min(q_cap * n_ivf_probe, ispec.n_partitions)
        cand_cap = candidate_capacity(loaded.ivf_lengths_host, n_cells, n_full_scores)
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
    b_tile = _tile_size(ispec, q_cap, mem_budget)
    if cand_cap is not None:
        kp = round_up(max(ispec.n_partitions, 1), 128)
        table = subset or not _fused_probe(
            loaded.device, kp, ispec.dim, approx_mode, None, min(n_ivf_probe, kp)
        )
        b_tile = min(
            b_tile,
            suggest_query_tile(
                ispec, q_cap, cand_cap, slot_budget=slot_budget, probe_table=table
            ),
        )
    if max_tile is not None:
        b_tile = min(b_tile, max(1, int(max_tile)))  # user memory hint
    exhaustive = n_ivf_probe >= ispec.n_partitions or (
        n_full_scores >= 2 * ispec.n_docs
    )
    # With the q4 cache resident, only the top rescue_pool rows a query
    # cross host->device for the codec-exact rescore.
    lm_q4 = (
        loaded.low_memory
        and loaded.dev.emb_q4 is not None
        and not exhaustive
        and rescue_pool(top_k) < max(n_full_scores // pool_divisor, 1)
    )
    if loaded.low_memory:
        # Bound the streamed rerank rows (codes int32 + residuals uint8 +
        # valid flag per token) by the memory budget; the pipeline keeps two
        # tiles in flight, so each gets half.
        r_pool = (
            rescue_pool(top_k) if lm_q4 else max(n_full_scores // pool_divisor, 1)
        )
        pd = loaded.host_residuals.shape[1]
        per_q = r_pool * ispec.doc_cap * (pd + 5)
        b_tile = min(b_tile, max(1, (mem_budget // 2) // max(per_q, 1)))
    return SearchPlan(cand_cap, slot_budget, approx_mode, rank_admit, b_tile, lm_q4)


def plan_search(loaded: LoadedIndex, q_cap: int, **params) -> SearchPlan:
    """``_resolve_plan``, memoised on ``loaded`` under every input it reads.

    The index is fixed for the life of a LoadedIndex (``update`` and
    ``delete`` load a new one). Each entry is one finished tuple stored by
    one assignment: threads racing on a key may both compute it, and none
    reads a part of one.
    """
    key = (q_cap, *sorted(params.items()))
    plan = loaded.plans.get(key)
    if plan is not None:
        tracing.count("search.plan.hit", 1)
        return plan
    tracing.count("search.plan.miss", 1)
    plan = _resolve_plan(loaded, q_cap, **params)
    if len(loaded.plans) >= _PLANS_MAX:
        loaded.plans.clear()
    loaded.plans[key] = plan
    return plan


def _gather_windows(
    src: np.ndarray,
    offs: np.ndarray,
    lens: np.ndarray,
    cap: int,
    pin: bool,
    use_native: bool,
) -> torch.Tensor:
    """Rows [off, off + len) of ``src`` [T, ...] for every window, zero-padded
    to ``cap`` rows: [W, cap, ...], in pinned memory with ``pin``.

    The C++ host gather (``native.gather_windows_u8``) writes straight into
    the output where it is built and ``use_native`` holds. Otherwise: tokens
    of one document are contiguous, so each window is one slice of an
    overlapping-window view of ``src``, copied by ``index_select``; windows
    that the end of ``src`` cuts short are copied one by one. Both clamp
    the start to [0, T) and give the same bytes.
    """
    t = src.shape[0]
    w = offs.shape[0]
    rest = src.shape[1:]
    with warnings.catch_warnings():  # read-only mmaps: never written here
        warnings.simplefilter("ignore", UserWarning)
        src_t = torch.from_numpy(src)
    out = torch.empty((w, cap, *rest), dtype=src_t.dtype, pin_memory=pin)
    if use_native and native.gather_windows_u8(src, offs, lens, cap, out=out) is not None:
        return out
    n_win = t - cap + 1
    if n_win > 0:
        win = src_t.as_strided((n_win, cap, *rest), (src_t.stride(0), *src_t.stride()))
        start = np.clip(offs, 0, n_win - 1)
        torch.index_select(win, 0, torch.from_numpy(start), out=out)
    else:
        out.zero_()
        start = np.full_like(offs, -1)
    for i in np.nonzero((start != offs) & (lens > 0))[0]:
        base = min(max(int(offs[i]), 0), max(t - 1, 0))
        avail = max(0, min(int(lens[i]), t - base))
        out[i, :avail] = src_t[base : base + avail]
        out[i, avail:] = 0
    keep = torch.from_numpy(np.arange(cap) < lens[:, None])
    out.mul_(keep.reshape(w, cap, *([1] * len(rest))))
    return out


def host_gather_rows(
    loaded: LoadedIndex, pids: np.ndarray, *, pin: bool = False, use_native: bool = True
):
    """Gather the token windows of ``pids`` [B, R] from the host-RAM arrays.

    Returns CPU tensors (codes_rows [B, R, doc_cap] int32, res_rows
    [B, R, doc_cap, PD] uint8, tok_valid [B, R, doc_cap] bool), in pinned
    memory with ``pin``. Tokens past a document's length are zero, and pids
    outside [0, n_docs) give empty rows. This is low_memory's streaming
    step: only these rows cross to the device. The codes (int32, 4 bytes a
    row) and the residuals go through the C++ host gather, as in the JAX
    package; ``use_native=False``, or a host where it is not built, takes
    the torch gather.
    """
    doc_cap = loaded.ispec.doc_cap
    n_docs = len(loaded.host_doc_lengths)
    pids = np.asarray(pids, dtype=np.int64)
    safe = np.clip(pids, 0, max(n_docs - 1, 0))
    lens = np.where((pids < 0) | (pids >= n_docs), 0, loaded.host_doc_lengths[safe])
    lens = np.minimum(lens, doc_cap).reshape(-1)
    offs = np.asarray(loaded.host_doc_offsets, np.int64)[safe].reshape(-1)
    codes = _gather_windows(loaded.host_codes, offs, lens, doc_cap, pin, use_native)
    res = _gather_windows(loaded.host_residuals, offs, lens, doc_cap, pin, use_native)
    tok_valid = torch.from_numpy(np.arange(doc_cap) < lens[:, None])
    shape = (*pids.shape, doc_cap)
    return (
        codes.reshape(shape),
        res.reshape(*shape, -1),
        tok_valid.reshape(shape),
    )


class PackedRows(NamedTuple):
    """A rerank pool's token rows with each distinct document once.

    ``codes`` [n + doc_cap] and ``residuals`` [n + doc_cap, PD] hold the
    distinct documents' valid tokens back to back (n in all), then doc_cap
    rows of any content, so that the doc_cap rows from any document's first
    one lie inside; ``slots`` [2, B, R] int32 holds each pool slot's first
    row and length.
    """

    codes: torch.Tensor
    residuals: torch.Tensor
    slots: torch.Tensor


def _pack_windows(
    src: np.ndarray,
    offs: np.ndarray,
    lens: np.ndarray,
    starts: np.ndarray,
    cap: int,
    out: torch.Tensor,
    use_native: bool,
) -> None:
    """Rows [off, off + len) of ``src`` for every window (``len`` at most
    ``cap``), window w at rows [starts[w], starts[w] + len) of ``out``: the
    valid rows of ``_gather_windows``' padded windows, byte for byte. The
    C++ host gather writes them where it is built and ``use_native`` holds;
    else the padded torch gather, cut to its valid rows."""
    if use_native:
        done = native.gather_windows_u8(src, offs, lens, cap, out=out, out_rows=starts)
        if done is not None:
            return
    padded = _gather_windows(src, offs, lens, cap, False, False)
    n = int(lens.sum())
    out[:n] = padded[torch.from_numpy(np.arange(cap) < lens[:, None])]


def _pack_rows(
    loaded: LoadedIndex, pids: np.ndarray, *, pin: bool = False, use_native: bool = True
) -> PackedRows:
    """The token rows of ``pids`` [B, R], each distinct document copied once.

    What crosses to the device in place of ``host_gather_rows``' padded
    [B, R, doc_cap] rows: a pool repeats the documents that several queries
    kept, and a document fills ``min(len, doc_cap)`` of its ``doc_cap``
    rows. Pids outside [0, n_docs) fold into one empty document. The pinned
    buffers are allocated at the padded size (and the spare rows), so that
    torch's caching host allocator hands the same blocks back call after
    call, and hold a prefix. ``_expand_rows`` rebuilds the padded rows on
    the device.
    """
    doc_cap = loaded.ispec.doc_cap
    n_docs = len(loaded.host_doc_lengths)
    pids = np.asarray(pids, dtype=np.int64)
    key = np.where((pids < 0) | (pids >= n_docs), n_docs, pids)
    uniq, inv = np.unique(key, return_inverse=True)
    live = uniq < n_docs
    safe = np.minimum(uniq, max(n_docs - 1, 0))
    lens = np.where(live, np.minimum(loaded.host_doc_lengths[safe], doc_cap), 0)
    starts = np.cumsum(lens) - lens
    offs = np.asarray(loaded.host_doc_offsets, np.int64)[safe]
    n_tok = int(lens.sum())
    bufs = []
    for src in (loaded.host_codes, loaded.host_residuals):
        dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
        rows = (pids.size + 1) * doc_cap
        buf = torch.empty((rows, *src.shape[1:]), dtype=dtype, pin_memory=pin)
        _pack_windows(src, offs, lens, starts, doc_cap, buf, use_native)
        bufs.append(buf[: n_tok + doc_cap])
    slots = torch.empty((2, *pids.shape), dtype=torch.int32, pin_memory=pin)
    inv = inv.reshape(pids.shape)
    slots[0] = torch.from_numpy(starts[inv])
    slots[1] = torch.from_numpy(lens[inv])
    tracing.count("gather.rows", pids.size)
    tracing.count("gather.distinct", int(live.sum()))
    tracing.count("gather.bytes", sum(b[:n_tok].nbytes for b in bufs))
    return PackedRows(*bufs, slots)


def _expand_rows(rows: PackedRows, doc_cap: int):
    """``rows`` (on the device) as ``host_gather_rows`` gives them: (codes_rows
    [B, R, doc_cap], res_rows [B, R, doc_cap, PD], tok_valid [B, R, doc_cap]).

    Each slot takes the doc_cap rows from its document's first one, a
    window of an overlapping-window view (one ``index_select`` a tensor,
    a block of doc_cap rows a slot), and is zeroed past its length in place.
    """
    codes, res, (start, length) = rows
    tok_valid = torch.arange(doc_cap, device=start.device) < length[..., None]
    first = start.reshape(-1).long()
    out = []
    for x in (codes, res):
        rest = x.shape[1:]
        n_win = x.shape[0] - doc_cap + 1
        win = x.as_strided((n_win, doc_cap, *rest), (x.stride(0), *x.stride()))
        got = win.index_select(0, first).view(*tok_valid.shape, *rest)
        out.append(got.mul_(tok_valid.view(*tok_valid.shape, *[1] * len(rest))))
    return (*out, tok_valid)


def _lm_finish(
    loaded: LoadedIndex,
    tile_dev: torch.Tensor,
    p2: torch.Tensor,
    stats: torch.Tensor,
    rows,
    *,
    top_k: int,
    mem_budget: int,
    want_tokens: bool = False,
):
    """low_memory phase 3: device rerank of the rows packed on the host.

    ``rows`` (``_pack_rows``) cross in their packed form and are expanded on
    the device, where the packed copies are dropped before stage 6. The
    token mask comes from the slots' lengths, which cross in pinned memory
    with the rows: a copy from pageable host memory would wait for the
    whole stream, the next tile's cascade included. With ``want_tokens``
    the winners' rows are gathered on the host a second time (into pinned
    memory on a GPU) and their token scores computed on the device.
    """
    ispec = loaded.ispec
    with tracing.span("search.upload"):
        tracing.count("h2d.bytes", sum(x.numel() * x.element_size() for x in rows))
        rows = _expand_rows(
            PackedRows(*(x.to(loaded.device, non_blocking=True) for x in rows)),
            ispec.doc_cap,
        )
    exact = rerank_rows(loaded.dev, rows, p2, tile_dev, ispec=ispec, mem_budget=mem_budget)
    fp, fs = final_topk(exact, p2, top_k)
    if not want_tokens:
        return fp, fs, stats
    fp_host, ready = _to_host_async(fp)
    if ready is not None:
        ready.synchronize()  # the winners alone, not the whole stream
    fp_np = fp_host.numpy()
    rows_k = host_gather_rows(
        loaded,
        np.where(fp_np < 0, ispec.sentinel_pid, fp_np),
        pin=loaded.device.type == "cuda",
    )
    codes_k, res_k = (x.to(loaded.device, non_blocking=True) for x in rows_k[:2])
    safe = torch.where(fp < 0, ispec.sentinel_pid, fp).long()
    doc_lens = torch.where(fp < 0, 0, loaded.dev.doc_lengths[safe])
    valid_k = torch.arange(ispec.doc_cap, device=fp.device) < doc_lens[..., None]
    emb_k = codec.decompress(
        codes_k, res_k, loaded.dev.centroids, loaded.dev.bucket_weights, ispec.nbits,
        out_dtype=torch.bfloat16,
    )
    tok = token_scores(emb_k, valid_k, tile_dev.to(torch.float32))
    return fp, fs, tok, doc_lens, stats


def _to_host_async(x: torch.Tensor):
    """Start a device->host copy of ``x``: (host tensor, CUDA event or None).

    On a GPU the copy goes into pinned memory behind the work already
    enqueued, and the event marks its end, so a worker thread can wait for
    this tensor alone instead of for the whole stream.
    """
    if x.device.type != "cuda":
        return x, None
    tracing.count("d2h.bytes", x.numel() * x.element_size())
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(x.device))
    return host, ready


def search_on_device(
    loaded: LoadedIndex,
    queries: np.ndarray | list[np.ndarray],
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
    """Run the cascade for a batch of queries on one device.

    ``queries`` is what ``normalize_queries`` gives: one float32 [B, Q, D]
    array, staged whole when every value is finite, or a list of [Q_i, D]
    arrays, checked one by one. The plan (``plan_search``) is resolved once
    per index and parameters. Returns, per query, a list of (pid, score) tuples, or (pid, score,
    token_matrix [q_tokens, doc_tokens]) with ``want_tokens``. ``subsets``
    (one id list per query, see ``normalize_subset``) restricts each query
    to its ids. A malformed or non-finite query yields an empty result; a
    tile whose device work fails yields empty results for its queries, with
    a RuntimeWarning.
    """
    with tracing.span("search.plan"):
        ispec = loaded.ispec
        if not ispec.has_ivf:
            msg = (
                "This index was created with compress_only=True and has no IVF; "
                "search is unavailable (use get_embeddings)."
            )
            raise ValueError(msg)
        if len(queries) == 0:
            return []
        dense = _dense_batch(queries, ispec.dim)
        if dense is not None:
            batch, q_lens = dense
            bad_queries: set[int] = set()
        else:
            batch, q_lens, bad_queries = _checked_batch(queries, ispec.dim)
        nq, q_cap, _ = batch.shape
        if pool_divisor is None:
            pool_divisor = int(os.environ.get("FASTPLAID_POOL_DIV", "2"))
        pool_divisor = max(1, int(pool_divisor))
        plan = plan_search(
            loaded,
            q_cap,
            top_k=top_k,
            n_full_scores=n_full_scores,
            n_ivf_probe=n_ivf_probe,
            mem_budget=mem_budget,
            approx_mode=approx_mode,
            max_tile=max_tile,
            pool_divisor=pool_divisor,
            rank_admit=rank_admit,
            subset=subsets is not None,
        )
        b_tile = max(1, min(plan.tile, nq))

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
        est_kernel, use_kernel = kernel_flags(loaded.dev)
        cascade = dict(
            ispec=ispec,
            n_ivf_probe=n_ivf_probe,
            n_full_scores=n_full_scores,
            mem_budget=mem_budget,
            cand_cap=plan.cand_cap,
            approx_mode=plan.approx_mode,
            with_stats=True,
            slot_budget=plan.slot_budget,
            use_estimate_kernel=est_kernel,
            pool_divisor=pool_divisor,
            rank_admit=plan.rank_admit,
        )
        n_tiles = -(-nq // b_tile)
        tracing.count("search.queries", nq)
        tracing.count("search.tiles", n_tiles)
        tracing.count("search.query_slots", n_tiles * b_tile)

    def stage(start: int):
        with tracing.span("search.upload"):
            end = min(start + b_tile, nq)
            # The tile is padded to the static size. Queries reach the engine
            # at half width on a GPU (unit-norm values lose ~5e-4 relative in
            # float16; the engine upcasts them), and stay float32 on the CPU.
            tile_dev = _stage_tile(batch[start:end], b_tile, loaded.device, half=on_gpu)
            sub_dev = None
            if subsets is not None:
                sub = _pad_subsets(subsets, ispec.n_docs, slice(start, end))
                if sub.shape[0] < b_tile:
                    pad = np.full(
                        (b_tile - sub.shape[0], sub.shape[1]), ispec.n_docs, np.int32
                    )
                    sub = np.concatenate([sub, pad])
                tracing.count("h2d.bytes", sub.nbytes)
                sub_dev = torch.from_numpy(sub).to(loaded.device)
            return end, tile_dev, sub_dev

    def gather_stage(p2_host, ready):
        with tracing.span("search.host_gather"):
            if ready is not None:
                with tracing.span("search.host_gather.pool_wait"):
                    ready.synchronize()  # this tile's pool alone, not the whole stream
            return _pack_rows(loaded, p2_host.numpy(), pin=on_gpu)

    def enqueue(start: int, pool: ThreadPoolExecutor):
        """Stage tile ``start`` and enqueue its device work: the whole
        cascade, or on low_memory the cascade to the pool and the pool's
        host gather on the worker."""
        end, tile_dev, sub_dev = stage(start)
        try:
            if not loaded.low_memory:
                out = search_impl(
                    loaded.dev, tile_dev, sub_dev, top_k=top_k, want_tokens=want_tokens,
                    use_rerank_kernel=use_kernel, **cascade,
                )
                return start, end, out
            p2, stats = candidates_impl(loaded.dev, tile_dev, sub_dev, **cascade)
            if plan.lm_q4:
                p2 = q4_prefilter(
                    loaded.dev, p2, tile_dev, sentinel_pid=ispec.sentinel_pid,
                    pool=rescue_pool(top_k), mem_budget=mem_budget, use_kernel=use_kernel,
                )
            fut = pool.submit(tracing.bind(gather_stage), *_to_host_async(p2))
            return start, end, (tile_dev, p2, stats, fut)
        except NotImplementedError:
            raise
        except RuntimeError as exc:  # e.g. out of device memory
            return start, end, exc

    def finish(start: int, end: int, out) -> None:
        """Emit a tile's results; on low_memory first await its host gather
        and rerank it. A RuntimeError of the tile's work empties them."""
        nonlocal pruned_total, overflow_total
        if loaded.low_memory and not isinstance(out, Exception):
            try:
                tile_dev, p2, stats, fut = out
                with tracing.span("search.gather_wait"):
                    rows = fut.result()
                out = _lm_finish(
                    loaded, tile_dev, p2, stats, rows, top_k=top_k,
                    mem_budget=mem_budget, want_tokens=want_tokens,
                )
            except RuntimeError as exc:  # gather/rerank failure: contained below
                out = exc
        with tracing.span("search.emit"):
            try:
                if isinstance(out, Exception):
                    raise out
                with tracing.span("search.emit.wait"):
                    host = [t.cpu().numpy() for t in out]
                tracing.count("d2h.bytes", sum(a.nbytes for a in host))
                if want_tokens:
                    pids, scores, tok, doc_lens, stats = host
                else:
                    pids, scores, stats = host
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
                if want_tokens:
                    qlen = q_lens[start + bi]
                    results.append(
                        [
                            (pid, score, tok[bi, ki, : doc_lens[bi, ki], :qlen].T.copy())
                            for ki, (pid, score) in enumerate(zip(pids_l[bi], scores_l[bi]))
                            if pid >= 0
                        ]
                    )
                else:
                    results.append(
                        [
                            (pid, score)
                            for pid, score in zip(pids_l[bi], scores_l[bi])
                            if pid >= 0
                        ]
                    )

    # Two tiles in flight: tile i + 1's device work is enqueued before tile
    # i is finished, so that its device->host copy (and on low_memory its
    # host gather, on the worker thread) never waits for the device idle.
    inflight: deque = deque()
    with torch.inference_mode(), ThreadPoolExecutor(max_workers=1) as pool:
        for start in iterator:
            inflight.append(enqueue(start, pool))
            if len(inflight) >= 2:
                finish(*inflight.popleft())
        while inflight:
            finish(*inflight.popleft())

    live = {t.ident for t in threading.enumerate()}
    for ident in [k for k in _LAST_STATS if k not in live]:
        _LAST_STATS.pop(ident, None)
    _LAST_STATS[threading.get_ident()] = {
        "dropped_candidate_slots": pruned_total + overflow_total,
        "budget_pruned_slots": pruned_total,
        "cap_overflow_slots": overflow_total,
        "queries": nq,
        "approx_mode": plan.approx_mode,
        "rank_admit": plan.rank_admit,
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
