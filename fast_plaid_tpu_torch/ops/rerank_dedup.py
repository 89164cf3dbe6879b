"""Deduplicated fused rerank: one candidate-row read per unique document.

Port of ``fast_plaid_tpu/ops/rerank_dedup.py``. Within one query tile the
rerank pools of different queries overlap (a small corpus against B * R
slots), so the per-query kernel (``ops/rerank_kernel.py``) reads the same
document row many times. This module scores each row once per group of at
most G requesters:

  1. ``_sort_pool`` (plain PyTorch): stable-sort the [B, R] pool by pid and
     cut each pid's run of requesters into entries of at most G (a run's
     start by ``searchsorted``, entry spans by a second one; no host sync).
  2. ``maxsim_gather_scores_dedup``: on a GPU the CUDA kernel
     ``csrc/rerank_dedup_kernel.cu`` scores every live entry's row against
     its requesters and writes each slot's score in place through the sort
     order; on the CPU ``maxsim_gather_scores_dedup_plain`` builds the JAX
     package's entry tables (``group_pool``: pid, length, G requester query
     ids, and ``inv[b, r] = entry * G + slot``), scores them and gathers the
     scores back through ``inv``.

The scores are those of ``maxsim_gather_scores`` up to the order of float32
sums (bf16 inputs, float32 accumulation, length-masked token max, sum over
query tokens). ``dedup_viable`` is the JAX package's static gate with the
CUDA kernel's width (D a multiple of 16, where the JAX kernel takes
multiples of 128), so both packages pick the same stage-6 kernel at every
shape the JAX kernel takes.

Both paths mark the grouping with the span ``rerank.group`` and add its live
entries to the device counter ``rerank.entries`` (``utils/tracing.py``).
"""

from __future__ import annotations

import os

import torch

from fast_plaid_tpu_torch.ops.rerank_kernel import _MAX_Q, _query_chunks
from fast_plaid_tpu_torch.utils import tracing

__all__ = [
    "dedup_viable",
    "group_pool",
    "maxsim_gather_scores_dedup",
    "maxsim_gather_scores_dedup_plain",
]

NEG = float("-inf")
G_DEFAULT = 8


def dedup_viable(
    np_rows: int,
    b: int,
    r: int,
    nq: int,
    d: int,
    g: int = G_DEFAULT,
) -> bool:
    """Static decision: does stage 6 take the dedup kernel?

    True when the worst-case entry count B*R//G + Np is at most half the
    slot count (at least 2x fewer row reads however the pools land) and the
    shapes are legal (D a multiple of 16, Q a multiple of 16, all queries
    within 8 MB). ``FASTPLAID_RERANK_DEDUP=0`` disables, ``=1`` forces where
    the shape is legal, ``auto`` (the default) decides.
    """
    env = os.environ.get("FASTPLAID_RERANK_DEDUP", "auto")
    if env == "0":
        return False
    legal = (
        d % 16 == 0
        and d >= 16
        and nq % 16 == 0
        and nq >= 16
        and b * nq * d * 2 <= 8 * 1024 * 1024
        and b * r >= 4 * g
    )
    if env == "1":
        return legal
    n = b * r
    return legal and (n // g + np_rows) <= n // 2


def _sort_pool(pids: torch.Tensor, g: int, e_cap: int):
    """Sort the flat pool by pid and cut each pid's run into entries of <= g.

    Returns (order [n] int64 sorted position -> flat slot, spid [n] sorted
    pids, entry_id [n] int64, slot [n] int64 position within its entry,
    bounds [e_cap + 1] int64, entry e spanning sorted positions
    [bounds[e], bounds[e + 1]), n_entries 0-d int32). Sync-free: the entry
    count stays on the pool's device.
    """
    n = pids.numel()
    device = pids.device
    flat_pid = pids.reshape(n).to(torch.int32)
    order = torch.argsort(flat_pid, stable=True)
    spid = flat_pid[order]
    # Position within the pid's run: index minus the run's first index.
    idx = torch.arange(n, dtype=torch.int64, device=device)
    pos = idx - torch.searchsorted(spid, spid)
    is_start = pos % g == 0
    entry_id = torch.cumsum(is_start, dim=0) - 1  # nondecreasing
    n_entries = (entry_id[-1] + 1).to(torch.int32)
    bounds = torch.searchsorted(
        entry_id, torch.arange(e_cap + 1, dtype=torch.int64, device=device)
    )
    return order, spid, entry_id, pos % g, bounds, n_entries


def group_pool(pids: torch.Tensor, lens: torch.Tensor, g: int, e_cap: int):
    """Group the rerank pool by document into entries of <= g requesters.

    Returns (entry_pid [E], entry_len [E], entry_qidx [E, g], inv [B, R],
    n_entries) with E = e_cap, int32 tensors on the pool's device and
    ``n_entries`` a 0-d int32 tensor. Entries are in ascending pid order;
    those at or past ``n_entries`` are padding (pid 0, length 0).
    """
    b, r = pids.shape
    n = b * r
    device = pids.device
    order, spid, entry_id, slot, bounds, n_entries = _sort_pool(pids, g, e_cap)
    slen = lens.reshape(n).to(torch.int32)[order]
    qidx = (order // r).to(torch.int32)
    estart, eend = bounds[:-1], bounds[1:]
    valid_e = estart < eend
    esafe = torch.clamp(estart, max=n - 1)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    entry_pid = torch.where(valid_e, spid[esafe], zero)
    entry_len = torch.where(valid_e, slen[esafe], zero)
    posg = esafe[:, None] + torch.arange(g, device=device)
    in_e = posg < eend[:, None]
    entry_qidx = torch.where(in_e, qidx[torch.clamp(posg, max=n - 1)], zero)
    # Each slot's (entry, slot) address, scattered back through the sort.
    inv = torch.empty(n, dtype=torch.int64, device=device)
    inv[order] = entry_id * g + slot
    return entry_pid, entry_len, entry_qidx, inv.to(torch.int32).reshape(b, r), n_entries


def _score_entries_plain(
    emb_cache: torch.Tensor,  # [Np, doc_cap, D] bf16
    entry_pid: torch.Tensor,  # [E] int32 (in range)
    entry_len: torch.Tensor,  # [E] int32
    entry_qidx: torch.Tensor,  # [E, G] int32
    q2: torch.Tensor,  # [B * Q, D] float32 (bf16-rounded)
    nq: int,
    mem_budget: int,
) -> torch.Tensor:
    """[E, G] float32: each entry's row against each of its G query slots."""
    e_n, g = entry_qidx.shape
    _, doc_cap, d = emb_cache.shape
    qv = q2.reshape(-1, nq, d)  # [B, Q, D]
    tok = torch.arange(doc_cap, device=entry_pid.device)
    per_entry = (g * doc_cap * nq * 2 + doc_cap * d + g * nq * d) * 4
    chunk = max(1, min(e_n, mem_budget // per_entry))
    out = torch.empty((e_n, g), dtype=torch.float32, device=entry_pid.device)
    for s in range(0, e_n, chunk):
        e = min(s + chunk, e_n)
        rows = emb_cache[entry_pid[s:e].long()].to(torch.float32)  # [c, T, D]
        qs = qv[entry_qidx[s:e].long()].reshape(e - s, g * nq, d)
        ts = torch.bmm(rows, qs.transpose(1, 2))  # [c, T, G*Q]
        valid = tok < entry_len[s:e, None]
        ts = torch.where(valid[..., None], ts, NEG)
        m = torch.amax(ts, dim=1).reshape(e - s, g, nq)
        out[s:e] = torch.sum(m, dim=-1)
    return out


def maxsim_gather_scores_dedup_plain(
    emb_cache: torch.Tensor,  # [Np, doc_cap, D] bf16
    pids: torch.Tensor,  # [B, R] int32
    lens: torch.Tensor,  # [B, R] int32 valid token counts
    queries: torch.Tensor,  # [B, Q, D] (rounded to bf16)
    *,
    g: int = G_DEFAULT,
    mem_budget: int = 256 * 1024 * 1024,
) -> torch.Tensor:
    """Plain PyTorch version: ``group_pool``, each live entry's row scored
    against its requesters, scattered back through ``inv``; [B, R] float32
    with -inf where len <= 0."""
    b, r = pids.shape
    np_rows, _, d = emb_cache.shape
    nq = queries.shape[1]
    n = b * r
    e_cap = min(n, n // g + np_rows)
    with tracing.span("rerank.group"):
        entry_pid, entry_len, entry_qidx, inv, n_entries = group_pool(pids, lens, g, e_cap)
    tracing.count_device("rerank.entries", n_entries)
    live = int(n_entries)
    q2 = queries.to(torch.bfloat16).to(torch.float32).reshape(b * nq, d)
    ent = torch.full((e_cap, g), NEG, dtype=torch.float32, device=pids.device)
    ent[:live] = _score_entries_plain(
        emb_cache,
        torch.clamp(entry_pid[:live], 0, np_rows - 1),
        entry_len[:live],
        entry_qidx[:live],
        q2,
        nq,
        mem_budget,
    )
    scores = ent.reshape(-1)[inv.reshape(-1).long()].reshape(b, r)
    return torch.where(lens > 0, scores, NEG)


def maxsim_gather_scores_dedup(
    emb_cache: torch.Tensor,  # [Np, doc_cap, D] bf16
    pids: torch.Tensor,  # [B, R] int32
    lens: torch.Tensor,  # [B, R] int32 valid token counts
    queries: torch.Tensor,  # [B, Q, D] (cast to bf16)
    *,
    g: int = G_DEFAULT,
) -> torch.Tensor:
    """Drop-in for ``maxsim_gather_scores``: [B, R] float32, -inf where
    len <= 0, one row read per (document, group of <= g requesters).

    Launches the CUDA kernel for CUDA tensors (counted in
    ``maxsim_gather_scores_dedup.launches``, once per chunk of 64 query
    tokens) and the plain version for CPU tensors. The kernel takes any
    doc_cap, D a multiple of 16 (ceil(D / 64) column halves, the columns
    past D zero-filled) whose query and row tiles fit a block (up to 1,024
    does), and any Q; it writes each slot's score in place, so no
    entry table is gathered back.
    """
    if pids.device.type == "cpu":
        return maxsim_gather_scores_dedup_plain(emb_cache, pids, lens, queries, g=g)
    from fast_plaid_tpu_torch.ops._build import check, count_launch, load_library

    name = "maxsim_gather_scores_dedup"
    if pids.device.type != "cuda":
        msg = f"{name}: unsupported device {pids.device}"
        raise ValueError(msg)
    if emb_cache.ndim != 3 or emb_cache.dtype != torch.bfloat16:
        msg = f"{name}: emb_cache must be a [Np, doc_cap, D] bf16 tensor"
        raise TypeError(msg)
    np_rows, doc_cap, d = emb_cache.shape
    b, r = pids.shape
    nq = queries.shape[1] if queries.ndim == 3 else 0
    if lens.shape != pids.shape:
        msg = f"lens {tuple(lens.shape)} must match pids {tuple(pids.shape)}"
        raise ValueError(msg)
    if queries.ndim != 3 or queries.shape[0] != b or queries.shape[2] != d:
        msg = f"queries must be [B={b}, Q, D={d}]; got {tuple(queries.shape)}"
        raise ValueError(msg)
    if pids.dtype != torch.int32 or lens.dtype != torch.int32:
        msg = f"{name}: pids and lens must be int32"
        raise TypeError(msg)
    for label, t in (("emb_cache", emb_cache), ("lens", lens), ("queries", queries)):
        if t.device != pids.device:
            msg = f"{name}: {label} is on {t.device}, not {pids.device}"
            raise ValueError(msg)
    bad_shape = d % 16 or d < 16 or nq < 1 or not 1 <= g <= 256
    if bad_shape or np_rows < 1 or np_rows * doc_cap >= 2**31:
        msg = (
            f"{name}: the kernel takes D a multiple of 16, Q >= 1, 1 <= g <= 256 "
            f"and Np * doc_cap < 2^31; got D={d}, Q={nq}, g={g}, Np={np_rows}, "
            f"doc_cap={doc_cap}"
        )
        raise ValueError(msg)
    if not emb_cache.is_contiguous() or emb_cache.data_ptr() % 16:
        msg = f"{name}: emb_cache must be contiguous and 16-byte aligned"
        raise ValueError(msg)
    lib = load_library()
    if lib.fp_maxsim_dedup_smem_bytes(d, min(nq, _MAX_Q)) < 0:
        msg = f"{name}: D={d} is too wide for one block's shared memory"
        raise ValueError(msg)
    n = b * r
    e_cap = min(n, n // g + np_rows)
    with tracing.span("rerank.group"):
        order, _, _, _, bounds, n_entries = _sort_pool(pids, g, e_cap)
        order = order.to(torch.int32)
        bounds = bounds.to(torch.int32)
    tracing.count_device("rerank.entries", n_entries)
    flat_pid = pids.reshape(n).contiguous()
    flat_len = lens.reshape(n).contiguous()
    q3 = queries.to(torch.bfloat16).contiguous()
    stream = torch.cuda.current_stream(pids.device).cuda_stream
    out = None
    for qc in _query_chunks(q3):
        # Slots of entries past e_cap (only out-of-range pids make any) stay -inf.
        part = torch.full((n,), NEG, dtype=torch.float32, device=pids.device)
        status = lib.fp_maxsim_dedup(
            emb_cache.data_ptr(),
            np_rows,
            doc_cap,
            d,
            flat_pid.data_ptr(),
            flat_len.data_ptr(),
            order.data_ptr(),
            bounds.data_ptr(),
            n_entries.data_ptr(),
            e_cap,
            b,
            r,
            qc.data_ptr(),
            qc.shape[1],
            part.data_ptr(),
            stream,
        )
        check(status, name)
        count_launch(maxsim_gather_scores_dedup)
        out = part if out is None else out.add_(part)
    return out.reshape(b, r)


maxsim_gather_scores_dedup.launches = 0
