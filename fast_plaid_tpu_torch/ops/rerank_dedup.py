"""Deduplicated fused rerank: one candidate-row read per unique document.

Port of ``fast_plaid_tpu/ops/rerank_dedup.py``. Within one query tile the
rerank pools of different queries overlap (a small corpus against B * R
slots), so the per-query kernel (``ops/rerank_kernel.py``) reads the same
document row many times. This module scores each row once per group of at
most G requesters:

  1. ``group_pool`` (plain PyTorch): stable-sort the [B, R] pool by pid, cut
     each pid's run of requesters into entries of at most G, and build the
     entry tables (pid, length, G requester query ids) and the inverse map
     ``inv[b, r] = entry * G + slot``.
  2. ``maxsim_gather_scores_dedup``: score every entry's row against its
     requesters (the CUDA kernel ``csrc/rerank_dedup_kernel.cu`` on a GPU,
     ``maxsim_gather_scores_dedup_plain`` on the CPU), then gather the entry
     scores back to [B, R] through ``inv``.

The scores are those of ``maxsim_gather_scores`` up to the order of float32
sums (bf16 inputs, float32 accumulation, length-masked token max, sum over
query tokens). ``dedup_viable`` is the JAX package's static gate, unchanged,
so both packages pick the same stage-6 kernel at every shape.
"""

from __future__ import annotations

import os

import torch

__all__ = [
    "dedup_fits",
    "dedup_smem_bytes",
    "dedup_viable",
    "group_pool",
    "maxsim_gather_scores_dedup",
    "maxsim_gather_scores_dedup_plain",
]

NEG = float("-inf")
G_DEFAULT = 8
_MAX_SMEM = 227 * 1024


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
    shapes are legal (D a multiple of 128, Q a multiple of 16, all queries
    within 8 MB). ``FASTPLAID_RERANK_DEDUP=0`` disables, ``=1`` forces where
    the shape is legal, ``auto`` (the default) decides.
    """
    env = os.environ.get("FASTPLAID_RERANK_DEDUP", "auto")
    if env == "0":
        return False
    legal = (
        d % 128 == 0
        and nq % 16 == 0
        and nq >= 16
        and b * nq * d * 2 <= 8 * 1024 * 1024
        and b * r >= 4 * g
    )
    if env == "1":
        return legal
    n = b * r
    return legal and (n // g + np_rows) <= n // 2


def _align128(x: int) -> int:
    return (x + 127) // 128 * 128


def dedup_smem_bytes(doc_cap: int, d: int, q: int, g: int = G_DEFAULT) -> int:
    """Shared-memory bytes one block of ``csrc/rerank_dedup_kernel.cu`` takes
    (its ``make_layout``): two [round_up(doc_cap, 16), D + 8] bf16 row
    buffers, eight warps' 16 x 20 float scratch tiles and G x Q float column
    maxima, each rounded up to 128 bytes."""
    buf = _align128((doc_cap + 15) // 16 * 16 * (d + 8) * 2)
    return 2 * buf + _align128(8 * 16 * 20 * 4) + _align128(g * q * 4)


def dedup_fits(doc_cap: int, d: int, q: int, g: int = G_DEFAULT) -> bool:
    """Does the dedup kernel's block fit in shared memory at this shape?

    Its row buffers grow with doc_cap (past about 400 at D 128, Q 32), while
    the per-query kernel's shared memory does not depend on doc_cap. Stage 6
    takes the dedup kernel only where ``dedup_viable`` and this both hold; the
    two compute the same scores, so the choice is by shape alone.
    """
    return dedup_smem_bytes(doc_cap, d, q, g) <= _MAX_SMEM


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
    flat_pid = pids.reshape(n).to(torch.int32)
    flat_len = lens.reshape(n).to(torch.int32)
    order = torch.argsort(flat_pid, stable=True)
    spid = flat_pid[order]
    slen = flat_len[order]
    qidx = (order // r).to(torch.int32)

    idx = torch.arange(n, dtype=torch.int64, device=device)
    is_new = torch.ones(n, dtype=torch.bool, device=device)
    is_new[1:] = spid[1:] != spid[:-1]
    # Position within the pid's run: index minus the run's start.
    run_start = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    pos = idx - run_start
    is_start = is_new | (pos % g == 0)
    entry_id = torch.cumsum(is_start.to(torch.int64), dim=0) - 1  # nondecreasing
    slot = pos % g
    n_entries = (entry_id[-1] + 1).to(torch.int32)

    # Entry e spans sorted positions [bounds[e], bounds[e + 1]).
    bounds = torch.searchsorted(
        entry_id, torch.arange(e_cap + 1, dtype=torch.int64, device=device)
    )
    estart, eend = bounds[:-1], bounds[1:]
    valid_e = estart < eend
    esafe = torch.clamp(estart, max=n - 1)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    entry_pid = torch.where(valid_e, spid[esafe], zero)
    entry_len = torch.where(valid_e, slen[esafe], zero)
    posg = esafe[:, None] + torch.arange(g, device=device)
    in_e = posg < eend[:, None]
    entry_qidx = torch.where(in_e, qidx[torch.clamp(posg, max=n - 1)], zero)

    # Inverse of the sort permutation -> each slot's (entry, slot) address.
    invperm = torch.empty_like(order)
    invperm[order] = idx
    inv = (entry_id * g + slot)[invperm].to(torch.int32).reshape(b, r)
    return entry_pid, entry_len, entry_qidx, inv, n_entries


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
    entry_pid, entry_len, entry_qidx, inv, n_entries = group_pool(pids, lens, g, e_cap)
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
    ``maxsim_gather_scores_dedup.launches``) and the plain version for CPU
    tensors.
    """
    if pids.device.type == "cpu":
        return maxsim_gather_scores_dedup_plain(emb_cache, pids, lens, queries, g=g)
    from fast_plaid_tpu_torch.ops._build import check, load_library

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
    if d not in (128, 256) or nq % 16 or nq < 16 or not 1 <= g <= 256:
        msg = (
            f"{name}: the kernel takes D 128 or 256, Q a positive multiple of "
            f"16 and 1 <= g <= 256; got D={d}, Q={nq}, g={g}"
        )
        raise ValueError(msg)
    if not emb_cache.is_contiguous() or emb_cache.data_ptr() % 16:
        msg = f"{name}: emb_cache must be contiguous and 16-byte aligned"
        raise ValueError(msg)
    if not dedup_fits(doc_cap, d, nq, g):
        msg = (
            f"{name}: doc_cap={doc_cap}, D={d}, Q={nq}, g={g} needs more "
            "shared memory than one block has"
        )
        raise ValueError(msg)
    lib = load_library()
    n = b * r
    e_cap = min(n, n // g + np_rows)
    entry_pid, entry_len, entry_qidx, inv, n_entries = group_pool(pids, lens, g, e_cap)
    entry_pid = torch.clamp(entry_pid, 0, np_rows - 1)
    # Requesters per entry: the live slots that inv addresses (a scatter-add,
    # which unlike bincount needs no device->host sync).
    entry_cnt = torch.zeros(e_cap, dtype=torch.int32, device=pids.device)
    entry_cnt.scatter_add_(
        0, (inv.reshape(-1) // g).long(), torch.ones_like(inv.reshape(-1))
    )
    q2 = queries.to(torch.bfloat16).reshape(b * nq, d).contiguous()
    ent = torch.empty((e_cap, g), dtype=torch.float32, device=pids.device)
    stream = torch.cuda.current_stream(pids.device).cuda_stream
    status = lib.fp_maxsim_dedup(
        emb_cache.data_ptr(),
        np_rows,
        doc_cap,
        d,
        entry_pid.data_ptr(),
        entry_len.data_ptr(),
        entry_cnt.data_ptr(),
        entry_qidx.data_ptr(),
        n_entries.data_ptr(),
        e_cap,
        q2.data_ptr(),
        nq,
        g,
        ent.data_ptr(),
        stream,
    )
    check(status, name)
    maxsim_gather_scores_dedup.launches += 1
    scores = ent.reshape(-1)[inv.reshape(-1).long()].reshape(b, r)
    return torch.where(lens > 0, scores, NEG)


maxsim_gather_scores_dedup.launches = 0
