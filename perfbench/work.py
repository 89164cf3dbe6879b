"""The work a kernel launch needs, and the least time one H100 could take.

Copied from ``chip_smoke.py`` (``bound``, ``rerank_work`` and the byte count
of ``check_estimate``) so that the yardstick stays fixed while the program
changes. Peaks: NVIDIA's data sheet for the H100 SXM part at 700 W, dense.
"""

from __future__ import annotations

import torch

__all__ = ["HBM_BPS", "BF16_OPS", "F32_OPS", "bound", "rerank_work", "estimate_work"]

HBM_BPS, BF16_OPS, F32_OPS = 3.35e12, 989e12, 67e12


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger, and which it was."""
    t_b, t_o = nbytes / HBM_BPS, ops / peak_ops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def rerank_work(pids, lens, queries, n_docs: int, cap: int, d: int, q4_half: int = 0) -> dict:
    """What a rerank launch needs on these inputs. Each distinct document's
    rows are read once, as many as the longest length asked of it (bf16: len
    rows of 2D bytes, out-of-range pids empty; q4: min(len, caph) packed rows
    of D bytes plus a scale, pids clamped); pids, lens and queries are read
    once and the [B, R] scores written once; every valid token of every slot
    costs 2 * Q * D operations, at the bf16 peak."""
    if q4_half:
        p = pids.clamp(0, n_docs - 1).long()
        ntok = lens.clamp(0, cap)
        rows, row_bytes = ntok.clamp(max=q4_half), d
    else:
        ok = (pids >= 0) & (pids < n_docs)
        p = torch.where(ok, pids, 0).long()
        ntok = torch.where(ok, lens.clamp(0, cap), 0)
        rows, row_bytes = ntok, 2 * d
    per_doc = torch.zeros(n_docs, dtype=torch.int64, device=pids.device)
    per_doc.scatter_reduce_(0, p.reshape(-1), rows.reshape(-1).long(), "amax")
    distinct = int(per_doc.sum()) * row_bytes
    if q4_half:
        distinct += 4 * int((per_doc > 0).sum())
    io = pids.numel() * 12 + queries.shape[0] * queries.shape[1] * d * 2
    ops = 2 * queries.shape[1] * d * int(ntok.sum())
    ms, by = bound(distinct + io, ops, BF16_OPS)
    return {"bytes": distinct + io, "ops": ops, "bound_ms": ms, "bound_by": by}


def estimate_work(pid, own, tbl) -> dict:
    """What a stage-4 estimate launch needs: pid and own read and the output
    written once (4 bytes each a slot), the [B, C, Q] table read once; a max
    per query token of every slot, at the float32 peak."""
    nbytes = pid.numel() * 12 + tbl.numel() * 2
    ops = pid.numel() * tbl.shape[2]
    ms, by = bound(nbytes, ops, F32_OPS)
    return {"bytes": nbytes, "ops": ops, "bound_ms": ms, "bound_by": by}
