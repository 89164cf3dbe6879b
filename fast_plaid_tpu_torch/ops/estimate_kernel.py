"""Segmented per-slot estimates (stage 4 of the budgeted candidate path).

Port of ``fast_plaid_tpu/ops/estimate_kernel.py``. For each slot i of a
pid-sorted slot table, the Q-sum of the per-query-token max of
``table[b, own[j], :]`` over the slot's equal-pid run suffix j >= i. At run
heads that is the candidate's estimate; callers mask the other slots.

``segmented_estimate`` launches the CUDA kernel (``csrc/estimate_kernel.cu``:
one launch, a block per row, any C) for tensors on a GPU and runs the plain PyTorch version,
``segmented_estimate_plain``, for tensors on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["segmented_estimate", "segmented_estimate_plain"]

_BF16_LOWEST = -3.0e38


def segmented_estimate_plain(
    pid_s: torch.Tensor,  # [B, W] int32, row-sorted by pid
    own_s: torch.Tensor,  # [B, W] int32 owner-cell index in [0, C)
    cell_scores: torch.Tensor,  # [B, C, Q] (rounded to bf16)
    *,
    max_run: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: [B, W] float32 per-slot run-suffix estimates.

    Gathers ``table[b, own]`` (bf16), takes the suffix max within equal-pid
    runs by log2 doubling, then sums over Q in float32. ``max_run`` bounds
    the run length the doubling covers (None: the whole row); runs are at
    most C long when IVF lists hold a document once per cell.
    """
    b, w = pid_s.shape
    c = cell_scores.shape[1]
    tbl = cell_scores.to(torch.bfloat16)
    own = torch.clamp(own_s.long(), 0, c - 1)
    s_slot = torch.gather(
        tbl, 1, own[..., None].expand(b, w, tbl.shape[2])
    )  # [B, W, Q] bf16
    neg = torch.tensor(_BF16_LOWEST, dtype=torch.bfloat16, device=tbl.device)
    limit = w if max_run is None else min(w, max_run)
    step = 1
    while step < limit:
        eq = pid_s[:, :-step] == pid_s[:, step:]
        shifted = torch.where(eq[..., None], s_slot[:, step:, :], neg)
        s_slot = torch.cat(
            [torch.maximum(s_slot[:, :-step, :], shifted), s_slot[:, -step:, :]],
            dim=1,
        )
        step *= 2
    return torch.sum(s_slot.to(torch.float32), dim=-1)


def segmented_estimate(
    pid_s: torch.Tensor,  # [B, W] int32, row-sorted by pid
    own_s: torch.Tensor,  # [B, W] int32 owner-cell index in [0, C)
    cell_scores: torch.Tensor,  # [B, C, Q] (cast to bf16)
) -> torch.Tensor:
    """[B, W] float32: per-slot Q-sum of the running per-token max over the
    slot's equal-pid run suffix. Launches the CUDA kernel for CUDA tensors
    (counted in ``segmented_estimate.launches``) and the plain version for
    CPU tensors.
    """
    if pid_s.device.type == "cpu":
        return segmented_estimate_plain(pid_s, own_s, cell_scores)
    from fast_plaid_tpu_torch.ops._build import check, count_launch, load_library

    if pid_s.device.type != "cuda":
        msg = f"segmented_estimate: unsupported device {pid_s.device}"
        raise ValueError(msg)
    b, w = pid_s.shape
    if cell_scores.ndim != 3 or cell_scores.shape[0] != b:
        msg = f"cell_scores must be [B={b}, C, Q]; got {tuple(cell_scores.shape)}"
        raise ValueError(msg)
    _, c, q = cell_scores.shape
    if own_s.shape != pid_s.shape:
        msg = f"own_s {tuple(own_s.shape)} must match pid_s {tuple(pid_s.shape)}"
        raise ValueError(msg)
    for name, t in (("pid_s", pid_s), ("own_s", own_s), ("cell_scores", cell_scores)):
        if t.device != pid_s.device:
            msg = f"segmented_estimate: {name} is on {t.device}, not {pid_s.device}"
            raise ValueError(msg)
    if pid_s.dtype != torch.int32 or own_s.dtype != torch.int32:
        msg = "segmented_estimate: pid_s and own_s must be int32"
        raise TypeError(msg)
    lib = load_library()
    if q > lib.fp_segmented_estimate_max_q() or c < 1:
        msg = f"segmented_estimate: unsupported shape B={b}, C={c}, Q={q}"
        raise ValueError(msg)
    if not (pid_s.is_contiguous() and own_s.is_contiguous()):
        msg = "segmented_estimate: inputs must be contiguous"
        raise ValueError(msg)
    # Table rows as whole 16-byte vectors: Q padded with zeros (never summed)
    # to 8 times the next power of two of ceil(Q / 8).
    qp = 8 * (1 << max(0, (q + 7) // 8 - 1).bit_length())
    tbl = cell_scores.to(torch.bfloat16)
    if qp != q:
        tbl = torch.nn.functional.pad(tbl, (0, qp - q))
    tbl = tbl.contiguous()
    out = torch.empty((b, w), dtype=torch.float32, device=pid_s.device)
    stream = torch.cuda.current_stream(pid_s.device).cuda_stream
    status = lib.fp_segmented_estimate(
        pid_s.data_ptr(),
        own_s.data_ptr(),
        tbl.data_ptr(),
        out.data_ptr(),
        b,
        w,
        c,
        q,
        stream,
    )
    check(status, "segmented_estimate")
    count_launch(segmented_estimate)
    return out


segmented_estimate.launches = 0
