"""Fused candidate gather + exact MaxSim (stage 6 over the bf16 corpus cache).

Port of ``fast_plaid_tpu/ops/rerank_kernel.py::maxsim_gather_scores``:

    out[b, r] = sum_q max_{t < lens[b, r]} <emb_cache[pids[b, r], t], queries[b, q]>

with bf16 inputs and float32 accumulation; an empty row (length 0) scores
-inf. A pid outside [0, Np) is treated as an empty row (never read).

``maxsim_gather_scores`` launches the CUDA kernel (``csrc/rerank_kernel.cu``)
for tensors on a GPU and runs the plain PyTorch version,
``maxsim_gather_scores_plain``, for tensors on the CPU.

``maxsim_q4_gather_scores`` is the same quantity over the 4-bit prefilter
cache (``ops/q4cache.py``), port of ``_q4_kernel``: the CUDA kernel
``csrc/q4_rerank_kernel.cu`` on a GPU, ``maxsim_q4_gather_scores_plain`` on
the CPU.

Both kernels stream a candidate's rows through shared memory in tiles of 64
(``csrc/maxsim_stream.cuh``), so their shared memory depends on D and Q
only and they take documents of any length.
"""

from __future__ import annotations

import torch

__all__ = [
    "maxsim_gather_scores",
    "maxsim_gather_scores_plain",
    "maxsim_q4_gather_scores",
    "maxsim_q4_gather_scores_plain",
]

_MAX_Q = 64  # query tokens per launch; longer queries run in chunks whose sums add


def _query_chunks(qb: torch.Tensor) -> list[torch.Tensor]:
    """[B, Q, D] bf16 -> contiguous chunks of at most ``_MAX_Q`` query tokens.
    The score is a sum over query tokens, so the chunks' scores add."""
    q = qb.shape[1]
    if q <= _MAX_Q:
        return [qb]
    return [qb[:, s : s + _MAX_Q].contiguous() for s in range(0, q, _MAX_Q)]


def maxsim_gather_scores_plain(
    emb_cache: torch.Tensor,  # [Np, doc_cap, D] bf16
    pids: torch.Tensor,  # [B, R] int32
    lens: torch.Tensor,  # [B, R] int32 valid token counts
    queries: torch.Tensor,  # [B, Q, D] (rounded to bf16)
    *,
    mem_budget: int = 256 * 1024 * 1024,
) -> torch.Tensor:
    """Plain PyTorch version: [B, R] float32, chunked over R so that the
    gathered float32 rows stay within ``mem_budget`` bytes."""
    b, r = pids.shape
    n_rows, doc_cap, d = emb_cache.shape
    q = queries.shape[1]
    qf = queries.to(torch.bfloat16).to(torch.float32)  # [B, Q, D]
    ok = (pids >= 0) & (pids < n_rows)
    safe = torch.where(ok, pids, torch.zeros_like(pids)).long()
    lens_eff = torch.where(ok, torch.clamp(lens, 0, doc_cap), torch.zeros_like(lens))
    tok = torch.arange(doc_cap, device=pids.device)
    per_row = b * doc_cap * max(d * 4, q * 4)
    r_chunk = max(1, min(r, mem_budget // max(1, per_row)))
    out = torch.empty((b, r), dtype=torch.float32, device=pids.device)
    for s in range(0, r, r_chunk):
        e = min(s + r_chunk, r)
        rows = emb_cache[safe[:, s:e]].to(torch.float32)  # [B, rc, T, D]
        ts = torch.bmm(
            rows.reshape(b, (e - s) * doc_cap, d), qf.transpose(1, 2)
        ).reshape(b, e - s, doc_cap, q)
        valid = tok[None, None, :] < lens_eff[:, s:e, None]
        ts = torch.where(valid[..., None], ts, float("-inf"))
        out[:, s:e] = torch.sum(torch.amax(ts, dim=2), dim=-1)
    return out


def maxsim_gather_scores(
    emb_cache: torch.Tensor,  # [Np, doc_cap, D] bf16
    pids: torch.Tensor,  # [B, R] int32
    lens: torch.Tensor,  # [B, R] int32 valid token counts
    queries: torch.Tensor,  # [B, Q, D] (cast to bf16)
) -> torch.Tensor:
    """Fused gather+MaxSim: [B, R] float32 scores (-inf for empty rows).

    Launches the CUDA kernel for CUDA tensors (counted in
    ``maxsim_gather_scores.launches``) and the plain version for CPU tensors.
    """
    if pids.device.type == "cpu":
        return maxsim_gather_scores_plain(emb_cache, pids, lens, queries)
    from fast_plaid_tpu_torch.ops._build import check, count_launch, load_library

    if pids.device.type != "cuda":
        msg = f"maxsim_gather_scores: unsupported device {pids.device}"
        raise ValueError(msg)
    if emb_cache.ndim != 3 or emb_cache.dtype != torch.bfloat16:
        msg = "maxsim_gather_scores: emb_cache must be a [Np, doc_cap, D] bf16 tensor"
        raise TypeError(msg)
    n_rows, doc_cap, d = emb_cache.shape
    b, r = pids.shape
    if lens.shape != pids.shape:
        msg = f"lens {tuple(lens.shape)} must match pids {tuple(pids.shape)}"
        raise ValueError(msg)
    if queries.ndim != 3 or queries.shape[0] != b or queries.shape[2] != d:
        msg = f"queries must be [B={b}, Q, D={d}]; got {tuple(queries.shape)}"
        raise ValueError(msg)
    if pids.dtype != torch.int32 or lens.dtype != torch.int32:
        msg = "maxsim_gather_scores: pids and lens must be int32"
        raise TypeError(msg)
    for name, t in (("emb_cache", emb_cache), ("lens", lens), ("queries", queries)):
        if t.device != pids.device:
            msg = f"maxsim_gather_scores: {name} is on {t.device}, not {pids.device}"
            raise ValueError(msg)
    q = queries.shape[1]
    qb = queries.to(torch.bfloat16)
    if not all(t.is_contiguous() for t in (emb_cache, pids, lens, qb)):
        msg = "maxsim_gather_scores: inputs must be contiguous"
        raise ValueError(msg)
    if doc_cap % 16 or d % 16 or q < 1:
        msg = (
            "maxsim_gather_scores: needs doc_cap and D multiples of 16 and Q >= 1; "
            f"got doc_cap={doc_cap}, D={d}, Q={q}"
        )
        raise ValueError(msg)
    if emb_cache.data_ptr() % 16 or qb.data_ptr() % 16:
        msg = "maxsim_gather_scores: emb_cache and queries must be 16-byte aligned"
        raise ValueError(msg)
    lib = load_library()
    if lib.fp_maxsim_gather_smem_bytes(d, min(q, _MAX_Q)) < 0:
        msg = f"maxsim_gather_scores: D={d} is too wide for one block's shared memory"
        raise ValueError(msg)
    stream = torch.cuda.current_stream(pids.device).cuda_stream
    out = None
    for qc in _query_chunks(qb):
        part = torch.empty((b, r), dtype=torch.float32, device=pids.device)
        status = lib.fp_maxsim_gather(
            emb_cache.data_ptr(),
            n_rows,
            doc_cap,
            d,
            pids.data_ptr(),
            lens.data_ptr(),
            qc.data_ptr(),
            b,
            r,
            qc.shape[1],
            part.data_ptr(),
            stream,
        )
        check(status, "maxsim_gather_scores")
        count_launch(maxsim_gather_scores)
        out = part if out is None else out.add_(part)
    return out


maxsim_gather_scores.launches = 0


def maxsim_q4_gather_scores_plain(
    emb_q4: torch.Tensor,  # [Np * caph, D] uint8 (caph = doc_cap / 2)
    q4_scale: torch.Tensor,  # [Np] float32
    pids: torch.Tensor,  # [B, R] int32
    lens: torch.Tensor,  # [B, R] int32 valid token counts
    queries: torch.Tensor,  # [B, Q, D] (rounded to bf16)
    *,
    mem_budget: int = 256 * 1024 * 1024,
) -> torch.Tensor:
    """Plain PyTorch version of the q4 kernel: [B, R] float32.

    Pids are clipped to [0, Np - 1]. Each nibble plane is scored on its own
    (low plane token t valid iff t < len, high plane iff t + caph < len),
    the planes are max-combined, and the per-document scale multiplies the
    sum; len <= 0 scores -inf. Chunked over R within ``mem_budget``.
    """
    b, r = pids.shape
    npd = q4_scale.shape[0]
    caph = emb_q4.shape[0] // npd
    d = emb_q4.shape[1]
    q = queries.shape[1]
    qt = queries.to(torch.bfloat16).to(torch.float32).transpose(1, 2)  # [B, D, Q]
    p = torch.clamp(pids, 0, npd - 1).long()
    tok = torch.arange(caph, device=pids.device)
    per_row = b * caph * max(d * 4, q * 4) * 3
    r_chunk = max(1, min(r, mem_budget // max(1, per_row)))
    out = torch.empty((b, r), dtype=torch.float32, device=pids.device)
    for s in range(0, r, r_chunk):
        e = min(s + r_chunk, r)
        ridx = p[:, s:e, None] * caph + tok
        rows = emb_q4[ridx].to(torch.int32).reshape(b, (e - s) * caph, d)
        lens_c = lens[:, s:e, None]
        planes = []
        for vals, first in (((rows & 15) - 8, 0), ((rows >> 4) - 8, caph)):
            ts = torch.bmm(vals.to(torch.float32), qt).reshape(b, e - s, caph, q)
            valid = (tok + first) < lens_c
            planes.append(torch.where(valid[..., None], ts, float("-inf")))
        raw = torch.sum(torch.amax(torch.maximum(*planes), dim=2), dim=-1)
        scaled = raw * q4_scale[p[:, s:e]]
        out[:, s:e] = torch.where(lens[:, s:e] > 0, scaled, float("-inf"))
    return out


def maxsim_q4_gather_scores(
    emb_q4: torch.Tensor,  # [Np * caph, D] uint8
    q4_scale: torch.Tensor,  # [Np] float32
    pids: torch.Tensor,  # [B, R] int32
    lens: torch.Tensor,  # [B, R] int32 valid token counts
    queries: torch.Tensor,  # [B, Q, D] (cast to bf16)
) -> torch.Tensor:
    """Fused q4 gather + dequantization + MaxSim: [B, R] float32 (-inf where
    len <= 0), scaled by ``q4_scale[clip(pid)]``.

    Launches the CUDA kernel for CUDA tensors (counted in
    ``maxsim_q4_gather_scores.launches``) and the plain version for CPU
    tensors.
    """
    if pids.device.type == "cpu":
        return maxsim_q4_gather_scores_plain(emb_q4, q4_scale, pids, lens, queries)
    from fast_plaid_tpu_torch.ops._build import check, count_launch, load_library

    name = "maxsim_q4_gather_scores"
    if pids.device.type != "cuda":
        msg = f"{name}: unsupported device {pids.device}"
        raise ValueError(msg)
    if emb_q4.ndim != 2 or emb_q4.dtype != torch.uint8:
        msg = f"{name}: emb_q4 must be a [Np * doc_cap/2, D] uint8 tensor"
        raise TypeError(msg)
    if q4_scale.ndim != 1 or q4_scale.dtype != torch.float32:
        msg = f"{name}: q4_scale must be a [Np] float32 tensor"
        raise TypeError(msg)
    npd = q4_scale.shape[0]
    d = emb_q4.shape[1]
    if npd < 1 or emb_q4.shape[0] % npd:
        msg = f"{name}: emb_q4 rows ({emb_q4.shape[0]}) are not a multiple of {npd}"
        raise ValueError(msg)
    caph = emb_q4.shape[0] // npd
    b, r = pids.shape
    if lens.shape != pids.shape:
        msg = f"lens {tuple(lens.shape)} must match pids {tuple(pids.shape)}"
        raise ValueError(msg)
    if queries.ndim != 3 or queries.shape[0] != b or queries.shape[2] != d:
        msg = f"queries must be [B={b}, Q, D={d}]; got {tuple(queries.shape)}"
        raise ValueError(msg)
    if pids.dtype != torch.int32 or lens.dtype != torch.int32:
        msg = f"{name}: pids and lens must be int32"
        raise TypeError(msg)
    others = {"emb_q4": emb_q4, "q4_scale": q4_scale, "lens": lens, "queries": queries}
    for label, t in others.items():
        if t.device != pids.device:
            msg = f"{name}: {label} is on {t.device}, not {pids.device}"
            raise ValueError(msg)
    q = queries.shape[1]
    qb = queries.to(torch.bfloat16)
    if not all(t.is_contiguous() for t in (emb_q4, q4_scale, pids, lens, qb)):
        msg = f"{name}: inputs must be contiguous"
        raise ValueError(msg)
    if d % 16 or q < 1:
        msg = f"{name}: needs D a multiple of 16 and Q >= 1; got D={d}, Q={q}"
        raise ValueError(msg)
    if emb_q4.data_ptr() % 16 or qb.data_ptr() % 16:
        msg = f"{name}: emb_q4 and queries must be 16-byte aligned"
        raise ValueError(msg)
    lib = load_library()
    if lib.fp_maxsim_q4_gather_smem_bytes(d, min(q, _MAX_Q)) < 0:
        msg = f"{name}: D={d} is too wide for one block's shared memory"
        raise ValueError(msg)
    # The kernel's dequantized k order inside each group of 4 dimensions is
    # (0, 2, 1, 3); the queries follow it, which leaves every dot unchanged.
    qb = qb.view(b, q, d // 4, 2, 2).transpose(-1, -2).reshape(b, q, d).contiguous()
    stream = torch.cuda.current_stream(pids.device).cuda_stream
    out = None
    for qc in _query_chunks(qb):
        part = torch.empty((b, r), dtype=torch.float32, device=pids.device)
        status = lib.fp_maxsim_q4_gather(
            emb_q4.data_ptr(),
            q4_scale.data_ptr(),
            npd,
            caph,
            d,
            pids.data_ptr(),
            lens.data_ptr(),
            qc.data_ptr(),
            b,
            r,
            qc.shape[1],
            part.data_ptr(),
            stream,
        )
        check(status, name)
        count_launch(maxsim_q4_gather_scores)
        out = part if out is None else out.add_(part)
    return out


maxsim_q4_gather_scores.launches = 0
