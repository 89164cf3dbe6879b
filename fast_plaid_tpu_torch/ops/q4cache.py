"""4-bit linearly quantized corpus cache (the q4 prefilter tier), in PyTorch.

Port of ``fast_plaid_tpu/ops/q4cache.py``. Each document's decompressed
embedding is re-quantized to 4 bits a dimension with one symmetric scale per
document, so that the cache costs a quarter of the bf16 corpus cache. It is
a prefilter: stage 6 scores the whole rerank pool from it, keeps the top
``rescue_pool(top_k)`` and rescores only those exactly through the codec.

The byte layout is the JAX package's, and both packages produce the same
bytes for the same input:

* Token-pair packing: byte (t, d) holds dimension d of tokens t (low nibble)
  and t + T/2 (high nibble). MaxSim reduces over tokens with a max, so the
  two nibble planes are scored independently and max-combined.
* Each nibble stores level + 8 with the level in [-7, 7]. The per-document
  scale is non-negative and commutes with the whole MaxSim reduction, so it
  multiplies the final score.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_emb_q4", "dequantize_emb_q4", "score_q4"]

NEG = float("-inf")


def quantize_emb_q4(emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., T, D] -> (packed [..., T/2, D] uint8, scale [...] float32).

    The scale maps the document's max |v| to level 7; an all-zero document
    gets scale 0. ``torch.round`` rounds half to even, as ``jnp.round``.
    """
    t = emb.shape[-2]
    if t % 2:
        msg = f"token count must be even for nibble packing, got {t}"
        raise ValueError(msg)
    emb = emb.to(torch.float32)
    peak = torch.amax(torch.abs(emb), dim=(-2, -1))
    scale = peak / 7.0
    q = torch.clamp(
        torch.round(emb / torch.clamp(scale, min=1e-12)[..., None, None]), -7, 7
    ).to(torch.int32) + 8
    lo, hi = q[..., : t // 2, :], q[..., t // 2 :, :]
    return (lo | (hi << 4)).to(torch.uint8), scale


def dequantize_emb_q4(
    packed: torch.Tensor, scale: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """(packed [..., T/2, D] uint8, scale [...]) -> [..., T, D] embeddings."""
    lo = (packed & 15).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.cat([lo, hi], dim=-2).to(torch.float32)
    return (q * scale[..., None, None].to(torch.float32)).to(out_dtype)


def score_q4(
    emb_q4: torch.Tensor,  # [Np * doc_cap/2, D] uint8 (2-D, index/layout.py)
    q4_scale: torch.Tensor,  # [Np] float32
    doc_lengths: torch.Tensor,  # [Np] int32
    pids: torch.Tensor,  # [B, R] int32
    queries: torch.Tensor,  # [B, Q, D]
    mem_budget: int = 256 * 1024 * 1024,
) -> torch.Tensor:
    """MaxSim scores of candidates from the q4 cache: [B, R] float32.

    Integer levels in bf16 against bf16-rounded queries, float32 sums, then
    the per-document scale. Pids are clipped to [0, Np - 1] (the last row
    has length 0); rows of length 0 score -inf.
    """
    b, r = pids.shape
    npd = q4_scale.shape[0]
    d = queries.shape[-1]
    q = queries.shape[1]
    caph = emb_q4.shape[0] // npd
    doc_cap = 2 * caph
    qf = queries.to(torch.bfloat16).to(torch.float32)
    per_row = b * doc_cap * (d * 2 + q * 4) * 2
    r_chunk = max(4, min(r, mem_budget // max(1, per_row)))
    p = torch.clamp(pids, 0, npd - 1).long()
    tok = torch.arange(doc_cap, device=pids.device)
    ones = torch.ones((), dtype=torch.float32, device=pids.device)
    out = torch.empty((b, r), dtype=torch.float32, device=pids.device)
    for s in range(0, r, r_chunk):
        pc = p[:, s : s + r_chunk]
        ridx = pc[..., None] * caph + torch.arange(caph, device=pids.device)
        emb = dequantize_emb_q4(emb_q4[ridx], ones.expand(pc.shape), torch.bfloat16)
        ts = torch.einsum("brtd,bqd->brtq", emb.to(torch.float32), qf)
        lens = doc_lengths[pc]
        ts = torch.where((tok < lens[..., None])[..., None], ts, NEG)
        sc = torch.sum(torch.amax(ts, dim=2), dim=-1) * q4_scale[pc]
        out[:, s : s + r_chunk] = torch.where(lens > 0, sc, NEG)
    return out
