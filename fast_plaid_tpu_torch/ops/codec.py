"""Residual quantization codec, in PyTorch.

Port of ``fast_plaid_tpu/ops/codec.py``. Same semantics and the same
``layout_version: 1`` byte layout (plane-major nibble packing: byte ``i`` of
a token's PD bytes holds dims ``i, i+PD, ..., i+(vpb-1)*PD``, value ``j`` at
bits ``[j*nbits, (j+1)*nbits)``), so either package reads the other's index.

* ``codes[t] = argmax_k centroids[k] . emb[t]``, scored with bf16-rounded
  inputs and float32 accumulation, as the JAX package does.
* ``bucket = #cutoffs strictly below value`` (``torch.bucketize``,
  ``right=False``).
* Decompression adds the bucket weight to the centroid and L2-normalizes
  (norm clamped at 1e-12). The weights are gathered directly; the JAX
  package's select-sum is a TPU workaround for slow gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "CodecParams",
    "train_codec",
    "assign_codes",
    "quantize_residuals",
    "pack_nibbles",
    "unpack_nibbles",
    "compress",
    "decompress",
    "packed_dim",
    "bf16_matmul",
]

# The reference multiplies bf16 inputs with float32 accumulation and a
# float32 result. TF32 would keep only ~10 mantissa bits of the sums and
# flip argmax/argmin far more often than true near-ties do.
torch.backends.cuda.matmul.allow_tf32 = False


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both inputs rounded to bf16 and a float32 product.

    The counterpart of ``jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32)``: products of bf16 values are exact in
    float32, so only the summation order differs. A bf16 ``torch.matmul``
    would round the OUTPUT to bf16 instead.
    """
    return torch.matmul(
        a.to(torch.bfloat16).to(torch.float32),
        b.to(torch.bfloat16).to(torch.float32),
    )


def packed_dim(dim: int, nbits: int) -> int:
    """Bytes per token for the packed residual of a ``dim``-d vector."""
    if 8 % nbits != 0:
        msg = f"nbits must divide 8, got {nbits}"
        raise ValueError(msg)
    if (dim * nbits) % 8 != 0:
        msg = f"dim * nbits must be a multiple of 8, got dim={dim}, nbits={nbits}"
        raise ValueError(msg)
    return dim * nbits // 8


@dataclass(frozen=True)
class CodecParams:
    """Trained quantization parameters (host-side container)."""

    bucket_cutoffs: np.ndarray  # [2^nbits - 1] float32
    bucket_weights: np.ndarray  # [2^nbits] float32
    avg_residual: np.ndarray  # [dim] float32
    cluster_threshold: float
    nbits: int


def train_codec(heldout_residuals: np.ndarray, nbits: int) -> CodecParams:
    """Train bucket cutoffs/weights from held-out residuals (numpy).

    A copy of ``fast_plaid_tpu.ops.codec.train_codec``: cutoffs at
    quantiles i/2^nbits for i in 1..2^nbits-1, weights at (i+0.5)/2^nbits.
    """
    n_options = 1 << nbits
    flat = np.asarray(heldout_residuals, dtype=np.float32).reshape(-1)
    cut_q = np.arange(1, n_options) / n_options
    w_q = (np.arange(n_options) + 0.5) / n_options
    bucket_cutoffs = np.quantile(flat, cut_q).astype(np.float32)
    bucket_weights = np.quantile(flat, w_q).astype(np.float32)
    norms = np.linalg.norm(
        np.asarray(heldout_residuals, dtype=np.float32), axis=-1
    )
    cluster_threshold = float(np.quantile(norms, 0.75)) if norms.size else 0.0
    avg_residual = np.abs(heldout_residuals).mean(axis=0).astype(np.float32)
    return CodecParams(
        bucket_cutoffs=bucket_cutoffs,
        bucket_weights=bucket_weights,
        avg_residual=avg_residual,
        cluster_threshold=cluster_threshold,
        nbits=nbits,
    )


def assign_codes(
    embeddings: torch.Tensor, centroids: torch.Tensor, block: int = 2048
) -> torch.Tensor:
    """Nearest-centroid (max inner product) assignment: [T, D] -> [T] int32.

    Processed in ``block``-row chunks so the [block, K] score tile stays
    bounded. Ties go to the lowest centroid id, as ``jnp.argmax``.
    """
    cent_t = centroids.t()
    out = torch.empty(
        (embeddings.shape[0],), dtype=torch.int32, device=embeddings.device
    )
    for start in range(0, embeddings.shape[0], block):
        scores = bf16_matmul(embeddings[start : start + block], cent_t)
        out[start : start + block] = torch.argmax(scores, dim=-1).to(torch.int32)
    return out


def quantize_residuals(
    residuals: torch.Tensor, bucket_cutoffs: torch.Tensor
) -> torch.Tensor:
    """Bucketize residual values: bucket = #cutoffs strictly below value."""
    return torch.bucketize(residuals, bucket_cutoffs, right=False).to(torch.uint8)


def pack_nibbles(bucket_ids: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack [T, D] bucket ids (< 2^nbits) into [T, D*nbits/8] uint8."""
    vpb = 8 // nbits
    t, d = bucket_ids.shape
    pd = d // vpb
    planes = bucket_ids.reshape(t, vpb, pd).to(torch.int32)
    shifts = (
        torch.arange(vpb, dtype=torch.int32, device=bucket_ids.device) * nbits
    )[None, :, None]
    return torch.sum(planes << shifts, dim=-2).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor, nbits: int, dim: int) -> torch.Tensor:
    """Unpack [..., D*nbits/8] uint8 into [..., D] uint8 bucket ids."""
    vpb = 8 // nbits
    mask = (1 << nbits) - 1
    planes = [(packed >> (j * nbits)) & mask for j in range(vpb)]
    return torch.cat(planes, dim=-1) if vpb > 1 else planes[0]


def compress(
    embeddings: torch.Tensor,
    centroids: torch.Tensor,
    bucket_cutoffs: torch.Tensor,
    nbits: int,
    block: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Embeddings -> (codes [T] int32, packed [T, PD] uint8)."""
    codes = assign_codes(embeddings, centroids, block=block)
    residuals = embeddings - centroids[codes.long()]
    bucket_ids = quantize_residuals(residuals, bucket_cutoffs)
    return codes, pack_nibbles(bucket_ids, nbits)


def decompress(
    codes: torch.Tensor,
    packed: torch.Tensor,
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    nbits: int,
    *,
    normalize: bool = True,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Reconstruct embeddings: centroid[code] + weight[bucket], L2-normalized.

    Shapes are polymorphic in the leading axes: codes [...], packed
    [..., PD] -> [..., D] float32 (or ``out_dtype``).
    """
    dim = centroids.shape[-1]
    bucket_ids = unpack_nibbles(packed, nbits, dim)
    emb = centroids[codes.long()] + bucket_weights[bucket_ids.long()]
    if normalize:
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        emb = emb / torch.clamp(norm, min=1e-12)
    if out_dtype is not None:
        emb = emb.to(out_dtype)
    return emb
