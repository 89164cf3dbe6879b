"""Chunked Lloyd's k-means in PyTorch.

Port of ``fast_plaid_tpu/ops/kmeans.py``: distances via the
||x||^2 + ||c||^2 - 2 x.c expansion (bf16 inputs, float32 accumulation),
``max_points_per_centroid`` subsampling, empty clusters re-seeded from
random data points, seeded and deterministic. The sampling and the initial
centroids come from numpy ``default_rng(seed)`` exactly as in the JAX
package, so both packages start from the same centroids. The empty-cluster
re-seed draws from a ``torch.Generator`` and so picks other points than
``jax.random`` does. Centroid sums use ``index_add_`` (the JAX package's
one-hot matmul is a TPU workaround for slow scatters). The host counter
``kmeans.points`` counts the points Lloyd's trains on.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_plaid_tpu_torch.ops.codec import bf16_matmul
from fast_plaid_tpu_torch.utils import tracing

__all__ = ["train_kmeans", "num_partitions_heuristic", "sample_size_heuristic"]


def num_partitions_heuristic(estimated_total_tokens: float) -> int:
    """K = 2^floor(log2(16 * sqrt(total_tokens)))."""
    return int(2 ** np.floor(np.log2(16 * np.sqrt(max(estimated_total_tokens, 1)))))


def sample_size_heuristic(num_documents: int) -> int:
    """Documents sampled for k-means: min(1 + 16*sqrt(120*N), N)."""
    return min(1 + int(16 * np.sqrt(120 * num_documents)), num_documents)


def _lloyd(
    data: torch.Tensor,
    init: torch.Tensor,
    generator: torch.Generator,
    k: int,
    niters: int,
    chunk: int,
) -> torch.Tensor:
    """Fixed-iteration Lloyd's over [T, D] float32 data with k centroids."""
    t, d = data.shape
    x2 = torch.sum(data * data, dim=-1)  # [T]
    data16 = data.to(torch.bfloat16).to(torch.float32)
    centroids = init
    for _ in range(niters):
        c2 = torch.sum(centroids * centroids, dim=-1)  # [k]
        sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        cent_t = centroids.t()
        for start in range(0, t, chunk):
            x = data[start : start + chunk]
            xc = bf16_matmul(x, cent_t)
            dist = x2[start : start + chunk, None] + c2[None, :] - 2.0 * xc
            codes = torch.argmin(dist, dim=-1)
            sums.index_add_(0, codes, data16[start : start + chunk])
            counts.index_add_(
                0, codes, torch.ones_like(codes, dtype=torch.float32)
            )
        new_centroids = sums / torch.clamp(counts, min=1.0)[:, None]
        rand_idx = torch.randint(0, t, (k,), generator=generator).to(data.device)
        centroids = torch.where(
            (counts > 0)[:, None], new_centroids, data[rand_idx]
        )
    return centroids


def train_kmeans(
    data: np.ndarray | torch.Tensor,
    k: int,
    niters: int = 4,
    seed: int = 42,
    max_points_per_centroid: int = 256,
    chunk: int = 16384,
    normalize: bool = True,
    device: torch.device | str = "cpu",
) -> np.ndarray | torch.Tensor:
    """Train k-means centroids on [T, D] float data; returns [k, D] float32.

    Subsamples to k * max_points_per_centroid points, seeds the init from a
    random permutation of the data, runs Lloyd's on ``device`` and
    (optionally) L2-normalizes the result. A tensor ``data`` stays where it
    is: the subsample is gathered and Lloyd's runs on its device (``device``
    is ignored), and the centroids come back as a tensor there. numpy data
    gives numpy centroids. The numpy draws are the same either way.
    """
    on_device = isinstance(data, torch.Tensor)
    if on_device:
        device = data.device
        data = data.to(torch.float32)
    else:
        device = torch.device(device)
        data = np.asarray(data, dtype=np.float32)
    t = data.shape[0]
    k = int(min(k, t))
    rng = np.random.default_rng(seed)

    # Keep the [chunk, k] distance tile within ~1 GiB on the device.
    max_chunk = max(1024, (1 << 30) // max(4 * k, 1))
    chunk = int(min(chunk, max_chunk))

    cap = k * max_points_per_centroid
    if t > cap:
        sel = np.sort(rng.choice(t, size=cap, replace=False))
        data = data[torch.from_numpy(sel).to(device)] if on_device else data[sel]
        t = cap

    # Trim to a whole number of chunks, as the JAX package does (it keeps
    # one compiled shape per (k, chunk)); the same points then train here.
    if t > chunk and t % chunk:
        t = (t // chunk) * chunk
        data = data[:t]

    tracing.count("kmeans.points", t)
    init_idx = np.sort(rng.permutation(t)[:k])
    data_t = (
        data.contiguous()
        if on_device
        else torch.from_numpy(np.ascontiguousarray(data)).to(device)
    )
    init = data_t[torch.from_numpy(init_idx).to(device)]
    generator = torch.Generator().manual_seed(seed)
    chunk = int(min(chunk, max(256, t)))
    centroids = _lloyd(data_t, init, generator, k, int(niters), chunk)
    if normalize:
        norms = torch.linalg.vector_norm(centroids, dim=-1, keepdim=True)
        centroids = centroids / torch.clamp(norms, min=1e-12)
    if on_device:
        return centroids
    return centroids.cpu().numpy().astype(np.float32, copy=False)
