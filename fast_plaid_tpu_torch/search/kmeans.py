"""Centroid training orchestration (port of ``fast_plaid_tpu/search/kmeans.py``).

Document sampling and the K heuristic on top of the PyTorch Lloyd's trainer
(``fast_plaid_tpu_torch.ops.kmeans``).
"""

from __future__ import annotations

import numpy as np
import torch

from fast_plaid_tpu_torch.ops import kmeans as kmeans_ops
from fast_plaid_tpu_torch.utils.devices import default_device

__all__ = ["compute_kmeans"]


def compute_kmeans(
    documents_embeddings,
    dim: int,
    kmeans_niters: int = 4,
    max_points_per_centroid: int = 256,
    seed: int = 42,
    n_samples_kmeans: int | None = None,
    num_partitions: int | None = None,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Sample documents, pick K, train k-means; returns [K, dim] f32 L2-normalized.

    Trains on ``device``: None is the CUDA card, and raises without one
    (pass ``device="cpu"`` for the CPU).

    Sampling: min(1 + 16*sqrt(120*N), N) documents. K:
    2^floor(log2(16*sqrt(estimated_total_tokens))) unless given, capped at
    the sampled token count.
    """
    device = default_device(device)
    num_documents = len(documents_embeddings)
    if n_samples_kmeans is None:
        n_samples_kmeans = kmeans_ops.sample_size_heuristic(num_documents)
    n_samples_kmeans = min(num_documents, n_samples_kmeans)

    rng = np.random.default_rng(seed)
    sampled = rng.permutation(num_documents)[:n_samples_kmeans]
    samples = np.concatenate(
        [np.asarray(documents_embeddings[i], dtype=np.float32) for i in sampled],
        axis=0,
    )
    total_tokens = samples.shape[0]

    if num_partitions is None:
        avg_tokens_per_doc = total_tokens / max(n_samples_kmeans, 1)
        estimated_total_tokens = avg_tokens_per_doc * num_documents
        num_partitions = kmeans_ops.num_partitions_heuristic(estimated_total_tokens)

    actual_k = int(min(num_partitions, total_tokens))
    return kmeans_ops.train_kmeans(
        samples,
        k=actual_k,
        niters=kmeans_niters,
        seed=seed,
        max_points_per_centroid=max_points_per_centroid,
        normalize=True,
        device=device,
    )
