"""k-means parity: the PyTorch Lloyd's against fast_plaid_tpu.ops.kmeans.

The two frameworks' RNGs differ, so the comparison injects the same initial
centroids and uses data that leaves no cluster empty (the empty-cluster
re-seed is the only random step after the init). Tolerance 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_plaid_tpu.ops import kmeans as jkm
from fast_plaid_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(2)


def _clustered(seed: int, k: int, per: int, d: int = 128):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3.0
    pts = centers[np.repeat(np.arange(k), per)] + rng.standard_normal(
        (k * per, d)
    ).astype(np.float32) * 0.3
    return pts[rng.permutation(k * per)].astype(np.float32)


@pytest.mark.parametrize("niters,chunk", [(1, 256), (4, 300)])
def test_lloyd_matches_jax(niters, chunk):
    k = 16
    data = _clustered(0, k, 120)
    init = data[np.sort(np.random.default_rng(1).permutation(data.shape[0])[:k])]
    cj = np.asarray(
        jkm._lloyd(
            jnp.asarray(data), jnp.asarray(init), jax.random.PRNGKey(0), k, niters, chunk
        )
    )
    ct = tkm._lloyd(
        torch.from_numpy(data),
        torch.from_numpy(init),
        torch.Generator().manual_seed(0),
        k,
        niters,
        chunk,
    ).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)


def test_train_kmeans_matches_jax():
    """End to end with the same seed: numpy draws the same subsample and
    init in both packages."""
    data = _clustered(2, 8, 200, d=64)
    cj = jkm.train_kmeans(data, k=8, niters=3, seed=5, max_points_per_centroid=150)
    ct = tkm.train_kmeans(data, k=8, niters=3, seed=5, max_points_per_centroid=150)
    assert ct.shape == cj.shape == (8, 64) and ct.dtype == np.float32
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)


def test_heuristics_match_jax():
    for n in (1, 10, 1000, 57_638, 2_000_000):
        assert tkm.sample_size_heuristic(n) == jkm.sample_size_heuristic(n)
        assert tkm.num_partitions_heuristic(n * 120) == jkm.num_partitions_heuristic(
            n * 120
        )
