"""Compute ops: residual codec, k-means, MaxSim reductions, Hopper kernels."""

from fast_plaid_tpu_torch.ops import codec, kmeans, maxsim  # noqa: F401

__all__ = ["codec", "kmeans", "maxsim"]
