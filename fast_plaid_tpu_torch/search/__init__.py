"""Search package: FastPlaid API, engine, k-means, loading."""

from fast_plaid_tpu_torch.search.fast_plaid import FastPlaid, resolve_devices
from fast_plaid_tpu_torch.search.kmeans import compute_kmeans
from fast_plaid_tpu_torch.search.searcher import search_on_device

__all__ = [
    "FastPlaid",
    "compute_kmeans",
    "resolve_devices",
    "search_on_device",
]
