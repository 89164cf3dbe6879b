"""Serving layer: micro-batched HTTP search server (stdlib-only)."""

from fast_plaid_tpu_torch.serving.batcher import BatchStats, MicroBatcher
from fast_plaid_tpu_torch.serving.server import SearchServer, make_server

__all__ = ["MicroBatcher", "BatchStats", "SearchServer", "make_server"]
