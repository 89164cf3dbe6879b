"""Utilities: cross-process locking, the span and counter recorder
(``tracing``), memory summaries."""

from fast_plaid_tpu_torch.utils.locking import FileLock  # noqa: F401

__all__ = ["FileLock"]
