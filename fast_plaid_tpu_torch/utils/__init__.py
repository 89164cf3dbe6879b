"""Utilities: cross-process locking."""

from fast_plaid_tpu_torch.utils.locking import FileLock  # noqa: F401

__all__ = ["FileLock"]
