"""Utilities: cross-process locking, resource profiling, profiler tracing,
memory summaries."""

from fast_plaid_tpu_torch.utils.locking import FileLock  # noqa: F401
from fast_plaid_tpu_torch.utils.profile import profile_resources  # noqa: F401

__all__ = ["FileLock", "profile_resources"]
