"""Opt-in resource profiling decorator.

``@profile_resources`` prints a call's wall time (the CUDA work it queued
included: it synchronizes before reading the clock), the host RSS delta via
psutil where installed, and the device memory delta from
``torch.cuda.memory_allocated``. Not wired into the main path.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import torch

__all__ = ["profile_resources"]


def _device_mem_bytes() -> int:
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))


def _rss_bytes() -> int:
    try:
        import psutil
    except ImportError:
        return 0
    return int(psutil.Process().memory_info().rss)


def profile_resources(func: Callable[..., Any]) -> Callable[..., Any]:
    """Print wall time, RSS delta and device-memory delta around a call."""

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        rss0 = _rss_bytes()
        dev0 = _device_mem_bytes()
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rss1 = _rss_bytes()
        dev1 = _device_mem_bytes()
        mib = 1024 * 1024
        print(
            f"[profile] {func.__name__}: {dt:.3f}s | "
            f"RSS {rss0 / mib:.1f}->{rss1 / mib:.1f} MiB "
            f"(delta {(rss1 - rss0) / mib:+.1f}) | "
            f"device {dev0 / mib:.1f}->{dev1 / mib:.1f} MiB "
            f"(delta {(dev1 - dev0) / mib:+.1f})"
        )
        return result

    return wrapper
