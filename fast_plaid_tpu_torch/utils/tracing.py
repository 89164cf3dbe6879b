"""Profiler helpers.

``trace(log_dir)`` records the enclosed region with ``torch.profiler``
(CPU and, where a card is present, CUDA activity) and writes a Chrome trace
into ``log_dir``; ``annotate(name)`` labels a host-side region inside it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region; write ``trace_<ns>.json`` into log_dir.

    Yields the ``torch.profiler.profile`` object, whose ``key_averages()``
    give the time by operator and kernel.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Context manager labeling a host-side region inside a profiler trace."""
    return record_function(name)
