"""Tensor and device memory debug helpers.

``print_array_memory`` prints the size of a numpy array or torch tensor;
``device_memory_summary`` gives one line per CUDA device from
``torch.cuda.memory_stats`` (in use, peak) and ``torch.cuda.mem_get_info``
(total). Opt-in tooling; not wired into the main path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["print_array_memory", "device_memory_summary"]


def _human(n_bytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n_bytes) < 1024.0:
            return f"{n_bytes:.2f} {unit}"
        n_bytes /= 1024.0
    return f"{n_bytes:.2f} PiB"


def print_array_memory(name: str, array) -> None:
    """Print a human-readable size line for a numpy array or torch tensor."""
    if isinstance(array, torch.Tensor):
        nbytes = array.numel() * array.element_size()
        where = f" device={array.device}"
    else:
        array = np.asarray(array)
        nbytes = array.nbytes
        where = ""
    print(
        f"[memory] {name}: shape={tuple(array.shape)} dtype={array.dtype}"
        f"{where} size={_human(nbytes)}"
    )


def device_memory_summary() -> str:
    """One line per CUDA device: bytes in use / peak (this process's
    allocator) and the card's total; empty without a CUDA device."""
    lines = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        lines.append(
            f"cuda:{i} {torch.cuda.get_device_name(i)} "
            f"in_use={_human(stats.get('allocated_bytes.all.current', 0))} "
            f"peak={_human(stats.get('allocated_bytes.all.peak', 0))} "
            f"total={_human(total)}"
        )
    summary = "\n".join(lines)
    print(summary)
    return summary
