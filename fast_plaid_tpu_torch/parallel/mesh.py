"""Device meshes: arrays of ``torch.device`` objects with axis names.

Port of ``fast_plaid_tpu/parallel/mesh.py``. The JAX package's mesh is a
``jax.sharding.Mesh`` that one program spans; here one Python process holds
the device array and drives each device from a thread of its own
(``parallel/sharded.py``). A device may appear more than once: ``[cuda:0] *
4`` puts four shards on one card, ``[cpu] * 4`` is what the tests pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "pick_devices"]


@dataclass
class Mesh:
    """``devices`` is an object array of ``torch.device``: shape [n] for a
    1-D mesh, [r, d] for a 2-D one, one axis name a dimension."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self) -> list[torch.device]:
        """Every device slot, row-major (repeats kept)."""
        return list(self.devices.flat)


def _device(spec) -> torch.device:
    """``torch.device(spec)``, with a bare "cuda" pinned to the current card
    so that equal slots compare (and hash) equal."""
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_array(devices, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """An object array of ``torch.device``, built element by element."""
    devs = [_device(d) for d in np.asarray(devices, dtype=object).flat]
    out = np.empty(len(devs), dtype=object)
    out[:] = devs
    return out.reshape(shape if shape is not None else (len(devs),))


def pick_devices(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (None: all of them).

    Unlike the JAX package, which falls back to virtual CPU devices, this
    raises RuntimeError where there is no CUDA device or fewer than asked;
    a CPU mesh is built from an explicit ``devices`` list.
    """
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cuda == 0:
        msg = "No CUDA device available; pass devices=[torch.device('cpu')] * n for a CPU mesh."
        raise RuntimeError(msg)
    if n_devices is None:
        n_devices = n_cuda
    if n_devices > n_cuda:
        msg = f"Requested {n_devices} devices but only {n_cuda} CUDA devices exist."
        raise RuntimeError(msg)
    return [torch.device("cuda", i) for i in range(n_devices)]


def make_mesh(
    n_devices: int | None = None,
    devices: list[torch.device] | None = None,
    axis: str = "d",
) -> Mesh:
    """1-D mesh over ``devices`` or the first ``n_devices`` CUDA devices."""
    if devices is None:
        devices = pick_devices(n_devices)
    return Mesh(device_array(devices), (axis,))
