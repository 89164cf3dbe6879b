"""Index loading onto devices (port of ``fast_plaid_tpu/search/load.py``).

Reads the on-disk artifacts once on the host, then materializes the padded
device layout (``index/layout.py``) on every requested ``torch.device`` and,
when it fits the budget, the bf16 decompressed-corpus cache.

low_memory (host-resident residuals streamed per query tile) is not ported
yet: on CUDA it raises NotImplementedError; on the CPU it is ignored, as in
the JAX package.
"""

from __future__ import annotations

import os

import torch

from fast_plaid_tpu_torch.index.layout import (
    DeviceIndex,
    IndexSpec,
    build_emb_cache,
    emb_cache_bytes,
    round_up,
    to_device,
)
from fast_plaid_tpu_torch.index.storage import load_index_data

__all__ = ["reload_index", "LoadedIndex", "default_emb_cache_budget"]


class LoadedIndex:
    """One device's resident index: tensors + static spec + the device."""

    def __init__(
        self,
        dev: DeviceIndex,
        ispec: IndexSpec,
        device: torch.device,
        ivf_lengths_host=None,
    ):
        self.dev = dev
        self.ispec = ispec
        self.device = device
        # Host-side IVF length stats feed candidate-capacity sizing.
        self.ivf_lengths_host = ivf_lengths_host


def default_emb_cache_budget(device: torch.device) -> int:
    """Default device-memory budget for the rerank cache.

    ``FASTPLAID_TPU_EMB_CACHE_BYTES`` overrides. On a GPU: 95% of the free
    memory that ``torch.cuda.mem_get_info`` reports, less 2 GB of headroom
    for search temporaries. On the CPU the cache is opt-in (0).
    """
    env = os.environ.get("FASTPLAID_TPU_EMB_CACHE_BYTES")
    if env is not None:
        return int(env)
    if device.type == "cpu":
        return 0
    free, _total = torch.cuda.mem_get_info(device)
    return max(0, int(0.95 * free) - 2 * 1024**3)


def _q4_cache_bytes(ispec: IndexSpec) -> int:
    np_docs = round_up(ispec.n_docs + 1, 8)
    return np_docs * (ispec.doc_cap * ispec.dim // 2 + 4)


def _construct(
    data,
    device: torch.device,
    emb_cache_budget: int | None = None,
    length_buckets: int = 4,
) -> LoadedIndex:
    dev, ispec = to_device(
        centroids=data.centroids,
        bucket_weights=data.bucket_weights,
        codes=data.codes,
        residuals=data.residuals,
        doc_lengths=data.doc_lengths,
        ivf=data.ivf,
        ivf_lengths=data.ivf_lengths,
        nbits=data.nbits,
        device=device,
        length_buckets=length_buckets,
    )
    budget = (
        default_emb_cache_budget(device)
        if emb_cache_budget is None
        else emb_cache_budget
    )
    if 0 < emb_cache_bytes(ispec) <= budget:
        dev = build_emb_cache(dev, ispec)
    elif ispec.dim % 2 == 0 and 0 < _q4_cache_bytes(ispec) <= budget:
        # The JAX package builds its 4-bit prefilter cache here.
        msg = (
            f"the bf16 corpus cache ({emb_cache_bytes(ispec)} B) exceeds the "
            f"budget ({budget} B) and the q4 tier that would take its place "
            "is not ported yet (ROADMAP.md §1, q4 tier); raise "
            "emb_cache_budget_bytes or set it to 0"
        )
        raise NotImplementedError(msg)
    return LoadedIndex(dev, ispec, device, ivf_lengths_host=data.ivf_lengths)


def reload_index(
    index_path: str,
    devices: list[torch.device],
    low_memory: bool = False,
    emb_cache_budget: int | None = None,
    length_buckets: int = 4,
) -> dict[str, LoadedIndex | None]:
    """Load the index for each device; returns {str(device): LoadedIndex|None}."""
    for d in devices:
        if low_memory and d.type != "cpu":
            msg = (
                "pass low_memory=False; low_memory lands in a later PR "
                "(ROADMAP.md §1, low_memory)"
            )
            raise NotImplementedError(msg)
    data = load_index_data(index_path)
    if data is None:
        return {str(d): None for d in devices}
    return {
        str(d): _construct(
            data,
            d,
            emb_cache_budget=emb_cache_budget,
            length_buckets=length_buckets,
        )
        for d in devices
    }
