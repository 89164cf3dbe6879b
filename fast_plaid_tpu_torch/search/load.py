"""Index loading onto devices (port of ``fast_plaid_tpu/search/load.py``).

Reads the on-disk artifacts once on the host, then materializes the padded
device layout (``index/layout.py``) on every requested ``torch.device`` and,
within the budget, a rerank cache: the bf16 decompressed corpus, or where
that does not fit, the 4-bit q4 prefilter cache.

low_memory keeps the residuals (the bulk of the index) in host RAM, as mmaps
of the index files, and the searcher gathers only the rerank rows of each
query tile there, codes included, and sends them to the device.
The q4 cache is then built on the device from host rows, streamed once. On
the CPU low_memory is ignored, as in the JAX package.

A resident load of a length-skewed corpus chooses between the single-cap
layout and length buckets by the cache budget (``choose_length_buckets``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from fast_plaid_tpu_torch.index.layout import (
    DeviceIndex,
    IndexSpec,
    build_emb_cache,
    build_q4_cache,
    emb_cache_bytes,
    plan_buckets,
    q4_cache_bytes,
    quantize_q4_rows,
    round_up,
    to_device,
)
from fast_plaid_tpu_torch.index.storage import load_index_data
from fast_plaid_tpu_torch.ops.codec import packed_dim
from fast_plaid_tpu_torch.utils import tracing

__all__ = [
    "reload_index",
    "LoadedIndex",
    "default_emb_cache_budget",
    "layout_cache_bytes",
    "choose_length_buckets",
]


class LoadedIndex:
    """One device's resident index: tensors + static spec + the device, and in
    low_memory the host-RAM arrays the searcher gathers rerank rows from."""

    def __init__(
        self,
        dev: DeviceIndex,
        ispec: IndexSpec,
        device: torch.device,
        ivf_lengths_host=None,
        low_memory: bool = False,
        host_codes: np.ndarray | None = None,
        host_residuals: np.ndarray | None = None,
        host_doc_offsets: np.ndarray | None = None,
        host_doc_lengths: np.ndarray | None = None,
    ):
        self.dev = dev
        self.ispec = ispec
        self.device = device
        # Host-side IVF length stats feed candidate-capacity sizing.
        self.ivf_lengths_host = ivf_lengths_host
        self.low_memory = low_memory
        self.host_codes = host_codes  # [T] int32 token-major
        self.host_residuals = host_residuals  # [T, PD] uint8
        self.host_doc_offsets = host_doc_offsets  # [n_docs] int64
        self.host_doc_lengths = host_doc_lengths  # [n_docs] int32
        # Resolved search plans (searcher.plan_search), one per q_cap and
        # parameter set: this index never changes, so neither do they.
        self.plans: dict = {}


def default_emb_cache_budget(device: torch.device, reserve: int = 0) -> int:
    """Default device-memory budget for the rerank cache.

    ``FASTPLAID_TPU_EMB_CACHE_BYTES`` overrides. On a GPU: 95% of the free
    memory that ``torch.cuda.mem_get_info`` reports, less ``reserve`` bytes
    the caller is about to place there and 2 GB of headroom for search
    temporaries. On the CPU the cache is opt-in (0).
    """
    env = os.environ.get("FASTPLAID_TPU_EMB_CACHE_BYTES")
    if env is not None:
        return int(env)
    if device.type == "cpu":
        return 0
    free, _total = torch.cuda.mem_get_info(device)
    return max(0, int(0.95 * (free - reserve)) - 2 * 1024**3)


def layout_cache_bytes(doc_lengths, dim: int, length_buckets: int) -> dict:
    """Device bytes of the rerank caches a resident load could build.

    ``bf16``: the bf16 cache at the single cap; ``bf16_buckets``: the bf16
    caches of the length buckets ``plan_buckets`` picks for these lengths
    (None where it keeps one cap); ``q4``: the q4 cache (single cap only).
    """
    lens = np.asarray(doc_lengths, np.int64)
    n = int(lens.size)
    doc_cap = round_up(max(int(lens.max()) if n else 1, 1), 16)
    flat = IndexSpec(
        dim=dim, nbits=0, n_docs=n, n_partitions=0, doc_cap=doc_cap,
        cell_cap=0, has_ivf=False,
    )
    caps = (
        plan_buckets(lens, doc_cap, max_buckets=length_buckets)
        if length_buckets > 1 and n
        else None
    )
    bucketed = None
    if caps:
        which = np.searchsorted(caps, np.minimum(lens, doc_cap), side="left")
        counts = np.bincount(which, minlength=len(caps))
        bucketed = emb_cache_bytes(
            dataclasses.replace(
                flat,
                bucket_caps=tuple(caps),
                bucket_counts=tuple(int(c) for c in counts),
            )
        )
    return {
        "bf16": emb_cache_bytes(flat),
        "bf16_buckets": bucketed,
        "q4": q4_cache_bytes(flat) if dim % 2 == 0 else None,
    }


def choose_length_buckets(sizes: dict, length_buckets: int, budget: int) -> int:
    """The ``length_buckets`` a resident load passes to ``to_device``.

    Buckets save device memory and cost time and recall: stage 6 runs once
    per bucket, and a bucket's candidates past its quota are dropped. So
    the single cap comes first wherever a rerank cache fits there: the bf16
    cache, or the q4 tier where the bucketed bf16 caches would not fit
    either. Buckets are taken where they are what lets the bf16 cache fit,
    or where no cache fits at all (their residuals are the smaller).
    """
    if sizes["bf16_buckets"] is None or sizes["bf16"] <= budget:
        return 0
    if sizes["bf16_buckets"] <= budget:
        return length_buckets
    if sizes["q4"] is not None and sizes["q4"] <= budget:
        return 0
    return length_buckets


def _construct(
    data,
    device: torch.device,
    low_memory: bool,
    emb_cache_budget: int | None = None,
    length_buckets: int = 4,
) -> LoadedIndex:
    if not low_memory and length_buckets > 1:
        dim = int(data.centroids.shape[1])
        sizes = layout_cache_bytes(data.doc_lengths, dim, length_buckets)
        if emb_cache_budget is None:
            # The budget once the single-cap codes and residuals are loaded.
            n_rows = round_up(len(data.doc_lengths) + 1, 8)
            doc_cap = round_up(max(int(np.max(data.doc_lengths, initial=1)), 1), 16)
            reserve = n_rows * doc_cap * (4 + packed_dim(dim, data.nbits))
            layout_budget = default_emb_cache_budget(device, reserve=reserve)
        else:
            layout_budget = emb_cache_budget
        length_buckets = choose_length_buckets(sizes, length_buckets, layout_budget)
    with tracing.span("open.device"):
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
            residuals_on_device=not low_memory,
            length_buckets=0 if low_memory else length_buckets,
        )
    budget = (
        default_emb_cache_budget(device)
        if emb_cache_budget is None
        else emb_cache_budget
    )
    if not low_memory:
        with tracing.span("open.cache"):
            if 0 < emb_cache_bytes(ispec) <= budget:
                dev = build_emb_cache(dev, ispec)
            elif ispec.dim % 2 == 0 and 0 < q4_cache_bytes(ispec) <= budget:
                # The bf16 cache does not fit and the q4 tier does: prefilter
                # from the 4x smaller copy, rescore the top slice via the codec.
                dev = build_q4_cache(dev, ispec)
    host_kwargs = {}
    if low_memory:
        doc_lengths = np.asarray(data.doc_lengths, np.int64)
        offsets = np.concatenate([[0], np.cumsum(doc_lengths)])[:-1].astype(np.int64)
        host_kwargs = {
            # The index files' mmaps as they are: pages load on demand.
            "host_codes": data.codes,
            "host_residuals": data.residuals,
            "host_doc_offsets": offsets,
            "host_doc_lengths": doc_lengths.astype(np.int32),
        }
    loaded = LoadedIndex(
        dev,
        ispec,
        device,
        ivf_lengths_host=data.ivf_lengths,
        low_memory=low_memory,
        **host_kwargs,
    )
    if low_memory and ispec.dim % 2 == 0 and 0 < q4_cache_bytes(ispec) <= budget:
        with tracing.span("open.cache"):
            _build_q4_from_host(loaded)
    return loaded


def _build_q4_from_host(loaded: LoadedIndex, block: int = 8192) -> None:
    """Build the device q4 prefilter cache from host-resident residuals.

    Streams doc-major row blocks to the device once (about the finished
    cache's bytes) and quantizes them there into one preallocated tensor.
    Afterwards the searcher scores whole rerank pools on the device and
    gathers only the rescue pool's rows on the host.
    """
    from fast_plaid_tpu_torch.search.searcher import host_gather_rows

    dev = loaded.dev
    ispec = loaded.ispec
    np_docs, cap = dev.codes.shape
    caph = cap // 2
    pin = loaded.device.type == "cuda"
    out = torch.empty(
        (np_docs * caph, ispec.dim), dtype=torch.uint8, device=loaded.device
    )
    scale = torch.empty((np_docs,), dtype=torch.float32, device=loaded.device)
    for start in range(0, np_docs, block):
        end = min(start + block, np_docs)
        pids = np.arange(start, end, dtype=np.int64)[None]
        codes_rows, res_rows, _ = host_gather_rows(loaded, pids, pin=pin)
        out[start * caph : end * caph], scale[start:end] = quantize_q4_rows(
            codes_rows[0].to(loaded.device, non_blocking=True),
            res_rows[0].to(loaded.device, non_blocking=True),
            dev.centroids,
            dev.bucket_weights,
            nbits=ispec.nbits,
        )
    loaded.dev = dataclasses.replace(dev, emb_q4=out, q4_scale=scale)


def reload_index(
    index_path: str,
    devices: list[torch.device],
    low_memory: bool = False,
    emb_cache_budget: int | None = None,
    length_buckets: int = 4,
) -> dict[str, LoadedIndex | None]:
    """Load the index for each device; returns {str(device): LoadedIndex|None}.

    low_memory is ignored on the CPU, where host and device memory are one.
    """
    with tracing.span("open"):
        with tracing.span("open.host"):
            data = load_index_data(index_path)
        if data is None:
            return {str(d): None for d in devices}
        return {
            str(d): _construct(
                data,
                d,
                low_memory and d.type != "cpu",
                emb_cache_budget=emb_cache_budget,
                length_buckets=length_buckets,
            )
            for d in devices
        }
