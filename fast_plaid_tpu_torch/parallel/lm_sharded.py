"""Per-shard low_memory: document sharding with host-resident residuals.

Port of ``fast_plaid_tpu/parallel/lm_sharded.py``. Documents are sliced
contiguously across devices; each shard is a normal ``LoadedIndex`` (codes,
IVF and the q4 prefilter cache on its device, residuals as host views of
the index files), searched by the single-device searcher
(``searcher.search_on_device``: device candidates, q4 prefilter, host
gather, codec-exact rerank) on a thread of its own. The merge is an exact
host top-k over the shards' codec-exact scores, so exhaustive parameters
reproduce the single-device ranking.
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index.storage import IndexData, load_index_data
from fast_plaid_tpu_torch.parallel.mesh import device_array, pick_devices
from fast_plaid_tpu_torch.search.load import LoadedIndex, _construct
from fast_plaid_tpu_torch.search.searcher import search_on_device

__all__ = ["ShardedLowMemory", "load_sharded_lm", "shard_index_data"]


@dataclass
class ShardedLowMemory:
    """Doc-sharded low_memory handle: one LoadedIndex a device slot (None
    for an empty tail shard)."""

    shards: list[LoadedIndex | None]
    doc_base: list[int]  # global pid of each shard's doc 0
    n_docs_total: int

    def search(
        self,
        queries,
        *,
        top_k: int = 10,
        n_full_scores: int = 4096,
        n_ivf_probe: int = 8,
        approx_mode: str = "auto",
        mem_budget: int = 256 * 1024 * 1024,
        show_progress: bool = False,
        rank_admit: int | None = None,
        pool_divisor: int | None = None,
    ) -> list[list[tuple[int, float]]]:
        """Search every shard with the whole query batch; exact host merge.

        Returns per query the global top_k as (pid, score). Each shard runs
        ``search_on_device``, so ``approx_mode``, ``rank_admit`` and
        ``pool_divisor`` resolve per shard as on one device.
        """
        live = [(ld, base) for ld, base in zip(self.shards, self.doc_base) if ld is not None]

        def one(arg):
            ld, base = arg
            rows = search_on_device(
                ld,
                queries,
                top_k=top_k,
                n_full_scores=n_full_scores,
                n_ivf_probe=n_ivf_probe,
                subsets=None,
                want_tokens=False,
                mem_budget=mem_budget,
                show_progress=show_progress,
                approx_mode=approx_mode,
                rank_admit=rank_admit,
                pool_divisor=pool_divisor,
            )
            return [[(pid + base, score) for pid, score in row] for row in rows]

        with ThreadPoolExecutor(max_workers=len(live)) as pool:
            per_shard = list(pool.map(one, live))

        merged: list[list[tuple[int, float]]] = []
        for qi in range(len(per_shard[0])):
            cand = [hit for rows in per_shard for hit in rows[qi]]
            cand.sort(key=lambda t: -t[1])  # stable: ties keep shard order
            merged.append(cand[:top_k])
        return merged


def shard_index_data(data: IndexData, n_shards: int) -> list[IndexData]:
    """Slice an IndexData into ``n_shards`` contiguous document ranges.

    Codes and residuals slices are numpy views (mmap-backed arrays stay on
    disk); each shard gets a local IVF built from its local codes. Tail
    shards may be empty when n_docs < n_shards.
    """
    doc_lengths = np.asarray(data.doc_lengths, np.int64)
    n_docs = len(doc_lengths)
    per = max(1, math.ceil(n_docs / n_shards))
    token_starts = np.concatenate([[0], np.cumsum(doc_lengths)])
    k = data.centroids.shape[0]

    out = []
    for si in range(n_shards):
        d0, d1 = min(si * per, n_docs), min((si + 1) * per, n_docs)
        t0, t1 = int(token_starts[d0]), int(token_starts[d1])
        lens = doc_lengths[d0:d1].astype(np.int32)
        ivf, ivf_lengths = ivf_mod.build_ivf(data.codes[t0:t1], lens, k)
        out.append(
            dataclasses.replace(
                data,
                codes=data.codes[t0:t1],
                residuals=data.residuals[t0:t1],
                doc_lengths=lens,
                ivf=ivf,
                ivf_lengths=ivf_lengths,
            )
        )
    return out


def load_sharded_lm(
    index_path: str,
    devices: list[torch.device] | None = None,
    *,
    low_memory: bool = True,
    emb_cache_budget: int | None = None,
) -> ShardedLowMemory:
    """Load an on-disk index doc-sharded across ``devices`` (None: every
    CUDA device; raises without one).

    Each device slot holds its shard's probe and candidate state and, where
    it fits the budget, the q4 prefilter cache; with ``low_memory`` the
    residuals stay in host RAM as views of the index files (not on CPU
    devices, where host and device memory are one pool).
    """
    devices = list(device_array(pick_devices() if devices is None else devices).flat)
    data = load_index_data(index_path)
    if data is None:
        msg = f"no index at {index_path!r}"
        raise FileNotFoundError(msg)
    slices = shard_index_data(data, len(devices))
    per = max(1, math.ceil(len(data.doc_lengths) / len(devices)))

    def construct(args) -> LoadedIndex | None:
        sl, device = args
        if len(sl.doc_lengths) == 0:
            return None
        return _construct(
            sl,
            device,
            low_memory and device.type != "cpu",
            emb_cache_budget=emb_cache_budget,
            # No length buckets: the shards are capacity slices already.
            length_buckets=0,
        )

    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        shards = list(pool.map(construct, zip(slices, devices)))
    return ShardedLowMemory(
        shards=shards,
        doc_base=[si * per for si in range(len(devices))],
        n_docs_total=len(data.doc_lengths),
    )
