"""2-D (replica x shard) mesh search: throughput x capacity.

Port of ``fast_plaid_tpu/parallel/mesh2d.py``. One axis ('d') shards the
documents, as ``parallel/sharded.py`` does; the other ('r') replicates that
shard group and splits the query batch across the replicas. Each replica
merges only within its own shard group; replicas never exchange results
before the final concatenation.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_plaid_tpu_torch.parallel.mesh import Mesh, device_array, pick_devices
from fast_plaid_tpu_torch.parallel.sharded import (
    SUBSET_SENTINEL,
    ShardedIndex,
    _as_tensor,
    _doc_sharded,
    _index_to,
    _pad_rows,
    _search_kwargs,
    pad_global_subsets,
)

__all__ = ["make_mesh_2d", "replicate_sharded_index", "sharded_search_2d"]


def make_mesh_2d(n_replicas: int, n_shards: int, devices=None) -> Mesh:
    """('r', 'd') mesh: ``n_replicas`` rows of ``n_shards`` device slots.
    ``devices`` None takes the first n_replicas * n_shards CUDA devices."""
    need = n_replicas * n_shards
    if devices is None:
        try:
            devices = pick_devices(need)
        except RuntimeError as exc:
            raise ValueError(str(exc)) from exc
    devices = device_array(devices)
    if devices.size < need:
        msg = f"need {need} devices, have {devices.size}"
        raise ValueError(msg)
    return Mesh(devices[:need].reshape(n_replicas, n_shards), ("r", "d"))


def replicate_sharded_index(sharded: ShardedIndex, mesh2d: Mesh) -> ShardedIndex:
    """Lay a doc-sharded index onto a 2-D mesh: replica row r gets a copy of
    every shard on the devices of that row (no copy where a shard is
    already on its slot's device)."""
    n_rep, n_sh = mesh2d.devices.shape
    if n_sh != sharded.n_shards:
        msg = f"the mesh's 'd' axis has {n_sh} slots for {sharded.n_shards} shards"
        raise ValueError(msg)
    shards = [
        _index_to(sharded.shards[i], mesh2d.devices[r, i])
        for r in range(n_rep)
        for i in range(n_sh)
    ]
    return ShardedIndex(
        shards=shards,
        ispec=sharded.ispec,
        doc_base=sharded.doc_base,
        mesh=mesh2d,
        n_docs_total=sharded.n_docs_total,
        ivf_lengths_host=sharded.ivf_lengths_host,
    )


def sharded_search_2d(
    sharded: ShardedIndex,
    queries,
    *,
    top_k: int = 10,
    n_ivf_probe: int = 8,
    n_full_scores: int = 4096,
    mem_budget: int = 256 * 1024 * 1024,
    approx_mode: str = "auto",
    rank_admit: int | None = None,
    pool_divisor: int = 2,
    subset: np.ndarray | list[list[int]] | None = None,
    want_tokens: bool = False,
    with_stats: bool = False,
):
    """[B, Q, D] queries -> ([B, top_k] global ids, scores) on an ('r', 'd')
    mesh. Batches not divisible by the replica count are padded with zero
    queries (and SUBSET_SENTINEL subset rows) and trimmed.

    ``subset`` / ``want_tokens`` / ``with_stats`` behave as in
    ``sharded.sharded_search``; stats are summed over each replica's shard
    group.
    """
    n_rep = sharded.mesh.shape["r"]
    q = _as_tensor(queries, torch.float32)
    b = q.shape[0]
    bp = -(-b // n_rep) * n_rep
    if isinstance(subset, list):
        subset = pad_global_subsets(subset, sharded.n_docs_total)
    sub = None if subset is None else _as_tensor(subset, torch.int32)
    q = _pad_rows(q, bp, 0)
    if sub is not None:
        sub = _pad_rows(sub, bp, SUBSET_SENTINEL)
    kw = _search_kwargs(
        sharded.ispec, q.shape[1], top_k=top_k, n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores, mem_budget=mem_budget, approx_mode=approx_mode,
        rank_admit=rank_admit, pool_divisor=pool_divisor,
        ivf_lengths_host=sharded.ivf_lengths_host,
    )
    per = bp // n_rep
    parts = [
        (q[r * per : (r + 1) * per], None if sub is None else sub[r * per : (r + 1) * per])
        for r in range(n_rep)
    ]
    out = _doc_sharded(sharded, parts, want_tokens=want_tokens, with_stats=with_stats, **kw)
    return tuple(x[:b] for x in out)
