"""Document-sharded search with a top-k merge, and query-sharded search.

Port of ``fast_plaid_tpu/parallel/sharded.py``. Documents (codes,
residuals, lengths and a per-shard IVF) are split contiguously across the
devices of a mesh; centroids and codec tables are copied to each. Every
shard runs the whole cascade (``engine.search_impl``) over its documents,
maps its local pids to global ids by its base, and the per-shard [B, top_k]
results are copied to the first device and merged there by one stable
top-k: a few KB a query, never the candidate sets.

The JAX package runs the shards as one SPMD program (``shard_map`` with an
``all_gather`` inside one ``jit``). Here one process drives them: one worker
thread a distinct device, and the shards that share a device run one after
another in its thread (``_run_jobs``), so ``[cuda:0] * 4`` runs four shards
on one card and ``[cpu] * 4`` runs them in the tests.

Query sharding (``query_sharded_search``) keeps one index a device and
splits the query batch across the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index.layout import (
    DeviceIndex,
    DocBucket,
    IndexSpec,
    aligned_ivf_len,
    device_index_from_arrays,
    round_up,
    to_device,
)
from fast_plaid_tpu_torch.parallel.mesh import Mesh
from fast_plaid_tpu_torch.search.engine import (
    _top_k,
    candidate_capacity,
    resolve_approx_mode,
    search_impl,
    suggest_slot_budget,
)
from fast_plaid_tpu_torch.search.searcher import kernel_flags

__all__ = [
    "ShardedIndex",
    "build_sharded_index",
    "sharded_search",
    "query_sharded_search",
    "pad_global_subsets",
    "sharded_index_from_arrays",
    "SUBSET_SENTINEL",
]


@dataclass
class ShardedIndex:
    """Document-sharded index: one ``DeviceIndex`` a mesh slot.

    ``shards[j]`` lives on ``mesh.device_list()[j]``. On a 1-D mesh shard j
    holds documents [doc_base[j], doc_base[j] + its count); on a 2-D
    ('r', 'd') mesh (``mesh2d.replicate_sharded_index``) replica row r holds
    shards[r * n_shards : (r + 1) * n_shards], each a copy of shard j mod
    n_shards. Every shard pads to the one ``ispec``.
    """

    shards: list[DeviceIndex]
    ispec: IndexSpec  # identical static spec for every shard
    doc_base: np.ndarray  # [n_shards] int64 global id of each shard's doc 0
    mesh: Mesh
    n_docs_total: int
    ivf_lengths_host: np.ndarray | None = None  # per-cell max over shards

    @property
    def n_shards(self) -> int:
        return len(self.doc_base)


def _index_to(dev: DeviceIndex, device: torch.device) -> DeviceIndex:
    """``dev`` with every tensor on ``device`` (no copy where it is there)."""

    def mv(x):
        return None if x is None else x.to(device)

    fields = {
        f.name: mv(getattr(dev, f.name))
        for f in dataclasses.fields(dev)
        if f.name != "buckets"
    }
    buckets = tuple(
        DocBucket(codes=mv(bk.codes), residuals=mv(bk.residuals), emb=mv(bk.emb))
        for bk in dev.buckets
    )
    return dataclasses.replace(dev, **fields, buckets=buckets)


def _run_jobs(jobs: list[tuple[torch.device, Callable]]) -> list:
    """Run each ``(device, fn)`` job and return the results in job order.

    One worker thread a distinct device; the jobs that share a device run in
    sequence in its thread, under ``torch.inference_mode`` and, on a GPU,
    with that device current. The first exception a job raises propagates.
    """
    by_dev: dict[torch.device, list[int]] = {}
    for i, (device, _) in enumerate(jobs):
        by_dev.setdefault(device, []).append(i)
    out: list = [None] * len(jobs)

    def run(idx: list[int]) -> None:
        device = jobs[idx[0]][0]
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with ctx, torch.inference_mode():
            for i in idx:
                out[i] = jobs[i][1]()

    if len(by_dev) == 1:
        run(next(iter(by_dev.values())))
    else:
        with ThreadPoolExecutor(max_workers=len(by_dev)) as pool:
            futures = [pool.submit(run, idx) for idx in by_dev.values()]
            for fut in futures:
                fut.result()
    return out


def build_sharded_index(
    *,
    centroids: np.ndarray,
    bucket_weights: np.ndarray,
    codes: np.ndarray,
    residuals: np.ndarray,
    doc_lengths: np.ndarray,
    nbits: int,
    mesh: Mesh,
) -> ShardedIndex:
    """Split documents contiguously across a 1-D mesh and build per-shard
    IVFs.

    Every shard is padded to the shapes the JAX package's single SPMD
    program needs (``per`` documents, the largest aligned IVF, the global
    ``doc_cap`` and largest ``cell_cap``), so both packages prune alike.
    """
    devices = mesh.device_list()
    n_shards = len(devices)
    n_docs = int(len(doc_lengths))
    per = -(-n_docs // n_shards)
    doc_lengths = np.asarray(doc_lengths, np.int64)
    token_starts = np.concatenate([[0], np.cumsum(doc_lengths)])

    shards = []
    bases = []
    k = centroids.shape[0]
    for si in range(n_shards):
        # Clamp both ends: with n_docs < n_shards * per the tail shards are
        # empty and si * per can exceed n_docs.
        d0, d1 = min(si * per, n_docs), min((si + 1) * per, n_docs)
        t0, t1 = int(token_starts[d0]), int(token_starts[d1])
        lens = doc_lengths[d0:d1]
        ivf, ivf_lengths = ivf_mod.build_ivf(codes[t0:t1], lens, k)
        shards.append(
            {
                "codes": codes[t0:t1],
                "residuals": residuals[t0:t1],
                "doc_lengths": lens,
                "ivf": ivf,
                "ivf_lengths": ivf_lengths,
            }
        )
        bases.append(d0)

    doc_cap = round_up(max(int(doc_lengths.max()) if n_docs else 1, 1), 16)
    cell_cap = round_up(
        max(max((int(s["ivf_lengths"].max()) if k else 1) for s in shards), 1), 8
    )
    pad_ivf = max(aligned_ivf_len(s["ivf_lengths"]) for s in shards)

    devs, ispec = [], None
    for s, device in zip(shards, devices):
        dev, ispec = to_device(
            centroids=centroids,
            bucket_weights=bucket_weights,
            codes=s["codes"],
            residuals=s["residuals"],
            doc_lengths=s["doc_lengths"],
            ivf=s["ivf"],
            ivf_lengths=s["ivf_lengths"],
            nbits=nbits,
            device=device,
            doc_cap=doc_cap,
            cell_cap=cell_cap,
            pad_docs_to=per,
            pad_ivf_to=pad_ivf,
        )
        devs.append(dev)
    return ShardedIndex(
        shards=devs,
        ispec=ispec,
        doc_base=np.asarray(bases, np.int64),
        mesh=mesh,
        n_docs_total=n_docs,
        ivf_lengths_host=np.max(np.stack([s["ivf_lengths"] for s in shards]), axis=0),
    )


def sharded_index_from_arrays(arrays: dict, mesh: Mesh) -> ShardedIndex:
    """A ``ShardedIndex`` from another implementation's exported leaves.

    ``arrays`` maps ``DeviceIndex`` field names to numpy arrays with the
    leading shard axis [n_shards, ...] (``np.asarray`` of a JAX sharded
    leaf), plus ``doc_base`` [n_shards], ``ispec`` (a mapping of IndexSpec
    fields), ``n_docs_total`` and optionally ``ivf_lengths_host``. Shard j
    goes to ``mesh.device_list()[j]`` through
    ``layout.device_index_from_arrays``.
    """
    meta = ("doc_base", "ispec", "n_docs_total", "ivf_lengths_host")
    doc_base = np.asarray(arrays["doc_base"], np.int64)
    devices = mesh.device_list()
    if len(devices) != len(doc_base):
        msg = f"{len(doc_base)} shards for a mesh of {len(devices)} devices"
        raise ValueError(msg)
    leaves = {
        name: np.asarray(a) for name, a in arrays.items() if name not in meta and a is not None
    }
    shards, ispec = [], None
    for j, device in enumerate(devices):
        dev, ispec = device_index_from_arrays(
            {name: a[j] for name, a in leaves.items()}, dict(arrays["ispec"]), device
        )
        shards.append(dev)
    lens = arrays.get("ivf_lengths_host")
    return ShardedIndex(
        shards=shards,
        ispec=ispec,
        doc_base=doc_base,
        mesh=mesh,
        n_docs_total=int(arrays["n_docs_total"]),
        ivf_lengths_host=None if lens is None else np.asarray(lens),
    )


def _rebase_subset(subset: torch.Tensor, base: int, ispec: IndexSpec) -> torch.Tensor:
    """Globally addressed subset rows -> this shard's local pid space.

    ``subset`` is [B, S] int32 sorted ascending with padding outside every
    shard's range (``SUBSET_SENTINEL``). Ids outside [base, base +
    ispec.n_docs) map to the shard's sentinel and the row is sorted again:
    the form ``search_impl`` expects.
    """
    loc = subset - base
    ok = (loc >= 0) & (loc < ispec.n_docs)
    return torch.sort(torch.where(ok, loc, ispec.sentinel_pid).to(torch.int32), dim=-1).values


def _merge_topk(gpids: list[torch.Tensor], scores: list[torch.Tensor], top_k: int):
    """Merge per-shard [B, k] results (on one device) by a stable top-k over
    the shard-major [B, n * k] layout; ties go to the lower shard, as
    ``lax.top_k`` over the gathered layout does.

    Returns (merged pids, merged scores, mi): ``mi`` indexes the [B, n * k]
    layout, so the winners' token matrices can be selected.
    """
    all_p = torch.stack(gpids)  # [n, B, k]
    all_s = torch.stack(scores)
    n, b, k = all_p.shape
    all_p = all_p.permute(1, 0, 2).reshape(b, n * k)
    all_s = all_s.permute(1, 0, 2).reshape(b, n * k)
    ms, mi = _top_k(all_s, top_k)
    mp = torch.gather(all_p, 1, mi)
    mp = torch.where(torch.isneginf(ms), -1, mp)
    return mp, ms, mi


def _merge_tokens(toks: list[torch.Tensor], doc_lens: list[torch.Tensor], mi: torch.Tensor):
    """The merged winners' token matrices, picked from the shards' [B, k,
    doc_cap, Q] winner matrices (top_k rows a shard, never candidate
    sets)."""
    all_t = torch.stack(toks)  # [n, B, k, cap, Q]
    all_l = torch.stack(doc_lens)  # [n, B, k]
    n, b, k = all_l.shape
    all_t = all_t.permute(1, 0, 2, 3, 4).reshape(b, n * k, *all_t.shape[3:])
    all_l = all_l.permute(1, 0, 2).reshape(b, n * k)
    rows = torch.arange(b, device=mi.device)[:, None]
    return all_t[rows, mi], torch.gather(all_l, 1, mi)


def _resolve_shard_params(
    ivf_lengths_host,
    ispec: IndexSpec,
    q_cap: int,
    n_ivf_probe: int,
    n_full_scores: int,
    approx_mode: str,
    rank_admit: int | None,
):
    """(approx_mode, rank_admit, slot_budget, cand_cap) for every shard.

    The single-device policy (``engine.resolve_approx_mode``) over the
    per-cell maximum of the shards' IVF lengths, so a corpus resolves to the
    same estimator however it is distributed.
    """
    cand_cap = None
    slot_budget = None
    if ivf_lengths_host is not None:
        n_cells = min(q_cap * n_ivf_probe, ispec.n_partitions)
        cand_cap = candidate_capacity(ivf_lengths_host, n_cells, n_full_scores)
        slot_budget = suggest_slot_budget(ivf_lengths_host, n_full_scores)
    approx_mode, rank_admit, slot_budget = resolve_approx_mode(
        approx_mode,
        ivf_lengths_host,
        q_cap=q_cap,
        n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores,
        n_partitions=ispec.n_partitions,
        cand_cap=cand_cap,
        rank_admit=rank_admit,
        slot_budget=slot_budget,
        n_docs=ispec.n_docs,
    )
    return approx_mode, rank_admit, slot_budget, cand_cap


# Globally addressed subset padding: outside every shard's range (a
# per-shard rebase maps it to that shard's sentinel). The corpus size would
# alias the tail shard's first padding document.
SUBSET_SENTINEL = 2**31 - 1


def pad_global_subsets(
    subsets: list[list[int]] | None, n_docs_total: int
) -> np.ndarray | None:
    """list of id lists -> [B, S] int32, sorted ascending, SUBSET_SENTINEL
    padding, S the longest row rounded up to 8."""
    if subsets is None:
        return None
    s_cap = max(max((len(s) for s in subsets), default=0), 1)
    s_cap = ((s_cap + 7) // 8) * 8
    out = np.full((len(subsets), s_cap), SUBSET_SENTINEL, np.int32)
    for i, s in enumerate(subsets):
        vals = np.asarray(sorted(v for v in s if 0 <= v < n_docs_total), np.int32)
        out[i, : len(vals)] = vals
    return out


def _as_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(dtype)


def _pad_rows(x: torch.Tensor, rows: int, value) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = torch.full((rows - x.shape[0], *x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _search_kwargs(ispec, q_cap, *, top_k, n_ivf_probe, n_full_scores, mem_budget,
                   approx_mode, rank_admit, pool_divisor, ivf_lengths_host) -> dict:
    approx_mode, rank_admit, slot_budget, cand_cap = _resolve_shard_params(
        ivf_lengths_host, ispec, q_cap, n_ivf_probe, n_full_scores, approx_mode, rank_admit
    )
    return dict(
        ispec=ispec,
        top_k=top_k,
        n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores,
        mem_budget=mem_budget,
        cand_cap=cand_cap,
        approx_mode=approx_mode,
        slot_budget=slot_budget,
        rank_admit=rank_admit,
        pool_divisor=pool_divisor,
    )


def _search_one(dev: DeviceIndex, queries, subset, *, want_tokens, with_stats, **kw) -> list:
    """``search_impl`` on one index with its device's kernel flags."""
    est, rerank = kernel_flags(dev)
    return list(
        search_impl(
            dev, queries, subset, want_tokens=want_tokens, with_stats=with_stats,
            use_estimate_kernel=est, use_rerank_kernel=rerank, **kw,
        )
    )


def _doc_sharded(
    sharded: ShardedIndex,
    parts: list[tuple[torch.Tensor, torch.Tensor | None]],
    *,
    want_tokens: bool,
    with_stats: bool,
    **kw,
) -> tuple:
    """Replica row r searches ``parts[r]`` (queries, global subset rows)
    over its shard group; each row merges on its first device, and the rows'
    results are concatenated on the mesh's first device."""
    devices = sharded.mesh.device_list()
    n_sh = sharded.n_shards
    ispec = sharded.ispec
    jobs = []
    for r, (q, sub) in enumerate(parts):
        for i in range(n_sh):
            device = devices[r * n_sh + i]
            base = int(sharded.doc_base[i])

            def job(shard=sharded.shards[r * n_sh + i], device=device, base=base, q=q, sub=sub):
                sub_local = None if sub is None else _rebase_subset(sub.to(device), base, ispec)
                out = _search_one(
                    shard, q.to(device), sub_local,
                    want_tokens=want_tokens, with_stats=with_stats, **kw,
                )
                out[0] = torch.where(out[0] >= 0, out[0] + base, -1)
                return out

            jobs.append((device, job))
    results = _run_jobs(jobs)

    merged = []
    with torch.inference_mode():
        for r in range(len(parts)):
            home = devices[r * n_sh]
            group = [[t.to(home) for t in out] for out in results[r * n_sh : (r + 1) * n_sh]]
            mp, ms, mi = _merge_topk([g[0] for g in group], [g[1] for g in group], kw["top_k"])
            res = [mp, ms]
            if want_tokens:
                res += list(_merge_tokens([g[2] for g in group], [g[3] for g in group], mi))
            if with_stats:
                res.append(torch.stack([g[-1] for g in group]).sum(dim=0, dtype=torch.int32))
            merged.append([t.to(devices[0]) for t in res])
    return tuple(torch.cat(cols) for cols in zip(*merged))


def sharded_search(
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
    """Doc-sharded search: [B, Q, D] queries -> ([B, top_k] global ids,
    scores) on the mesh's first device.

    ``approx_mode="auto"`` resolves through the single-device policy over
    the per-shard IVF statistics. ``subset``: per-query allowed GLOBAL ids,
    a [B, S] int32 array (sorted ascending, SUBSET_SENTINEL padding) or a
    list of id lists; each shard rebases it to its local pids.
    ``want_tokens`` appends (token scores [B, top_k, doc_cap, Q], doc
    lengths [B, top_k]); ``with_stats`` appends the [B, 2] int32
    pruned/overflow accounting summed over shards.
    """
    q = _as_tensor(queries, torch.float32)
    if isinstance(subset, list):
        subset = pad_global_subsets(subset, sharded.n_docs_total)
    sub = None if subset is None else _as_tensor(subset, torch.int32)
    kw = _search_kwargs(
        sharded.ispec, q.shape[1], top_k=top_k, n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores, mem_budget=mem_budget, approx_mode=approx_mode,
        rank_admit=rank_admit, pool_divisor=pool_divisor,
        ivf_lengths_host=sharded.ivf_lengths_host,
    )
    return _doc_sharded(sharded, [(q, sub)], want_tokens=want_tokens, with_stats=with_stats, **kw)


def query_sharded_search(
    dev: DeviceIndex,
    ispec: IndexSpec,
    queries,
    mesh: Mesh,
    *,
    top_k: int = 10,
    n_ivf_probe: int = 8,
    n_full_scores: int = 4096,
    mem_budget: int = 256 * 1024 * 1024,
    approx_mode: str = "auto",
    rank_admit: int | None = None,
    pool_divisor: int = 2,
    ivf_lengths_host: np.ndarray | None = None,
    subset: np.ndarray | list[list[int]] | None = None,
    want_tokens: bool = False,
    with_stats: bool = False,
):
    """Replicated-index data parallelism: the query batch split over the
    mesh.

    The index is copied once to each distinct device of the mesh it is not
    already on. [B, Q, D] queries are padded with zero queries to a
    multiple of the mesh size, each device slot searches its part, and the
    parts are concatenated on the mesh's first device and trimmed.
    ``subset`` rows address the whole corpus (no rebasing): [B, S] sorted
    ascending with sentinel_pid padding, or a list of id lists. Pass
    ``ivf_lengths_host`` to save one device->host copy.
    """
    devices = mesh.device_list()
    n = len(devices)
    q = _as_tensor(queries, torch.float32)
    b = q.shape[0]
    bp = -(-b // n) * n
    if isinstance(subset, list):
        # Replicated index: local == global ids; clamp the global padding
        # sentinel to the engine's own.
        subset = np.minimum(pad_global_subsets(subset, ispec.n_docs), ispec.sentinel_pid)
    sub = None if subset is None else _as_tensor(subset, torch.int32)
    q = _pad_rows(q, bp, 0)
    if sub is not None:
        sub = _pad_rows(sub, bp, ispec.sentinel_pid)
    if ivf_lengths_host is None:
        ivf_lengths_host = dev.ivf_lengths[: ispec.n_partitions].cpu().numpy()
    kw = _search_kwargs(
        ispec, q.shape[1], top_k=top_k, n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores, mem_budget=mem_budget, approx_mode=approx_mode,
        rank_admit=rank_admit, pool_divisor=pool_divisor, ivf_lengths_host=ivf_lengths_host,
    )
    home = dev.centroids.device
    copies = {d: dev if d == home else _index_to(dev, d) for d in dict.fromkeys(devices)}
    per = bp // n
    jobs = []
    for j, device in enumerate(devices):
        rows = slice(j * per, (j + 1) * per)

        def job(device=device, rows=rows):
            return _search_one(
                copies[device], q[rows].to(device),
                None if sub is None else sub[rows].to(device),
                want_tokens=want_tokens, with_stats=with_stats, **kw,
            )

        jobs.append((device, job))
    results = _run_jobs(jobs)
    with torch.inference_mode():
        return tuple(
            torch.cat([t.to(devices[0]) for t in cols])[:b] for cols in zip(*results)
        )
