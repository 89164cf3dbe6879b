"""User-facing multi-device search over an on-disk index.

Port of ``fast_plaid_tpu/parallel/api.py``. ``ShardedFastPlaid`` loads the
same index directory as ``search.FastPlaid``, shards its documents across a
mesh (``parallel/sharded.py``) and answers batched queries with the
per-shard top-k merge. Read-only: mutations go through ``FastPlaid`` and a
sharded instance reloads.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np

from fast_plaid_tpu_torch.index.storage import load_index_data
from fast_plaid_tpu_torch.parallel.mesh import Mesh, make_mesh
from fast_plaid_tpu_torch.parallel.sharded import (
    build_sharded_index,
    pad_global_subsets,
    sharded_search,
)
from fast_plaid_tpu_torch.search import searcher
from fast_plaid_tpu_torch.search.searcher import normalize_queries, normalize_subset

__all__ = ["ShardedFastPlaid"]


class ShardedFastPlaid:
    """Document-sharded search over an existing index.

    ``mesh`` None shards over ``n_devices`` CUDA devices (None: all of
    them) and raises without one; a CPU run passes a mesh of CPU devices,
    ``make_mesh(devices=[torch.device("cpu")] * n)``.
    """

    def __init__(
        self,
        index: str,
        mesh: Mesh | None = None,
        n_devices: int | None = None,
        mem_budget_bytes: int = 256 * 1024 * 1024,
    ) -> None:
        self.index = index
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.mem_budget = int(mem_budget_bytes)
        self.sharded = None
        self.reload()

    def reload(self) -> None:
        data = load_index_data(self.index)
        if data is None:
            msg = f"No index found in '{self.index}'."
            raise FileNotFoundError(msg)
        if data.ivf is None:
            msg = "compress_only indexes cannot be searched."
            raise ValueError(msg)
        self.sharded = build_sharded_index(
            centroids=data.centroids,
            bucket_weights=data.bucket_weights,
            codes=data.codes,
            residuals=data.residuals,
            doc_lengths=data.doc_lengths,
            nbits=data.nbits,
            mesh=self.mesh,
        )

    def search(
        self,
        queries_embeddings,
        top_k: int = 10,
        n_full_scores: int = 4096,
        n_ivf_probe: int = 8,
        approx_mode: str = "auto",
        rank_admit: int | None = None,
        pool_divisor: int = 2,
        subset=None,
        _want_tokens: bool = False,
    ) -> list[list[tuple[int, float]]]:
        """Batched search; returns per query a list of (doc_id, score).

        The parameters mirror ``FastPlaid.search``: "auto" resolves through
        the same policy over per-shard IVF statistics, and subsets take the
        same int / flat list / per-query lists forms and address GLOBAL doc
        ids. The whole batch goes to the mesh at once (no tiling). Overflow
        accounting, summed over shards, is in
        ``searcher.last_search_stats()``.
        """
        queries = normalize_queries(queries_embeddings)
        if len(queries) == 0:
            return []
        subsets = normalize_subset(subset, len(queries))
        sub_arr = (
            None if subsets is None else pad_global_subsets(subsets, self.sharded.n_docs_total)
        )
        q_cap = max(max(q.shape[0] for q in queries), 1)
        q_cap = ((q_cap + 7) // 8) * 8
        dim = self.sharded.ispec.dim
        batch = np.zeros((len(queries), q_cap, dim), np.float32)
        lens = []
        for i, q in enumerate(queries):
            batch[i, : q.shape[0]] = q
            lens.append(q.shape[0])
        out_t = sharded_search(
            self.sharded,
            batch,
            top_k=top_k,
            n_ivf_probe=n_ivf_probe,
            n_full_scores=n_full_scores,
            mem_budget=self.mem_budget,
            approx_mode=approx_mode,
            rank_admit=rank_admit,
            pool_divisor=pool_divisor,
            subset=sub_arr,
            want_tokens=_want_tokens,
            with_stats=True,
        )
        out_t = [x.cpu().numpy() for x in out_t]
        stats = out_t.pop()
        self._record_stats(stats, len(queries))
        pids, scores = out_t[0], out_t[1]
        out = []
        for b in range(pids.shape[0]):
            row = []
            for ki in range(pids.shape[1]):
                p, s = int(pids[b, ki]), float(scores[b, ki])
                if p < 0 or not np.isfinite(s):
                    continue
                if _want_tokens:
                    dlen = int(out_t[3][b, ki])
                    mat = out_t[2][b, ki, :dlen, : lens[b]].T.copy()
                    row.append((p, s, mat))
                else:
                    row.append((p, s))
            out.append(row)
        return out

    def search_token_scores(
        self,
        queries_embeddings,
        top_k: int = 10,
        n_full_scores: int = 4096,
        n_ivf_probe: int = 8,
        approx_mode: str = "auto",
        rank_admit: int | None = None,
        pool_divisor: int = 2,
        subset=None,
    ) -> list[list[tuple[int, float, np.ndarray]]]:
        """Like ``search``, each hit carrying its [q_tokens, doc_tokens]
        token-score matrix. Only the shards' winner matrices are copied to
        the merging device, never candidate sets."""
        return self.search(
            queries_embeddings,
            top_k=top_k,
            n_full_scores=n_full_scores,
            n_ivf_probe=n_ivf_probe,
            approx_mode=approx_mode,
            rank_admit=rank_admit,
            pool_divisor=pool_divisor,
            subset=subset,
            _want_tokens=True,
        )

    def _record_stats(self, stats: np.ndarray, nq: int) -> None:
        """The single-device searcher's overflow accounting over the mesh:
        budget pruning is by design and silent; truncation by static
        buffers beyond it can cost recall and warns."""
        pruned = int(stats[:nq, 0].sum())
        overflow = int(stats[:nq, 1].sum())
        searcher._LAST_STATS[threading.get_ident()] = {
            "dropped_candidate_slots": pruned + overflow,
            "budget_pruned_slots": pruned,
            "cap_overflow_slots": overflow,
            "queries": nq,
            "approx_mode": "sharded",
            "rank_admit": None,
        }
        if overflow:
            warnings.warn(
                f"candidate buffer overflow on the mesh: {overflow} "
                f"candidate slots truncated across {nq} queries beyond the "
                "slot budget's own pruning; raise mem_budget or cand_cap "
                "if recall matters more than memory",
                RuntimeWarning,
                stacklevel=3,
            )
