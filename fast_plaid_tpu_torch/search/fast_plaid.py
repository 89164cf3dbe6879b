"""FastPlaid — the public API class (port of ``fast_plaid_tpu/search/fast_plaid.py``).

Device resolution; ``create`` (with SQLite metadata), ``update``,
``delete``, ``search`` (with subsets), ``search_token_scores`` and
``get_embeddings``; the cross-process FileLock and the mtime-triggered
reload, over the PyTorch engine. With several devices the query batch is
split across them.

Embeddings in and out are numpy arrays (anything ``np.asarray`` accepts,
CPU torch tensors included).
"""

from __future__ import annotations

import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from fast_plaid_tpu_torch import filtering
from fast_plaid_tpu_torch.index import storage
from fast_plaid_tpu_torch.index.builder import create_index as build_index
from fast_plaid_tpu_torch.index.deleter import delete_from_index
from fast_plaid_tpu_torch.search import update as update_mod
from fast_plaid_tpu_torch.search.engine import reconstruct_core, reconstruct_rows_core
from fast_plaid_tpu_torch.search.kmeans import compute_kmeans
from fast_plaid_tpu_torch.search.load import LoadedIndex, reload_index
from fast_plaid_tpu_torch.search.searcher import (
    host_gather_rows,
    normalize_queries,
    normalize_subset,
    search_on_device,
)
from fast_plaid_tpu_torch.utils import tracing
from fast_plaid_tpu_torch.utils.devices import NO_CUDA
from fast_plaid_tpu_torch.utils.locking import FileLock, Timeout

__all__ = ["FastPlaid", "resolve_devices", "default_mem_budget"]


def default_mem_budget(device: torch.device) -> int:
    """Default per-search device working budget.

    ``FASTPLAID_TPU_MEM_BUDGET`` overrides. The CPU gets 256 MB; a GPU an
    eighth of its memory. (The JAX package gives accelerators a quarter:
    eager PyTorch materializes the float32 temporaries XLA fuses away.)
    """
    env = os.environ.get("FASTPLAID_TPU_MEM_BUDGET")
    if env is not None:
        return int(env)
    if device.type == "cpu":
        return 256 * 1024 * 1024
    return torch.cuda.get_device_properties(device).total_memory // 8


def resolve_devices(device: str | list[str] | None) -> list[torch.device]:
    """Map device spec strings to torch devices.

    None -> every CUDA device; raises when there is none (the CPU is taken
    only when asked for by name). Accepts "cpu", "cuda", "cuda:N" and
    "gpu[:N]" (an alias of "cuda[:N]").
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CUDA)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    specs = [device] if isinstance(device, str) else list(device)
    out: list[torch.device] = []
    for spec in specs:
        name, _, idx = spec.lower().partition(":")
        if name == "cpu":
            out.append(torch.device("cpu"))
            continue
        if name not in ("cuda", "gpu"):
            msg = f"Unknown device spec '{spec}'."
            raise RuntimeError(msg)
        if not torch.cuda.is_available():
            msg = f"No CUDA device available for device spec '{spec}'."
            raise RuntimeError(msg)
        index = int(idx) if idx else 0
        if index >= torch.cuda.device_count():
            msg = f"Unknown device spec '{spec}'."
            raise RuntimeError(msg)
        out.append(torch.device("cuda", index))
    return list(dict.fromkeys(out))


def _format_embeddings(embeddings) -> list[np.ndarray]:
    """Standardize to a list of [L, D] float32 arrays."""
    if isinstance(embeddings, (list, tuple)):
        out = []
        for e in embeddings:
            a = np.asarray(e, dtype=np.float32)
            if a.ndim == 3:
                a = a[0]
            out.append(a)
        return out
    arr = np.asarray(embeddings, dtype=np.float32)
    if arr.ndim == 2:
        return [arr]
    return [arr[i] for i in range(arr.shape[0])]


class FastPlaid:
    """Create and search a PLAID index with concurrent safety."""

    def __init__(
        self,
        index: str,
        device: str | list[str] | None = None,
        low_memory: bool = True,
        mem_budget_bytes: int | None = None,
        emb_cache_budget_bytes: int | None = None,
        length_buckets: int = 4,
        **kwargs: Any,  # noqa: ARG002 - parity with the reference signature
    ) -> None:
        self.index = index
        self.devices = resolve_devices(device)
        self.low_memory = low_memory
        self.mem_budget = (
            default_mem_budget(self.devices[0])
            if mem_budget_bytes is None
            else int(mem_budget_bytes)
        )
        self.emb_cache_budget = emb_cache_budget_bytes
        self.length_buckets = int(length_buckets)

        os.makedirs(self.index, exist_ok=True)
        self.lock_path = os.path.join(self.index, "plaid.lock")
        self.lock = FileLock(self.lock_path)
        # Held by this instance's create / update / delete. The FileLock is
        # shared by all threads of the process, so without it a search on
        # another thread would reload from a half-written index.
        self._mutation_lock = threading.RLock()
        self._index_swap_lock = threading.RLock()
        self._last_known_mtime = -1.0
        self.indices: dict[str, LoadedIndex | None] = {}
        self._check_and_reload_index(blocking=True)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Release device tensors (safe before deleting the index directory)."""
        with self._index_swap_lock:
            self.indices.clear()

    def __enter__(self) -> "FastPlaid":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    # ------------------------------------------------------------------
    # reload machinery (mtime double-checked locking)
    # ------------------------------------------------------------------

    def _current_mtime(self) -> float:
        meta = os.path.join(self.index, "metadata.json")
        try:
            return os.path.getmtime(meta)
        except OSError:
            return 0.0

    def _reload(self) -> dict[str, LoadedIndex | None]:
        return reload_index(
            self.index,
            self.devices,
            low_memory=self.low_memory,
            emb_cache_budget=self.emb_cache_budget,
            length_buckets=self.length_buckets,
        )

    def _check_and_reload_index(self, blocking: bool = True) -> bool:
        current = self._current_mtime()
        if current == self._last_known_mtime and self.indices:
            return False
        # A mutation on another thread of this instance: wait for it when
        # blocking, else keep serving the current index.
        if not self._mutation_lock.acquire(blocking=blocking):
            return False
        try:
            try:
                self.lock.acquire(timeout=-1.0 if blocking else 0.0)
            except Timeout:
                return False  # an update is in flight; keep serving current index
            try:
                current = self._current_mtime()
                if current == self._last_known_mtime and self.indices:
                    return False
                new_indices = self._reload()
                with self._index_swap_lock:
                    self.indices = new_indices
                    self._last_known_mtime = current
                return True
            finally:
                self.lock.release()
        finally:
            self._mutation_lock.release()

    def _loaded_indices(self) -> dict[str, LoadedIndex | None]:
        """The current indices, reloaded first when they changed on disk.

        While a mutation on another thread has freed them, this waits for
        its reload.
        """
        self._check_and_reload_index(blocking=False)
        with self._index_swap_lock:
            indices = dict(self.indices)
        if any(v is None for v in indices.values()) or not indices:
            self._check_and_reload_index(blocking=True)
            with self._index_swap_lock:
                indices = dict(self.indices)
        return indices

    def _reload_and_swap(self) -> None:
        with self._index_swap_lock:
            self.indices = {}  # free the old device tensors before loading
        new_indices = self._reload()
        with self._index_swap_lock:
            self.indices = new_indices
            self._last_known_mtime = self._current_mtime()

    # ------------------------------------------------------------------
    # create
    # ------------------------------------------------------------------

    @staticmethod
    def _prepare_index_directory(index_path: str) -> None:
        """Purge stale *.json / *.npy artifacts."""
        import glob

        if os.path.isdir(index_path):
            for pattern in ("*.json", "*.npy"):
                for path in glob.glob(os.path.join(index_path, pattern)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        else:
            os.makedirs(index_path, exist_ok=True)

    def create(
        self,
        documents_embeddings,
        kmeans_niters: int = 4,
        max_points_per_centroid: int = 256,
        nbits: int = 4,
        n_samples_kmeans: int | None = None,
        batch_size: int = 25_000,
        seed: int = 42,
        use_triton_kmeans: bool | None = None,  # noqa: ARG002 - API parity
        metadata: list[dict[str, Any]] | None = None,
        start_from_scratch: int = 1000,
        compress_only: bool = False,
        show_progress: bool = False,
    ) -> "FastPlaid":
        """Create and persist the index; k-means and compression run on the
        first device. ``metadata`` (one dict per document) goes into the
        SQLite store that ``filtering.where`` queries."""
        with tracing.span("create"), self._mutation_lock, self.lock:
            docs = _format_embeddings(documents_embeddings)
            if not docs:
                msg = "documents_embeddings must not be empty."
                raise ValueError(msg)
            dim = docs[0].shape[-1]
            self._prepare_index_directory(self.index)

            if metadata is not None:
                if len(metadata) != len(docs):
                    msg = (
                        f"The length of metadata ({len(metadata)}) must match "
                        f"the number of documents_embeddings ({len(docs)})."
                    )
                    raise ValueError(msg)
                filtering.create(index=self.index, metadata=metadata)

            if len(docs) <= start_from_scratch:
                storage.save_object_npy(
                    os.path.join(self.index, "embeddings.npy"), docs
                )

            with tracing.span("create.kmeans"):
                centroids = compute_kmeans(
                    documents_embeddings=docs,
                    dim=dim,
                    kmeans_niters=kmeans_niters,
                    max_points_per_centroid=max_points_per_centroid,
                    seed=seed,
                    n_samples_kmeans=n_samples_kmeans,
                    device=self.devices[0],
                )
            build_index(
                self.index,
                docs,
                centroids,
                nbits=nbits,
                batch_size=batch_size,
                seed=seed,
                compress_only=compress_only,
                show_progress=show_progress,
                device=self.devices[0],
            )
            self._reload_and_swap()
        return self

    # ------------------------------------------------------------------
    # update / delete
    # ------------------------------------------------------------------

    def update(
        self,
        documents_embeddings,
        metadata: list[dict[str, Any]] | None = None,
        batch_size: int = 25_000,
        kmeans_niters: int = 4,
        max_points_per_centroid: int = 256,
        n_samples_kmeans: int | None = None,
        seed: int = 42,
        start_from_scratch: int = 999,
        buffer_size: int = 100,
        use_triton_kmeans: bool | None = False,  # noqa: ARG002 - API parity
    ) -> "FastPlaid":
        """Add documents to an existing index (or create it); new ids follow
        the existing ones. Compression and k-means run on the first device."""
        with self._mutation_lock, self.lock:
            docs = _format_embeddings(documents_embeddings)
            update_mod.process_update(
                index_path=self.index,
                documents_embeddings=docs,
                metadata=metadata,
                batch_size=batch_size,
                kmeans_niters=kmeans_niters,
                max_points_per_centroid=max_points_per_centroid,
                n_samples_kmeans=n_samples_kmeans,
                seed=seed,
                start_from_scratch=start_from_scratch,
                buffer_size=buffer_size,
                create_fn=self.create,
                delete_fn=self.delete,
                device=self.devices[0],
            )
            self._reload_and_swap()
        return self

    def delete(
        self,
        subset: list[int],
        _delete_metadata: bool = True,
        _delete_buffer: bool = True,
    ) -> "FastPlaid":
        """Delete documents by id; the remaining ids shift down."""
        with self._mutation_lock, self.lock:
            subset = sorted({int(i) for i in subset})
            meta = storage.load_metadata(self.index)
            pre_num_documents = int(meta.get("num_documents", 0))

            delete_from_index(self.index, subset)

            if _delete_metadata and os.path.exists(
                os.path.join(self.index, "metadata.db")
            ):
                filtering.delete(index=self.index, subset=subset)

            # Rewrite the raw-embedding store minus deleted rows.
            emb_path = os.path.join(self.index, "embeddings.npy")
            if os.path.exists(emb_path):
                arrays = storage.load_object_npy(emb_path)
                drop = {i for i in subset if i < len(arrays)}
                remaining = [a for i, a in enumerate(arrays) if i not in drop]
                if remaining:
                    storage.save_object_npy(emb_path, remaining)
                else:
                    os.remove(emb_path)

            # Rewrite the update buffer: buffered docs are the last
            # len(buffer) docs of the pre-delete index.
            buffer_path = os.path.join(self.index, "buffer.npy")
            if _delete_buffer and os.path.exists(buffer_path):
                buffered = storage.load_object_npy(buffer_path)
                buffer_start = pre_num_documents - len(buffered)
                drop_local = {
                    i - buffer_start
                    for i in subset
                    if buffer_start <= i < pre_num_documents
                }
                if drop_local:
                    remaining = [
                        a for i, a in enumerate(buffered) if i not in drop_local
                    ]
                    if remaining:
                        storage.save_object_npy(buffer_path, remaining)
                    else:
                        os.remove(buffer_path)

            self._reload_and_swap()
        return self

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _prepare_search(self, queries_embeddings, subset):
        with tracing.span("search.prepare"):
            indices = self._loaded_indices()
            if not os.path.exists(os.path.join(self.index, "metadata.json")):
                msg = (
                    f"Index metadata not found in '{self.index}'. "
                    "Please create the index before searching."
                )
                raise FileNotFoundError(msg)
            for key, loaded in indices.items():
                if loaded is None:
                    msg = f"Index could not be loaded on device '{key}'."
                    raise RuntimeError(msg)
            queries = normalize_queries(queries_embeddings)
            return indices, queries, normalize_subset(subset, len(queries))

    def _dispatch_search(self, indices, queries, subsets, **kwargs) -> list:
        """Run on the first device, or split the query batch (and its
        subsets) across the devices."""
        loaded = [indices[str(d)] for d in self.devices]
        kwargs["mem_budget"] = self.mem_budget
        if len(loaded) == 1 or len(queries) <= 1:
            return search_on_device(loaded[0], queries, subsets=subsets, **kwargs)
        n_dev = min(len(loaded), len(queries))
        per = math.ceil(len(queries) / n_dev)
        chunks = [
            (
                loaded[i],
                queries[i * per : (i + 1) * per],
                subsets[i * per : (i + 1) * per] if subsets is not None else None,
            )
            for i in range(n_dev)
        ]
        results: list = []
        with ThreadPoolExecutor(max_workers=n_dev) as pool:
            run = tracing.bind(search_on_device)
            futures = [
                pool.submit(run, ld, qs, subsets=ss, **kwargs)
                for ld, qs, ss in chunks
                if len(qs)
            ]
            for fut in futures:
                results.extend(fut.result())
        return results

    def search(
        self,
        queries_embeddings,
        top_k: int = 10,
        batch_size: int = 2000,
        n_full_scores: int = 4096,
        n_ivf_probe: int = 8,
        show_progress: bool = True,
        subset: list[list[int]] | list[int] | None = None,
        n_processes: int | None = None,  # noqa: ARG002 - API parity
        approx_mode: str = "auto",
        pool_divisor: int | None = None,
        rank_admit: int | None = None,
    ) -> list[list[tuple[int, float]]]:
        """Search the index; returns per query a list of (doc_id, score).

        Same parameters and defaults as ``fast_plaid_tpu``'s FastPlaid.search.
        ``subset``: one id list for every query, an int, or one list per
        query (ids from ``filtering.where``). With several devices the query
        batch is split across them.
        """
        with tracing.span("search"):
            indices, queries, subsets = self._prepare_search(queries_embeddings, subset)
            return self._dispatch_search(
                indices,
                queries,
                subsets,
                want_tokens=False,
                top_k=top_k,
                n_full_scores=n_full_scores,
                n_ivf_probe=n_ivf_probe,
                show_progress=show_progress,
                approx_mode=approx_mode,
                max_tile=batch_size,
                pool_divisor=pool_divisor,
                rank_admit=rank_admit,
            )

    def search_token_scores(
        self,
        queries_embeddings,
        top_k: int = 10,
        batch_size: int = 2000,
        n_full_scores: int = 4096,
        n_ivf_probe: int = 8,
        show_progress: bool = True,
        subset: list[list[int]] | list[int] | None = None,
        n_processes: int | None = None,  # noqa: ARG002 - API parity
        approx_mode: str = "auto",
        pool_divisor: int | None = None,
        rank_admit: int | None = None,
    ) -> list[list[tuple[int, float, np.ndarray]]]:
        """Like search() but each tuple carries a [q_tokens, doc_tokens]
        token-score matrix."""
        with tracing.span("search"):
            indices, queries, subsets = self._prepare_search(queries_embeddings, subset)
            return self._dispatch_search(
                indices,
                queries,
                subsets,
                want_tokens=True,
                top_k=top_k,
                n_full_scores=n_full_scores,
                n_ivf_probe=n_ivf_probe,
                show_progress=show_progress,
                approx_mode=approx_mode,
                max_tile=batch_size,
                pool_divisor=pool_divisor,
                rank_admit=rank_admit,
            )

    # ------------------------------------------------------------------
    # reconstruction
    # ------------------------------------------------------------------

    def get_embeddings(self, subset: list[int]) -> list[np.ndarray]:
        """Reconstruct (decompress, float32) document embeddings by id."""
        if not subset:
            return []
        loaded = self._loaded_indices().get(str(self.devices[0]))
        if loaded is None:
            msg = "Index not loaded."
            raise RuntimeError(msg)
        pids = np.asarray(subset, dtype=np.int64)
        n_docs = (
            len(loaded.host_doc_lengths) if loaded.low_memory else loaded.ispec.n_docs
        )
        bad = pids[(pids < 0) | (pids >= n_docs)]
        if bad.size:
            msg = (
                f"get_embeddings ids must be in [0, {n_docs}); got "
                f"{bad[:8].tolist()}"
            )
            raise ValueError(msg)
        sent = loaded.ispec.sentinel_pid
        block = 256
        out: list[np.ndarray] = []
        with torch.inference_mode():
            for start in range(0, len(pids), block):
                chunk = pids[start : start + block]
                padded = np.full((block,), sent, np.int64)
                padded[: len(chunk)] = chunk
                if loaded.low_memory:
                    codes_rows, res_rows, _ = host_gather_rows(
                        loaded, padded[None, :], pin=loaded.device.type == "cuda"
                    )
                    pid_dev = torch.from_numpy(padded).to(loaded.device)
                    lens = loaded.dev.doc_lengths[pid_dev]
                    valid = torch.arange(loaded.ispec.doc_cap, device=lens.device) < lens[:, None]
                    emb = reconstruct_rows_core(
                        codes_rows[0].to(loaded.device, non_blocking=True),
                        res_rows[0].to(loaded.device, non_blocking=True),
                        valid,
                        loaded.dev.centroids,
                        loaded.dev.bucket_weights,
                        nbits=loaded.ispec.nbits,
                    )
                else:
                    emb, lens = reconstruct_core(
                        loaded.dev,
                        torch.from_numpy(padded).to(loaded.device),
                        ispec=loaded.ispec,
                    )
                emb, lens = emb.cpu().numpy(), lens.cpu().numpy()
                for i in range(len(chunk)):
                    out.append(np.asarray(emb[i, : int(lens[i])], dtype=np.float32))
        return out
