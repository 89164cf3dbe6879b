"""Test and benchmark helpers: synthetic corpora and in-memory index builds.

Copies of ``fast_plaid_tpu/testing.py``'s helpers. Host draws come from a
numpy ``Generator``; ``random_flat_corpus_device`` draws on the device from
a seeded ``torch.Generator``. The builds return (DeviceIndex, IndexSpec)
without writing anything to disk, on ``device`` (a GPU unless the caller
passes ``"cpu"``); ``MemoryIndex`` searches such an index as
``FastPlaid.search`` searches a loaded one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index.builder import (
    compress_documents,
    compress_tokens,
    train_codec_from_documents,
)
from fast_plaid_tpu_torch.index.device_build import (
    _phase_marker,
    build_memory_index_device,
)
from fast_plaid_tpu_torch.index.layout import (
    DeviceIndex,
    IndexSpec,
    build_emb_cache,
    to_device,
)
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.ops.kmeans import num_partitions_heuristic, train_kmeans
from fast_plaid_tpu_torch.search import searcher
from fast_plaid_tpu_torch.search.fast_plaid import default_mem_budget
from fast_plaid_tpu_torch.search.load import LoadedIndex

__all__ = [
    "MemoryIndex",
    "random_documents",
    "random_queries",
    "random_flat_corpus",
    "random_flat_corpus_device",
    "build_memory_index",
    "build_memory_index_flat",
]


def random_flat_corpus_device(
    seed: int,
    n: int,
    length: int,
    dim: int,
    variable: bool = False,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, np.ndarray]:
    """[T, D] unit-norm tokens drawn on ``device`` + host document lengths.

    Lengths come from numpy ``default_rng(seed)`` (uniform in [length/2,
    length] with ``variable``), the tokens from a ``torch.Generator`` seeded
    with ``seed`` on the device.
    """
    rng = np.random.default_rng(seed)
    if variable:
        lens = rng.integers(max(length // 2, 1), length + 1, size=n).astype(np.int64)
    else:
        lens = np.full((n,), length, np.int64)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((int(lens.sum()), dim), generator=g, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True), lens


def random_flat_corpus(
    rng: np.random.Generator, n: int, length: int, dim: int, variable: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """One flat [T, D] unit-norm token array + document lengths (no list of
    per-document arrays)."""
    if variable:
        lens = rng.integers(max(length // 2, 1), length + 1, size=n).astype(np.int64)
    else:
        lens = np.full((n,), length, np.int64)
    t = int(lens.sum())
    flat = np.empty((t, dim), np.float32)
    block = 1 << 20
    for start in range(0, t, block):
        end = min(start + block, t)
        x = rng.standard_normal((end - start, dim)).astype(np.float32)
        flat[start:end] = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return flat, lens


def random_documents(
    rng: np.random.Generator, n: int, length: int, dim: int, variable: bool = False
) -> list[np.ndarray]:
    docs = []
    for _ in range(n):
        ln = int(rng.integers(max(length // 2, 1), length + 1)) if variable else length
        x = rng.standard_normal((ln, dim)).astype(np.float32)
        docs.append(x / np.linalg.norm(x, axis=-1, keepdims=True))
    return docs


def random_queries(rng: np.random.Generator, n: int, length: int, dim: int) -> np.ndarray:
    x = rng.standard_normal((n, length, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def build_memory_index(
    documents: list[np.ndarray],
    nbits: int = 4,
    seed: int = 42,
    k: int | None = None,
    kmeans_niters: int = 4,
    device: torch.device | str = "cuda",
    verbose: bool = False,
    emb_cache: bool = False,
    length_buckets: int = 0,
) -> tuple[DeviceIndex, IndexSpec]:
    """The full build pipeline (k-means, codec, compression, IVF) -> device
    tensors, without writing the index."""
    mark = _phase_marker(verbose)
    t = time.perf_counter()
    flat = np.concatenate(documents, axis=0)
    if k is None:
        k = min(num_partitions_heuristic(flat.shape[0]), flat.shape[0])
    centroids = train_kmeans(flat, k=k, niters=kmeans_niters, seed=seed, device=device)
    t = mark(f"kmeans k={k}", t)
    params = train_codec_from_documents(documents, centroids, nbits, seed, device)
    t = mark("codec", t)
    codes, packed = compress_documents(
        documents, centroids, params.bucket_cutoffs, nbits, device=device
    )
    t = mark("compress", t)
    doc_lengths = np.asarray([d.shape[0] for d in documents], np.int64)
    ivf, ivf_lengths = ivf_mod.build_ivf(codes, doc_lengths, centroids.shape[0])
    mark("ivf", t)
    dev, ispec = to_device(
        centroids=centroids,
        bucket_weights=params.bucket_weights,
        codes=codes,
        residuals=packed,
        doc_lengths=doc_lengths,
        ivf=ivf,
        ivf_lengths=ivf_lengths,
        nbits=nbits,
        device=device,
        length_buckets=length_buckets,
    )
    if emb_cache:
        dev = build_emb_cache(dev, ispec)
    return dev, ispec


def build_memory_index_flat(
    flat: np.ndarray | torch.Tensor,
    doc_lengths: np.ndarray,
    nbits: int = 4,
    seed: int = 42,
    k: int | None = None,
    kmeans_niters: int = 4,
    device: torch.device | str | None = None,
    verbose: bool = False,
    emb_cache: bool = False,
    length_buckets: int = 0,
) -> tuple[DeviceIndex, IndexSpec]:
    """Build from one flat [T, D] token array (large-corpus benchmarks).

    A tensor corpus (with ``device`` None and no length buckets) takes the
    build on its own device, ``build_memory_index_device``.
    Otherwise the host path: codec training samples 50,000 held-out tokens
    uniformly from the flat array, and the layout is padded on the host and
    sent to ``device`` (default: the GPU).
    """
    if (
        isinstance(flat, torch.Tensor)
        and device is None
        and length_buckets == 0
        and flat.shape[0] > 0
        and len(doc_lengths) > 0
    ):
        return build_memory_index_device(
            flat,
            doc_lengths,
            nbits=nbits,
            seed=seed,
            k=k,
            kmeans_niters=kmeans_niters,
            emb_cache=emb_cache,
            verbose=verbose,
        )

    device = torch.device("cuda" if device is None else device)
    if isinstance(flat, torch.Tensor):
        flat = flat.cpu().numpy()
    mark = _phase_marker(verbose)
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    if k is None:
        k = min(num_partitions_heuristic(flat.shape[0]), flat.shape[0])
    centroids = train_kmeans(flat, k=k, niters=kmeans_niters, seed=seed, device=device)
    t = mark(f"kmeans k={k}", t)
    heldout_n = min(50_000, flat.shape[0])
    hsel = np.sort(rng.choice(flat.shape[0], heldout_n, replace=False))
    heldout = np.asarray(flat[hsel], np.float32)
    h_codes = (
        codec.assign_codes(
            torch.from_numpy(heldout).to(device), torch.from_numpy(centroids).to(device)
        )
        .cpu()
        .numpy()
    )
    params = codec.train_codec(heldout - centroids[h_codes], nbits)
    t = mark("codec", t)
    codes, packed = compress_tokens(
        flat, centroids, params.bucket_cutoffs, nbits, device=device
    )
    t = mark("compress", t)
    ivf, ivf_lengths = ivf_mod.build_ivf(
        codes, np.asarray(doc_lengths, np.int64), centroids.shape[0]
    )
    t = mark("ivf", t)
    dev, ispec = to_device(
        centroids=centroids,
        bucket_weights=params.bucket_weights,
        codes=codes,
        residuals=packed,
        doc_lengths=doc_lengths,
        ivf=ivf,
        ivf_lengths=ivf_lengths,
        nbits=nbits,
        device=device,
        length_buckets=length_buckets,
    )
    if emb_cache:
        dev = build_emb_cache(dev, ispec)
        mark("emb_cache", t)
    return dev, ispec


class MemoryIndex:
    """An in-memory index (a build's DeviceIndex) behind ``search``.

    Drives ``searcher.search_on_device`` as ``FastPlaid.search`` does, with
    the same per-search memory budget, for indexes that were never written
    to disk.
    """

    def __init__(self, dev: DeviceIndex, ispec: IndexSpec, device: torch.device | str):
        device = torch.device(device)
        lens = dev.ivf_lengths[: ispec.n_partitions].cpu().numpy()
        self.loaded = LoadedIndex(dev, ispec, device, ivf_lengths_host=lens)
        self.mem_budget = default_mem_budget(device)

    def search(
        self,
        queries,
        top_k: int = 10,
        n_full_scores: int = 4096,
        n_ivf_probe: int = 8,
        show_progress: bool = False,
        approx_mode: str = "auto",
    ) -> list[list[tuple[int, float]]]:
        """Top-k (pid, score) lists, one a query, as ``FastPlaid.search``."""
        return searcher.search_on_device(
            self.loaded,
            searcher.normalize_queries(queries),
            top_k=top_k,
            n_full_scores=n_full_scores,
            n_ivf_probe=n_ivf_probe,
            mem_budget=self.mem_budget,
            show_progress=show_progress,
            approx_mode=approx_mode,
        )
