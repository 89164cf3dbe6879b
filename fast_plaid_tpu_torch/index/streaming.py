"""Streaming in-memory builds: corpora too large to hold as one token array.

Port of the single-device half of ``fast_plaid_tpu/index/streaming.py``. The
corpus comes from a range-addressable chunk source, ``chunk_gen(d0, d1) ->
[sum(lens[d0:d1]), D]`` tensor of the tokens of documents [d0, d1). Chunks
are compressed one at a time on the device and written in place into the
preallocated doc-major tensors, so the token-major corpus never exists
whole: the peak is the finished index plus one chunk.

The centroids and the codec are global, trained once on a document-prefix
sample (``train_global_codec``).
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from fast_plaid_tpu_torch.index.device_build import (
    DeviceCodec,
    _assemble,
    _compress_device,
    _finalize_ivf,
    _layout_docmajor,
    _phase_marker,
    train_codec_device,
)
from fast_plaid_tpu_torch.index.layout import (
    DeviceIndex,
    IndexSpec,
    build_emb_cache,
    quantize_q4_into,
    round_up,
)
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.ops.kmeans import num_partitions_heuristic, train_kmeans

__all__ = ["train_global_codec", "build_memory_index_streaming"]

# k-means subsamples its document-prefix sample to this many points per
# centroid (the reference streaming build's value).
KMEANS_POINTS_PER_CENTROID = 64

ChunkGen = Callable[[int, int], torch.Tensor]


def train_global_codec(
    chunk_gen: ChunkGen,
    doc_lengths: np.ndarray,
    *,
    nbits: int,
    k: int | None = None,
    kmeans_niters: int = 4,
    seed: int = 42,
) -> tuple[torch.Tensor, DeviceCodec, int]:
    """Train centroids and the residual codec on a document-prefix sample.

    Returns (centroids [k, D] on the sample's device, DeviceCodec, k). The
    sample is the reference's first 1 + 16 sqrt(120 N) documents; ``k``
    defaults to the partition heuristic on the full token count.
    """
    doc_lengths = np.asarray(doc_lengths, np.int64)
    n_docs = len(doc_lengths)
    total_tokens = int(doc_lengths.sum())
    if k is None:
        k = min(num_partitions_heuristic(total_tokens), total_tokens)
    sample_docs = max(1, int(min(1 + 16.0 * math.sqrt(120.0 * n_docs), n_docs)))
    sample = chunk_gen(0, sample_docs).to(torch.float32)
    centroids = train_kmeans(
        sample,
        k=k,
        niters=kmeans_niters,
        seed=seed,
        max_points_per_centroid=KMEANS_POINTS_PER_CENTROID,
    )
    rng = np.random.default_rng(seed)
    heldout_n = min(50_000, sample.shape[0])
    hsel = np.sort(rng.choice(sample.shape[0], heldout_n, replace=False))
    params = train_codec_device(
        sample[torch.from_numpy(hsel).to(sample.device)], centroids, nbits
    )
    return centroids, params, int(k)


def _stream_compress_into(
    chunk_gen: ChunkGen,
    doc_lengths: np.ndarray,
    centroids: torch.Tensor,
    cutoffs: torch.Tensor,
    *,
    nbits: int,
    doc_cap: int,
    np_docs: int,
    chunk_docs: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compress document chunks straight into doc-major tensors on the
    centroids' device: (codes [np_docs, doc_cap] int32, row-flat residuals
    [np_docs, doc_cap * PD] uint8, lengths [np_docs] int32). Rows past the
    last document stay zero."""
    n_docs = len(doc_lengths)
    device = centroids.device
    pd = codec.packed_dim(centroids.shape[1], nbits)
    lengths = np.zeros((np_docs,), np.int32)
    lengths[:n_docs] = np.minimum(doc_lengths, doc_cap)
    codes2d = torch.zeros((np_docs, doc_cap), dtype=torch.int32, device=device)
    res2d = torch.zeros((np_docs, doc_cap * pd), dtype=torch.uint8, device=device)
    for d0 in range(0, n_docs, chunk_docs):
        d1 = min(d0 + chunk_docs, n_docs)
        lens_c = doc_lengths[d0:d1]
        flat = chunk_gen(d0, d1).to(device)
        c, p = _compress_device(flat, centroids, cutoffs, nbits)
        del flat
        offs = np.concatenate([[0], np.cumsum(lens_c)])[:-1]
        codes2d[d0:d1], res2d[d0:d1] = _layout_docmajor(
            c,
            p,
            torch.from_numpy(offs.astype(np.int64)).to(device),
            torch.from_numpy(lengths[d0:d1]).to(device),
            doc_cap=doc_cap,
        )
        del c, p
    return codes2d, res2d, torch.from_numpy(lengths).to(device)


def build_memory_index_streaming(
    chunk_gen: ChunkGen,
    doc_lengths: np.ndarray,
    *,
    nbits: int = 4,
    k: int | None = None,
    centroids: torch.Tensor | None = None,
    codec_params: DeviceCodec | None = None,
    chunk_docs: int = 100_000,
    kmeans_niters: int = 4,
    seed: int = 42,
    emb_cache: bool = False,
    q4_cache: bool = False,
    verbose: bool = False,
) -> tuple[DeviceIndex, IndexSpec]:
    """Single-device streaming build; the peak is the index plus one chunk.

    The index lives on the device of ``centroids`` (given, or trained on the
    first chunk's). ``q4_cache`` builds the 4-bit prefilter cache into a
    tensor allocated before compression starts; ``emb_cache`` the bf16 cache
    at the end. With ``verbose`` each phase waits for the device and prints
    its seconds.
    """
    mark = _phase_marker(verbose)
    t0 = time.perf_counter()
    doc_lengths = np.asarray(doc_lengths, np.int64)
    n_docs = len(doc_lengths)
    if centroids is None or codec_params is None:
        centroids, codec_params, k = train_global_codec(
            chunk_gen,
            doc_lengths,
            nbits=nbits,
            k=k,
            kmeans_niters=kmeans_niters,
            seed=seed,
        )
        t0 = mark(f"codec+kmeans k={k}", t0)
    k, dim = int(centroids.shape[0]), int(centroids.shape[1])
    device = centroids.device
    kp = round_up(max(k, 1), 128)
    doc_cap = round_up(max(int(doc_lengths.max()) if n_docs else 1, 1), 16)
    np_docs = round_up(n_docs + 1, 8)
    extra = {}
    if q4_cache:
        # Allocated before the chunk loop: the corpus-sized cache then comes
        # early in a monotone sequence of large allocations.
        extra["emb_q4"] = torch.empty(
            (np_docs * (doc_cap // 2), dim), dtype=torch.uint8, device=device
        )
        extra["q4_scale"] = torch.empty((np_docs,), dtype=torch.float32, device=device)
    codes2d, res2d, lengths = _stream_compress_into(
        chunk_gen,
        doc_lengths,
        centroids,
        codec_params.bucket_cutoffs,
        nbits=nbits,
        doc_cap=doc_cap,
        np_docs=np_docs,
        chunk_docs=max(1, min(chunk_docs, n_docs)),
    )
    t0 = mark("stream compress", t0)
    if q4_cache:
        # Codes < k index real centroid rows only: no padding needed.
        quantize_q4_into(
            codes2d, res2d, centroids, codec_params.bucket_weights,
            nbits=nbits, out=extra["emb_q4"], scale=extra["q4_scale"],
        )
        t0 = mark("q4 cache", t0)
    ivf = _finalize_ivf(codes2d, lengths, k=k, kp=kp, n_docs=n_docs)
    t0 = mark("ivf", t0)
    dev, ispec = _assemble(
        centroids, codec_params, codes2d, res2d, lengths, ivf,
        nbits=nbits, n_docs=n_docs, doc_cap=doc_cap, **extra,
    )
    if emb_cache:
        dev = build_emb_cache(dev, ispec)
        mark("emb_cache", t0)
    return dev, ispec
