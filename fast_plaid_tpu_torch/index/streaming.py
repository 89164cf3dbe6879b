"""Streaming in-memory builds: corpora too large to hold as one token array.

Port of the single-device half of ``fast_plaid_tpu/index/streaming.py``. The
corpus comes from a range-addressable chunk source, ``chunk_gen(d0, d1) ->
[sum(lens[d0:d1]), D]`` tensor of the tokens of documents [d0, d1). Chunks
are compressed one at a time on the device and written in place into the
preallocated doc-major tensors, so the token-major corpus never exists
whole: the peak is the finished index plus one chunk.

The centroids and the codec are global, trained once on a document-prefix
sample (``train_global_codec``). The sharded build
(``build_sharded_index_streaming``) compresses each shard's contiguous
document range on its own device and returns a ``parallel.ShardedIndex``.
"""

from __future__ import annotations

import math
import time
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from fast_plaid_tpu_torch.index.device_build import (
    DeviceCodec,
    _assemble,
    _cell_cap,
    _compress_device,
    _finalize_ivf,
    _ivf_device,
    _layout_docmajor,
    _phase_marker,
    train_codec_device,
)
from fast_plaid_tpu_torch.index.layout import (
    IVF_ALIGN,
    DeviceIndex,
    IndexSpec,
    align_ivf_device,
    aligned_ivf_len,
    build_emb_cache,
    quantize_q4_into,
    round_up,
)
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.ops.kmeans import num_partitions_heuristic, train_kmeans

if TYPE_CHECKING:
    from fast_plaid_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "train_global_codec",
    "build_memory_index_streaming",
    "build_sharded_index_streaming",
]

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


def build_sharded_index_streaming(
    chunk_gen: ChunkGen,
    doc_lengths: np.ndarray,
    mesh: Mesh,
    *,
    nbits: int = 4,
    k: int | None = None,
    centroids: torch.Tensor | None = None,
    codec_params: DeviceCodec | None = None,
    chunk_docs: int = 100_000,
    kmeans_niters: int = 4,
    seed: int = 42,
    verbose: bool = False,
):
    """Sharded streaming build over a 1-D mesh: each shard's tensors live
    only on its device slot; the host holds nothing bigger than a [K]
    histogram.

    Shard i owns documents [i * per, (i + 1) * per), so ``doc_base`` and
    ``parallel.sharded_search`` apply unchanged. Given ``centroids`` and
    ``codec_params`` (a trained codec), no k-means runs. The shapes are the
    JAX package's: ``round_up(per + 1, 8)`` rows a shard, ``ispec.n_docs``
    = per, each shard's IVF padded to the largest shard's with its own
    document count.
    """
    from fast_plaid_tpu_torch.parallel.sharded import ShardedIndex

    mark = _phase_marker(verbose)
    t0 = time.perf_counter()
    doc_lengths = np.asarray(doc_lengths, np.int64)
    n_docs = len(doc_lengths)
    devices = mesh.device_list()
    n_shards = len(devices)
    per = -(-n_docs // n_shards)

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
    kp = round_up(max(k, 1), 128)
    doc_cap = round_up(max(int(doc_lengths.max()) if n_docs else 1, 1), 16)
    np_docs = round_up(per + 1, 8)  # one static shape for every shard

    parts = []
    for si, device in enumerate(devices):
        d0, d1 = min(si * per, n_docs), min((si + 1) * per, n_docs)
        lens_s = doc_lengths[d0:d1]
        cent_s = centroids.to(device)
        codes2d, res2d, lengths = _stream_compress_into(
            lambda a, b, _d0=d0: chunk_gen(_d0 + a, _d0 + b),
            lens_s,
            cent_s,
            codec_params.bucket_cutoffs.to(device),
            nbits=nbits,
            doc_cap=doc_cap,
            np_docs=np_docs,
            chunk_docs=min(chunk_docs, max(len(lens_s), 1)),
        )
        # The shard's compact IVF and its [kp] histogram; aligned below,
        # once every shard's size is known.
        ivf_pids, ivf_len = _ivf_device(codes2d, lengths, kp=kp, n_docs=d1 - d0)
        parts.append((cent_s, codes2d, res2d, lengths, ivf_pids, ivf_len.cpu().numpy(), d0, d1 - d0))
        t0 = mark(f"shard {si}: docs [{d0}, {d1}) on {device}", t0)

    # One IVF size for every shard, the JAX build's: the largest of the
    # shards' aligned cells plus their own window tails. Each shard pads
    # with its own document count (its first zero-length row).
    caps = [_cell_cap(p[5], k) for p in parts]
    tails = [round_up(cc, IVF_ALIGN) for cc in caps]
    ivf_size = max(aligned_ivf_len(p[5][:k]) + t for p, t in zip(parts, tails))
    shards, shard_lens = [], []
    for (cent_s, codes2d, res2d, lengths, ivf_pids, ln_host, _, n_local), cc, tail in zip(
        parts, caps, tails
    ):
        device = codes2d.device
        flat, off, ln = align_ivf_device(
            ivf_pids, ln_host, k=k, kp=kp, n_docs=n_local, cell_cap=cc,
            pad_ivf_to=ivf_size - tail,
        )
        shard_lens.append(ln[:kp])
        cent_p = torch.zeros((kp, dim), dtype=torch.float32, device=device)
        cent_p[:k] = cent_s
        shards.append(
            DeviceIndex(
                centroids=cent_p,
                bucket_weights=codec_params.bucket_weights.to(device),
                codes=codes2d,
                residuals=res2d,
                doc_lengths=lengths,
                ivf=flat,
                ivf_offsets=torch.from_numpy(off).to(device),
                ivf_lengths=torch.from_numpy(ln).to(device),
            )
        )
    ispec = IndexSpec(
        dim=dim,
        nbits=nbits,
        n_docs=per,  # per-shard local ids; the sentinel row `per` has length 0
        n_partitions=k,
        doc_cap=doc_cap,
        cell_cap=max(caps),
        has_ivf=True,
    )
    return ShardedIndex(
        shards=shards,
        ispec=ispec,
        doc_base=np.asarray([p[6] for p in parts], np.int64),
        mesh=mesh,
        n_docs_total=n_docs,
        # Per-cell max of the shards' [Kp] histograms (zero past K).
        ivf_lengths_host=np.max(np.stack(shard_lens), axis=0),
    )
