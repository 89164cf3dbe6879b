"""In-memory index build on the device.

Port of ``fast_plaid_tpu/index/device_build.py``. The host build
(``index/builder.py`` + ``layout.to_device``) brings codes and residuals to
the host and sends the padded layout back. Here every corpus-sized tensor
stays on the corpus's device:

* k-means on a strided slice of the corpus (``ops/kmeans.py`` takes a
  tensor), codec training on held-out tokens (``train_codec_device``), and
  compression in fixed token blocks;
* the doc-major layout by one gather per tensor;
* the IVF by one sort of int64 (cell, pid) keys, so pids ascend within each
  cell as in the host build. Only the [K] cell-length histogram comes to the
  host: the static cell window and the aligned IVF layout need it.

Used for in-memory indexes (benchmarks and tests). ``FastPlaid.create``
still writes its index through ``index/builder.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from fast_plaid_tpu_torch.index.layout import (
    DeviceIndex,
    IndexSpec,
    align_ivf_device,
    build_emb_cache,
    round_up,
)
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.ops.kmeans import (
    num_partitions_heuristic,
    sample_size_heuristic,
    train_kmeans,
)

__all__ = ["build_memory_index_device", "train_codec_device", "DeviceCodec"]


@dataclass(frozen=True)
class DeviceCodec:
    """Codec parameters as tensors on the build's device."""

    bucket_cutoffs: torch.Tensor  # [2^nbits - 1] float32
    bucket_weights: torch.Tensor  # [2^nbits] float32


def _quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Linear-interpolated quantiles of a 1-D float32 tensor, as
    ``jnp.quantile`` computes them (positions q * (n - 1) in float32).

    One sort and two gathers: ``torch.quantile`` refuses inputs past 2^24
    elements, which 50,000 held-out tokens of D 384 already exceed.
    """
    xs = torch.sort(x).values
    n = torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device)
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lo = torch.clamp(low, torch.zeros_like(n), n - 1).long()
    hi = torch.clamp(high, torch.zeros_like(n), n - 1).long()
    return xs[lo] * low_w + xs[hi] * high_w


def train_codec_device(
    heldout: torch.Tensor, centroids: torch.Tensor, nbits: int
) -> DeviceCodec:
    """Codec training on the device, with the semantics of
    ``codec.train_codec``: cutoffs at the quantiles i / 2^nbits of the
    held-out residuals, weights at (i + 0.5) / 2^nbits, from one sort."""
    codes = codec.assign_codes(heldout, centroids)
    res = (heldout - centroids[codes.long()]).reshape(-1)
    n_options = 1 << nbits
    cut_q = np.arange(1, n_options) / n_options
    w_q = (np.arange(n_options) + 0.5) / n_options
    qs = torch.from_numpy(np.concatenate([cut_q, w_q]).astype(np.float32))
    vals = _quantile(res, qs.to(res.device))
    return DeviceCodec(
        bucket_cutoffs=vals[: n_options - 1].contiguous(),
        bucket_weights=vals[n_options - 1 :].contiguous(),
    )


def _compress_device(
    flat: torch.Tensor,
    centroids: torch.Tensor,
    cutoffs: torch.Tensor,
    nbits: int,
    token_block: int = 1 << 20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``codec.compress`` over fixed token blocks (bounding its float32
    temporaries), into preallocated [T] int32 codes and [T, PD] uint8."""
    t, dim = flat.shape
    codes = torch.empty((t,), dtype=torch.int32, device=flat.device)
    packed = torch.empty(
        (t, codec.packed_dim(dim, nbits)), dtype=torch.uint8, device=flat.device
    )
    for start in range(0, t, token_block):
        end = min(start + token_block, t)
        codes[start:end], packed[start:end] = codec.compress(
            flat[start:end].to(torch.float32), centroids, cutoffs, nbits
        )
    return codes, packed


def _layout_docmajor(
    codes: torch.Tensor,  # [T] int32 token-major
    packed: torch.Tensor,  # [T, PD] uint8
    offsets: torch.Tensor,  # [N] int64 first token of each row's document
    lengths: torch.Tensor,  # [N] int32 (0 for padding and sentinel rows)
    *,
    doc_cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-major flats -> doc-major codes [N, doc_cap] and row-flat
    residuals [N, doc_cap * PD], by one gather each; slots past a row's
    length are zero."""
    n = offsets.shape[0]
    pd = packed.shape[1]
    if codes.shape[0] == 0:
        return (
            torch.zeros((n, doc_cap), dtype=torch.int32, device=codes.device),
            torch.zeros((n, doc_cap * pd), dtype=torch.uint8, device=codes.device),
        )
    iota = torch.arange(doc_cap, device=codes.device)
    valid = iota[None, :] < lengths[:, None]
    idx = torch.clamp(offsets[:, None] + iota[None, :], 0, codes.shape[0] - 1)
    codes2d = torch.where(valid, codes[idx], 0).to(torch.int32)
    res2d = torch.where(valid[..., None], packed[idx], 0).to(torch.uint8)
    return codes2d, res2d.reshape(n, doc_cap * pd)


def _ivf_device(
    codes2d: torch.Tensor, lengths: torch.Tensor, *, kp: int, n_docs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF from doc-major codes: (pids grouped by cell [n_ivf] int32, cell
    lengths [kp] int64), both on the device.

    One sort of int64 keys cell * (n_docs + 1) + pid over the valid tokens;
    the first of each run of equal keys is one (cell, document) entry, so a
    document appears once per cell and pids ascend within a cell.
    """
    npd, cap = codes2d.shape
    m = n_docs + 1
    iota = torch.arange(cap, device=codes2d.device)
    valid = iota[None, :] < lengths[:npd, None]
    pid = torch.arange(npd, dtype=torch.int64, device=codes2d.device)[:, None]
    key = torch.where(valid, codes2d.to(torch.int64) * m + pid, -1).reshape(-1)
    sk = torch.sort(key).values
    sk = sk[sk >= 0]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    uniq = sk[first]
    ivf_len = torch.bincount(uniq // m, minlength=kp)[:kp]
    return (uniq % m).to(torch.int32), ivf_len


def _cell_cap(ivf_len_host: np.ndarray, k: int) -> int:
    """The candidate window of the longest cell, a multiple of 8."""
    return round_up(max(int(ivf_len_host.max()) if k else 1, 1), 8)


def _finalize_ivf(
    codes2d: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    kp: int,
    n_docs: int,
):
    """The device IVF in the aligned layout search reads: (flat pids,
    ivf_offsets, ivf_lengths, cell_cap). The [kp] histogram is the only
    tensor fetched to the host."""
    ivf_pids, ivf_len_dev = _ivf_device(codes2d, lengths, kp=kp, n_docs=n_docs)
    ivf_len_host = ivf_len_dev.cpu().numpy()
    cell_cap = _cell_cap(ivf_len_host, k)
    flat, ivf_off, ivf_len = align_ivf_device(
        ivf_pids, ivf_len_host, k=k, kp=kp, n_docs=n_docs, cell_cap=cell_cap
    )
    return flat, ivf_off, ivf_len, cell_cap


def _assemble(
    centroids: torch.Tensor,
    codec_params: DeviceCodec,
    codes2d: torch.Tensor,
    res2d: torch.Tensor,
    lengths: torch.Tensor,
    ivf,
    *,
    nbits: int,
    n_docs: int,
    doc_cap: int,
    **extra,
) -> tuple[DeviceIndex, IndexSpec]:
    """The DeviceIndex / IndexSpec of a device build (centroids padded to
    Kp rows)."""
    flat, ivf_off, ivf_len, cell_cap = ivf
    k, dim = centroids.shape
    kp = round_up(max(k, 1), 128)
    device = centroids.device
    cent_p = torch.zeros((kp, dim), dtype=torch.float32, device=device)
    cent_p[:k] = centroids
    dev = DeviceIndex(
        centroids=cent_p,
        bucket_weights=codec_params.bucket_weights,
        codes=codes2d,
        residuals=res2d,
        doc_lengths=lengths,
        ivf=flat,
        ivf_offsets=torch.from_numpy(ivf_off).to(device),
        ivf_lengths=torch.from_numpy(ivf_len).to(device),
        **extra,
    )
    ispec = IndexSpec(
        dim=dim,
        nbits=nbits,
        n_docs=n_docs,
        n_partitions=k,
        doc_cap=doc_cap,
        cell_cap=cell_cap,
        has_ivf=True,
    )
    return dev, ispec


def _phase_marker(verbose: bool):
    """``mark(name, t0) -> now``: with ``verbose``, waits for the GPU (where
    there is one) and prints the phase's seconds; otherwise only reads the
    clock."""

    def mark(name: str, t0: float) -> float:
        if verbose:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            print(f"#   build phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)
        return time.perf_counter()

    return mark


def build_memory_index_device(
    flat: torch.Tensor,
    doc_lengths: np.ndarray,
    *,
    nbits: int = 4,
    seed: int = 42,
    k: int | None = None,
    kmeans_niters: int = 4,
    emb_cache: bool = False,
    verbose: bool = False,
) -> tuple[DeviceIndex, IndexSpec]:
    """Build a searchable index from a [T, D] corpus tensor on its device.

    Documents are consecutive runs of ``doc_lengths`` tokens. Only [K]-sized
    or smaller arrays reach the host; the corpus, its compressed form and
    the doc-major layout stay on ``flat.device``. With ``verbose`` each phase
    waits for the device and prints its seconds.
    """
    device = flat.device
    mark = _phase_marker(verbose)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    t, dim = int(flat.shape[0]), int(flat.shape[1])
    doc_lengths = np.asarray(doc_lengths, np.int64)
    n_docs = len(doc_lengths)
    if k is None:
        k = min(num_partitions_heuristic(t), t)

    # k-means on the token share of the reference's document sample, as a
    # strided slice: every region of the corpus, no host permutation of T.
    frac = sample_size_heuristic(n_docs) / max(n_docs, 1)
    km_points = min(t, int(t * frac) + 1)
    km_data = flat if km_points >= t else flat[:: max(t // km_points, 1)]
    centroids = train_kmeans(km_data, k=k, niters=kmeans_niters, seed=seed)
    t0 = mark(f"kmeans k={k}", t0)

    heldout_n = min(50_000, t)
    if heldout_n == t:
        heldout = flat  # every token: the same quantiles as the host build
    else:
        # With replacement: O(held-out) on the host, not rng.choice's O(T).
        hsel = np.sort(rng.integers(0, t, heldout_n))
        heldout = flat[torch.from_numpy(hsel).to(device)]
    params = train_codec_device(heldout.to(torch.float32), centroids, nbits)
    t0 = mark("codec", t0)

    codes, packed = _compress_device(flat, centroids, params.bucket_cutoffs, nbits)
    t0 = mark("compress", t0)

    doc_cap = round_up(max(int(doc_lengths.max()) if n_docs else 1, 1), 16)
    np_docs = round_up(n_docs + 1, 8)
    offsets = np.zeros((np_docs,), np.int64)
    offsets[:n_docs] = np.concatenate([[0], np.cumsum(doc_lengths)])[:-1]
    lengths = np.zeros((np_docs,), np.int32)
    lengths[:n_docs] = np.minimum(doc_lengths, doc_cap)
    lengths_dev = torch.from_numpy(lengths).to(device)
    codes2d, res2d = _layout_docmajor(
        codes, packed, torch.from_numpy(offsets).to(device), lengths_dev, doc_cap=doc_cap
    )
    del codes, packed
    t0 = mark("layout", t0)

    kp = round_up(max(k, 1), 128)
    ivf = _finalize_ivf(codes2d, lengths_dev, k=k, kp=kp, n_docs=n_docs)
    t0 = mark("ivf", t0)
    dev, ispec = _assemble(
        centroids, params, codes2d, res2d, lengths_dev, ivf,
        nbits=nbits, n_docs=n_docs, doc_cap=doc_cap,
    )
    if emb_cache:
        dev = build_emb_cache(dev, ispec)
        mark("emb_cache", t0)
    return dev, ispec
