"""Device-resident index layout, in PyTorch.

Port of the full-cap branch of ``fast_plaid_tpu/index/layout.py``. Documents
live doc-major and padded, so one row gather fetches a whole document:

* ``codes``       [Np, doc_cap]       int32
* ``residuals``   [Np, doc_cap * PD]  uint8 (PD bytes per token, row-flat;
                                      None in low_memory, where they stay in
                                      host RAM)
* ``doc_lengths`` [Np]                int32 (0 beyond n_docs)
* ``emb_cache``   [Np, doc_cap, D]    bf16 decompressed corpus (optional)
* ``emb_q4``      [Np * doc_cap/2, D] uint8 4-bit prefilter cache (optional,
                                      ``ops/q4cache.py``), with ``q4_scale``
                                      [Np] float32

With length buckets (``to_device(length_buckets > 1)`` on a length-skewed
corpus) the residuals and the bf16 cache live per bucket instead, each
document padded to its bucket's cap (``DocBucket``); ``residuals`` and
``emb_cache`` are then None and ``doc_bucket`` / ``doc_bucket_row`` map a
pid to its bucket and row there. ``codes`` stays full-cap.

IVF cells keep the flat + offsets form with every cell starting on a
multiple of ``IVF_ALIGN``, so candidate windows are whole rows of
``ivf.view(-1, IVF_ALIGN)``. One sentinel document (pid == n_docs, length 0)
absorbs invalid candidate slots.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.utils.devices import default_device

__all__ = [
    "DeviceIndex",
    "DocBucket",
    "IndexSpec",
    "to_device",
    "round_up",
    "plan_buckets",
    "gather_res",
    "build_emb_cache",
    "emb_cache_bytes",
    "build_q4_cache",
    "q4_cache_bytes",
    "quantize_q4_rows",
    "device_index_from_arrays",
    "IVF_ALIGN",
    "aligned_ivf_len",
    "align_ivf_device",
]

# Every cell's IVF list starts on a multiple of this, so candidate windows
# are whole rows of the 2-D IVF view (one row gather per window).
IVF_ALIGN = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def aligned_ivf_len(ivf_lengths: np.ndarray) -> int:
    """Flat length of the IVF_ALIGN-aligned layout of these cells."""
    lens = np.asarray(ivf_lengths, np.int64)
    return int((-(-lens // IVF_ALIGN)).sum()) * IVF_ALIGN


def align_ivf_device(
    ivf_pids: torch.Tensor,
    ivf_len_host: np.ndarray,
    *,
    k: int,
    kp: int,
    n_docs: int,
    cell_cap: int,
    pad_ivf_to: int | None = None,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Re-lay a compact device IVF (the cells' pid lists back to back) into
    the aligned layout ``to_device`` builds on the host.

    Returns (aligned flat pids on ``ivf_pids``'s device, ivf_offsets,
    ivf_lengths as host arrays [kp + 8]). One row gather of IVF_ALIGN pids
    per aligned row; slots past a cell's length hold the sentinel pid.
    ``pad_ivf_to`` pads the aligned part to at least that many slots, as
    ``to_device`` does, so the shards of a sharded index share one size.
    """
    lens = np.asarray(ivf_len_host[:k], np.int64)
    nrows_c = -(-lens // IVF_ALIGN)
    row_start = np.concatenate([[0], np.cumsum(nrows_c)])
    n_rows = int(row_start[-1])
    n_aligned = n_rows * IVF_ALIGN
    src_off = np.concatenate([[0], np.cumsum(lens)])[:-1]
    owner = np.repeat(np.arange(k, dtype=np.int64), nrows_c)
    local = np.arange(n_rows, dtype=np.int64) - row_start[owner]
    src_start = src_off[owner] + IVF_ALIGN * local
    rem = lens[owner] - IVF_ALIGN * local

    device = ivf_pids.device
    # The last window's tail past the (padded) aligned part.
    size = round_up(max(pad_ivf_to or n_aligned, n_aligned), IVF_ALIGN) + round_up(
        cell_cap, IVF_ALIGN
    )
    flat = torch.full((size,), n_docs, dtype=torch.int32, device=device)
    if n_rows:
        iota = torch.arange(IVF_ALIGN, dtype=torch.int64, device=device)
        idx = torch.from_numpy(src_start).to(device)[:, None] + iota[None, :]
        idx = torch.clamp(idx, 0, int(ivf_pids.shape[0]) - 1)
        keep = iota[None, :] < torch.from_numpy(rem).to(device)[:, None]
        flat[:n_aligned] = torch.where(keep, ivf_pids[idx].to(torch.int32), n_docs).reshape(-1)
    ivf_off = np.zeros((kp + 8,), np.int32)
    ivf_off[:k] = (row_start[:-1] * IVF_ALIGN).astype(np.int32)
    ivf_off[k:] = n_aligned
    ivf_len = np.zeros((kp + 8,), np.int32)
    ivf_len[:k] = lens.astype(np.int32)
    return flat, ivf_off, ivf_len


@dataclass
class DocBucket:
    """Doc-major token rows of one length bucket, at the bucket's cap.

    The last row of each tensor is all zeros and absorbs sentinel and
    padding lookups.
    """

    codes: torch.Tensor  # [Nb + 1, cap_b] int32
    residuals: torch.Tensor  # [Nb + 1, cap_b * PD] uint8 (row-flat)
    emb: torch.Tensor | None = None  # [Nb + 1, cap_b, D] bf16 cache


@dataclass
class DeviceIndex:
    """All device-resident tensors of one loaded index."""

    centroids: torch.Tensor  # [Kp, D] float32, rows >= K are zero
    bucket_weights: torch.Tensor  # [2^nbits] float32
    codes: torch.Tensor  # [Np, doc_cap] int32 doc-major
    residuals: torch.Tensor | None  # [Np, doc_cap * PD] uint8 (None: low_memory)
    doc_lengths: torch.Tensor  # [Np] int32 (0 beyond n_docs)
    ivf: torch.Tensor  # [Ip] int32 (pids, grouped by cell)
    ivf_offsets: torch.Tensor  # [Kp + 8] int32
    ivf_lengths: torch.Tensor  # [Kp + 8] int32 (0 beyond K)
    emb_cache: torch.Tensor | None = None  # [Np, doc_cap, D] bf16
    emb_q4: torch.Tensor | None = None  # [Np * doc_cap/2, D] uint8 (2-D)
    q4_scale: torch.Tensor | None = None  # [Np] float32 per-document scale
    # Length-bucketed layout (``IndexSpec.bucket_caps`` non-empty): the
    # residuals and the bf16 cache live in ``buckets``, and ``residuals`` /
    # ``emb_cache`` above are None.
    doc_bucket: torch.Tensor | None = None  # [Np] int32 bucket of each pid
    doc_bucket_row: torch.Tensor | None = None  # [Np] int32 row in that bucket
    buckets: tuple[DocBucket, ...] = ()


@dataclass(frozen=True)
class IndexSpec:
    """Static shape/config info that accompanies a DeviceIndex."""

    dim: int
    nbits: int
    n_docs: int
    n_partitions: int  # real K (centroid rows < Kp are real)
    doc_cap: int  # static per-document token window
    cell_cap: int  # static per-IVF-cell window
    has_ivf: bool
    # Length-bucket plan (empty: the single doc_cap layout). Caps ascend and
    # end at doc_cap; counts are real documents a bucket and set the static
    # rerank quotas (engine._bucket_quota).
    bucket_caps: tuple[int, ...] = ()
    bucket_counts: tuple[int, ...] = ()

    @property
    def sentinel_pid(self) -> int:
        return self.n_docs


def plan_buckets(
    doc_lengths: np.ndarray,
    doc_cap: int,
    max_buckets: int = 4,
    min_gain: float = 1.4,
) -> list[int] | None:
    """Choose length-bucket caps from the corpus length distribution.

    A copy of ``fast_plaid_tpu.index.layout.plan_buckets``: ascending caps
    ending at ``doc_cap``, or None when one bucket is within ``min_gain``
    of optimal.
    """
    lens = np.minimum(np.asarray(doc_lengths, np.int64), doc_cap)
    if lens.size == 0 or max_buckets <= 1:
        return None
    qs = np.linspace(0.5, 1.0, num=max_buckets)
    caps = sorted(
        {
            min(int(round_up(max(int(np.quantile(lens, q)), 1), 16)), doc_cap)
            for q in qs
        }
    )
    caps[-1] = doc_cap
    kept = [caps[-1]]
    for c in reversed(caps[:-1]):
        if c <= kept[-1] * 0.7:
            kept.append(c)
    caps = sorted(kept)
    if len(caps) == 1:
        return None
    which = np.searchsorted(caps, lens, side="left")
    padded = sum(int((which == i).sum()) * c for i, c in enumerate(caps))
    gain = (lens.size * doc_cap) / max(padded, 1)
    return caps if gain >= min_gain else None


def to_device(
    *,
    centroids: np.ndarray,
    bucket_weights: np.ndarray,
    codes: np.ndarray,
    residuals: np.ndarray,
    doc_lengths: np.ndarray,
    ivf: np.ndarray | None,
    ivf_lengths: np.ndarray | None,
    nbits: int,
    device: torch.device | str | None = None,
    doc_cap: int | None = None,
    cell_cap: int | None = None,
    pad_docs_to: int | None = None,
    pad_ivf_to: int | None = None,
    residuals_on_device: bool = True,
    length_buckets: int = 0,
) -> tuple[DeviceIndex, IndexSpec]:
    """Pad host arrays (token-major flats) into the doc-major device layout.

    ``residuals_on_device=False`` is low_memory: the residuals stay in host
    RAM and ``DeviceIndex.residuals`` is None. ``length_buckets > 1`` allows
    up to that many length buckets (device-resident residuals only), taken
    where ``plan_buckets`` finds the corpus skewed enough to pay off: each
    bucket holds its documents' residuals at its own cap, and
    ``DeviceIndex.residuals`` is None. ``device`` None is the CUDA card, and
    raises without one (pass ``device="cpu"`` for the CPU).
    """
    device = default_device(device)
    k, dim = centroids.shape
    n_real_docs = int(len(doc_lengths))
    n_docs = max(pad_docs_to or n_real_docs, n_real_docs)
    n_tokens = int(codes.shape[0])
    pd = residuals.shape[1] if residuals.ndim == 2 else (dim * nbits) // 8

    doc_lengths = np.asarray(doc_lengths, dtype=np.int64)
    if doc_cap is None:
        doc_cap = round_up(
            max(int(doc_lengths.max()) if n_real_docs else 1, 1), 16
        )
    kp = round_up(max(k, 1), 128)

    np_docs = round_up(n_docs + 1, 8)
    offsets = (
        np.concatenate([[0], np.cumsum(doc_lengths)])[:-1]
        if n_real_docs
        else np.zeros((0,), np.int64)
    )
    codes2d = np.zeros((np_docs, doc_cap), dtype=np.int32)
    lengths = np.zeros((np_docs,), dtype=np.int32)
    clipped = np.minimum(doc_lengths, doc_cap)
    caps = (
        plan_buckets(clipped, doc_cap, max_buckets=length_buckets)
        if length_buckets > 1 and residuals_on_device and n_real_docs
        else None
    )
    residuals2d = (
        np.zeros((np_docs, doc_cap, pd), dtype=np.uint8)
        if residuals_on_device and not caps
        else None
    )
    if n_real_docs:
        doc_ids = np.repeat(np.arange(n_real_docs, dtype=np.int64), doc_lengths)
        within = np.arange(n_tokens, dtype=np.int64) - np.repeat(
            offsets, doc_lengths
        )
        keep = within < doc_cap
        dst = doc_ids[keep] * doc_cap + within[keep]
        codes_np = np.asarray(codes, np.int32)
        codes2d.reshape(-1)[dst] = codes_np[keep]
        if residuals2d is not None:
            residuals2d.reshape(-1, pd)[dst] = np.asarray(residuals)[keep]
    lengths[:n_real_docs] = clipped.astype(np.int32)
    if residuals2d is not None:
        residuals2d = residuals2d.reshape(np_docs, doc_cap * pd)

    host_buckets: list[tuple[np.ndarray, np.ndarray]] = []
    bucket_counts: list[int] = []
    doc_bucket = doc_bucket_row = None
    if caps:
        res_np = np.asarray(residuals)
        which = np.searchsorted(caps, clipped, side="left")  # [n_real]
        row_in_bucket = np.zeros((n_real_docs,), np.int64)
        for i in range(len(caps)):
            in_i = which == i
            bucket_counts.append(int(in_i.sum()))
            row_in_bucket[in_i] = np.arange(bucket_counts[-1])
        for i, cap_b in enumerate(caps):
            nb = bucket_counts[i]
            codes_b = np.zeros((nb + 1, cap_b), dtype=np.int32)
            res_b = np.zeros((nb + 1, cap_b, pd), dtype=np.uint8)
            in_b = (which[doc_ids] == i) & (within < cap_b)
            dst_b = row_in_bucket[doc_ids[in_b]] * cap_b + within[in_b]
            codes_b.reshape(-1)[dst_b] = codes_np[in_b]
            res_b.reshape(-1, pd)[dst_b] = res_np[in_b]
            host_buckets.append((codes_b, res_b.reshape(nb + 1, cap_b * pd)))
        # Padding documents and the sentinel map to bucket 0's zero row.
        doc_bucket = np.zeros((np_docs,), np.int32)
        doc_bucket[:n_real_docs] = which
        doc_bucket_row = np.full((np_docs,), bucket_counts[0], np.int32)
        doc_bucket_row[:n_real_docs] = row_in_bucket

    cent_p = np.zeros((kp, dim), dtype=np.float32)
    cent_p[:k] = centroids.astype(np.float32, copy=False)

    if ivf is not None and ivf_lengths is not None:
        lens64 = np.asarray(ivf_lengths, np.int64)
        if cell_cap is None:
            cell_cap = round_up(max(int(ivf_lengths.max()) if k else 1, 1), 8)
        nrows_c = -(-lens64 // IVF_ALIGN)
        row_start = np.concatenate([[0], np.cumsum(nrows_c)])
        n_aligned = int(row_start[-1]) * IVF_ALIGN
        pad_ivf = round_up(max(pad_ivf_to or n_aligned, n_aligned), IVF_ALIGN)
        ip = pad_ivf + round_up(cell_cap, IVF_ALIGN)
        ivf_p = np.full((ip,), n_docs, dtype=np.int32)  # pad -> sentinel pid
        n_ivf = int(ivf.shape[0])
        if n_ivf:
            cell_of = np.repeat(np.arange(k, dtype=np.int64), lens64)
            src_off = np.concatenate([[0], np.cumsum(lens64)])[:-1]
            within_c = np.arange(n_ivf, dtype=np.int64) - np.repeat(
                src_off, lens64
            )
            dst_c = row_start[cell_of] * IVF_ALIGN + within_c
            ivf_p[dst_c] = ivf.astype(np.int32, copy=False)
        ivf_off = np.zeros((kp + 8,), dtype=np.int32)
        ivf_len = np.zeros((kp + 8,), dtype=np.int32)
        ivf_len[:k] = ivf_lengths.astype(np.int32, copy=False)
        ivf_off[:k] = (row_start[:-1] * IVF_ALIGN).astype(np.int32)
        ivf_off[k:] = n_aligned
        has_ivf = True
    else:
        cell_cap = cell_cap or 8
        ivf_p = np.full(
            (round_up(cell_cap, IVF_ALIGN),), n_docs, dtype=np.int32
        )
        ivf_off = np.zeros((kp + 8,), dtype=np.int32)
        ivf_len = np.zeros((kp + 8,), dtype=np.int32)
        has_ivf = False

    device = torch.device(device)

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    dev = DeviceIndex(
        centroids=put(cent_p),
        bucket_weights=put(np.asarray(bucket_weights, dtype=np.float32)),
        codes=put(codes2d),
        residuals=put(residuals2d) if residuals2d is not None else None,
        doc_lengths=put(lengths),
        ivf=put(ivf_p),
        ivf_offsets=put(ivf_off),
        ivf_lengths=put(ivf_len),
        doc_bucket=put(doc_bucket) if doc_bucket is not None else None,
        doc_bucket_row=put(doc_bucket_row) if doc_bucket_row is not None else None,
        buckets=tuple(
            DocBucket(codes=put(cb), residuals=put(rb)) for cb, rb in host_buckets
        ),
    )
    spec = IndexSpec(
        dim=dim,
        nbits=nbits,
        n_docs=n_docs,
        n_partitions=k,
        doc_cap=doc_cap,
        cell_cap=cell_cap,
        has_ivf=has_ivf,
        bucket_caps=tuple(caps) if caps else (),
        bucket_counts=tuple(bucket_counts),
    )
    return dev, spec


def device_index_from_arrays(
    arrays: dict[str, np.ndarray],
    spec_fields: dict,
    device: torch.device | str = "cpu",
) -> tuple[DeviceIndex, IndexSpec]:
    """Build the port's (DeviceIndex, IndexSpec) from exported numpy arrays.

    ``arrays`` maps DeviceIndex field names to numpy arrays (for example
    ``{f: np.asarray(getattr(dev, f))}`` over another implementation's
    index); bf16 arrays (``ml_dtypes.bfloat16``) are accepted, and an
    absent ``residuals`` (low_memory, or a bucketed index) becomes None. A
    bucketed index also passes ``buckets``: one mapping a bucket with its
    ``codes``, ``residuals`` and optionally ``emb`` arrays.
    """
    device = torch.device(device)

    def put(x: np.ndarray) -> torch.Tensor:
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":  # exact through float32
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(x)).to(device)  # a writable copy

    known = {f.name for f in dataclasses.fields(DeviceIndex)} - {"buckets"}
    kwargs = {
        name: put(arr)
        for name, arr in arrays.items()
        if name in known and arr is not None and np.asarray(arr).size
    }
    kwargs["buckets"] = tuple(
        DocBucket(
            codes=put(bk["codes"]),
            residuals=put(bk["residuals"]).reshape(np.shape(bk["codes"])[0], -1),
            emb=put(bk["emb"]) if bk.get("emb") is not None else None,
        )
        for bk in arrays.get("buckets") or ()
    )
    if "residuals" in kwargs:
        kwargs["residuals"] = kwargs["residuals"].reshape(
            kwargs["codes"].shape[0], -1
        )
    kwargs.setdefault("residuals", None)
    spec_keys = {f.name for f in dataclasses.fields(IndexSpec)}
    spec = IndexSpec(
        **{
            k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in spec_fields.items()
            if k in spec_keys
        }
    )
    return DeviceIndex(**kwargs), spec


def gather_res(res_flat: torch.Tensor, idx: torch.Tensor, cap: int) -> torch.Tensor:
    """Row gather from the row-flat residual store: -> [..., cap, PD] uint8."""
    return res_flat[idx.long()].reshape(*idx.shape, cap, -1)


def emb_cache_bytes(ispec: IndexSpec) -> int:
    """Device-memory cost of the decompressed-corpus cache for this index."""
    if ispec.bucket_caps:
        return sum(
            (n + 1) * cap * ispec.dim * 2
            for n, cap in zip(ispec.bucket_counts, ispec.bucket_caps)
        )
    np_docs = round_up(ispec.n_docs + 1, 8)
    return np_docs * ispec.doc_cap * ispec.dim * 2


def build_emb_cache(
    dev: DeviceIndex, ispec: IndexSpec, block: int = 2048
) -> DeviceIndex:
    """Decompress the whole corpus once into a bf16 device cache.

    Afterwards stage 6 is a pure gather + MaxSim over cached rows. Needs
    device-resident residuals, full-cap or in length buckets (each bucket
    gets its own cache at its cap).
    """
    if dev.buckets:
        if dev.buckets[0].emb is not None:
            return dev
        buckets = tuple(
            dataclasses.replace(
                bk,
                emb=_decompress_2d(
                    bk.codes,
                    bk.residuals,
                    dev.centroids,
                    dev.bucket_weights,
                    nbits=ispec.nbits,
                    block=min(block, bk.codes.shape[0]),
                ),
            )
            for bk in dev.buckets
        )
        return dataclasses.replace(dev, buckets=buckets)
    if dev.residuals is None or dev.emb_cache is not None:
        return dev
    cache = _decompress_2d(
        dev.codes,
        dev.residuals,
        dev.centroids,
        dev.bucket_weights,
        nbits=ispec.nbits,
        block=min(block, dev.codes.shape[0]),
    )
    return dataclasses.replace(dev, emb_cache=cache)


def _decompress_2d(codes, residuals, centroids, bucket_weights, *, nbits, block):
    """Decompress a whole [N, cap(, PD)] doc-major array into a bf16 cache.

    The cache is allocated once and filled ``block`` documents at a time,
    so the float32 temporaries stay one block in size.
    """
    n, cap = codes.shape
    res = residuals.reshape(n, cap, -1)
    dim = centroids.shape[-1]
    out = torch.empty((n, cap, dim), dtype=torch.bfloat16, device=codes.device)
    for start in range(0, n, max(block, 1)):
        end = min(start + block, n)
        out[start:end] = codec.decompress(
            codes[start:end],
            res[start:end],
            centroids,
            bucket_weights,
            nbits,
            out_dtype=torch.bfloat16,
        )
    return out


def q4_cache_bytes(ispec: IndexSpec) -> int:
    """Device-memory cost of the 4-bit prefilter cache (packed data + scales)."""
    np_docs = round_up(ispec.n_docs + 1, 8)
    return np_docs * (ispec.doc_cap * ispec.dim // 2 + 4)


def quantize_q4_rows(codes_rows, res_rows, centroids, bucket_weights, *, nbits):
    """Decompress + q4-quantize doc-major rows.

    [N, cap] codes + [N, cap, PD] residuals -> ([N * cap/2, D] uint8 packed,
    [N] float32 scales): the 2-D layout in which document pid's block is
    rows [pid * cap/2, (pid + 1) * cap/2), as the q4 kernel reads it.
    """
    from fast_plaid_tpu_torch.ops.q4cache import quantize_emb_q4

    n, cap = codes_rows.shape
    emb = codec.decompress(codes_rows, res_rows, centroids, bucket_weights, nbits)
    packed, scale = quantize_emb_q4(emb)
    return packed.reshape(n * (cap // 2), -1), scale


def build_q4_cache(
    dev: DeviceIndex, ispec: IndexSpec, block: int = 2048
) -> DeviceIndex:
    """Quantize the decompressed corpus into the 4-bit prefilter cache.

    Decompresses and quantizes ``block`` documents at a time into one
    preallocated tensor, so the decompressed corpus never exists whole.
    Needs device-resident residuals in the single-cap layout.
    """
    if dev.residuals is None or dev.buckets or dev.emb_q4 is not None:
        return dev
    n, cap = dev.codes.shape
    out = torch.empty((n * (cap // 2), ispec.dim), dtype=torch.uint8, device=dev.codes.device)
    scale = torch.empty((n,), dtype=torch.float32, device=dev.codes.device)
    quantize_q4_into(
        dev.codes, dev.residuals, dev.centroids, dev.bucket_weights,
        nbits=ispec.nbits, out=out, scale=scale, block=block,
    )
    return dataclasses.replace(dev, emb_q4=out, q4_scale=scale)


def quantize_q4_into(
    codes: torch.Tensor,  # [N, cap] int32 doc-major
    residuals: torch.Tensor,  # [N, cap * PD] uint8 row-flat
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    *,
    nbits: int,
    out: torch.Tensor,  # [N * cap/2, D] uint8, written in place
    scale: torch.Tensor,  # [N] float32, written in place
    block: int = 2048,
) -> None:
    """Fill a preallocated q4 cache from doc-major rows, ``block`` documents
    at a time, so the decompressed corpus never exists whole."""
    n, cap = codes.shape
    caph = cap // 2
    res = residuals.reshape(n, cap, -1)
    for start in range(0, n, max(block, 1)):
        end = min(start + block, n)
        out[start * caph : end * caph], scale[start:end] = quantize_q4_rows(
            codes[start:end], res[start:end], centroids, bucket_weights, nbits=nbits
        )
