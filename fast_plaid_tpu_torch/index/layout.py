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

IVF cells keep the flat + offsets form with every cell starting on a
multiple of ``IVF_ALIGN``, so candidate windows are whole rows of
``ivf.view(-1, IVF_ALIGN)``. One sentinel document (pid == n_docs, length 0)
absorbs invalid candidate slots. The length-bucketed layout is not ported
yet (ROADMAP.md §1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from fast_plaid_tpu_torch.ops import codec

__all__ = [
    "DeviceIndex",
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
]

# Every cell's IVF list starts on a multiple of this, so candidate windows
# are whole rows of the 2-D IVF view (one row gather per window).
IVF_ALIGN = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
    # Length buckets are not ported; both stay empty.
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
    device: torch.device | str = "cpu",
    doc_cap: int | None = None,
    cell_cap: int | None = None,
    pad_docs_to: int | None = None,
    pad_ivf_to: int | None = None,
    residuals_on_device: bool = True,
    length_buckets: int = 0,
) -> tuple[DeviceIndex, IndexSpec]:
    """Pad host arrays (token-major flats) into the doc-major device layout.

    ``residuals_on_device=False`` is low_memory: the residuals stay in host
    RAM and ``DeviceIndex.residuals`` is None. ``length_buckets > 1`` asks
    for the length-bucketed layout (device-resident residuals only). Where
    ``plan_buckets`` would choose buckets this raises NotImplementedError
    rather than silently taking the single-cap layout.
    """
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
    if length_buckets > 1 and residuals_on_device and n_real_docs:
        caps = plan_buckets(clipped, doc_cap, max_buckets=length_buckets)
        if caps:
            msg = (
                f"this corpus's length skew selects length buckets {caps}; "
                "the length-bucketed layout is not ported yet (ROADMAP.md "
                "§1, length buckets). Pass length_buckets=0."
            )
            raise NotImplementedError(msg)
    residuals2d = (
        np.zeros((np_docs, doc_cap, pd), dtype=np.uint8)
        if residuals_on_device
        else None
    )
    if n_real_docs:
        doc_ids = np.repeat(np.arange(n_real_docs, dtype=np.int64), doc_lengths)
        within = np.arange(n_tokens, dtype=np.int64) - np.repeat(
            offsets, doc_lengths
        )
        keep = within < doc_cap
        dst = doc_ids[keep] * doc_cap + within[keep]
        codes2d.reshape(-1)[dst] = np.asarray(codes, np.int32)[keep]
        if residuals2d is not None:
            residuals2d.reshape(-1, pd)[dst] = np.asarray(residuals)[keep]
    lengths[:n_real_docs] = clipped.astype(np.int32)
    if residuals2d is not None:
        residuals2d = residuals2d.reshape(np_docs, doc_cap * pd)

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
    )
    spec = IndexSpec(
        dim=dim,
        nbits=nbits,
        n_docs=n_docs,
        n_partitions=k,
        doc_cap=doc_cap,
        cell_cap=cell_cap,
        has_ivf=has_ivf,
    )
    return dev, spec


_UNPORTED_FIELDS = ("doc_bucket", "doc_bucket_row", "buckets")


def device_index_from_arrays(
    arrays: dict[str, np.ndarray],
    spec_fields: dict,
    device: torch.device | str = "cpu",
) -> tuple[DeviceIndex, IndexSpec]:
    """Build the port's (DeviceIndex, IndexSpec) from exported numpy arrays.

    ``arrays`` maps DeviceIndex field names to numpy arrays (for example
    ``{f: np.asarray(getattr(dev, f))}`` over another implementation's
    index); bf16 arrays (``ml_dtypes.bfloat16``) are accepted, and an
    absent ``residuals`` (low_memory) becomes None. Fields of layouts this
    package does not implement must be absent or empty.
    """
    device = torch.device(device)
    for name in _UNPORTED_FIELDS:
        arr = arrays.get(name)
        if arr is not None and np.asarray(arr).size:
            msg = f"DeviceIndex field {name!r} belongs to a layout not ported yet"
            raise NotImplementedError(msg)

    def put(x: np.ndarray) -> torch.Tensor:
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":  # exact through float32
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(x)).to(device)  # a writable copy

    known = {f.name for f in dataclasses.fields(DeviceIndex)}
    kwargs = {
        name: put(arr)
        for name, arr in arrays.items()
        if name in known and arr is not None and np.asarray(arr).size
    }
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
    if spec.bucket_caps:
        msg = "length-bucketed indexes are not ported yet (ROADMAP.md §1)"
        raise NotImplementedError(msg)
    return DeviceIndex(**kwargs), spec


def gather_res(res_flat: torch.Tensor, idx: torch.Tensor, cap: int) -> torch.Tensor:
    """Row gather from the row-flat residual store: -> [..., cap, PD] uint8."""
    return res_flat[idx.long()].reshape(*idx.shape, cap, -1)


def emb_cache_bytes(ispec: IndexSpec) -> int:
    """Device-memory cost of the decompressed-corpus cache for this index."""
    np_docs = round_up(ispec.n_docs + 1, 8)
    return np_docs * ispec.doc_cap * ispec.dim * 2


def build_emb_cache(
    dev: DeviceIndex, ispec: IndexSpec, block: int = 2048
) -> DeviceIndex:
    """Decompress the whole corpus once into a bf16 device cache.

    Afterwards stage 6 is a pure gather + MaxSim over cached rows. Needs
    device-resident residuals.
    """
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
    Needs device-resident residuals.
    """
    if dev.residuals is None or dev.emb_q4 is not None:
        return dev
    n, cap = dev.codes.shape
    caph = cap // 2
    res = dev.residuals.reshape(n, cap, -1)
    out = torch.empty((n * caph, ispec.dim), dtype=torch.uint8, device=dev.codes.device)
    scale = torch.empty((n,), dtype=torch.float32, device=dev.codes.device)
    for start in range(0, n, max(block, 1)):
        end = min(start + block, n)
        out[start * caph : end * caph], scale[start:end] = quantize_q4_rows(
            dev.codes[start:end],
            res[start:end],
            dev.centroids,
            dev.bucket_weights,
            nbits=ispec.nbits,
        )
    return dataclasses.replace(dev, emb_q4=out, q4_scale=scale)
