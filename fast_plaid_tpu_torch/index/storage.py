"""On-disk index persistence.

A verbatim copy of ``fast_plaid_tpu/index/storage.py`` (numpy only), so the
two packages read and write the same ``layout_version: 1`` directory byte
for byte without this one importing jax.

Keeps the reference's durable-state contract (SURVEY.md §5.4; reference:
rust/index/create.rs:380-582, python/fast_plaid/search/load.py) — the index
directory IS the checkpoint, every mutation is written through before the
in-memory handle swaps:

    metadata.json        {num_chunks, nbits, num_partitions, num_embeddings,
                          avg_doclen, num_documents, compress_only, dim,
                          layout_version}
    plan.json            {nbits, num_chunks}
    centroids.npy        [K, D] float32
    bucket_cutoffs.npy   [2^nbits - 1] float32
    bucket_weights.npy   [2^nbits] float32
    avg_residual.npy     [D] float32
    cluster_threshold.npy scalar float32
    {i}.codes.npy        [tokens_i] int32
    {i}.residuals.npy    [tokens_i, D*nbits/8] uint8   (our packing, v1)
    doclens.{i}.json     list[int]
    {i}.metadata.json    {num_documents, num_embeddings, embedding_offset}
    ivf.npy / ivf_lengths.npy   (absent when compress_only)
    embeddings.npy       raw doc embeddings (object array) for small indexes
    buffer.npy           pending update buffer (object array)
    metadata.db          SQLite metadata store (see filtering/)

``layout_version: 1`` marks that residual bytes use the shift/mask packing
from fast_plaid_tpu.ops.codec (NOT binary-compatible with the reference's
bit-reversed packbits layout).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "LAYOUT_VERSION",
    "IndexData",
    "load_index_data",
    "load_metadata",
    "save_metadata",
    "save_object_npy",
    "load_object_npy",
    "chunk_paths",
]

LAYOUT_VERSION = 1


def _p(index_path: str, name: str) -> str:
    return os.path.join(index_path, name)


def load_metadata(index_path: str) -> dict:
    with open(_p(index_path, "metadata.json")) as f:
        return json.load(f)


def save_metadata(index_path: str, meta: dict) -> None:
    with open(_p(index_path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=4)


def save_object_npy(path: str, arrays: list[np.ndarray]) -> None:
    """Persist a list of [L_i, D] float arrays as a pickled object .npy.

    Same contract as the reference's save_list_tensors_on_disk
    (load.py:430-444) — used for embeddings.npy / buffer.npy.
    """
    obj = np.empty(len(arrays), dtype=object)
    for i, a in enumerate(arrays):
        obj[i] = np.asarray(a, dtype=np.float32)
    np.save(path, obj, allow_pickle=True)


def load_object_npy(path: str) -> list[np.ndarray]:
    obj = np.load(path, allow_pickle=True)
    return [np.asarray(a, dtype=np.float32) for a in obj]


def chunk_paths(index_path: str, i: int) -> tuple[str, str, str, str]:
    return (
        _p(index_path, f"{i}.codes.npy"),
        _p(index_path, f"{i}.residuals.npy"),
        _p(index_path, f"doclens.{i}.json"),
        _p(index_path, f"{i}.metadata.json"),
    )


# ---------------------------------------------------------------------------
# Merged-mmap load cache.
#
# Parity with the reference's manifest-driven chunk merger (reference:
# python/fast_plaid/search/load.py:35-217): per-chunk {i}.codes.npy /
# {i}.residuals.npy are merged once into merged_codes.npy /
# merged_residuals.npy with a JSON manifest recording each chunk's
# (mtime, rows). Reloads then mmap one file instead of re-reading every
# chunk; when only new chunks appeared the merge is incremental via an
# in-place npy header resize + append (full rewrite as the fallback).
# ---------------------------------------------------------------------------


def _chunk_state(index_path: str, kind: str, num_chunks: int) -> list[dict]:
    state = []
    for i in range(num_chunks):
        path = _p(index_path, f"{i}.{kind}.npy")
        st = os.stat(path)
        state.append({"chunk": i, "mtime": st.st_mtime, "size": st.st_size})
    return state


def _resize_npy_inplace(path: str, new_rows: int) -> bool:
    """Grow a .npy file's leading dimension without rewriting its data.

    Returns False when the new header would not fit in the existing header
    block (caller falls back to a full rewrite).
    """
    import numpy.lib.format as npf

    with open(path, "r+b") as f:
        version = npf.read_magic(f)
        shape, fortran, dtype = npf._read_array_header(f, version)
        header_end = f.tell()
        new_shape = (new_rows, *shape[1:])
        header = {
            "descr": npf.dtype_to_descr(dtype),
            "fortran_order": fortran,
            "shape": new_shape,
        }
        import io

        buf = io.BytesIO()
        try:
            npf._write_array_header(buf, header, version)
        except Exception:
            npf.write_array_header_1_0(buf, header)
        raw = buf.getvalue()
        if len(raw) != header_end:
            return False
        f.seek(0)
        f.write(raw)
        return True


def get_merged_mmap(
    index_path: str, kind: str, num_chunks: int
) -> np.ndarray | None:
    """Return an mmap of the merged chunk data, maintaining the cache.

    kind is "codes" or "residuals". Returns None when there are no chunks.
    """
    if num_chunks <= 0:
        return None
    merged_path = _p(index_path, f"merged_{kind}.npy")
    manifest_path = _p(index_path, f"merged_{kind}.manifest.json")
    state = _chunk_state(index_path, kind, num_chunks)

    old: list[dict] = []
    if os.path.exists(manifest_path) and os.path.exists(merged_path):
        try:
            with open(manifest_path) as f:
                old = json.load(f)["chunks"]
        except (json.JSONDecodeError, KeyError, OSError):
            old = []

    def rows_of(i: int) -> int:
        arr = np.load(_p(index_path, f"{i}.{kind}.npy"), mmap_mode="r")
        return int(arr.shape[0])

    unchanged = 0
    for a, b in zip(old, state):
        if a["mtime"] == b["mtime"] and a["size"] == b["size"]:
            unchanged += 1
        else:
            break

    if unchanged == len(state) and len(old) == len(state):
        return np.load(merged_path, mmap_mode="c")

    try:
        if 0 < unchanged == len(old) and unchanged < len(state):
            # Pure append: grow the merged file in place.
            base_rows = sum(rows_of(i) for i in range(unchanged))
            new_rows = base_rows + sum(
                rows_of(i) for i in range(unchanged, num_chunks)
            )
            if _resize_npy_inplace(merged_path, new_rows):
                merged = np.load(merged_path, mmap_mode="r+")
                cursor = base_rows
                for i in range(unchanged, num_chunks):
                    arr = np.load(_p(index_path, f"{i}.{kind}.npy"), mmap_mode="r")
                    merged[cursor : cursor + arr.shape[0]] = arr
                    cursor += arr.shape[0]
                merged.flush()
                del merged
                with open(manifest_path, "w") as f:
                    json.dump({"chunks": state}, f)
                return np.load(merged_path, mmap_mode="c")
    except Exception:
        # Corrupt cache, or a numpy release changing the private header
        # helpers _resize_npy_inplace uses -> full rewrite (the reference
        # falls back the same way, load.py:182-183).
        pass

    # Full rewrite.
    arrays = [
        np.load(_p(index_path, f"{i}.{kind}.npy"), mmap_mode="r")
        for i in range(num_chunks)
    ]
    total = sum(int(a.shape[0]) for a in arrays)
    tail = arrays[0].shape[1:]
    out = np.lib.format.open_memmap(
        merged_path + ".tmp",
        mode="w+",
        dtype=arrays[0].dtype,
        shape=(total, *tail),
    )
    cursor = 0
    for a in arrays:
        out[cursor : cursor + a.shape[0]] = a
        cursor += a.shape[0]
    out.flush()
    del out
    os.replace(merged_path + ".tmp", merged_path)
    with open(manifest_path, "w") as f:
        json.dump({"chunks": state}, f)
    return np.load(merged_path, mmap_mode="c")


@dataclass
class IndexData:
    """Host-side (numpy) view of a fully loaded index."""

    centroids: np.ndarray  # [K, D] f32
    bucket_cutoffs: np.ndarray  # [2^nbits - 1] f32
    bucket_weights: np.ndarray  # [2^nbits] f32
    avg_residual: np.ndarray  # [D] f32
    cluster_threshold: float
    codes: np.ndarray  # [T] int32
    residuals: np.ndarray  # [T, PD] uint8
    doc_lengths: np.ndarray  # [N] int32
    ivf: np.ndarray | None  # [I] int32
    ivf_lengths: np.ndarray | None  # [K] int64
    metadata: dict

    @property
    def nbits(self) -> int:
        return int(self.metadata["nbits"])

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])


def load_index_data(index_path: str) -> IndexData | None:
    """Load every on-disk artifact into host memory (mmap for the big flats).

    Mirrors _load_index_tensors_cpu (reference load.py:220-322) without the
    merged-mmap cache: chunks are concatenated directly. Returns None when
    no index exists yet.
    """
    meta_path = _p(index_path, "metadata.json")
    if not os.path.exists(meta_path):
        return None
    metadata = load_metadata(index_path)
    num_chunks = int(metadata["num_chunks"])

    centroids = np.load(_p(index_path, "centroids.npy")).astype(np.float32)
    bucket_cutoffs = np.load(_p(index_path, "bucket_cutoffs.npy")).astype(np.float32)
    bucket_weights = np.load(_p(index_path, "bucket_weights.npy")).astype(np.float32)
    avg_residual = np.load(_p(index_path, "avg_residual.npy")).astype(np.float32)
    cluster_threshold = float(
        np.load(_p(index_path, "cluster_threshold.npy")).item()
    )

    doclens: list[int] = []
    for i in range(num_chunks):
        with open(chunk_paths(index_path, i)[2]) as f:
            doclens.extend(json.load(f))

    if num_chunks == 1:
        # Single chunk: no merge needed, mmap it directly.
        codes = np.load(chunk_paths(index_path, 0)[0], mmap_mode="c")
        residuals = np.load(chunk_paths(index_path, 0)[1], mmap_mode="c")
    elif num_chunks > 1:
        codes = get_merged_mmap(index_path, "codes", num_chunks)
        residuals = get_merged_mmap(index_path, "residuals", num_chunks)
    else:
        pd = (centroids.shape[1] * int(metadata["nbits"])) // 8
        codes = np.zeros((0,), dtype=np.int32)
        residuals = np.zeros((0, pd), dtype=np.uint8)
    codes = np.asarray(codes, dtype=np.int32) if codes.dtype != np.int32 else codes
    doc_lengths = np.asarray(doclens, dtype=np.int32)

    ivf = ivf_lengths = None
    if os.path.exists(_p(index_path, "ivf.npy")):
        ivf = np.load(_p(index_path, "ivf.npy")).astype(np.int32)
        ivf_lengths = np.load(_p(index_path, "ivf_lengths.npy")).astype(np.int64)

    return IndexData(
        centroids=centroids,
        bucket_cutoffs=bucket_cutoffs,
        bucket_weights=bucket_weights,
        avg_residual=avg_residual,
        cluster_threshold=cluster_threshold,
        codes=codes,
        residuals=residuals,
        doc_lengths=doc_lengths,
        ivf=ivf,
        ivf_lengths=ivf_lengths,
        metadata=metadata,
    )
