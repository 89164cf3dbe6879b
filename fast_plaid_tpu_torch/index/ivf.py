"""Inverted-file construction and splicing, on the host.

A copy of ``fast_plaid_tpu/index/ivf.py``: ``build_ivf`` and ``splice_ivf``.
As in the JAX package, a build of at least 1M codes goes through the C++
host kernel (``fast_plaid_tpu_torch.native``) where it is built; smaller
builds, and every build without it, take the numpy path. Both give the
identical (cell, pid)-sorted, per-cell-deduped lists.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_ivf", "build_ivf_numpy", "splice_ivf"]


def build_ivf(
    codes: np.ndarray, doc_lengths: np.ndarray, n_partitions: int
) -> tuple[np.ndarray, np.ndarray]:
    """Build (ivf [I] int32 pids grouped by cell, ivf_lengths [K] int64).

    Args:
        codes: [T] int32 centroid id per token (token-major, doc order).
        doc_lengths: [N] token count per document.
        n_partitions: K, the number of centroids.
    """
    n_docs = int(len(doc_lengths))
    if n_docs == 0 or codes.size == 0:
        return (
            np.zeros((0,), dtype=np.int32),
            np.zeros((n_partitions,), dtype=np.int64),
        )
    if codes.size >= 1_000_000:  # the native path pays off on large builds
        from fast_plaid_tpu_torch import native

        result = native.build_ivf_native(codes, doc_lengths, n_partitions)
        if result is not None:
            return result
    return build_ivf_numpy(codes, doc_lengths, n_partitions)


def build_ivf_numpy(
    codes: np.ndarray, doc_lengths: np.ndarray, n_partitions: int
) -> tuple[np.ndarray, np.ndarray]:
    """``build_ivf``'s numpy path (one ``np.unique`` over (cell, pid) keys),
    for at least one document and one code."""
    n_docs = int(len(doc_lengths))
    pids = np.repeat(
        np.arange(n_docs, dtype=np.int64), np.asarray(doc_lengths, dtype=np.int64)
    )
    key = codes.astype(np.int64) * n_docs + pids
    uniq = np.unique(key)  # sorted by (cell, pid), deduped
    cells = uniq // n_docs
    ivf = (uniq % n_docs).astype(np.int32)
    ivf_lengths = np.bincount(cells, minlength=n_partitions).astype(np.int64)
    return ivf, ivf_lengths


def splice_ivf(
    old_ivf: np.ndarray,
    old_lengths: np.ndarray,
    new_codes: np.ndarray,
    new_doc_lengths: np.ndarray,
    pid_base: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge newly appended documents into an existing IVF without a rebuild.

    New pids (``pid_base + local id``) are bucketed per partition and
    concatenated after each cell's existing list: O(|old_ivf| + |new
    tokens|), never touching old chunks' codes. Per-cell dedup holds because
    new pids are disjoint from old ones.
    """
    k = int(old_lengths.shape[0])
    new_ivf, new_lengths = build_ivf(new_codes, new_doc_lengths, k)
    if new_ivf.size == 0:
        return old_ivf, old_lengths
    new_ivf = new_ivf + np.int32(pid_base)

    old_lengths = np.asarray(old_lengths, np.int64)
    out_lengths = old_lengths + new_lengths
    out_offsets = np.concatenate([[0], np.cumsum(out_lengths)])
    out = np.empty(old_ivf.size + new_ivf.size, np.int32)

    cells_arange = np.arange(k, dtype=np.int64)
    if old_ivf.size:
        old_offsets = np.concatenate([[0], np.cumsum(old_lengths)])
        old_cells = np.repeat(cells_arange, old_lengths)
        rank = np.arange(old_ivf.size, dtype=np.int64) - old_offsets[old_cells]
        out[out_offsets[old_cells] + rank] = old_ivf
    new_offsets = np.concatenate([[0], np.cumsum(new_lengths)])
    new_cells = np.repeat(cells_arange, new_lengths)
    rank = np.arange(new_ivf.size, dtype=np.int64) - new_offsets[new_cells]
    out[out_offsets[new_cells] + old_lengths[new_cells] + rank] = new_ivf
    return out, out_lengths
