"""Inverted-file construction (numpy, on the host).

A copy of the numpy path of ``fast_plaid_tpu/index/ivf.py::build_ivf``. The
reference's optional C++ branch for large builds lives in the JAX package's
``native`` module, which cannot be imported without jax; the numpy path
below gives the identical (cell, pid)-sorted, per-cell-deduped lists.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_ivf"]


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
    pids = np.repeat(
        np.arange(n_docs, dtype=np.int64), np.asarray(doc_lengths, dtype=np.int64)
    )
    key = codes.astype(np.int64) * n_docs + pids
    uniq = np.unique(key)  # sorted by (cell, pid), deduped
    cells = uniq // n_docs
    ivf = (uniq % n_docs).astype(np.int32)
    ivf_lengths = np.bincount(cells, minlength=n_partitions).astype(np.int64)
    return ivf, ivf_lengths
