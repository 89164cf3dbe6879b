"""Buffered incremental update (port of ``fast_plaid_tpu/search/update.py``).

* no index yet -> full create;
* index still small (<= start_from_scratch docs) and raw embeddings.npy
  present -> rebuild from scratch with old + new raw embeddings;
* fewer than buffer_size pending docs -> append to the index at once AND
  remember them in buffer.npy (searchable now, re-ingested once the buffer
  trips);
* buffer trips -> delete the buffered docs from the index, add k-means
  centroids over the outlier tokens (squared distance to the nearest
  centroid above cluster_threshold²), then re-append buffered + new docs
  with the threshold refreshed.

The outlier scan is a blocked float32 matmul on ``device``; k-means and the
compression of new documents run there too.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from fast_plaid_tpu_torch.filtering import update as update_metadata_db
from fast_plaid_tpu_torch.index import storage
from fast_plaid_tpu_torch.index.appender import update_index
from fast_plaid_tpu_torch.search.kmeans import compute_kmeans

__all__ = ["process_update", "update_centroids"]


def _min_dists_sq(
    flat: np.ndarray,
    centroids: np.ndarray,
    device: torch.device | str = "cpu",
    block: int = 4096,
) -> np.ndarray:
    """Min squared L2 distance to any centroid: ||x||² + ||c||² - 2 x·c,
    float32 throughout. On a GPU the product runs in full float32 as long as
    TF32 stays off (PyTorch's default), as the JAX package's does: TF32
    would move points across the outlier threshold."""
    device = torch.device(device)
    cent = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    c2 = torch.sum(cent * cent, dim=-1)
    out = np.empty((flat.shape[0],), np.float32)
    for start in range(0, flat.shape[0], block):
        x = torch.from_numpy(np.asarray(flat[start : start + block], np.float32))
        x = x.to(device)
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        d = x2 + c2[None, :] - 2.0 * torch.matmul(x, cent.t())
        out[start : start + block] = torch.amin(d, dim=-1).cpu().numpy()
    return out


def update_centroids(
    index_path: str,
    new_embeddings: list[np.ndarray],
    cluster_threshold: float,
    kmeans_niters: int,
    max_points_per_centroid: int,
    seed: int,
    n_samples_kmeans: int | None = None,
    device: torch.device | str = "cpu",
) -> None:
    """Append k-means centroids over the outlier tokens.

    k = max(1, 4 * ceil(n_outliers / max_points_per_centroid));
    ivf_lengths.npy is zero-extended and metadata num_partitions bumped.
    """
    centroids_path = os.path.join(index_path, "centroids.npy")
    if not os.path.exists(centroids_path):
        return
    existing = np.load(centroids_path).astype(np.float32)
    flat = np.concatenate(
        [np.asarray(e, np.float32) for e in new_embeddings], axis=0
    )
    if flat.ndim == 3:
        flat = flat.reshape(-1, flat.shape[-1])

    dists = _min_dists_sq(flat, existing, device)
    outliers = flat[dists > cluster_threshold**2]
    if outliers.shape[0] == 0:
        return

    target_k = math.ceil(outliers.shape[0] / max_points_per_centroid)
    k_update = max(1, target_k * 4)
    new_centroids = compute_kmeans(
        documents_embeddings=[outliers],
        dim=outliers.shape[1],
        kmeans_niters=kmeans_niters,
        max_points_per_centroid=max_points_per_centroid,
        seed=seed,
        n_samples_kmeans=n_samples_kmeans,
        num_partitions=k_update,
        device=device,
    )
    final = np.concatenate([existing, new_centroids.astype(np.float32)], axis=0)
    np.save(centroids_path, final)

    ivf_len_path = os.path.join(index_path, "ivf_lengths.npy")
    if os.path.exists(ivf_len_path):
        ivf_lengths = np.load(ivf_len_path)
        np.save(
            ivf_len_path,
            np.concatenate(
                [ivf_lengths, np.zeros(new_centroids.shape[0], ivf_lengths.dtype)]
            ),
        )

    meta_path = os.path.join(index_path, "metadata.json")
    if os.path.exists(meta_path):
        meta = storage.load_metadata(index_path)
        meta["num_partitions"] = int(final.shape[0])
        storage.save_metadata(index_path, meta)


def process_update(
    index_path: str,
    documents_embeddings: list[np.ndarray],
    metadata: list[dict] | None,
    batch_size: int,
    kmeans_niters: int,
    max_points_per_centroid: int,
    n_samples_kmeans: int | None,
    seed: int,
    start_from_scratch: int,
    buffer_size: int,
    create_fn,
    delete_fn,
    device: torch.device | str = "cpu",
) -> None:
    """Apply an update to the files on disk; callers reload device indexes after."""
    if not os.path.exists(os.path.join(index_path, "metadata.json")):
        create_fn(
            documents_embeddings=documents_embeddings,
            kmeans_niters=kmeans_niters,
            max_points_per_centroid=max_points_per_centroid,
            n_samples_kmeans=n_samples_kmeans,
            batch_size=batch_size,
            seed=seed,
            metadata=metadata,
            start_from_scratch=start_from_scratch,
        )
        return

    documents_embeddings = [
        np.asarray(d, np.float32) for d in documents_embeddings
    ]
    meta = storage.load_metadata(index_path)
    num_documents_in_index = int(
        meta.get("num_documents", start_from_scratch + 1)
    )
    compress_only = bool(meta.get("compress_only", False))
    num_docs = len(documents_embeddings)

    if os.path.exists(os.path.join(index_path, "metadata.db")):
        if metadata is None:
            metadata = [{} for _ in range(num_docs)]
        if len(metadata) != num_docs:
            msg = (
                f"The length of metadata ({len(metadata)}) must match the "
                f"number of documents_embeddings ({num_docs})."
            )
            raise ValueError(msg)
        update_metadata_db(index=index_path, metadata=metadata)

    # Small index: rebuild from scratch with stored raw embeddings.
    emb_path = os.path.join(index_path, "embeddings.npy")
    if num_documents_in_index <= start_from_scratch and os.path.exists(emb_path):
        existing = storage.load_object_npy(emb_path)
        combined = existing + documents_embeddings
        create_fn(
            documents_embeddings=combined,
            kmeans_niters=kmeans_niters,
            max_points_per_centroid=max_points_per_centroid,
            n_samples_kmeans=n_samples_kmeans,
            batch_size=batch_size,
            seed=seed,
            metadata=None,
            start_from_scratch=start_from_scratch,
            compress_only=compress_only,
        )
        if len(combined) > start_from_scratch and os.path.exists(emb_path):
            os.remove(emb_path)
        return

    cluster_threshold = float(
        np.load(os.path.join(index_path, "cluster_threshold.npy")).item()
    )

    buffer_path = os.path.join(index_path, "buffer.npy")
    buffered: list[np.ndarray] = []
    if os.path.exists(buffer_path):
        buffered = storage.load_object_npy(buffer_path)

    total_new = len(documents_embeddings) + len(buffered)

    if total_new >= buffer_size:
        # Buffer trip: pull buffered docs out, expand centroids, re-append all.
        if buffered:
            start_del = num_documents_in_index - len(buffered)
            delete_fn(
                subset=list(range(start_del, num_documents_in_index)),
                _delete_metadata=False,
                _delete_buffer=False,
            )
            documents_embeddings = buffered + documents_embeddings
        update_centroids(
            index_path=index_path,
            new_embeddings=documents_embeddings,
            cluster_threshold=cluster_threshold,
            kmeans_niters=kmeans_niters,
            max_points_per_centroid=max_points_per_centroid,
            seed=seed,
            n_samples_kmeans=n_samples_kmeans,
            device=device,
        )
        if os.path.exists(buffer_path):
            os.remove(buffer_path)
        update_index(
            index_path,
            documents_embeddings,
            batch_size=batch_size,
            update_threshold_centroids=True,
            device=device,
        )
        return

    # Below the buffer threshold: append now, remember in buffer.npy.
    storage.save_object_npy(buffer_path, buffered + documents_embeddings)
    update_index(
        index_path,
        documents_embeddings,
        batch_size=batch_size,
        update_threshold_centroids=False,
        device=device,
    )
