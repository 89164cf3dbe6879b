"""Index creation pipeline (codec training + chunked compression + IVF).

Port of ``fast_plaid_tpu/index/builder.py``: seeded document sampling,
held-out codec training, chunked compress-and-persist, then IVF assembly.
The compression math runs in PyTorch on ``device``; everything written to
disk is the same ``layout_version: 1`` format the JAX package writes.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index import storage
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.utils import tracing

__all__ = ["create_index", "compress_documents", "train_codec_from_documents"]


def _doc_list(documents_embeddings) -> list[np.ndarray]:
    return [np.asarray(d, dtype=np.float32) for d in documents_embeddings]


def train_codec_from_documents(
    documents: list[np.ndarray],
    centroids: np.ndarray,
    nbits: int,
    seed: int,
    device: torch.device | str = "cpu",
) -> codec.CodecParams:
    """Seeded sampling + held-out residual codec training.

    Sample min(1 + 16*sqrt(120*N), N) documents, hold out min(5% of sampled
    tokens, 50k) tokens taken from the tail of the sample.
    """
    n_docs = len(documents)
    sample_count = int(min(1.0 + 16.0 * math.sqrt(120.0 * n_docs), float(n_docs)))
    rng = np.random.default_rng(seed)
    sample_pids = rng.permutation(n_docs)[:sample_count]

    total_sample_tokens = int(sum(documents[p].shape[0] for p in sample_pids))
    heldout_size = int(round(min(0.05 * total_sample_tokens, 50_000.0)))
    heldout_size = max(heldout_size, 1)

    taken: list[np.ndarray] = []
    count = 0
    for p in reversed(sample_pids):
        if count >= heldout_size:
            break
        doc = documents[p]
        need = heldout_size - count
        part = doc if doc.shape[0] <= need else doc[-need:]
        taken.append(part)
        count += part.shape[0]
    taken.reverse()
    heldout = (
        np.concatenate(taken, axis=0)
        if taken
        else np.zeros((0, centroids.shape[1]), np.float32)
    )
    if heldout.shape[0] == 0:
        msg = "Cannot train codec: no heldout samples were generated."
        raise ValueError(msg)

    device = torch.device(device)
    cent = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    codes = (
        codec.assign_codes(torch.from_numpy(heldout).to(device), cent)
        .cpu()
        .numpy()
    )
    residuals = heldout - centroids[codes]
    return codec.train_codec(residuals, nbits)


def compress_documents(
    documents: list[np.ndarray],
    centroids: np.ndarray,
    bucket_cutoffs: np.ndarray,
    nbits: int,
    token_block: int = 262_144,
    device: torch.device | str = "cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Compress a batch of documents to (codes [T] int32, packed [T, PD] u8)."""
    if not documents:
        pd = codec.packed_dim(centroids.shape[1], nbits)
        return np.zeros((0,), np.int32), np.zeros((0, pd), np.uint8)
    flat = np.concatenate(documents, axis=0).astype(np.float32, copy=False)
    return compress_tokens(
        flat, centroids, bucket_cutoffs, nbits, token_block, device=device
    )


def compress_tokens(
    flat: np.ndarray,
    centroids: np.ndarray,
    bucket_cutoffs: np.ndarray,
    nbits: int,
    token_block: int = 262_144,
    device: torch.device | str = "cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Compress a flat [T, D] token array in ``token_block`` windows."""
    device = torch.device(device)
    flat = np.asarray(flat, dtype=np.float32)
    t = flat.shape[0]
    cent = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    cuts = torch.from_numpy(np.asarray(bucket_cutoffs, np.float32)).to(device)
    codes_out = np.empty((t,), np.int32)
    packed_out = np.empty((t, codec.packed_dim(flat.shape[1], nbits)), np.uint8)
    for start in range(0, t, token_block):
        end = min(start + token_block, t)
        x = torch.from_numpy(flat[start:end]).to(device)
        c, p = codec.compress(x, cent, cuts, nbits)
        codes_out[start:end] = c.cpu().numpy()
        packed_out[start:end] = p.cpu().numpy()
    return codes_out, packed_out


def create_index(
    index_path: str,
    documents_embeddings,
    centroids: np.ndarray,
    nbits: int = 4,
    batch_size: int = 25_000,
    seed: int | None = 42,
    compress_only: bool = False,
    show_progress: bool = False,
    device: torch.device | str = "cpu",
) -> None:
    """Build and persist a complete index given precomputed centroids."""
    documents = _doc_list(documents_embeddings)
    n_docs = len(documents)
    dim = int(centroids.shape[1])
    os.makedirs(index_path, exist_ok=True)

    proc_chunk = max(1, min(int(batch_size), 1 + n_docs))
    n_chunks = max(1, math.ceil(n_docs / proc_chunk)) if n_docs else 0

    with open(os.path.join(index_path, "plan.json"), "w") as f:
        json.dump({"nbits": nbits, "num_chunks": n_chunks}, f, indent=4)

    with tracing.span("create.build"):
        params = train_codec_from_documents(
            documents, centroids, nbits, seed if seed is not None else 42, device
        )

    with tracing.span("create.write"):
        np.save(
            os.path.join(index_path, "centroids.npy"),
            centroids.astype(np.float32, copy=False),
        )
        np.save(os.path.join(index_path, "bucket_cutoffs.npy"), params.bucket_cutoffs)
        np.save(os.path.join(index_path, "bucket_weights.npy"), params.bucket_weights)
        np.save(os.path.join(index_path, "avg_residual.npy"), params.avg_residual)
        np.save(
            os.path.join(index_path, "cluster_threshold.npy"),
            np.float32(params.cluster_threshold),
        )

    all_codes: list[np.ndarray] = []
    all_doclens: list[int] = []
    total_embeddings = 0
    iterator = range(n_chunks)
    if show_progress:
        try:
            from tqdm import tqdm  # type: ignore[import-not-found]

            iterator = tqdm(iterator, desc="Creating index")
        except ImportError:
            pass
    for ci in iterator:
        chunk_docs = documents[ci * proc_chunk : (ci + 1) * proc_chunk]
        doclens = [int(d.shape[0]) for d in chunk_docs]
        with tracing.span("create.build"):
            codes_np, packed_np = compress_documents(
                chunk_docs, centroids, params.bucket_cutoffs, nbits, device=device
            )
        with tracing.span("create.write"):
            cpath, rpath, dpath, mpath = storage.chunk_paths(index_path, ci)
            np.save(cpath, codes_np)
            np.save(rpath, packed_np)
            with open(dpath, "w") as f:
                json.dump(doclens, f)
            with open(mpath, "w") as f:
                json.dump(
                    {
                        "num_documents": len(doclens),
                        "num_embeddings": int(codes_np.shape[0]),
                        "embedding_offset": total_embeddings,
                    },
                    f,
                    indent=4,
                )
        total_embeddings += int(codes_np.shape[0])
        all_codes.append(codes_np)
        all_doclens.extend(doclens)

    if not compress_only:
        with tracing.span("create.build"):
            codes_flat = (
                np.concatenate(all_codes) if all_codes else np.zeros((0,), np.int32)
            )
            ivf, ivf_lengths = ivf_mod.build_ivf(
                codes_flat, np.asarray(all_doclens, dtype=np.int64), centroids.shape[0]
            )
        with tracing.span("create.write"):
            np.save(os.path.join(index_path, "ivf.npy"), ivf)
            np.save(os.path.join(index_path, "ivf_lengths.npy"), ivf_lengths)

    avg_doclen = (sum(all_doclens) / n_docs) if n_docs else 0.0
    with tracing.span("create.write"):
        storage.save_metadata(
            index_path,
            {
                "num_chunks": n_chunks,
                "nbits": nbits,
                "num_partitions": int(centroids.shape[0]),
                "num_embeddings": total_embeddings,
                "avg_doclen": avg_doclen,
                "num_documents": n_docs,
                "compress_only": bool(compress_only),
                "dim": dim,
                "layout_version": storage.LAYOUT_VERSION,
            },
        )
