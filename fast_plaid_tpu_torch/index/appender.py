"""Incremental index append (port of ``fast_plaid_tpu/index/appender.py``).

New documents are compressed with the existing codec (on ``device``),
merged into the last chunk when it is small (fewer than 2000 documents) or
appended as fresh chunks; the cluster threshold is optionally refreshed as a
count-weighted average of the old and new 0.75-quantile residual norms; the
new pids are spliced into the IVF without reloading any old chunk, and
metadata.json is rewritten. The files are the ones the JAX package writes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index import storage
from fast_plaid_tpu_torch.index.builder import compress_documents

__all__ = ["update_index"]

MAX_DOCS_REOPEN_CHUNK = 2000


def _load_chunk(index_path: str, i: int):
    cpath, rpath, dpath, _ = storage.chunk_paths(index_path, i)
    codes = np.load(cpath)
    residuals = np.load(rpath)
    with open(dpath) as f:
        doclens = json.load(f)
    return codes, residuals, doclens


def _write_chunk(
    index_path: str,
    i: int,
    codes: np.ndarray,
    residuals: np.ndarray,
    doclens: list[int],
    embedding_offset: int,
) -> None:
    cpath, rpath, dpath, mpath = storage.chunk_paths(index_path, i)
    np.save(cpath, codes.astype(np.int32, copy=False))
    np.save(rpath, residuals.astype(np.uint8, copy=False))
    with open(dpath, "w") as f:
        json.dump(doclens, f)
    with open(mpath, "w") as f:
        json.dump(
            {
                "num_documents": len(doclens),
                "num_embeddings": int(codes.shape[0]),
                "embedding_offset": embedding_offset,
            },
            f,
            indent=4,
        )


def _iter_doc_blocks(documents_embeddings, block_docs: int):
    """Yield lists of <= block_docs float32 arrays from any iterable.

    Accepts a list or a lazy iterator/generator: with a generator no more
    than one block of raw embeddings is resident at a time.
    """
    block: list[np.ndarray] = []
    for doc in documents_embeddings:
        block.append(np.asarray(doc, dtype=np.float32))
        if len(block) >= block_docs:
            yield block
            block = []
    if block:
        yield block


def update_index(
    index_path: str,
    documents_embeddings,
    batch_size: int = 25_000,
    update_threshold_centroids: bool = False,
    device: torch.device | str = "cpu",
) -> None:
    """Append documents to an existing on-disk index.

    ``documents_embeddings`` may be a list or any iterable/generator of
    [tokens, dim] arrays. Documents are consumed in ``batch_size`` blocks:
    each block is compressed on ``device`` and written through before the
    next is pulled, so host memory holds one block's raw embeddings and
    packed residuals (plus the running int32 codes for the IVF splice).
    """
    meta = storage.load_metadata(index_path)
    nbits = int(meta["nbits"])
    centroids = np.load(os.path.join(index_path, "centroids.npy")).astype(np.float32)
    bucket_cutoffs = np.load(os.path.join(index_path, "bucket_cutoffs.npy"))

    num_chunks = int(meta["num_chunks"])
    all_codes: list[np.ndarray] = []  # int32, kept for the IVF splice
    new_doclens: list[int] = []
    norms: list[np.ndarray] = []  # [T_block] f32 per block (threshold refresh)
    first = True

    for block in _iter_doc_blocks(documents_embeddings, batch_size):
        blk_codes, blk_packed = compress_documents(
            block, centroids, bucket_cutoffs, nbits, device=device
        )
        blk_doclens = [int(d.shape[0]) for d in block]
        if update_threshold_centroids:
            flat = np.concatenate(block, axis=0)
            res = flat - centroids[blk_codes]
            norms.append(np.linalg.norm(res, axis=-1).astype(np.float32))
            del flat, res
        del block  # raw embeddings of this block are done

        docs_cursor = 0
        tokens_cursor = 0
        if first and num_chunks > 0:
            # Re-open the last chunk when it is small.
            last_codes, last_res, last_doclens = _load_chunk(
                index_path, num_chunks - 1
            )
            with open(storage.chunk_paths(index_path, num_chunks - 1)[3]) as f:
                last_meta = json.load(f)
            if len(last_doclens) < MAX_DOCS_REOPEN_CHUNK:
                room = max(0, MAX_DOCS_REOPEN_CHUNK - len(last_doclens))
                take = min(room, len(blk_doclens))
                take_tokens = int(sum(blk_doclens[:take]))
                _write_chunk(
                    index_path,
                    num_chunks - 1,
                    np.concatenate([last_codes, blk_codes[:take_tokens]]),
                    np.concatenate(
                        [last_res, blk_packed[:take_tokens]], axis=0
                    ),
                    list(last_doclens) + blk_doclens[:take],
                    int(last_meta.get("embedding_offset", 0)),
                )
                docs_cursor = take
                tokens_cursor = take_tokens
            del last_codes, last_res
        first = False

        # Remaining docs of this block -> new chunks (block size ==
        # batch_size, so each block adds at most one fresh chunk plus the
        # reopened tail).
        while docs_cursor < len(blk_doclens):
            chunk_docs = blk_doclens[docs_cursor : docs_cursor + batch_size]
            chunk_tokens = int(sum(chunk_docs))
            offset_meta = (
                int(meta.get("num_embeddings", 0))
                + int(sum(int(c.shape[0]) for c in all_codes))
                + tokens_cursor
            )
            _write_chunk(
                index_path,
                num_chunks,
                blk_codes[tokens_cursor : tokens_cursor + chunk_tokens],
                blk_packed[tokens_cursor : tokens_cursor + chunk_tokens],
                list(chunk_docs),
                offset_meta,
            )
            num_chunks += 1
            docs_cursor += len(chunk_docs)
            tokens_cursor += chunk_tokens

        all_codes.append(blk_codes)
        new_doclens.extend(blk_doclens)
        del blk_packed  # only the 4-byte/token codes persist per block

    if not new_doclens:
        return
    new_codes = np.concatenate(all_codes) if all_codes else np.zeros((0,), np.int32)
    del all_codes

    if update_threshold_centroids:
        # Count-weighted average of the old and new residual-norm quantiles.
        new_q = float(np.quantile(np.concatenate(norms), 0.75))
        old_q = float(
            np.load(os.path.join(index_path, "cluster_threshold.npy")).item()
        )
        old_n = int(meta.get("num_embeddings", 0))
        new_n = int(new_codes.shape[0])
        merged = (old_q * old_n + new_q * new_n) / max(old_n + new_n, 1)
        np.save(
            os.path.join(index_path, "cluster_threshold.npy"), np.float32(merged)
        )

    # Splice the new pids into the existing IVF; rebuild only when the IVF
    # files are missing or stale in partition count.
    if not meta.get("compress_only", False):
        ivf_path = os.path.join(index_path, "ivf.npy")
        len_path = os.path.join(index_path, "ivf_lengths.npy")
        old_ivf = old_lengths = None
        if os.path.exists(ivf_path) and os.path.exists(len_path):
            old_ivf = np.load(ivf_path).astype(np.int32, copy=False)
            old_lengths = np.load(len_path).astype(np.int64, copy=False)
            if old_lengths.shape[0] != centroids.shape[0]:
                old_ivf = old_lengths = None
        if old_ivf is not None:
            ivf, ivf_lengths = ivf_mod.splice_ivf(
                old_ivf,
                old_lengths,
                new_codes,
                np.asarray(new_doclens, np.int64),
                pid_base=int(meta["num_documents"]),
            )
        else:
            codes_parts, all_doclens = [], []
            for i in range(num_chunks):
                c, _, d = _load_chunk(index_path, i)
                codes_parts.append(np.asarray(c, dtype=np.int32))
                all_doclens.extend(d)
            ivf, ivf_lengths = ivf_mod.build_ivf(
                np.concatenate(codes_parts),
                np.asarray(all_doclens, np.int64),
                centroids.shape[0],
            )
        np.save(ivf_path, ivf)
        np.save(len_path, ivf_lengths)

    n_new_docs = len(new_doclens)
    n_new_tokens = int(new_codes.shape[0])
    total_docs = int(meta["num_documents"]) + n_new_docs
    total_tokens = int(meta["num_embeddings"]) + n_new_tokens
    meta.update(
        {
            "num_chunks": num_chunks,
            "num_documents": total_docs,
            "num_embeddings": total_tokens,
            "avg_doclen": total_tokens / max(total_docs, 1),
            "num_partitions": int(centroids.shape[0]),
        }
    )
    storage.save_metadata(index_path, meta)
