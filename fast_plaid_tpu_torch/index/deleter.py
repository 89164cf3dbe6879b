"""Index deletion (port of ``fast_plaid_tpu/index/deleter.py``, numpy only).

Every chunk holding a deleted document is rewritten without that document's
rows of codes, residuals and doclens; the remaining documents are
re-numbered in order (ids shift down), the IVF is rebuilt and metadata.json
is refreshed. Chunks that lose nothing keep their data files.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index import storage

__all__ = ["delete_from_index"]


def delete_from_index(index_path: str, subset: list[int]) -> None:
    """Remove documents by global 0-based id; remaining ids shift down."""
    meta = storage.load_metadata(index_path)
    num_chunks = int(meta["num_chunks"])
    to_delete = {int(i) for i in subset}
    if not to_delete:
        return

    # Pre-pass: original global document offset of each chunk.
    chunk_doclens: list[list[int]] = []
    for ci in range(num_chunks):
        with open(storage.chunk_paths(index_path, ci)[2]) as f:
            chunk_doclens.append(json.load(f))
    chunk_doc_offsets = np.concatenate(
        [[0], np.cumsum([len(d) for d in chunk_doclens])]
    ).astype(int)

    emb_offset = 0
    all_codes: list[np.ndarray] = []
    all_doclens: list[int] = []
    for ci in range(num_chunks):
        cpath, rpath, dpath, mpath = storage.chunk_paths(index_path, ci)
        codes = np.load(cpath)
        doclens = chunk_doclens[ci]
        base = int(chunk_doc_offsets[ci])

        keep = [i for i in range(len(doclens)) if (base + i) not in to_delete]
        touched = len(keep) != len(doclens)
        if touched:
            residuals = np.load(rpath)
            token_starts = np.concatenate(
                [[0], np.cumsum(np.asarray(doclens, np.int64))]
            )
            token_mask = np.zeros(codes.shape[0], dtype=bool)
            for i in keep:
                token_mask[token_starts[i] : token_starts[i + 1]] = True
            codes = codes[token_mask]
            residuals = residuals[token_mask]
            doclens = [doclens[i] for i in keep]
            np.save(cpath, np.asarray(codes, np.int32))
            np.save(rpath, np.asarray(residuals, np.uint8))
            with open(dpath, "w") as f:
                json.dump(doclens, f)
        # Untouched chunks keep their data files (and mtimes, so the merged
        # mmap manifest stays valid for them); the chunk metadata is
        # rewritten only when it changed.
        with open(mpath) as f:
            old_meta = json.load(f)
        new_meta = {
            "num_documents": len(doclens),
            "num_embeddings": int(codes.shape[0]),
            "embedding_offset": emb_offset,
        }
        if touched or old_meta != new_meta:
            with open(mpath, "w") as f:
                json.dump(new_meta, f, indent=4)
        emb_offset += int(codes.shape[0])
        all_codes.append(np.asarray(codes, np.int32))
        all_doclens.extend(doclens)

    codes_flat = (
        np.concatenate(all_codes) if all_codes else np.zeros((0,), np.int32)
    )
    if not meta.get("compress_only", False):
        centroids = np.load(os.path.join(index_path, "centroids.npy"))
        ivf, ivf_lengths = ivf_mod.build_ivf(
            codes_flat, np.asarray(all_doclens, np.int64), centroids.shape[0]
        )
        np.save(os.path.join(index_path, "ivf.npy"), ivf)
        np.save(os.path.join(index_path, "ivf_lengths.npy"), ivf_lengths)

    total_docs = len(all_doclens)
    total_tokens = int(codes_flat.shape[0])
    meta.update(
        {
            "num_documents": total_docs,
            "num_embeddings": total_tokens,
            "avg_doclen": total_tokens / max(total_docs, 1),
        }
    )
    storage.save_metadata(index_path, meta)
