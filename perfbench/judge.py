"""What decides ``correct``: a side's index and answers against the reference.

A side is the program (its index files and the answers its timed calls gave)
or the precision control (the reference run at a lower precision in the
program's place). Every number is computed the same way for both:

* ``kmeans_gap``: the largest distance, over centroids, between the side's
  centroid and the reference k-means's, from the same seeded sample.
* From here on the reference follows a side's centroid where it lies within
  the ``kmeans_gap`` limit of its own, and keeps its own elsewhere (k-means
  is the one stage it cannot redo bit for bit: its float sums are
  unordered, so a point at a tie can change sides). A centroid beyond the
  limit then also shows in the codes and residuals.
  ``codec_gap``: the largest gap of a bucket cutoff or weight.
* ``index_mismatch``: tokens whose code is not the best centroid (beyond a
  tie of ``CODE_TIE``), tokens whose packed residual bytes differ, documents
  whose length differs, and (cell, pid) pairs in one IVF and not the other.
  At a code tie the reference takes the side's code: both are right.
* ``score_err``: the largest gap between a score the side returned and the
  reference's exact MaxSim of that document.
* ``miss_share``: % of judged queries from whose answer a document of the
  reference's top-k is missing that scores above the answer's worst by more
  than ``MISS_TIE``.
* ``bad_lists``: judged answers that are not ``top_k`` distinct documents
  in descending order of score.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from perfbench import reference as ref

__all__ = ["read_index", "judge", "search_params", "CODE_TIE", "MISS_TIE"]

CODE_TIE = 1e-5  # float32 sums of 128 bf16 products differ by ~1e-7 with their order
MISS_TIE = 1e-3  # scores of ~10-30 agree to ~1e-5 across summation orders


def read_index(path: str, device) -> ref.Index:
    """The index ``create`` wrote under ``path``, as plain tensors."""
    def load(name):
        return torch.from_numpy(np.load(os.path.join(path, name))).to(device)

    with open(os.path.join(path, "metadata.json")) as f:
        n_chunks = int(json.load(f)["num_chunks"])
    codes, packed, lens = [], [], []
    for i in range(n_chunks):
        codes.append(np.load(os.path.join(path, f"{i}.codes.npy")))
        packed.append(np.load(os.path.join(path, f"{i}.residuals.npy")))
        with open(os.path.join(path, f"doclens.{i}.json")) as f:
            lens.extend(json.load(f))
    return ref.Index(
        centroids=load("centroids.npy").float(),
        cutoffs=load("bucket_cutoffs.npy").float(),
        weights=load("bucket_weights.npy").float(),
        codes=torch.from_numpy(np.concatenate(codes)).to(device).long(),
        packed=torch.from_numpy(np.concatenate(packed)).to(device),
        lengths=torch.tensor(lens, dtype=torch.int64, device=device),
        ivf=load("ivf.npy").long(),
        ivf_lengths=load("ivf_lengths.npy").long(),
    )


def search_params(ivf_lengths: np.ndarray, n_docs: int, mix: dict, q_cap: int, *,
                  doc_cap: int, pd: int, mem_budget: int, route: str) -> dict:
    """The search's resolved parameters, as the program resolves them from
    the index (the frozen policy in ``reference``), with its query tile."""
    s = mix["search"]
    k = len(ivf_lengths)
    n_cells = min(q_cap * s["n_ivf_probe"], k)
    cand_cap = ref.candidate_capacity(ivf_lengths, n_cells, s["n_full_scores"])
    mode, rank_admit, slot_budget = ref.resolve_approx_mode(
        ivf_lengths, q_cap=q_cap, n_ivf_probe=s["n_ivf_probe"],
        n_full_scores=s["n_full_scores"], n_partitions=k, cand_cap=cand_cap, n_docs=n_docs,
    )
    pool_divisor = 2
    exhaustive = s["n_ivf_probe"] >= k or s["n_full_scores"] >= 2 * n_docs
    kp = ref.round_up(max(k, 1), 128)
    tile = max(1, min(256, mem_budget // max(1, q_cap * kp * 8)))
    cell_cap = ref.round_up(max(int(np.max(ivf_lengths)), 1), 8)
    per_query = q_cap * kp * 8 + cand_cap * 32
    width = 2 * min(cand_cap, slot_budget) + cell_cap + 256
    per_query += width * (q_cap * 6 + 12)
    tile = min(tile, max(1, min(256, (8 << 30) // per_query)))
    if route == "q4":  # low_memory: the streamed rows of two tiles in flight
        per_q = ref.rescue_pool(s["top_k"]) * doc_cap * (pd + 5)
        tile = min(tile, max(1, (mem_budget // 2) // per_q))
    return {
        "top_k": s["top_k"], "n_ivf_probe": s["n_ivf_probe"], "n_full_scores": s["n_full_scores"],
        "cand_cap": cand_cap, "mode": mode, "rank_admit": rank_admit, "slot_budget": slot_budget,
        "pool_divisor": pool_divisor, "exhaustive": exhaustive, "tile": tile,
    }


def reference_answers(index: ref.Index, batch: np.ndarray, p: dict, *, wire, route, cap,
                      nbits, rnd, device):
    """Reference top-k of one call's queries [B, Q, D], tile by tile as the
    program runs them (the last tile zero-padded), at the wire precision."""
    pids, scores = [], []
    tile = p["tile"]
    for s in range(0, batch.shape[0], tile):
        part = batch[s : s + tile]
        pad = np.zeros((tile, *batch.shape[1:]), np.float32)
        pad[: part.shape[0]] = part
        q = torch.from_numpy(pad.astype(wire)).to(device).float()
        pp, ss = ref.search(index, q, p, route=route, cap=cap, nbits=nbits, rnd=rnd)
        pids.append(pp[: part.shape[0]])
        scores.append(ss[: part.shape[0]])
    return torch.cat(pids), torch.cat(scores)


def judge(tokens: torch.Tensor, lengths: np.ndarray, side: ref.Index, calls: list, *,
          cfg: dict, mix: dict, mem_budget: int, wire) -> dict:
    """The numbers for one side. ``calls``: (queries [B, Q, D] float32 numpy,
    the side's answers: one list of (pid, score) a query) of the judged
    calls."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    device = tokens.device
    rnd = ref.ROUNDINGS[cfg["precision"]["rounded_inputs"]]
    nbits = int(cfg["create"]["nbits"])
    route = cfg["stage6_route"]
    top_k = mix["search"]["top_k"]
    seed = int(cfg["create"]["seed"])
    out: dict = {}

    c_ref = ref.kmeans(tokens, lengths, seed=seed, niters=int(cfg["create"]["kmeans_niters"]), rnd=rnd)
    if c_ref.shape != side.centroids.shape:
        out["kmeans_gap"] = float("inf")
        cent = c_ref
    else:
        gap = torch.linalg.vector_norm(side.centroids - c_ref, dim=-1)
        out["kmeans_gap"] = float(torch.max(gap))
        out["_kmeans_moved"] = {f">{t:g}": int((gap > t).sum()) for t in (0.0, 1e-4, 1e-3, 1e-2, 1e-1)}
        cent = torch.where((gap <= cfg["limits"]["kmeans_gap"])[:, None], side.centroids, c_ref)
        del gap
    del c_ref

    cut, wts = ref.train_codec(tokens, lengths, cent, seed=seed, nbits=nbits, rnd=rnd)
    out["codec_gap"] = float(max(torch.max(torch.abs(side.cutoffs - cut)), torch.max(torch.abs(side.weights - wts))))

    lens_t = torch.from_numpy(lengths).to(device)
    mismatch = int((side.lengths != lens_t).sum()) if side.lengths.shape == lens_t.shape else len(lengths)
    k = cent.shape[0]
    n = len(lengths)
    codes = ref.assign(tokens, cent, rnd)
    if side.codes.shape != codes.shape or side.packed.shape[0] != codes.shape[0]:
        mismatch += int(tokens.shape[0])
    else:
        ok = (side.codes >= 0) & (side.codes < k)
        theirs = torch.where(ok, side.codes, 0)
        tie = (ref.code_margins(tokens, cent, codes, theirs, rnd) <= CODE_TIE) & ok
        mismatch += int(((codes != side.codes) & ~tie).sum())
        codes = torch.where(tie, side.codes, codes)
    packed = ref.pack(tokens, cent, codes, cut, nbits)
    if side.codes.shape == codes.shape and side.packed.shape == packed.shape:
        mismatch += int(((side.packed != packed).any(dim=-1) & (codes == side.codes)).sum())
        ivf, ivf_len = ref.build_ivf(torch.clamp(side.codes, 0, k - 1), lens_t, k)
        if side.ivf_lengths.shape[0] != k or int(side.ivf_lengths.sum()) != side.ivf.shape[0]:
            mismatch += int(ivf.shape[0])
        else:
            cell = torch.arange(k, device=device)
            mine = torch.repeat_interleave(cell, ivf_len) * n + ivf
            theirs = torch.repeat_interleave(cell, side.ivf_lengths) * n + side.ivf
            both = torch.cat([torch.unique(mine), torch.unique(theirs)])
            mismatch += int((torch.unique(both, return_counts=True)[1] == 1).sum())
    elif side.codes.shape == codes.shape:
        mismatch += int(tokens.shape[0])
    out["index_mismatch"] = mismatch

    index = ref.Index(cent, cut, wts, codes, packed, lens_t, *ref.build_ivf(codes, lens_t, k))
    cap = ref.round_up(int(lengths.max()), 16)
    p = search_params(index.ivf_lengths.cpu().numpy(), len(lengths), mix, ref.round_up(cfg["query_maxlen"], 8),
                      doc_cap=cap, pd=int(packed.shape[1]), mem_budget=mem_budget, route=route)
    out["_params"] = {k_: p[k_] for k_ in ("mode", "rank_admit", "slot_budget", "cand_cap", "tile")}
    score_err, misses, bad, judged = 0.0, 0, 0, 0
    for batch, answers in calls:
        r_pids, r_scores = reference_answers(index, batch, p, wire=wire, route=route, cap=cap,
                                             nbits=nbits, rnd=rnd, device=device)
        for qi, ans in enumerate(answers):
            judged += 1
            ids = [int(a[0]) for a in ans]
            scs = [float(a[1]) for a in ans]
            if (len(ids) != top_k or len(set(ids)) != len(ids)
                    or any(i < 0 or i >= len(lengths) for i in ids)
                    or any(a < b for a, b in zip(scs, scs[1:]))):
                bad += 1
                continue
            q = torch.from_numpy(batch[qi].astype(wire)).to(device).float()
            ex = ref.exact_scores(index, torch.tensor(ids, device=device), q, cap=cap, nbits=nbits, rnd=rnd)
            score_err = max(score_err, float(torch.max(torch.abs(ex - torch.tensor(scs, device=device)))))
            worst = float(torch.min(ex))
            ref_ids = r_pids[qi].tolist()
            ref_sc = r_scores[qi].tolist()
            if any(rid not in ids and rs > worst + MISS_TIE for rid, rs in zip(ref_ids, ref_sc) if rid >= 0):
                misses += 1
    out["score_err"] = score_err
    out["miss_share"] = 100.0 * misses / max(judged, 1)
    out["bad_lists"] = bad
    out["_judged"] = judged
    return out
