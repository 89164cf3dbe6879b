"""Plain reference of the benchmarked deployment: build and search, in torch.

Imports nothing of the program. Given the corpus tokens, it works out the
index that ``FastPlaid.create`` should build (k-means centroids, the residual
codec, codes, packed residuals, the IVF) and what ``FastPlaid.search`` should
return for a batch of queries, stage by stage:

  1. query-centroid scores (bf16 inputs, float32 sums, a bf16 table from
     32,768 cells on), 2. the IVF probe of each query token,
  3. the admitted cells' documents (the budgeted admission policy),
  4. each candidate's estimate (per query token, the best of its admitted
     cells' scores, summed), 5. the rerank pool,
  6. the stage-6 route of the configuration: ``q4`` (scores from a 4-bit
     copy of each document, the best ``rescue_pool`` reranked exactly) or
     ``bf16_cache`` (every pool document reranked exactly),
  7. the top-k.

The estimator policy (``resolve_approx_mode`` and the budget functions) is a
frozen copy of the program's numpy policy. The sampling draws are those that
``create`` makes from its ``seed``. Where a choice is a tie to rounding (a
token's two best centroids, the order of equal scores) the reference takes
the stated tie rule; ``judge.py`` says where it follows the program's side.

``rnd`` is the precision the configuration states for every rounded input
(``bfloat16``); the precision control passes ``float8_e4m3fn`` instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "Index",
    "ROUNDINGS",
    "kmeans",
    "train_codec",
    "assign",
    "pack",
    "build_ivf",
    "search",
    "exact_scores",
    "resolve_approx_mode",
]

NEG = float("-inf")
MAXSIM_NEG = -9999.0  # score of a query token that finds no valid doc token


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale a tensor (its largest magnitude at 448)."""
    peak = torch.amax(torch.abs(x)) if x.numel() else torch.ones((), device=x.device)
    s = 448.0 / torch.clamp(peak.float(), min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


ROUNDINGS = {"bfloat16": _bf16, "float8_e4m3fn": _fp8}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Index:
    """An index as the reference reads or builds it (torch tensors)."""

    centroids: torch.Tensor  # [K, D] float32
    cutoffs: torch.Tensor  # [2^nbits - 1] float32
    weights: torch.Tensor  # [2^nbits] float32
    codes: torch.Tensor  # [T] int64
    packed: torch.Tensor  # [T, D * nbits / 8] uint8, plane-major nibbles
    lengths: torch.Tensor  # [N] int64
    ivf: torch.Tensor  # [I] int64 pids grouped by cell, ascending in a cell
    ivf_lengths: torch.Tensor  # [K] int64

    @property
    def offsets(self) -> torch.Tensor:
        return torch.cumsum(self.lengths, 0) - self.lengths


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _doc_rows(offsets: np.ndarray, lengths: np.ndarray, pids: np.ndarray) -> np.ndarray:
    """Token rows of documents ``pids``, in that order."""
    lens = lengths[pids]
    starts = np.repeat(offsets[pids] - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return starts + np.arange(int(lens.sum()))


def kmeans(tokens, lengths: np.ndarray, *, seed: int, niters: int, rnd,
           max_points_per_centroid: int = 256) -> torch.Tensor:
    """Lloyd's k-means on the sample ``create`` draws: [K, D] unit centroids.

    min(1 + 16 sqrt(120 N), N) documents by ``default_rng(seed)``, K =
    2^floor(log2(16 sqrt(estimated tokens))), at most K * 256 points,
    initial centroids drawn from the points, distances ||x||^2 + ||c||^2 -
    2 x.c with ``rnd`` inputs, empty clusters re-seeded from random points
    of a CPU ``torch.Generator(seed)``.
    """
    n = len(lengths)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    n_samples = min(1 + int(16 * np.sqrt(120 * n)), n)
    sampled = np.random.default_rng(seed).permutation(n)[:n_samples]
    rows = _doc_rows(offsets, lengths, sampled)
    t = rows.size
    est_total = t / max(n_samples, 1) * n
    k = int(min(int(2 ** np.floor(np.log2(16 * np.sqrt(max(est_total, 1))))), t))
    rng = np.random.default_rng(seed)
    chunk = int(min(16384, max(1024, (1 << 30) // max(4 * k, 1))))
    if t > k * max_points_per_centroid:
        rows = rows[np.sort(rng.choice(t, size=k * max_points_per_centroid, replace=False))]
        t = rows.size
    if t > chunk and t % chunk:
        t = (t // chunk) * chunk
        rows = rows[:t]
    init_idx = np.sort(rng.permutation(t)[:k])
    data = tokens[torch.from_numpy(rows).to(tokens.device)]
    gen = torch.Generator().manual_seed(seed)
    chunk = int(min(chunk, max(256, t)))
    x2 = torch.sum(data * data, dim=-1)
    data_r = rnd(data)
    cent = data[torch.from_numpy(init_idx).to(data.device)]
    for _ in range(niters):
        c2 = torch.sum(cent * cent, dim=-1)
        sums = torch.zeros_like(cent)
        counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        cent_t = rnd(cent).t()
        for s in range(0, t, chunk):
            dist = x2[s : s + chunk, None] + c2[None, :] - 2.0 * (data_r[s : s + chunk] @ cent_t)
            code = torch.argmin(dist, dim=-1)
            sums.index_add_(0, code, data_r[s : s + chunk])
            counts.index_add_(0, code, torch.ones_like(code, dtype=torch.float32))
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        reseed = torch.randint(0, t, (k,), generator=gen).to(data.device)
        cent = torch.where((counts > 0)[:, None], new, data[reseed])
    return cent / torch.clamp(torch.linalg.vector_norm(cent, dim=-1, keepdim=True), min=1e-12)


def assign(x: torch.Tensor, centroids: torch.Tensor, rnd, block: int = 2048):
    """Nearest centroid by inner product with ``rnd`` inputs and float32
    sums, ties to the lowest id: codes [T]."""
    cent_t = rnd(centroids).t()
    codes = torch.empty((x.shape[0],), dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        codes[s : s + block] = torch.argmax(rnd(x[s : s + block]) @ cent_t, dim=-1)
    return codes


def code_margins(x, centroids, codes, other, rnd, block: int = 1 << 18) -> torch.Tensor:
    """score(codes) - score(other) per token, scored as ``assign`` scores."""
    cent_r = rnd(centroids)
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], block):
        xr = rnd(x[s : s + block])
        a = torch.sum(xr * cent_r[codes[s : s + block]], dim=-1)
        b = torch.sum(xr * cent_r[other[s : s + block]], dim=-1)
        out[s : s + block] = a - b
    return out


def train_codec(tokens, lengths: np.ndarray, centroids, *, seed: int, nbits: int, rnd):
    """Bucket cutoffs and weights from the held-out residuals ``create``
    takes: the tail tokens of its seeded document sample, at most 5% of the
    sample's tokens and 50,000; cutoffs at quantiles i / 2^nbits, weights at
    (i + 0.5) / 2^nbits of the residual values."""
    n = len(lengths)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    count = int(min(1.0 + 16.0 * math.sqrt(120.0 * n), float(n)))
    sample = np.random.default_rng(seed).permutation(n)[:count]
    total = int(lengths[sample].sum())
    need = max(int(round(min(0.05 * total, 50_000.0))), 1)
    parts, got = [], 0
    for p in sample[::-1]:
        if got >= need:
            break
        take = min(int(lengths[p]), need - got)
        parts.append(np.arange(offsets[p] + lengths[p] - take, offsets[p] + lengths[p]))
        got += take
    rows = np.concatenate(parts[::-1])
    held = tokens[torch.from_numpy(rows).to(tokens.device)]
    codes = assign(held, centroids, rnd)
    res = (held.cpu().numpy() - centroids.cpu().numpy()[codes.cpu().numpy()]).reshape(-1)
    opts = 1 << nbits
    cut = np.quantile(res, np.arange(1, opts) / opts).astype(np.float32)
    wts = np.quantile(res, (np.arange(opts) + 0.5) / opts).astype(np.float32)
    dev = tokens.device
    return torch.from_numpy(cut).to(dev), torch.from_numpy(wts).to(dev)


def pack(x, centroids, codes, cutoffs, nbits: int, block: int = 1 << 20) -> torch.Tensor:
    """Residual buckets (#cutoffs strictly below the value), packed
    plane-major: byte i of a token holds dims i, i + PD, ... from the low
    bits up."""
    vpb = 8 // nbits
    d = x.shape[1]
    pd = d // vpb
    out = torch.empty((x.shape[0], pd), dtype=torch.uint8, device=x.device)
    shifts = (torch.arange(vpb, device=x.device) * nbits)[None, :, None]
    for s in range(0, x.shape[0], block):
        res = x[s : s + block] - centroids[codes[s : s + block]]
        bucket = torch.bucketize(res, cutoffs, right=False).view(-1, vpb, pd)
        out[s : s + block] = torch.sum(bucket << shifts, dim=1).to(torch.uint8)
    return out


def build_ivf(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Each cell's distinct pids, ascending: (ivf [I], ivf_lengths [K])."""
    n = lengths.shape[0]
    pid = torch.repeat_interleave(torch.arange(n, device=codes.device), lengths)
    key = torch.unique(codes * n + pid)
    return key % n, torch.bincount(key // n, minlength=k)


def decompress(index: Index, pids: torch.Tensor, cap: int, nbits: int):
    """Rows of documents ``pids`` [P] at ``cap`` tokens: ([P, cap, D] unit
    float32, valid [P, cap]). Tokens past a document's length decode from
    code 0 and zero bytes, as the program's zero-padded rows do."""
    lens = index.lengths[pids]
    tok = torch.arange(cap, device=pids.device)
    valid = tok[None, :] < lens[:, None]
    rows = torch.clamp(index.offsets[pids][:, None] + tok[None, :], max=index.codes.shape[0] - 1)
    codes = torch.where(valid, index.codes[rows], 0)
    packed = torch.where(valid[..., None], index.packed[rows], 0)
    mask = (1 << nbits) - 1
    bucket = torch.cat([(packed >> (j * nbits)) & mask for j in range(8 // nbits)], dim=-1)
    emb = index.centroids[codes] + index.weights[bucket.long()]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
    return emb, valid


def _maxsim(emb, valid, q):
    ts = torch.einsum("ptd,qd->ptq", emb, q)
    ts = torch.where(valid[..., None], ts, MAXSIM_NEG)
    return torch.sum(torch.amax(ts, dim=1), dim=-1)


def exact_scores(index: Index, pids, q, *, cap: int, nbits: int, rnd, block: int = 512):
    """Exact MaxSim [P] of query ``q`` [Q, D] against documents ``pids``
    decompressed: ``rnd`` document tokens and query, float32 sums."""
    out = []
    qr = rnd(q)
    for s in range(0, pids.shape[0], block):
        emb, valid = decompress(index, pids[s : s + block], cap, nbits)
        out.append(_maxsim(rnd(emb), valid, qr))
    return torch.cat(out) if out else torch.zeros((0,), device=q.device)


def q4_scores(index: Index, pids, q, *, cap: int, nbits: int, rnd, block: int = 512):
    """Scores [P] from each document's 4-bit copy: its decompressed rows at
    ``cap`` tokens in levels round(v / s) in [-7, 7], s = its largest |v| / 7,
    a MaxSim of the levels against the ``rnd`` query, times s."""
    out = []
    qr = rnd(q)
    for s in range(0, pids.shape[0], block):
        emb, valid = decompress(index, pids[s : s + block], cap, nbits)
        scale = torch.amax(torch.abs(emb), dim=(1, 2)) / 7.0
        lev = torch.clamp(torch.round(emb / torch.clamp(scale, min=1e-12)[:, None, None]), -7, 7)
        sc = _maxsim(lev, valid, qr) * scale
        out.append(torch.where(index.lengths[pids[s : s + block]] > 0, sc, NEG))
    return torch.cat(out) if out else torch.zeros((0,), device=q.device)


# ---------------------------------------------------------------------------
# the estimator policy (frozen copy of the program's numpy policy functions)
# ---------------------------------------------------------------------------


def candidate_capacity(ivf_lengths, n_cells: int, n_full_scores: int) -> int:
    lens = np.sort(np.asarray(ivf_lengths, np.int64))[::-1]
    if lens.size == 0:
        return 128
    worst = int(lens[: min(n_cells, lens.size)].sum())
    typical = int(2.0 * n_cells * float(lens.mean()))
    cap = min(worst, max(typical, 4 * n_full_scores, 1024))
    return max(128, ((cap + 127) // 128) * 128)


def suggest_slot_budget(ivf_lengths, n_full_scores: int, n_hubs: int = 16) -> int:
    lens = np.sort(np.asarray(ivf_lengths, np.int64))[::-1]
    k2 = ((n_full_scores + 127) // 128) * 128
    if lens.size == 0:
        return k2
    h = min(n_hubs, lens.size)
    excess = int(lens[:h].sum()) - h * int(np.median(lens))
    return k2 + int(min(max(excess, 0), 4 * k2))


def suggest_safe_budget(ivf_lengths, n_full_scores: int, q_cap: int, rank_admit: int = 1) -> int:
    base = suggest_slot_budget(ivf_lengths, n_full_scores)
    lens = np.asarray(ivf_lengths, np.int64)
    if lens.size == 0:
        return base
    p90 = float(np.quantile(lens, 0.90))
    need = int(q_cap * max(rank_admit, 0) * max(p90, 1.0))
    return base + ((need + 127) // 128) * 128


def resolve_approx_mode(ivf_lengths, *, q_cap, n_ivf_probe, n_full_scores, n_partitions,
                        cand_cap, n_docs):
    """``approx_mode="auto"`` -> (mode, rank_admit, slot_budget)."""
    slot_budget = suggest_slot_budget(ivf_lengths, n_full_scores)
    mode, rank_admit = "cells", None
    lens_h = np.asarray(ivf_lengths, np.float64)
    n_cells = min(q_cap * n_ivf_probe, max(n_partitions, 1))
    expected = float(lens_h.mean()) * n_cells
    p90_len = float(np.quantile(lens_h, 0.9))
    if max(n_partitions, 1) <= 4 * n_ivf_probe and p90_len >= max(n_full_scores // 2, 1):
        if n_full_scores // 4 >= max(n_docs // 4, 1):
            return "tokens", 0, slot_budget
        return "cells_full", 0, slot_budget
    if expected > 6.0 * n_full_scores:
        r_adm = 1
        if expected > 32.0 * n_full_scores:
            affordable = max(32768, 8 * n_full_scores)
            if suggest_safe_budget(ivf_lengths, n_full_scores, q_cap, 2) <= affordable:
                r_adm = 2
        safe = suggest_safe_budget(ivf_lengths, n_full_scores, q_cap, r_adm)
        if safe >= cand_cap:
            mode = "cells_full"
        else:
            rank_admit = r_adm
    rank_admit = 0 if rank_admit is None else rank_admit
    if rank_admit > 0:
        slot_budget = max(slot_budget, suggest_safe_budget(ivf_lengths, n_full_scores, q_cap, rank_admit))
    return mode, rank_admit, slot_budget


def rescue_pool(top_k: int) -> int:
    return round_up(max(4 * top_k, 32), 8)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _argsort_desc(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(-x, dim=-1, stable=True)


def _admitted(index: Index, q: torch.Tensor, p: dict, rnd):
    """Stages 1-3 for a batch [B, Q, D]: per query, the admitted cells (ids)
    and their [A, Q] score rows as the estimate reads them."""
    b, nq, d = q.shape
    k = index.centroids.shape[0]
    kp = round_up(k, 128)
    cent = torch.zeros((kp, d), dtype=torch.float32, device=q.device)
    cent[:k] = index.centroids
    flat = q.reshape(b * nq, d)
    if kp >= 32768:  # from 32k cells on: rounded inputs, a rounded table
        scores = rnd(rnd(flat) @ rnd(cent).t()).to(torch.bfloat16)
    else:
        scores = flat @ cent.t()
    tok_ok = torch.sum(torch.abs(q), dim=-1) > 0
    cell_ok = torch.arange(kp, device=q.device) < k
    probe_scores = torch.where(cell_ok[None, None, :] & tok_ok[..., None], scores.reshape(b, nq, kp), NEG)
    probe = min(p["n_ivf_probe"], kp)
    top, cells = torch.topk(probe_scores.reshape(b * nq, kp), probe)
    cells = torch.where(top > NEG, cells, kp).reshape(b, nq * probe)
    pp = 1 << max((probe - 1).bit_length(), 1)
    rank = torch.arange(probe, device=q.device).repeat(nq)[None, :]
    packed = torch.sort(torch.where(cells == kp, kp * pp, cells * pp + rank), dim=-1).values
    best_rank = packed % pp
    cells = packed // pp
    dup = torch.cat([torch.zeros_like(cells[:, :1], dtype=torch.bool), cells[:, 1:] == cells[:, :-1]], 1)
    cells = torch.where(dup, kp, cells)
    tbl = torch.bmm(cent[torch.clamp(cells, 0, kp - 1)], q.transpose(1, 2))  # [B, C, Q]
    order = _argsort_desc(torch.where(cells == kp, NEG, torch.amax(tbl, dim=-1)))
    cells = torch.gather(cells, 1, order)
    best_rank = torch.gather(best_rank, 1, order)
    tbl = torch.gather(tbl, 1, order[..., None].expand(-1, -1, nq))
    lens_k = torch.cat([index.ivf_lengths, torch.zeros((kp + 1 - k,), dtype=torch.int64, device=q.device)])
    lens = lens_k[cells]
    cell_tot = torch.where(cells == kp, NEG, torch.sum(tbl, dim=-1))
    c_cells = cells.shape[1]
    cand_cap, mode, rank_admit, slot_budget = p["cand_cap"], p["mode"], p["rank_admit"], p["slot_budget"]
    if mode == "cells_full":
        budget, c_sel = cand_cap, c_cells
        order_b = _argsort_desc(cell_tot)
    else:
        k2 = min(cand_cap, round_up(p["n_full_scores"], 128))
        budget = min(cand_cap, max(k2, slot_budget or 0))
        typical = max(1, cand_cap // max(c_cells, 1))
        c_sel = min(c_cells, max(8, -(-2 * budget // typical)))
        mean_len = int(index.ivf_lengths.sum()) // max(k, 1)
        giant = (lens > max(8 * mean_len, budget // 4)) & torch.isfinite(cell_tot)
        demoted = torch.where(giant, cell_tot - 1e10, cell_tot)
        if rank_admit > 0:
            tier0 = (best_rank < rank_admit) & (cells != kp) & ~giant
            demoted = torch.where(tier0, 1e10 * (rank_admit - best_rank).to(torch.float32), demoted)
            c_sel = min(c_cells, max(c_sel, nq * rank_admit + 8))
        order_b = _argsort_desc(demoted)
    lens_o = torch.gather(lens, 1, order_b)
    ok = ((torch.cumsum(lens_o, dim=-1) - lens_o) < budget)[:, :c_sel] & (lens_o[:, :c_sel] > 0)
    cells_o = torch.gather(cells, 1, order_b)[:, :c_sel]
    tbl_o = rnd(torch.gather(tbl, 1, order_b[..., None].expand(-1, -1, nq))[:, :c_sel])
    return [(cells_o[i][ok[i]], tbl_o[i][ok[i]]) for i in range(b)]


def _pool(index: Index, cells, rows, r: int, sentinel: int):
    """Stages 3-5 for one query: the admitted cells' documents, each
    estimated as sum_q max over its admitted cells of the cell's score, the
    ``r`` best (equal estimates: lower pid first)."""
    ivf_off = torch.cumsum(index.ivf_lengths, 0) - index.ivf_lengths
    lens = index.ivf_lengths[cells]
    owner = torch.repeat_interleave(torch.arange(cells.shape[0], device=cells.device), lens)
    within = torch.arange(int(lens.sum()), device=cells.device) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens
    )
    pids = index.ivf[ivf_off[cells][owner] + within]
    uniq, inv = torch.unique(pids, return_inverse=True)
    best = torch.full((uniq.shape[0], rows.shape[1]), NEG, device=cells.device)
    best.scatter_reduce_(0, inv[:, None].expand(-1, rows.shape[1]), rows[owner], "amax")
    est = torch.sum(best, dim=-1)
    top = _argsort_desc(est)[:r]
    return uniq[top], est[top]


def search(index: Index, queries: torch.Tensor, p: dict, *, route: str, cap: int,
           nbits: int, rnd) -> tuple[torch.Tensor, torch.Tensor]:
    """The top ``p["top_k"]`` (pids [B, k] with -1 padding, scores [B, k])
    of a batch of queries [B, Q, D], as they arrive on the device."""
    if p["mode"] == "tokens" or p["exhaustive"]:
        msg = "the reference covers the budgeted cells estimators only"
        raise NotImplementedError(msg)
    b = queries.shape[0]
    top_k = p["top_k"]
    r = max(p["n_full_scores"] // p["pool_divisor"], 1)
    sentinel = index.lengths.shape[0]
    out_p = torch.full((b, top_k), -1, dtype=torch.int64, device=queries.device)
    out_s = torch.full((b, top_k), NEG, dtype=torch.float32, device=queries.device)
    for i, (cells, rows) in enumerate(_admitted(index, queries, p, rnd)):
        pool, _ = _pool(index, cells, rows, r, sentinel)
        q = queries[i]
        if route == "q4" and rescue_pool(top_k) < r:
            pre = q4_scores(index, pool, q, cap=cap, nbits=nbits, rnd=rnd)
            pool = pool[_argsort_desc(pre)[: rescue_pool(top_k)]]
        elif route not in ("q4", "bf16_cache"):
            msg = f"unknown stage-6 route {route!r}"
            raise ValueError(msg)
        ex = exact_scores(index, pool, q, cap=cap, nbits=nbits, rnd=rnd)
        top = _argsort_desc(ex)[:top_k]
        out_p[i, : top.shape[0]] = pool[top]
        out_s[i, : top.shape[0]] = ex[top]
    return out_p, out_s
