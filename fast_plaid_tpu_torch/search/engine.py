"""The PLAID search cascade over a query tile, in eager PyTorch.

Port of ``fast_plaid_tpu/search/engine.py``: the same static-shape cascade
(fixed-capacity buffers, sentinel ids, sort-based dedup), run eagerly on one
``torch.device``. Stages:

  1. query-centroid scores
  2. IVF probe (exact top-k per query token; stages 1-2 are one kernel,
     ``ops/probe_kernel.py``, where ``_fused_probe`` holds)
  3. candidates from whole cells, as 128-aligned IVF row windows
  4. per-slot approximate estimates (``ops/estimate_kernel.py``), or with
     ``approx_mode="tokens"`` the reference's token-level estimates
  5. prune to the exact-rerank pool R = n_full_scores / pool_divisor
  6. exact MaxSim over the pool: over the bf16 corpus cache through the
     dedup kernel (``ops/rerank_dedup.py``) where ``dedup_viable`` holds,
     else the per-query kernel (``ops/rerank_kernel.py``); or decompress +
     MaxSim, after the q4 prefilter (``q4_prefilter``) has narrowed the
     pool where only the 4-bit cache is resident. A length-bucketed index
     reranks each bucket's share of the pool at the bucket's cap
     (``_rerank_bucketed``), through the same two kernels over the
     bucket's cache (counters ``rerank.dedup`` / ``rerank.gather``: which
     of the two ran). Every plain MaxSim runs in one chunk loop,
     ``_chunked_maxsim``, whose callers say only where a chunk's rows come
     from.
  7. final top-k

``q4_prefilter`` and ``rerank_rows`` are also low_memory's device steps
(``search/searcher.py``): the q4 prefilter, then the codec-exact rerank of
rows gathered on the host. ``token_scores`` gives every path's winners'
token scores.

A subset restricts the probe to the cells its documents occupy
(``_allowed_cells_mask``) and keeps only member pids in the candidate
windows; ``search_impl`` exact-reranks a subset of at most twice the rerank
pool directly, skipping stages 1-5. ``reconstruct_core`` and
``reconstruct_rows_core`` decompress documents for ``get_embeddings``.

Ported here: the ``cells`` / ``cells_full`` estimators (the exhaustive and
the budgeted chunked-window branches, with rank admission, with or without
a subset), the ``tokens`` estimator (plain PyTorch: the JAX package has no
kernel for it), the emb_cache, q4, decompress and length-bucketed rerank
branches, token-score matrices, reconstruction and the numpy policy
functions.

Tie order follows the JAX package on its CPU backend: cell orderings and the
stage-5 and stage-7 top-k use stable sorts, so equal scores keep the lower
index, as ``jnp.argsort`` and ``lax.top_k`` do. The reference's stage-2
probe is ``approx_max_k``, approximate on its accelerator; the port's is
exact. On a GPU with 32k cells or more it is the probe kernel
(``ops/probe_kernel.py``: no score table; exact ties in ``torch.topk``'s
order, since rank admission reads each cell's probe rank) unless the table
is needed (``tokens``, a subset); otherwise ``torch.topk`` over the table,
which differs from the CPU reference only where two probe scores tie
exactly. Counters ``probe.fused`` / ``probe.table`` say which ran.
"""

from __future__ import annotations

import torch

from fast_plaid_tpu_torch.index.layout import (
    IVF_ALIGN,
    DeviceIndex,
    IndexSpec,
    gather_res,
    round_up,
)
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.ops.estimate_kernel import (
    segmented_estimate,
    segmented_estimate_plain,
)
from fast_plaid_tpu_torch.ops.maxsim import NEG_INF as MAXSIM_NEG
from fast_plaid_tpu_torch.ops.maxsim import maxsim_reduce
from fast_plaid_tpu_torch.ops.probe_kernel import BF16_FROM, probe_table, probe_topk
from fast_plaid_tpu_torch.ops.probe_kernel import MAX_K as PROBE_MAX_K
from fast_plaid_tpu_torch.ops.q4cache import score_q4
from fast_plaid_tpu_torch.ops.rerank_dedup import (
    dedup_viable,
    maxsim_gather_scores_dedup,
)
from fast_plaid_tpu_torch.ops.rerank_kernel import (
    maxsim_gather_scores,
    maxsim_q4_gather_scores,
)
from fast_plaid_tpu_torch.utils import tracing

__all__ = [
    "search_impl",
    "candidates_impl",
    "final_topk",
    "q4_prefilter",
    "rerank_rows",
    "token_scores",
    "reconstruct_core",
    "reconstruct_rows_core",
    "candidate_capacity",
    "suggest_query_tile",
    "suggest_slot_budget",
    "suggest_safe_budget",
    "resolve_approx_mode",
    "rescue_pool",
]

NEG = float("-inf")


def _exact_scores(emb, queries, valid):
    """MaxSim of doc tokens vs queries: bf16-rounded inputs, float32 math."""
    ts = torch.einsum(
        "brtd,bqd->brtq",
        emb.to(torch.bfloat16).to(torch.float32),
        queries.to(torch.bfloat16).to(torch.float32),
    )
    return maxsim_reduce(ts, valid), ts


def rescue_pool(top_k: int) -> int:
    """Exact-rescore slice size after the q4 prefilter (4x top_k, min 32)."""
    return round_up(max(4 * top_k, 32), 8)


def _pad_to(x: torch.Tensor, size: int, axis: int, value) -> torch.Tensor:
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], axis)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx, axis=1)`` for [B, N(, ...)] tensors."""
    idx = idx.long()
    if x.ndim == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def _argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """Stable descending argsort (``jnp.argsort(-x)``: ties keep index order)."""
    return torch.argsort(-x, dim=-1, stable=True)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _doc_mask(dev: DeviceIndex, pids: torch.Tensor, doc_cap: int) -> torch.Tensor:
    """Validity mask [..., doc_cap] for doc-major rows gathered by pid."""
    lens = dev.doc_lengths[pids.long()]
    return torch.arange(doc_cap, device=pids.device) < lens[..., None]


def _allowed_cells_mask(
    dev: DeviceIndex, subset: torch.Tensor, ispec: IndexSpec, kp: int, chunk: int
) -> torch.Tensor:
    """[B, S] subset pids -> [B, kp] bool mask of the cells their tokens occupy.

    With a subset only the centroids present in the subset documents' codes
    may be probed. Each query row gets its own mask, even where all rows
    hold one subset. Invalid tokens scatter into a spare column ``kp``
    (torch has no drop mode), sliced off at the end.
    """
    b, s = subset.shape
    doc_cap = ispec.doc_cap
    mask = torch.zeros((b, kp + 1), dtype=torch.bool, device=subset.device)
    for start in range(0, s, chunk):
        pids = subset[:, start : start + chunk].long()
        valid = _doc_mask(dev, pids, doc_cap)
        tok_codes = torch.where(valid, dev.codes[pids], kp).long()
        mask.scatter_(1, tok_codes.reshape(b, -1), True)
    return mask[:, :kp]


def _subset_filter(pid: torch.Tensor, subset: torch.Tensor, sent_pid: int) -> torch.Tensor:
    """Sentinel-out the pids [B, N] not in the row-sorted subset [B, S]."""
    pos = torch.searchsorted(subset, pid.contiguous())
    pos = torch.clamp(pos, 0, subset.shape[1] - 1)
    member = torch.gather(subset, 1, pos) == pid
    return torch.where(member, pid, sent_pid)


def _sort_pid_payload(
    pid: torch.Tensor, payload: torch.Tensor, payload_bound: int, sent_pid: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-sort ``pid`` carrying ``payload`` (values in [0, payload_bound)).

    Packs both into one int32 key when the range fits, so one array is
    sorted; otherwise co-sorts. Payload order within an equal-pid run is
    unspecified; callers only max-combine runs.
    """
    cpad = 1 << max(payload_bound - 1, 1).bit_length()
    if (sent_pid + 1) * cpad < 2**31:
        key_s = torch.sort(pid * cpad + payload, dim=-1).values
        return key_s // cpad, key_s % cpad
    pid_s, idx = torch.sort(pid, dim=-1, stable=True)
    return pid_s, torch.gather(payload, 1, idx)


def _dedup_sorted(x: torch.Tensor, sentinel) -> torch.Tensor:
    """Replace repeated values in a row-sorted array with ``sentinel``."""
    dup = torch.cat(
        [
            torch.zeros((*x.shape[:-1], 1), dtype=torch.bool, device=x.device),
            x[..., 1:] == x[..., :-1],
        ],
        dim=-1,
    )
    return torch.where(dup, torch.full_like(x, sentinel), x)


def _run_heads(pid_s: torch.Tensor, sent_pid: int) -> torch.Tensor:
    """First slot of every equal-pid run, sentinel runs excluded."""
    first = torch.ones((pid_s.shape[0], 1), dtype=torch.bool, device=pid_s.device)
    return torch.cat([first, pid_s[:, 1:] != pid_s[:, :-1]], dim=-1) & (
        pid_s != sent_pid
    )


def _slot_estimates(
    pid_s: torch.Tensor,  # [B, W] int32, row-sorted by pid (sentinels last)
    own_s: torch.Tensor,  # [B, W] int32 owning-cell index into cell_scores
    cell_scores: torch.Tensor,  # [B, C, Q] bf16 probe-score table
    *,
    use_kernel: bool,
) -> torch.Tensor:
    """Per-slot candidate estimates [B, W] f32: sum_q max over the slot's
    equal-pid run of the owning cells' query-token scores. Only valid at
    each run's first slot; mask with the run heads.

    ``use_kernel`` goes through the kernel wrapper (the CUDA kernel for CUDA
    tensors); otherwise the plain version runs with the doubling capped at
    C, the bound on a run's length.
    """
    if use_kernel:
        return segmented_estimate(pid_s, own_s, cell_scores)
    return segmented_estimate_plain(
        pid_s, own_s, cell_scores, max_run=cell_scores.shape[1]
    )


def _count_live(name: str, pids: torch.Tensor, sent_pid: int) -> None:
    """Counter ``name`` += the live (non-sentinel) slots of ``pids``, on the
    device, while the recorder is on."""
    if tracing.enabled():
        tracing.count_device(name, pids != sent_pid)


def _count_pool(p2: torch.Tensor, sent_pid: int) -> None:
    """Counters of a tile's rerank pool while the recorder is on:
    ``rerank.rows`` (B x R slots) and ``rerank.distinct_rows`` (its distinct
    live pids, on the device): their ratio is what the dedup kernel saves."""
    if tracing.enabled():
        tracing.count("rerank.rows", p2.numel())
        s = torch.sort(p2.reshape(-1)).values
        head = torch.ones_like(s, dtype=torch.bool)
        head[1:] = s[1:] != s[:-1]
        tracing.count_device("rerank.distinct_rows", head & (s != sent_pid))


def _fused_probe(
    device: torch.device, kp: int, d: int, approx_mode: str, subset, probe: int
) -> bool:
    """Whether stages 1-2 run as the probe kernel (``probe_topk``) rather
    than the score table (``probe_table`` + ``torch.topk``): on a GPU, in
    the bf16-table regime, where nothing but the top-k reads the table (not
    ``tokens``, no subset mask) and the shape fits the kernel."""
    return (
        device.type == "cuda"
        and kp >= BF16_FROM
        and approx_mode != "tokens"
        and subset is None
        and probe <= PROBE_MAX_K
        and d % 16 == 0
        and 16 <= d <= 256
    )


def candidates_impl(
    dev: DeviceIndex,
    queries: torch.Tensor,  # [B, Q, D] (zero-padded query tokens)
    subset: torch.Tensor | None,  # [B, S] int32 sorted asc, sentinel_pid padding
    *,
    ispec: IndexSpec,
    n_ivf_probe: int,
    n_full_scores: int,
    mem_budget: int = 256 * 1024 * 1024,
    cand_cap: int | None = None,
    approx_mode: str = "cells",
    with_stats: bool = False,
    slot_budget: int | None = None,
    use_estimate_kernel: bool = False,
    pool_divisor: int = 2,
    rank_admit: int = 0,
):
    """Cascade stages 1-5. Returns the rerank set p2 [B, R] (sentinel_pid
    padding), sorted by descending approximate score; with ``with_stats``
    also a [B, 2] int32 array (budget-pruned slots, cap-overflow slots).

    See ``fast_plaid_tpu.search.engine.candidates_impl`` for the estimator
    regimes. With a subset, only cells its documents occupy are probed, only
    member pids keep their slots, and the budgeted branch scales its slot
    budget by the corpus-to-subset density. ``mem_budget`` sizes the chunks
    of the subset's cell mask.
    """
    if approx_mode not in ("cells", "cells_full", "tokens"):
        msg = f"approx_mode must be 'cells', 'cells_full' or 'tokens'; got {approx_mode!r}"
        raise ValueError(msg)
    with tracing.span("engine.probe"):
        queries = queries.to(torch.float32)
        device = queries.device
        b, q, d = queries.shape
        kp = dev.centroids.shape[0]
        k_real = ispec.n_partitions
        cell_cap = ispec.cell_cap
        sent_pid = ispec.sentinel_pid

        probe = min(n_ivf_probe, kp)
        flat_q = queries.reshape(b * q, d)
        scores_qc = None  # the [B, Q, Kp] table, where it is made
        if _fused_probe(device, kp, d, approx_mode, subset, probe):
            tracing.count("probe.fused", 1)
            # Cast a call (8 MB at 32k x 128, a few us): a copy kept beside
            # the float32 centroids would raise every window's peak memory.
            cent = dev.centroids.to(torch.bfloat16)
            top_cell_scores, cells = probe_topk(flat_q, cent, k_real, probe)
            del cent
        else:
            tracing.count("probe.table", 1)
            scores_qc, probe_scores = probe_table(flat_q, dev.centroids, k_real)
            scores_qc = scores_qc.reshape(b, q, kp)
            probe_scores = probe_scores.reshape(b, q, kp)
            if subset is not None:
                # Chunk of subset documents per scatter: the int64 index tensor
                # (8 B a token), the gathered int32 codes and the mask (~24 B a
                # token in all) stay within mem_budget.
                chunk = max(
                    8, min(subset.shape[1], mem_budget // (24 * b * ispec.doc_cap))
                )
                allowed = _allowed_cells_mask(dev, subset, ispec, kp, chunk)
                probe_scores = torch.where(allowed[:, None, :], probe_scores, NEG)
            # torch.topk orders exact ties as it likes on a GPU; the probed
            # set differs from a stable sort's only at a tie with the k-th.
            top_cell_scores, cells = torch.topk(
                probe_scores.reshape(b * q, kp), probe, dim=-1
            )
        top_cell_scores = top_cell_scores.reshape(b, q, probe)
        cells = cells.to(torch.int32).reshape(b, q, probe)
        cells = torch.where(top_cell_scores > NEG, cells, kp)  # kp = empty cell
    with tracing.span("engine.candidates"):
        # Pack each probed cell with its per-token probe rank and sort, so the
        # best rank at which any query token probed a cell heads its run.
        pp = 1 << max((probe - 1).bit_length(), 1)
        if (kp + 1) * pp >= 2**31:
            msg = (
                f"n_partitions ({kp}) x probe-rank range ({pp}) overflows the "
                "int32 cell/rank packing; reduce n_ivf_probe or the partition "
                "count"
            )
            raise ValueError(msg)
        rank = torch.arange(probe, dtype=torch.int32, device=device).expand(b, q, probe)
        packed = torch.where(cells == kp, kp * pp, cells * pp + rank)
        packed = torch.sort(packed.reshape(b, q * probe), dim=-1).values
        best_rank = packed % pp  # valid at each run head
        cells = _dedup_sorted(packed // pp, kp)
        # [B, C, Q] per-cell/query-token score table from the probed centroids.
        cent_sel = dev.centroids[torch.clamp(cells, 0, kp - 1).long()].to(torch.float32)
        tbl = torch.bmm(cent_sel, queries.transpose(1, 2))  # [B, C, Q]
        del cent_sel
        # Order the deduped cells by descending probe score so truncation
        # drops the least promising cells first.
        cell_pri = torch.where(cells == kp, NEG, torch.amax(tbl, dim=-1))
        order = _argsort_desc(cell_pri)
        cells = _take(cells, order)
        tbl = _take(tbl, order)
        best_rank = _take(best_rank, order)

        # ---- 3. candidates: probed cells' IVF lists.
        c_cells = cells.shape[1]
        offs = dev.ivf_offsets[cells.long()]
        lens = dev.ivf_lengths[cells.long()]  # sentinel cells -> 0
        total = torch.sum(lens, dim=-1, dtype=torch.int32)
        if cand_cap is None:
            cand_cap = c_cells * cell_cap
    if approx_mode == "tokens":
        return _token_candidates(
            dev, scores_qc, subset, offs, lens, total,
            ispec=ispec, n_full_scores=n_full_scores, cand_cap=cand_cap,
            mem_budget=mem_budget, with_stats=with_stats,
        )

    with tracing.span("engine.candidates"):
        # [B, C] cell totals (zero-padded query rows contribute exactly 0).
        cell_tot = torch.where(cells == kp, NEG, torch.sum(tbl, dim=-1))
        order2 = _argsort_desc(cell_tot)
        ct_s = _take(cell_tot, order2)
        offs_s = _take(offs, order2)
        lens_s = _take(lens, order2)

        exhaustive = n_ivf_probe >= k_real or n_full_scores >= 2 * ispec.n_docs
        if approx_mode == "cells_full":
            # cells_full promises per-query-token estimates; the exhaustive
            # branch scores at cell granularity, sound only when the rerank
            # pool covers the corpus.
            exhaustive = n_full_scores >= 2 * ispec.n_docs
        k2 = min(cand_cap, ((n_full_scores + 127) // 128) * 128)
        ivf2d = dev.ivf.reshape(-1, IVF_ALIGN)
        n_ivf_rows = ivf2d.shape[0]

    if exhaustive:
        # Brute-force-identity contract: every probed cell is admitted (an
        # explicit cand_cap still caps, counted as overflow) and candidates
        # score at cell granularity.
        with tracing.span("engine.candidates"):
            budget = cand_cap
            c_sel = c_cells
            csum = torch.cumsum(lens_s, dim=-1, dtype=torch.int32)
            cell_ok = (csum - lens_s) < budget
            rows_pc = -(-cell_cap // IVF_ALIGN)
            row_ids = (offs_s // IVF_ALIGN)[..., None] + torch.arange(
                rows_pc, dtype=torch.int32, device=device
            )
            win = ivf2d[torch.clamp(row_ids, 0, n_ivf_rows - 1).long()].reshape(
                b, c_sel, rows_pc * IVF_ALIGN
            )[:, :, :cell_cap]
            iota_cc = torch.arange(cell_cap, dtype=torch.int32, device=device)
            valid = (iota_cc[None, None, :] < lens_s[..., None]) & cell_ok[..., None]
            width = c_sel * cell_cap
            pid = torch.where(valid, win, sent_pid).reshape(b, width)
            if subset is not None:
                pid = _subset_filter(pid, subset, sent_pid)
            _count_live("candidates", pid, sent_pid)
            vals = torch.where(valid, ct_s[..., None], NEG).reshape(b, width)

        with tracing.span("engine.estimate"):
            # Dedup multi-cell docs: sort by pid, keep each run's max score.
            pid_s, idx = torch.sort(pid, dim=-1, stable=True)
            val_s = torch.gather(vals, 1, idx)
            step = 1
            while step < width:
                eq = pid_s[:, :-step] == pid_s[:, step:]
                head = torch.maximum(
                    val_s[:, :-step], torch.where(eq, val_s[:, step:], NEG)
                )
                val_s = torch.cat([head, val_s[:, -step:]], dim=1)
                step *= 2
            approx = torch.where(_run_heads(pid_s, sent_pid), val_s, NEG)
        with tracing.span("engine.prune"):
            r = min(max(n_full_scores // 2, 1), width)
            s1, i1 = _top_k(approx, r)
            p2 = torch.where(torch.isneginf(s1), sent_pid, torch.gather(pid_s, 1, i1))
            if with_stats:
                kept = torch.sum(torch.where(cell_ok, lens_s, 0), dim=-1)
                over = torch.clamp(total - kept, min=0).to(torch.int32)
                return p2, torch.stack([torch.zeros_like(over), over], dim=-1)
            return p2

    # ---- budgeted chunked-window branch ("cells_full" opens the budget
    # to the full candidate capacity).
    with tracing.span("engine.candidates"):
        if approx_mode == "cells_full":
            budget = cand_cap
            c_sel = c_cells
            order_b = _argsort_desc(cell_tot)
        else:
            budget = min(cand_cap, max(k2, slot_budget or 0))
            if subset is not None:
                # Density-scaled budget: only ~S / n_docs of an admitted cell's
                # documents survive the membership filter, so scale the budget
                # to admit as many subset documents as the unfiltered budget
                # admits documents. (S is the padded subset width.)
                density = max(1, ispec.n_docs // max(subset.shape[1], 1))
                budget = min(cand_cap, budget * density)
            typical = max(1, cand_cap // max(c_cells, 1))
            c_sel = min(c_cells, max(8, -(-2 * budget // typical)))
            # Giant-cell demotion: hub cells rank below every normal cell.
            mean_len = torch.sum(dev.ivf_lengths) // max(k_real, 1)
            giant_thresh = torch.clamp(8 * mean_len, min=budget // 4)
            is_giant = (lens > giant_thresh) & torch.isfinite(cell_tot)
            demoted = torch.where(is_giant, cell_tot - 1e10, cell_tot)
            if rank_admit > 0:
                # Rank-based admission tier: every query token's
                # top-``rank_admit`` probed cells are admitted whole first.
                tier0 = (best_rank < rank_admit) & (cells != kp) & ~is_giant
                demoted = torch.where(
                    tier0, 1e10 * (rank_admit - best_rank).to(torch.float32), demoted
                )
                c_sel = min(c_cells, max(c_sel, q * rank_admit + 8))
            order_b = _argsort_desc(demoted)
        offs_o = _take(offs, order_b)
        lens_o = _take(lens, order_b)
        csum_full = torch.cumsum(lens_o, dim=-1, dtype=torch.int32)
        ok_full = (csum_full - lens_o) < budget  # whole cells until budget
        offs_s, lens_s = offs_o[:, :c_sel], lens_o[:, :c_sel]
        cell_ok = ok_full[:, :c_sel]

        # Chunk table: the selected cells' lists as IVF_ALIGN-wide chunks laid
        # end to end, each one row of the 2-D IVF view.
        w = IVF_ALIGN
        s_chunks = -(-budget // w) + c_sel + -(-cell_cap // w)
        nck = torch.where(cell_ok, (lens_s + w - 1) // w, 0)  # [B, c_sel]
        ck_end = torch.cumsum(nck, dim=-1, dtype=torch.int32)
        ck_start = ck_end - nck
        jj = torch.arange(s_chunks, dtype=torch.int32, device=device)
        own = (jj[None, :, None] >= ck_start[:, None, :]) & (
            jj[None, :, None] < ck_end[:, None, :]
        )  # [B, S, c_sel]: exactly one owner while jj < total chunks
        sel_ids = torch.arange(c_sel, dtype=torch.int32, device=device)
        owner = torch.sum(torch.where(own, sel_ids[None, None, :], 0), dim=-1).to(
            torch.int32
        )  # [B, S]
        has = torch.any(own, dim=-1)
        del own
        local = jj[None, :] - _take(ck_start, owner)
        off = _take(offs_s, owner) + local * w
        rem = _take(lens_s, owner) - local * w
        win = ivf2d[torch.clamp(off // w, 0, n_ivf_rows - 1).long()]  # [B, S, w]
        iota_w = torch.arange(w, dtype=torch.int32, device=device)
        valid = (iota_w[None, None, :] < rem[..., None]) & has[..., None]
        width = s_chunks * w
        pid = torch.where(valid, win, sent_pid).reshape(b, width)
        # Each [B, width] buffer is dropped once the next step has read it:
        # the tile's peak is the prune's sort over the slots, and the dead
        # windows would otherwise sit under it (5 x 4 B a slot).
        del win, valid
        if subset is not None:
            pid = _subset_filter(pid, subset, sent_pid)
        _count_live("candidates", pid, sent_pid)
        ownw = owner[..., None].expand(b, s_chunks, w).reshape(b, width)

    with tracing.span("engine.estimate"):
        # ---- 4. sort by pid carrying the owning cell; per-query-token
        # estimates from the [B, c_sel, Q] table, max-combined within runs.
        pid_s, own_s = _sort_pid_payload(pid, ownw, c_sel, sent_pid)
        del pid, ownw
        cell_scores = _take(tbl, order_b)[:, :c_sel].to(torch.bfloat16)
        est = _slot_estimates(pid_s, own_s, cell_scores, use_kernel=use_estimate_kernel)
        del own_s
        approx = torch.where(_run_heads(pid_s, sent_pid), est, NEG)
        del est

    with tracing.span("engine.prune"):
        # ---- 5. prune straight to the exact-rerank pool.
        r = min(max(n_full_scores // pool_divisor, 1), width)
        s1, i1 = _top_k(approx, r)
        p2 = torch.where(torch.isneginf(s1), sent_pid, torch.gather(pid_s, 1, i1))
        if with_stats:
            kept = torch.sum(torch.where(cell_ok, lens_s, 0), dim=-1)
            if approx_mode == "cells_full":
                over = torch.clamp(total - kept, min=0).to(torch.int32)
                return p2, torch.stack([torch.zeros_like(over), over], dim=-1)
            budget_free = max(k2, slot_budget or 0)  # pre-cand_cap intent
            if subset is not None:
                budget_free = budget_free * max(1, ispec.n_docs // max(subset.shape[1], 1))
            ok_free = (csum_full - lens_o) < budget_free
            target_free = torch.sum(torch.where(ok_free, lens_o, 0), dim=-1)
            target_cap = torch.sum(torch.where(ok_full, lens_o, 0), dim=-1)
            over = torch.clamp(target_free - target_cap, min=0).to(torch.int32)
            pruned = torch.clamp(total - kept, min=0).to(torch.int32) - over
            return p2, torch.stack([torch.clamp(pruned, min=0), over], dim=-1)
        return p2


def _token_candidates(
    dev: DeviceIndex,
    scores_qc: torch.Tensor,  # [B, Q, Kp] query-centroid scores
    subset: torch.Tensor | None,
    offs: torch.Tensor,  # [B, C] probed cells' IVF offsets (probe-score order)
    lens: torch.Tensor,  # [B, C] their lengths (0 for empty cells)
    total: torch.Tensor,  # [B] sum of lens
    *,
    ispec: IndexSpec,
    n_full_scores: int,
    cand_cap: int,
    mem_budget: int,
    with_stats: bool,
):
    """Stages 3-5 of the ``tokens`` estimator (the reference's): the probed
    cells' lists laid end to end in a [B, cand_cap] buffer (cells past it
    are dropped, counted as overflow), deduplicated, each unique candidate
    estimated from its own tokens' centroid scores, and pruned to the pool
    R = n_full_scores / 4."""
    b = scores_qc.shape[0]
    sent_pid = ispec.sentinel_pid
    device = scores_qc.device
    with tracing.span("engine.candidates"):
        seg_end = torch.cumsum(lens, dim=-1)
        jj = torch.arange(cand_cap, dtype=seg_end.dtype, device=device).expand(b, cand_cap)
        # Slot j belongs to the first cell whose list ends past it.
        owner = torch.clamp(
            torch.searchsorted(seg_end.contiguous(), jj.contiguous(), right=True),
            max=lens.shape[1] - 1,
        )
        base = _take(offs - (seg_end - lens), owner)
        src = torch.clamp(base + jj, 0, dev.ivf.shape[0] - 1)
        pid = torch.where(jj < total[:, None], dev.ivf[src.long()], sent_pid)
        if subset is not None:
            pid = _subset_filter(pid, subset, sent_pid)
        _count_live("candidates", pid, sent_pid)
        pid_s = torch.sort(pid, dim=-1).values
        # Unique candidates compacted to the front, sentinels behind.
        cand = torch.sort(torch.where(_run_heads(pid_s, sent_pid), pid_s, sent_pid), dim=-1).values
    with tracing.span("engine.estimate"):
        approx = _token_estimates(dev, cand, scores_qc, ispec=ispec, mem_budget=mem_budget)

    with tracing.span("engine.prune"):
        # ---- 5. prune: top n_full_scores, then the pool (n_full_scores // 4).
        k1 = min(n_full_scores, cand_cap)
        s1, i1 = _top_k(approx, k1)
        p1 = torch.where(torch.isneginf(s1), sent_pid, torch.gather(cand, 1, i1))
        p2 = p1[:, : min(max(n_full_scores // 4, 1), k1)].contiguous()
        if with_stats:
            over = torch.clamp(total - cand_cap, min=0).to(torch.int32)
            return p2, torch.stack([torch.zeros_like(over), over], dim=-1)
        return p2


def _token_estimates(
    dev: DeviceIndex,
    cand: torch.Tensor,  # [B, A] unique pids, sentinels at the back of each row
    scores_qc: torch.Tensor,  # [B, Q, Kp]
    *,
    ispec: IndexSpec,
    mem_budget: int,
) -> torch.Tensor:
    """[B, A] token-level estimates: for each query token, the max over the
    candidate's valid tokens of their centroid's score, summed over Q; -inf
    at sentinels, Q * MAXSIM_NEG for an empty document.

    Chunked over candidates (the gathered [B, A_c, 64, Q] block stays within
    ``mem_budget``) and over 64-token blocks of the document; chunks past the
    last row's last live candidate are not computed.
    """
    b, width = cand.shape
    q, kp = scores_qc.shape[1], scores_qc.shape[2]
    doc_cap = ispec.doc_cap
    sent_pid = ispec.sentinel_pid
    flat_tab = scores_qc.transpose(1, 2).to(torch.bfloat16).reshape(b * kp, q)
    tab_off = (torch.arange(b, device=cand.device) * kp)[:, None, None]
    t_blk = min(doc_cap, 64)
    # A gathered bf16 element and its float32 masked copy: 6 bytes.
    a_chunk = max(8, min(width, mem_budget // max(1, 6 * b * t_blk * q)))
    n_live = int(torch.sum(cand != sent_pid, dim=-1).max())
    approx = torch.full((b, width), NEG, dtype=torch.float32, device=cand.device)
    for start in range(0, n_live, a_chunk):
        p = cand[:, start : start + a_chunk]
        valid = _doc_mask(dev, p, doc_cap)
        tok_codes = dev.codes[p.long()]  # [B, A_c, doc_cap]
        mx = torch.full((*p.shape, q), MAXSIM_NEG, dtype=torch.float32, device=p.device)
        for t0 in range(0, doc_cap, t_blk):
            g = flat_tab[tok_codes[:, :, t0 : t0 + t_blk] + tab_off]  # [B, A_c, t, Q]
            g = torch.where(valid[:, :, t0 : t0 + t_blk, None], g.to(torch.float32), MAXSIM_NEG)
            mx = torch.maximum(mx, torch.amax(g, dim=2))
        approx[:, start : start + a_chunk] = torch.where(p == sent_pid, NEG, torch.sum(mx, dim=-1))
    return approx


def _cache_scores(emb: torch.Tensor, pids, lens, queries) -> torch.Tensor:
    """Stage 6 over a bf16 cache through the kernel wrappers: the dedup
    kernel where ``dedup_viable`` holds for this pool, else the per-query
    kernel. [B, R] float32, -inf for empty rows. Counters ``rerank.dedup``
    / ``rerank.gather``: one a call, the route taken."""
    b, r = pids.shape
    if dedup_viable(emb.shape[0], b, r, queries.shape[1], queries.shape[2]):
        tracing.count("rerank.dedup", 1)
        return maxsim_gather_scores_dedup(emb, pids, lens, queries)
    tracing.count("rerank.gather", 1)
    return maxsim_gather_scores(emb, pids, lens, queries)


def _chunked_maxsim(take, queries: torch.Tensor, n: int, cap: int, mem_budget: int) -> torch.Tensor:
    """Plain stage 6: exact MaxSim [B, n] float32 of a pool of n rows a
    query, whose chunk [lo, hi) ``take(lo, hi)`` gives as (bf16 rows
    [B, hi - lo, cap, D], token mask [B, hi - lo, cap]).

    Chunked over n so that a chunk's rows and token scores stay within
    ``mem_budget``; the last chunk is the shorter. Empty slots are each
    caller's to mask: a chunk's rows are fetched only inside the loop, so
    the [B, n, cap, ...] tensors never materialize in full.
    """
    b, q, d = queries.shape
    per_row = b * cap * max(d * 4, q * 4)
    n_chunk = max(4, min(n, mem_budget // max(1, per_row)))
    parts = []
    for lo in range(0, n, n_chunk):
        emb, valid = take(lo, lo + n_chunk)
        parts.append(_exact_scores(emb, queries, valid)[0])
    return torch.cat(parts, dim=1)


def _codec_rows(dev: DeviceIndex, codes: torch.Tensor, res: torch.Tensor, nbits: int) -> torch.Tensor:
    """bf16 token rows [..., cap, D] decompressed from code rows [..., cap]
    and residual rows [..., cap, PD]."""
    return codec.decompress(
        codes, res, dev.centroids, dev.bucket_weights, nbits, out_dtype=torch.bfloat16
    )


def _resident_rows(dev: DeviceIndex, pids: torch.Tensor, ispec: IndexSpec) -> torch.Tensor:
    """bf16 token rows [..., doc_cap, D] of sentinel-safe ``pids`` from the
    resident layout: the length buckets, the bf16 cache, or the codec."""
    pids = pids.long()
    if dev.buckets:
        return _decompress_rows_bucketed(dev, pids, ispec=ispec, out_dtype=torch.bfloat16)
    if dev.emb_cache is not None:
        return dev.emb_cache[pids]
    return _codec_rows(
        dev, dev.codes[pids], gather_res(dev.residuals, pids, ispec.doc_cap), ispec.nbits
    )


def token_scores(emb: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """[B, K, doc_cap, Q] float32 token-score matrices of the winners' bf16
    rows ``emb`` [B, K, doc_cap, D] with mask ``valid`` [B, K, doc_cap],
    zero past each document's length."""
    _, tok = _exact_scores(emb, queries, valid)
    return torch.where(valid[..., None], tok, 0.0)


def _bucket_quota(r: int, ispec: IndexSpec, bi: int) -> int:
    """Static rerank-slot quota of length bucket ``bi``: twice its share of
    the documents plus a floor of 64, rounded up to 8, at most R.

    A candidate past its bucket's quota is dropped from the exact rerank and
    counted as overflow in the search stats.
    """
    counts = ispec.bucket_counts
    share = counts[bi] / max(sum(counts), 1)
    q = int(r * share * 2.0) + 64
    return min(r, ((q + 7) // 8) * 8)


def _score_bucket_rows(
    dev: DeviceIndex,
    bucket,
    rows: torch.Tensor,  # [B, N] local row ids (the zero row for invalid)
    lens: torch.Tensor,  # [B, N] valid token counts (<= cap_b)
    queries: torch.Tensor,
    *,
    nbits: int,
    cap_b: int,
    mem_budget: int,
) -> torch.Tensor:
    """Plain stage 6 over one bucket's rows -> [B, N]: from the bucket's
    cache, or decompressed from its codec rows."""
    iota = torch.arange(cap_b, device=rows.device)

    def take(lo: int, hi: int):
        rr = rows[:, lo:hi].long()
        if bucket.emb is not None:
            emb = bucket.emb[rr]
        else:
            emb = _codec_rows(dev, bucket.codes[rr], gather_res(bucket.residuals, rr, cap_b), nbits)
        return emb, iota < lens[:, lo:hi, None]

    return _chunked_maxsim(take, queries, rows.shape[1], cap_b, mem_budget)


def _rerank_bucketed(
    dev: DeviceIndex,
    queries: torch.Tensor,
    p2: torch.Tensor,  # [B, R] pids sorted by descending estimate
    *,
    ispec: IndexSpec,
    mem_budget: int,
    use_kernel: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 6 over the length-bucketed layout.

    Each bucket reranks its own candidates at its cap: they are compacted to
    the front in estimate order (a stable sort) and cut to the bucket's
    quota. With ``use_kernel`` and the bucket's cache resident the rows go
    through ``_cache_scores`` (the kernels on a GPU), else the plain
    ``_score_bucket_rows``. Scores go back to their p2 positions by a max
    scatter; dropped slots stay -inf. Returns (exact [B, R] float32,
    quota-dropped [B] int32).
    """
    b, r = p2.shape
    sent = ispec.sentinel_pid
    pos = torch.arange(r, device=p2.device)[None, :]
    safe_pid = torch.clamp(p2, 0, dev.doc_bucket.shape[0] - 1).long()
    b_of = dev.doc_bucket[safe_pid]
    valid = p2 != sent
    exact = torch.full((b, r), NEG, dtype=torch.float32, device=p2.device)
    dropped = torch.zeros((b,), dtype=torch.int32, device=p2.device)
    for bi, bucket in enumerate(dev.buckets):
        cap_b = ispec.bucket_caps[bi]
        quota = _bucket_quota(r, ispec, bi)
        in_b = (b_of == bi) & valid
        keyed = torch.where(in_b, pos, r + pos)
        perm = torch.argsort(keyed, dim=-1, stable=True)[:, :quota]
        sel_ok = torch.gather(in_b, 1, perm)
        pids_b = torch.gather(safe_pid, 1, perm)
        zero_row = bucket.codes.shape[0] - 1
        rows = torch.where(sel_ok, dev.doc_bucket_row[pids_b], zero_row).to(torch.int32)
        lens = torch.where(sel_ok, dev.doc_lengths[pids_b], 0).to(torch.int32)
        if use_kernel and bucket.emb is not None:
            sc = _cache_scores(bucket.emb, rows, lens, queries)
        else:
            sc = _score_bucket_rows(
                dev, bucket, rows, lens, queries,
                nbits=ispec.nbits, cap_b=cap_b, mem_budget=mem_budget,
            )
        # A position belongs to one bucket; the others touch it only with
        # -inf fillers, so the max scatter composes.
        exact.scatter_reduce_(1, perm, torch.where(sel_ok, sc, NEG), "amax")
        dropped += torch.clamp(torch.sum(in_b, dim=-1, dtype=torch.int32) - quota, min=0)
    return exact, dropped


def _decompress_rows_bucketed(
    dev: DeviceIndex,
    pids: torch.Tensor,  # [...] sentinel-safe pids
    *,
    ispec: IndexSpec,
    out_dtype=None,
    use_cache: bool = True,
) -> torch.Tensor:
    """Token rows of ``pids`` from the bucketed layout: [..., doc_cap, D],
    zero past each bucket's cap. From the bucket caches with ``use_cache``
    where they are resident, else decompressed from the codec; one masked
    pass per bucket (meant for small pid sets)."""
    doc_cap = ispec.doc_cap
    safe_pid = torch.clamp(pids, 0, dev.doc_bucket.shape[0] - 1).long()
    b_of = dev.doc_bucket[safe_pid]
    out = None
    for bi, bucket in enumerate(dev.buckets):
        cap_b = ispec.bucket_caps[bi]
        in_b = b_of == bi
        rows = torch.where(
            in_b, dev.doc_bucket_row[safe_pid], bucket.codes.shape[0] - 1
        ).long()
        if use_cache and bucket.emb is not None:
            emb = bucket.emb[rows]
            if out_dtype is not None:
                emb = emb.to(out_dtype)
        else:
            emb = codec.decompress(
                bucket.codes[rows],
                gather_res(bucket.residuals, rows, cap_b),
                dev.centroids,
                dev.bucket_weights,
                ispec.nbits,
                out_dtype=out_dtype,
            )
        emb = torch.where(in_b[..., None, None], emb, 0)
        emb = _pad_to(emb, doc_cap, emb.ndim - 2, 0)
        out = emb if out is None else out + emb
    return out


def rerank_rows(
    dev: DeviceIndex,
    rows: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    p2: torch.Tensor,  # [B, R] int32 (sentinel padding)
    queries: torch.Tensor,  # [B, Q, D]
    *,
    ispec: IndexSpec,
    mem_budget: int = 256 * 1024 * 1024,
) -> torch.Tensor:
    """low_memory's stage 6 over token rows gathered on the host: ``rows``
    is (codes_rows [B, R, doc_cap] int32, res_rows [B, R, doc_cap, PD]
    uint8, tok_valid [B, R, doc_cap] bool) of ``p2``. Decompress + exact
    MaxSim, [B, R] float32 with -inf at sentinel slots."""
    codes_rows, res_rows, tok_valid = rows
    with tracing.span("engine.rerank"):
        _count_pool(p2, ispec.sentinel_pid)
        queries = queries.to(torch.float32)

        def take(lo: int, hi: int):
            emb = _codec_rows(dev, codes_rows[:, lo:hi], res_rows[:, lo:hi], ispec.nbits)
            return emb, tok_valid[:, lo:hi]

        exact = _chunked_maxsim(take, queries, p2.shape[1], ispec.doc_cap, mem_budget)
        return torch.where(p2 == ispec.sentinel_pid, NEG, exact)


def _q4_scores(dev: DeviceIndex, p2, queries, *, mem_budget: int, use_kernel: bool):
    """[B, R] q4 prefilter scores of the pool: the q4 kernel wrapper, or the
    plain ``score_q4``."""
    if use_kernel:
        safe = torch.clamp(p2, 0, dev.doc_lengths.shape[0] - 1).long()
        return maxsim_q4_gather_scores(
            dev.emb_q4, dev.q4_scale, p2, dev.doc_lengths[safe], queries
        )
    return score_q4(
        dev.emb_q4, dev.q4_scale, dev.doc_lengths, p2, queries, mem_budget=mem_budget
    )


def q4_prefilter(
    dev: DeviceIndex,
    p2: torch.Tensor,  # [B, R] rerank pool (sentinel_pid padding)
    queries: torch.Tensor,  # [B, Q, D]
    *,
    sentinel_pid: int,
    pool: int,
    mem_budget: int = 256 * 1024 * 1024,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Narrow the rerank pool through the q4 cache: [B, R] -> [B, pool] pids.

    All R candidates are scored from the device-resident q4 cache and the
    top ``pool`` go on to the codec-exact rerank: low_memory's phase 2,
    before the host row gather, and the resident q4 tier's.
    """
    with tracing.span("engine.q4_prefilter"):
        queries = queries.to(torch.float32)
        pre = _q4_scores(dev, p2, queries, mem_budget=mem_budget, use_kernel=use_kernel)
        s_m, i_m = _top_k(pre, min(pool, p2.shape[1]))
        return torch.where(torch.isneginf(s_m), sentinel_pid, torch.gather(p2, 1, i_m))


def final_topk(exact: torch.Tensor, p2: torch.Tensor, top_k: int):
    """Stage 7: the ``top_k`` best of ``exact`` [B, R] -> (pids [B, top_k]
    int32 with -1 padding, scores [B, top_k] with -inf padding)."""
    with tracing.span("engine.topk"):
        r = p2.shape[1]
        kk = min(top_k, r)
        fs, fi = _top_k(exact, kk)
        fp = torch.gather(p2, 1, fi)
        fp = torch.where(torch.isneginf(fs), -1, fp)
        return _pad_to(fp, top_k, 1, -1), _pad_to(fs, top_k, 1, NEG)


def search_impl(
    dev: DeviceIndex,
    queries: torch.Tensor,
    subset: torch.Tensor | None,
    *,
    ispec: IndexSpec,
    top_k: int,
    n_ivf_probe: int,
    n_full_scores: int,
    want_tokens: bool = False,
    mem_budget: int = 256 * 1024 * 1024,
    cand_cap: int | None = None,
    approx_mode: str = "cells",
    with_stats: bool = False,
    use_rerank_kernel: bool = False,
    slot_budget: int | None = None,
    use_estimate_kernel: bool = False,
    pool_divisor: int = 2,
    rank_admit: int = 0,
):
    """Batched PLAID cascade. Returns (pids [B, top_k] int32 with -1
    padding, scores [B, top_k] f32 with -inf padding); with ``want_tokens``
    also (token scores [B, top_k, doc_cap, Q] f32, doc lengths [B, top_k]
    int32); with ``with_stats`` a final [B, 2] int32 stats array.

    ``subset`` [B, S] int32 restricts each query to its row's documents. A
    subset of at most twice the rerank pool is exact-reranked whole (the
    result is brute-force MaxSim over the subset); a larger one takes the
    cascade with the subset's probe mask and membership filter.

    ``use_estimate_kernel`` / ``use_rerank_kernel`` route stages 4 and 6
    through the kernel wrappers (the CUDA kernels on a GPU); False runs the
    plain PyTorch versions. Needs device-resident residuals unless the bf16
    corpus cache is resident.
    """
    queries = queries.to(torch.float32)  # f16 wire staging -> f32 math
    doc_cap = ispec.doc_cap
    sent_pid = ispec.sentinel_pid
    r_pool = max(n_full_scores // pool_divisor, 1)
    if subset is not None and subset.shape[1] <= 2 * r_pool:
        # Direct-subset pool: skip stages 1-5 and exact-rerank every
        # subset document (sorted, duplicates and out-of-range ids as
        # sentinels).
        with tracing.span("engine.candidates"):
            sub_s = torch.sort(subset.to(torch.int32), dim=-1).values
            sub_s = _dedup_sorted(sub_s, sent_pid)
            p2 = torch.where((sub_s < 0) | (sub_s >= ispec.n_docs), sent_pid, sub_s)
        stats = (
            torch.zeros((queries.shape[0], 2), dtype=torch.int32, device=queries.device)
            if with_stats
            else None
        )
    else:
        cand_out = candidates_impl(
            dev,
            queries,
            subset,
            ispec=ispec,
            n_ivf_probe=n_ivf_probe,
            n_full_scores=n_full_scores,
            mem_budget=mem_budget,
            cand_cap=cand_cap,
            approx_mode=approx_mode,
            with_stats=with_stats,
            slot_budget=slot_budget,
            use_estimate_kernel=use_estimate_kernel,
            pool_divisor=pool_divisor,
            rank_admit=rank_admit,
        )
        p2, stats = cand_out if with_stats else (cand_out, None)

    # q4 prefilter tier: with only the 4-bit cache resident, score the whole
    # pool from it and rescore exactly (codec) only the top rescue_pool.
    # Exhaustive parameters promise brute-force identity, so no approximate
    # narrowing applies there.
    exhaustive = n_ivf_probe >= ispec.n_partitions or (
        n_full_scores >= 2 * ispec.n_docs
    )
    q4_pool = rescue_pool(top_k)
    if (
        dev.emb_q4 is not None
        and dev.emb_cache is None
        and not dev.buckets
        and not exhaustive
        and q4_pool < p2.shape[1]
    ):
        p2 = q4_prefilter(
            dev, p2, queries, sentinel_pid=sent_pid, pool=q4_pool,
            mem_budget=mem_budget, use_kernel=use_rerank_kernel,
        )

    with tracing.span("engine.rerank"):
        _count_pool(p2, sent_pid)
        if dev.buckets:
            # Length-bucketed stage 6: one pass a bucket at its cap.
            exact, qdrop = _rerank_bucketed(
                dev, queries, p2, ispec=ispec, mem_budget=mem_budget,
                use_kernel=use_rerank_kernel,
            )
            if with_stats:
                stats[:, 1] += qdrop  # quota drops are static-buffer overflow
        elif use_rerank_kernel and dev.emb_cache is not None:
            # Fused gather + MaxSim: candidate rows stream into shared memory
            # once and only [B, R] scores come back. Where the tile's pools
            # overlap enough (small corpus against B * R), the dedup kernel
            # reads each (document, requester group) row once instead.
            exact = _cache_scores(dev.emb_cache, p2, dev.doc_lengths[p2.long()], queries)
        else:

            def take(lo: int, hi: int):
                pids = p2[:, lo:hi]
                valid = _doc_mask(dev, pids, doc_cap)
                return _resident_rows(dev, pids, ispec), valid

            exact = _chunked_maxsim(take, queries, p2.shape[1], doc_cap, mem_budget)
            exact = torch.where(p2 == sent_pid, NEG, exact)
    fp, fs = final_topk(exact, p2, top_k)
    if not want_tokens:
        return (fp, fs, stats) if with_stats else (fp, fs)

    # Token-score matrices of the winners only, recomputed.
    safe = torch.where(fp < 0, sent_pid, fp).long()
    valid = _doc_mask(dev, safe, doc_cap)
    tok = token_scores(_resident_rows(dev, safe, ispec), valid, queries)
    doc_lens = torch.where(fp < 0, 0, dev.doc_lengths[safe])
    if with_stats:
        return fp, fs, tok, doc_lens, stats
    return fp, fs, tok, doc_lens


def reconstruct_rows_core(
    codes_rows: torch.Tensor,
    res_rows: torch.Tensor,
    tok_valid: torch.Tensor,
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    *,
    nbits: int,
) -> torch.Tensor:
    """Decompress pre-gathered token rows in float32 (low_memory
    reconstruction); zero past each document's length."""
    emb = codec.decompress(codes_rows, res_rows, centroids, bucket_weights, nbits)
    return torch.where(tok_valid[..., None], emb, 0.0)


def reconstruct_core(
    dev: DeviceIndex, pids: torch.Tensor, *, ispec: IndexSpec
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompress documents: [S] pids -> ([S, doc_cap, D] f32, [S] lengths).

    Always from the codec in float32, never from the bf16 cache:
    get_embeddings promises full-precision decompression. Needs
    device-resident residuals (full-cap or in length buckets).
    """
    pids = pids.long()
    valid = _doc_mask(dev, pids, ispec.doc_cap)
    if dev.buckets:
        emb = _decompress_rows_bucketed(dev, pids, ispec=ispec, use_cache=False)
    else:
        emb = codec.decompress(
            dev.codes[pids],
            gather_res(dev.residuals, pids, ispec.doc_cap),
            dev.centroids,
            dev.bucket_weights,
            ispec.nbits,
        )
    emb = torch.where(valid[..., None], emb, 0.0)
    return emb, dev.doc_lengths[pids]


# ---------------------------------------------------------------------------
# Host-side (numpy) policy functions, copied from
# fast_plaid_tpu/search/engine.py so both packages resolve a corpus alike.
# ---------------------------------------------------------------------------


def suggest_query_tile(
    ispec: IndexSpec,
    q_cap: int,
    cand_cap: int,
    hbm_budget: int = 8 * 1024 * 1024 * 1024,
    max_tile: int = 256,
    slot_budget: int | None = None,
    probe_table: bool = True,
) -> int:
    """Queries per device tile such that the cascade's per-query working
    set (query-centroid scores + candidate buffers + slot scores with the
    doubling double-buffer) fits the device-memory budget. With
    ``probe_table`` False (stages 1-2 run as the probe kernel, which writes
    no [Q, Kp] score table) the scores are left out of the working set."""
    kp = ((max(ispec.n_partitions, 1) + 127) // 128) * 128
    per_query = q_cap * kp * 8 if probe_table else 0
    per_query += cand_cap * 32
    if slot_budget is not None:
        width = 2 * min(cand_cap, slot_budget) + ispec.cell_cap + 256
        per_query += width * (q_cap * 2 * 3 + 12)
    return int(max(1, min(max_tile, hbm_budget // max(per_query, 1))))


def candidate_capacity(ivf_lengths, n_cells: int, n_full_scores: int) -> int:
    """Static candidate-buffer size: the sum of the ``n_cells`` largest IVF
    lists, capped near 2x the expected sum."""
    import numpy as np

    lens = np.sort(np.asarray(ivf_lengths, np.int64))[::-1]
    if lens.size == 0:
        return 128
    worst = int(lens[: min(n_cells, lens.size)].sum())
    typical = int(2.0 * n_cells * float(lens.mean()))
    cap = min(worst, max(typical, 4 * n_full_scores, 1024))
    return max(128, ((cap + 127) // 128) * 128)


def suggest_slot_budget(ivf_lengths, n_full_scores: int, n_hubs: int = 16) -> int:
    """Hub-aware candidate slot budget for the budgeted cells path: the base
    budget plus the excess mass of the ``n_hubs`` largest cells over the
    uniform expectation, capped at 4x the base."""
    import numpy as np

    lens = np.sort(np.asarray(ivf_lengths, np.int64))[::-1]
    k2 = ((n_full_scores + 127) // 128) * 128
    if lens.size == 0:
        return k2
    h = min(n_hubs, lens.size)
    excess = int(lens[:h].sum()) - h * int(np.median(lens))
    return k2 + int(min(max(excess, 0), 4 * k2))


def resolve_approx_mode(
    approx_mode: str,
    ivf_lengths_host,
    *,
    q_cap: int,
    n_ivf_probe: int,
    n_full_scores: int,
    n_partitions: int,
    cand_cap: int | None,
    rank_admit: int | None = None,
    slot_budget: int | None = None,
    n_docs: int | None = None,
) -> tuple[str, int, int | None]:
    """Resolve "auto" to a concrete (approx_mode, rank_admit, slot_budget).

    The estimator-selection policy of the JAX package, unchanged (see
    ``fast_plaid_tpu.search.engine.resolve_approx_mode`` for the measured
    rationale of each threshold).
    """
    import numpy as np

    if approx_mode == "auto":
        approx_mode = "cells"
        if ivf_lengths_host is not None:
            lens_h = np.asarray(ivf_lengths_host, np.float64)
            n_cells = min(q_cap * n_ivf_probe, max(n_partitions, 1))
            mean_len = float(lens_h.mean()) if lens_h.size else 0.0
            expected = mean_len * n_cells
            p90_len = float(np.quantile(lens_h, 0.9)) if lens_h.size else 0.0
            if (
                max(n_partitions, 1) <= 4 * n_ivf_probe
                and p90_len >= max(n_full_scores // 2, 1)
            ):
                if n_docs is not None and n_full_scores // 4 >= max(
                    n_docs // 4, 1
                ):
                    return "tokens", 0, slot_budget
                return "cells_full", 0, slot_budget
            if expected > 6.0 * n_full_scores:
                r_adm = 1
                if expected > 32.0 * n_full_scores:
                    affordable = max(32768, 8 * n_full_scores)
                    if (
                        suggest_safe_budget(
                            ivf_lengths_host, n_full_scores, q_cap, 2
                        )
                        <= affordable
                    ):
                        r_adm = 2
                safe = suggest_safe_budget(
                    ivf_lengths_host, n_full_scores, q_cap, r_adm
                )
                if cand_cap is not None and safe >= cand_cap:
                    approx_mode = "cells_full"
                elif rank_admit is None:
                    rank_admit = r_adm
    rank_admit = 0 if rank_admit is None else max(0, int(rank_admit))
    if rank_admit > 0 and ivf_lengths_host is not None:
        slot_budget = max(
            slot_budget or 0,
            suggest_safe_budget(
                ivf_lengths_host, n_full_scores, q_cap, rank_admit
            ),
        )
    return approx_mode, rank_admit, slot_budget


def suggest_safe_budget(
    ivf_lengths,
    n_full_scores: int,
    q_cap: int,
    rank_admit: int = 1,
) -> int:
    """Slot budget sized so the rank-based admission tier fits whole: the
    hub-aware base plus q_cap * rank_admit p90-length cells."""
    import numpy as np

    base = suggest_slot_budget(ivf_lengths, n_full_scores)
    lens = np.asarray(ivf_lengths, np.int64)
    if lens.size == 0:
        return base
    p90 = float(np.quantile(lens, 0.90))
    need = int(q_cap * max(rank_admit, 0) * max(p90, 1.0))
    return base + ((need + 127) // 128) * 128
