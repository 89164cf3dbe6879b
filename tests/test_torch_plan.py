"""The search call's host head on the CPU: the plan memoised on the loaded
index (``searcher.plan_search``) and the dense route of a one-shape batch;
and low_memory's rows, each distinct document packed once on the host and
expanded on the device.

The memo must give every call the plan the engine's policies give it fresh,
and miss whenever an input of theirs changes; the dense route must give the
answers, warnings and errors of the per-query route, and its float16 tile
must be bit for bit the host's ``astype(np.float16)``. The expanded rows
must be ``host_gather_rows``' bytes, and the search's answers those of the
padded rows.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from fast_plaid_tpu_torch import native
from fast_plaid_tpu_torch.index.layout import IndexSpec, round_up
from fast_plaid_tpu_torch.index.storage import load_index_data
from fast_plaid_tpu_torch.search import FastPlaid, engine, load, searcher
from fast_plaid_tpu_torch.search.engine import (
    candidate_capacity,
    rescue_pool,
    resolve_approx_mode,
    suggest_query_tile,
    suggest_slot_budget,
)
from fast_plaid_tpu_torch.search.load import LoadedIndex
from fast_plaid_tpu_torch.utils import tracing

torch.set_num_threads(2)

DIM = 32
SEARCH = {"top_k": 5, "n_full_scores": 256, "n_ivf_probe": 4, "show_progress": False}


def _docs(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    docs = [rng.standard_normal((int(rng.integers(8, 40)), DIM)).astype(np.float32) for _ in range(n)]
    return [d / np.linalg.norm(d, axis=1, keepdims=True) for d in docs]


def _queries(n: int, seed: int = 1, tokens: int = 8) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal((n, tokens, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plan") / "index")
    FastPlaid(path, device="cpu").create(_docs(300), kmeans_niters=2)
    return path


def _counted(fn):
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    return out, tracing.drain()["counters"]


def _plan_counts(counters: dict) -> tuple[int, int]:
    return counters.get("search.plan.miss", 0), counters.get("search.plan.hit", 0)


# --------------------------------------------------------------------------
# the plan memo
# --------------------------------------------------------------------------


def test_a_repeated_search_hits_the_plan(index_dir):
    fp = FastPlaid(index_dir, device="cpu")
    q = _queries(6)
    first, c1 = _counted(lambda: fp.search(q, **SEARCH))
    second, c2 = _counted(lambda: fp.search(q, **SEARCH))
    assert _plan_counts(c1) == (1, 0)
    assert _plan_counts(c2) == (0, 1)
    assert first == second  # ids and scores bit for bit


@pytest.mark.parametrize(
    "change",
    ["n_full_scores", "n_ivf_probe", "top_k", "approx_mode", "pool_div_env"],
)
def test_a_changed_input_misses(index_dir, monkeypatch, change):
    fp = FastPlaid(index_dir, device="cpu")
    q = _queries(4)
    monkeypatch.delenv("FASTPLAID_POOL_DIV", raising=False)
    fp.search(q, **SEARCH)
    kw = dict(SEARCH)
    if change == "pool_div_env":
        monkeypatch.setenv("FASTPLAID_POOL_DIV", "4")
    elif change == "approx_mode":
        kw["approx_mode"] = "cells_full"
    else:
        kw[change] = SEARCH[change] * 2
    _, counters = _counted(lambda: fp.search(q, **kw))
    assert _plan_counts(counters) == (1, 0)
    _, counters = _counted(lambda: fp.search(q, **kw))
    assert _plan_counts(counters) == (0, 1)


@pytest.mark.parametrize("mutation", ["update", "delete"])
def test_a_mutated_index_starts_with_an_empty_memo(tmp_path, mutation):
    fp = FastPlaid(str(tmp_path / "index"), device="cpu")
    fp.create(_docs(120), kmeans_niters=2)
    q = _queries(4)
    fp.search(q, **SEARCH)
    _, counters = _counted(lambda: fp.search(q, **SEARCH))
    assert _plan_counts(counters) == (0, 1)
    if mutation == "update":
        fp.update(_docs(10, seed=5))
    else:
        fp.delete([0, 1, 2])
    _, counters = _counted(lambda: fp.search(q, **SEARCH))
    assert _plan_counts(counters) == (1, 0)


def _hub_index(low_memory: bool, q4: bool) -> LoadedIndex:
    """A LoadedIndex over a hub-skewed IVF: lognormal cell lengths (median
    53, p90 194) and 16 hubs of 20,000, as a corpus with frequent tokens has."""
    rng = np.random.default_rng(7)
    n_part = 4096
    lens = rng.lognormal(4.0, 1.0, n_part).astype(np.int64).clip(1)
    lens[:16] = 20_000  # the hubs
    ispec = IndexSpec(
        dim=128, nbits=4, n_docs=200_000, n_partitions=n_part, doc_cap=192,
        cell_cap=round_up(int(lens.max()), 128), has_ivf=True,
    )
    dev = types.SimpleNamespace(emb_q4=object() if q4 else None)
    host_res = np.zeros((1, 64), np.uint8) if low_memory else None
    return LoadedIndex(
        dev, ispec, torch.device("cpu"), ivf_lengths_host=lens,
        low_memory=low_memory, host_residuals=host_res,
    )


def _fresh_plan(loaded, q_cap, *, top_k, n_full_scores, n_ivf_probe, mem_budget,
                approx_mode, max_tile, pool_divisor, rank_admit):
    """The head's policies in the order every call ran them before the memo."""
    ispec = loaded.ispec
    lens = loaded.ivf_lengths_host
    n_cells = min(q_cap * n_ivf_probe, ispec.n_partitions)
    cand_cap = candidate_capacity(lens, n_cells, n_full_scores)
    slot_budget = suggest_slot_budget(lens, n_full_scores)
    approx_mode, rank_admit, slot_budget = resolve_approx_mode(
        approx_mode, lens, q_cap=q_cap, n_ivf_probe=n_ivf_probe,
        n_full_scores=n_full_scores, n_partitions=ispec.n_partitions,
        cand_cap=cand_cap, rank_admit=rank_admit, slot_budget=slot_budget,
        n_docs=ispec.n_docs,
    )
    kp = round_up(ispec.n_partitions, 128)
    tile = max(1, min(256, max(1, mem_budget // (q_cap * kp * 8))))
    tile = min(tile, suggest_query_tile(ispec, q_cap, cand_cap, slot_budget=slot_budget))
    if max_tile is not None:
        tile = min(tile, max(1, int(max_tile)))
    exhaustive = n_ivf_probe >= ispec.n_partitions or n_full_scores >= 2 * ispec.n_docs
    lm_q4 = (
        loaded.low_memory and loaded.dev.emb_q4 is not None and not exhaustive
        and rescue_pool(top_k) < max(n_full_scores // pool_divisor, 1)
    )
    if loaded.low_memory:
        r_pool = rescue_pool(top_k) if lm_q4 else max(n_full_scores // pool_divisor, 1)
        per_q = r_pool * ispec.doc_cap * (loaded.host_residuals.shape[1] + 5)
        tile = min(tile, max(1, (mem_budget // 2) // per_q))
    return (cand_cap, slot_budget, approx_mode, rank_admit, tile, lm_q4)


@pytest.mark.parametrize("tier", ["resident", "low_memory", "low_memory_q4"])
@pytest.mark.parametrize("approx_mode", ["auto", "cells", "cells_full", "tokens"])
def test_the_memoised_plan_is_the_fresh_one(tier, approx_mode):
    loaded = _hub_index(tier != "resident", tier == "low_memory_q4")
    resolved = set()
    for _ in range(2):  # the second pass reads the memo
        for q_cap in (8, 32, 64):
            for n_full_scores in (64, 512, 4096, 16384):
                for n_ivf_probe in (1, 8, 32, 1024, 4096):
                    kw = {
                        "top_k": 10, "n_full_scores": n_full_scores,
                        "n_ivf_probe": n_ivf_probe, "mem_budget": 256 * 1024 * 1024,
                        "approx_mode": approx_mode, "max_tile": 2000,
                        "pool_divisor": 2, "rank_admit": None,
                    }
                    got = searcher.plan_search(loaded, q_cap, **kw)
                    assert tuple(got) == _fresh_plan(loaded, q_cap, **kw)
                    resolved.add((got.approx_mode, got.rank_admit))
    if approx_mode == "auto":  # the grid reaches every branch of the policy
        assert {m for m, _ in resolved} >= {"cells", "cells_full"}
        assert {r for _, r in resolved} >= {0, 1, 2}


@pytest.mark.parametrize("n_part", [32_768, 65_536])
def test_the_tile_budgets_the_probe_table_only_where_it_is_written(n_part):
    """The probe kernel's route (a GPU, 32k cells or more, not ``tokens``,
    no subset) writes no [Q, Kp] score table, so the tile leaves it out of
    the working set; ``tokens``, a subset call and the CPU's table route
    count it. At 65,536 cells of a TREC-COVID-like IVF (lists of ~490, 16
    hubs of 22,000) the table alone cut the tile below 256."""
    rng = np.random.default_rng(11)
    lens = rng.lognormal(6.0, 0.6, n_part).astype(np.int64).clip(1)
    lens[:16] = 22_000
    ispec = IndexSpec(
        dim=96, nbits=4, n_docs=171_332, n_partitions=n_part, doc_cap=304,
        cell_cap=round_up(int(lens.max()), 128), has_ivf=True,
    )
    kw = {"top_k": 10, "n_full_scores": 4096, "n_ivf_probe": 8,
          "mem_budget": 10 * 1024**3, "max_tile": None, "pool_divisor": 2, "rank_admit": None}
    cand_cap = candidate_capacity(lens, min(32 * 8, n_part), 4096)
    slot_budget = suggest_slot_budget(lens, 4096)

    def tile(table):
        return suggest_query_tile(ispec, 32, cand_cap, slot_budget=slot_budget, probe_table=table)

    def plan(device, **extra):
        loaded = LoadedIndex(types.SimpleNamespace(emb_q4=None), ispec, torch.device(device),
                             ivf_lengths_host=lens)
        return searcher.plan_search(loaded, 32, **{"approx_mode": "cells", **kw, **extra})

    assert plan("cuda").tile == tile(False) == 256
    assert plan("cuda", subset=True).tile == tile(True)
    assert plan("cuda", approx_mode="tokens").tile == tile(True)
    assert plan("cpu").tile == tile(True)
    assert tile(True) == (228 if n_part == 65_536 else 256)


def test_threads_racing_on_the_memo_read_whole_plans():
    loaded = _hub_index(True, True)
    base = {"top_k": 10, "n_ivf_probe": 8, "mem_budget": 256 * 1024 * 1024,
            "approx_mode": "auto", "max_tile": None, "pool_divisor": 2, "rank_admit": None}
    keys = [(q_cap, nfs) for q_cap in (8, 16, 32) for nfs in (256, 1024, 4096)]
    want = {k: searcher.SearchPlan(*_fresh_plan(loaded, k[0], n_full_scores=k[1], **base))
            for k in keys}
    wrong: list = []
    barrier = threading.Barrier(12)

    def run(seed):
        rng = np.random.default_rng(seed)
        barrier.wait()
        for _ in range(200):
            q_cap, nfs = keys[int(rng.integers(len(keys)))]
            if rng.random() < 0.05:
                loaded.plans.clear()
            got = searcher.plan_search(loaded, q_cap, n_full_scores=nfs, **base)
            if got != want[(q_cap, nfs)]:
                wrong.append((q_cap, nfs, got))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []


# --------------------------------------------------------------------------
# the dense route
# --------------------------------------------------------------------------


def test_one_shape_batches_stay_whole():
    q = _queries(3)
    assert isinstance(searcher.normalize_queries(q), np.ndarray)
    assert isinstance(searcher.normalize_queries(list(q)), np.ndarray)
    assert isinstance(searcher.normalize_queries(q[0]), np.ndarray)  # [Q, D]: one query
    ragged = searcher.normalize_queries([q[0], q[1][:5]])
    assert isinstance(ragged, list) and [a.shape for a in ragged] == [(8, DIM), (5, DIM)]
    np.testing.assert_array_equal(searcher.normalize_queries(list(q.astype(np.float64))), q)


@pytest.mark.parametrize("tokens", [8, 5, 13])
def test_array_list_and_ragged_list_answer_alike(index_dir, tokens):
    fp = FastPlaid(index_dir, device="cpu")
    q = _queries(8, tokens=tokens)
    short = _queries(1, seed=9, tokens=3)[0]  # shorter: the token cap stays
    as_array, c_array = _counted(lambda: fp.search(q, **SEARCH))
    as_list, c_list = _counted(lambda: fp.search(list(q), **SEARCH))
    ragged, c_ragged = _counted(lambda: fp.search([*q[:7], short], **SEARCH))
    assert c_array["search.stage.dense"] == c_list["search.stage.dense"] == 8
    assert "search.stage.dense" not in c_ragged
    assert as_array == as_list  # ids and scores bit for bit
    assert as_array[:7] == ragged[:7]


@pytest.mark.parametrize("tokens", [1, 5, 8, 13, 0])
def test_the_dense_batch_is_padded_as_before(tokens):
    q = _queries(4, tokens=tokens)
    batch, lens = searcher._dense_batch(q, DIM)
    want, want_lens = searcher._pad_queries(list(q), DIM)
    assert batch.dtype == want.dtype and lens == want_lens
    np.testing.assert_array_equal(batch, want)
    if tokens % 8 == 0 and tokens:
        assert batch is q  # already at the cap: no copy


def test_a_nan_query_warns_and_the_rest_answer(index_dir):
    fp = FastPlaid(index_dir, device="cpu")
    q = _queries(5)
    clean = fp.search(q, **SEARCH)
    bad = q.copy()
    bad[2, 3, 7] = np.nan
    with pytest.warns(RuntimeWarning, match=r"1 query \(indices \[2\]\) had non-finite"):
        got, counters = _counted(lambda: fp.search(bad, **SEARCH))
    assert "search.stage.dense" not in counters
    assert got[2] == []
    assert got[:2] + got[3:] == clean[:2] + clean[3:]


def test_an_all_nan_batch_raises_as_before(index_dir):
    fp = FastPlaid(index_dir, device="cpu")
    q = np.full((3, 8, DIM), np.nan, np.float32)
    with pytest.raises(ValueError, match=r"All queries are invalid: .* got shapes \[\(8, 32\)\]"):
        fp.search(q, **SEARCH)
    with pytest.raises(ValueError, match=r"All queries are invalid: .* got shapes \[\(8, 16\)\]"):
        fp.search(np.zeros((3, 8, 16), np.float32), **SEARCH)


def _half_cases() -> np.ndarray:
    """Float32 values at every kind of float16 rounding edge: random, the
    ties halfway between float16 neighbours (both parities), overflow, and
    the subnormal range."""
    rng = np.random.default_rng(3)
    rand = rng.standard_normal(40_000).astype(np.float32) * np.float32(4.0)
    h = np.arange(0, 0x7BFF, 7, dtype=np.uint16).view(np.float16)  # finite float16s
    lo, hi = h.astype(np.float32), np.nextafter(h, np.float16(np.inf)).astype(np.float32)
    ties = (lo + (hi - lo) / 2).astype(np.float32)  # exact in float32
    near = np.concatenate([np.nextafter(ties, np.float32(0)), np.nextafter(ties, np.float32(np.inf))])
    big = np.array([65504, 65519, 65519.996, 65520, 65536, 1e6, 3.0e38], np.float32)
    sub = (np.arange(-3000, 3000, dtype=np.float32) * np.float32(2.0 ** -26))
    flat = np.concatenate([rand, ties, near, big, sub])
    flat = np.concatenate([flat, -flat])
    return np.resize(flat, (round_up(flat.size, 4 * 8 * 16) // (8 * 16), 8, 16)).astype(np.float32)


def test_the_staged_tile_rounds_like_numpy():
    x = _half_cases()
    got = searcher._stage_tile(x, x.shape[0] + 3, torch.device("cpu"), half=True)
    assert got.dtype == torch.float16 and tuple(got.shape) == (x.shape[0] + 3, 8, 16)
    with np.errstate(over="ignore"):
        want = x.astype(np.float16)
    np.testing.assert_array_equal(got[: x.shape[0]].numpy().view(np.uint16), want.view(np.uint16))
    assert not got[x.shape[0]:].any()
    plain = searcher._stage_tile(x[:2], 2, torch.device("cpu"), half=False)
    assert plain.dtype == torch.float32
    np.testing.assert_array_equal(plain.numpy(), x[:2])


def test_a_read_only_batch_is_staged_without_warnings(index_dir):
    fp = FastPlaid(index_dir, device="cpu")
    q = _queries(3)
    want = fp.search(q, **SEARCH)
    q.setflags(write=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fp.search(q, **SEARCH) == want


# --------------------------------------------------------------------------
# the low_memory rows: each distinct document packed once, expanded on the
# device
# --------------------------------------------------------------------------


def _low_memory(index_dir: str) -> FastPlaid:
    """A CPU instance with a low_memory load and the q4 cache (``reload_index``
    keeps the CPU resident)."""
    fp = FastPlaid(index_dir, device="cpu")
    cpu = torch.device("cpu")
    loaded = load._construct(load_index_data(index_dir), cpu, True, emb_cache_budget=10**9)
    assert loaded.low_memory and loaded.dev.emb_q4 is not None
    fp.indices[str(cpu)] = loaded
    return fp


def _pool_with_repeats(n_docs: int) -> np.ndarray:
    """[6, 40] pids: repeats within a query and across queries, the sentinel
    pid and pids on both sides of [0, n_docs)."""
    pids = np.random.default_rng(5).integers(0, n_docs, (6, 40))
    pids[:, 10:20] = pids[:, :10]
    pids[1] = pids[0]
    pids[2, ::7] = n_docs
    pids[3, ::5] = -1
    pids[3, 1::5] = n_docs + 9
    pids[4, :3] = n_docs - 1
    return pids


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "torch"])
@pytest.mark.parametrize("layout", ["index", "cut"])
def test_packed_rows_expand_to_the_padded_gather(index_dir, use_native, layout):
    """``_pack_rows`` then ``_expand_rows`` give ``host_gather_rows``' three
    tensors byte for byte; ``cut`` lowers doc_cap under the longest
    documents and moves two windows past the ends of the host arrays."""
    loaded = _low_memory(index_dir).indices["cpu"]
    pids = _pool_with_repeats(loaded.ispec.n_docs)
    if layout == "cut":
        loaded = copy.copy(loaded)
        loaded.ispec = dataclasses.replace(loaded.ispec, doc_cap=16)
        offsets = np.array(loaded.host_doc_offsets, np.int64)
        offsets[pids[0, 0]] = len(loaded.host_codes) - 3
        offsets[pids[5, 0]] = -4
        loaded.host_doc_offsets = offsets
    cap = loaded.ispec.doc_cap
    calls = native.gather_windows_u8.calls
    packed = searcher._pack_rows(loaded, pids, use_native=use_native)
    assert native.gather_windows_u8.calls == calls + 2 * (use_native and native.AVAILABLE)
    got = searcher._expand_rows(packed, cap)
    want = searcher.host_gather_rows(loaded, pids, use_native=use_native)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    distinct = np.unique(pids[(pids >= 0) & (pids < loaded.ispec.n_docs)])
    tokens = int(np.minimum(loaded.host_doc_lengths[distinct], cap).sum())
    assert packed.codes.shape[0] == packed.residuals.shape[0] == tokens + cap
    assert packed.slots.dtype == torch.int32 and packed.slots.shape == (2, *pids.shape)


def test_low_memory_search_equals_the_padded_composition(index_dir, monkeypatch):
    """A low_memory search answers with the ids and scores of the padded
    composition, ``host_gather_rows`` then ``rerank_rows``, on the same pool;
    with queries that repeat documents it gathers fewer distinct documents
    than pool slots."""
    fp = _low_memory(index_dir)
    finish, prior, pools = searcher._lm_finish, [], []

    def both(loaded, tile_dev, p2, stats, rows, **kw):
        pools.append(p2.numpy())
        padded = searcher.host_gather_rows(loaded, p2.numpy())
        exact = engine.rerank_rows(
            loaded.dev, padded, p2, tile_dev, ispec=loaded.ispec, mem_budget=kw["mem_budget"]
        )
        prior.append(engine.final_topk(exact, p2, kw["top_k"]))
        return finish(loaded, tile_dev, p2, stats, rows, **kw)

    monkeypatch.setattr(searcher, "_lm_finish", both)
    q = _queries(4)
    q = np.concatenate([q, q, q[:2]])
    tracing.enable()
    got = fp.search(q, **SEARCH)
    counters = tracing.drain()["counters"]
    ids = torch.cat([p for p, _ in prior]).tolist()
    scores = torch.cat([s for _, s in prior]).tolist()
    want = [[(p, s) for p, s in zip(ip, sp) if p >= 0] for ip, sp in zip(ids, scores)]
    assert got == want[: len(q)] and all(got)
    (pool,) = pools
    assert counters["gather.rows"] == pool.size
    assert counters["gather.distinct"] == len(np.unique(pool[pool < fp.indices["cpu"].ispec.n_docs]))
    assert 0 < counters["gather.distinct"] < counters["gather.rows"]
