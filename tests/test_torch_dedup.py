"""Deduplicated rerank parity: the port's ``ops/rerank_dedup.py`` against the
JAX package's on the same seeded pools.

* ``group_pool``: identical entry tables, ``inv`` and entry count, also
  where one pid takes every slot.
* ``dedup_viable``: the same decision as the JAX package's on a grid of
  (Np, B, R, Q, D), the chip_smoke shape included, and under each
  ``FASTPLAID_RERANK_DEDUP``; at D 64 and 96, which only the CUDA kernel
  takes, the JAX package's decision for the same pool at D 128. The route
  counters ``rerank.dedup`` / ``rerank.gather`` of the engine's stage 6.
* ``maxsim_gather_scores_dedup`` (its plain version on the CPU) against the
  JAX one in interpret mode and against ``maxsim_gather_scores_plain``, at
  rtol = atol = 1e-3 (float32 sums in another order), with identical -inf
  patterns: heavy overlap, Zipf skew, runs longer than G, all-sentinel rows.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu import testing
from fast_plaid_tpu.index.layout import build_emb_cache
from fast_plaid_tpu.ops import rerank_dedup as jdedup
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.ops import rerank_dedup as tdedup
from fast_plaid_tpu_torch.ops.rerank_kernel import maxsim_gather_scores_plain
from fast_plaid_tpu_torch.utils import tracing

torch.set_num_threads(2)

TOL = 1e-3


def _pool(rng, b, r, n_docs, sentinel_frac=0.1):
    pids = rng.integers(0, n_docs, (b, r)).astype(np.int32)
    pids[rng.random((b, r)) < sentinel_frac] = n_docs  # zero-length sentinel row
    return pids


def _corpus(rng, n_docs, doc_cap, d):
    doc_lengths = np.concatenate([rng.integers(1, doc_cap + 1, n_docs), [0]]).astype(
        np.int32
    )
    emb = rng.standard_normal((n_docs + 1, doc_cap, d)).astype(np.float32)
    emb16 = jnp.asarray(emb, dtype=jnp.bfloat16)
    emb_t = torch.from_numpy(np.asarray(emb16, np.float32)).to(torch.bfloat16)
    return doc_lengths, emb16, emb_t


@pytest.mark.parametrize(
    "b,r,n_docs,g",
    [(8, 64, 40, 4), (4, 50, 3, 8), (6, 16, 200, 8), (2, 40, 1, 8)],
    ids=["overlap", "runs_longer_than_g", "sparse", "one_pid"],
)
def test_group_pool_matches_jax(b, r, n_docs, g):
    rng = np.random.default_rng(b * r + n_docs)
    pids = _pool(rng, b, r, n_docs)
    doc_lengths = np.concatenate([rng.integers(1, 7, n_docs), [0]]).astype(np.int32)
    lens = doc_lengths[pids]
    n = b * r
    e_cap = min(n, n // g + n_docs + 1)
    want = [np.asarray(x) for x in jdedup.group_pool(jnp.asarray(pids), jnp.asarray(lens), g, e_cap)]
    got = [x.numpy() for x in tdedup.group_pool(torch.from_numpy(pids), torch.from_numpy(lens), g, e_cap)]
    for name, w, t in zip(("entry_pid", "entry_len", "entry_qidx", "inv", "n_entries"), want, got):
        assert t.dtype == np.int32, name
        np.testing.assert_array_equal(t, w, err_msg=name)
    # Every slot maps to an entry of its pid, with its query at its slot.
    epid, _, eq, inv, n_entries = got
    e, s = inv // g, inv % g
    assert (e < int(n_entries)).all()
    np.testing.assert_array_equal(epid[e], pids)
    np.testing.assert_array_equal(eq[e, s], np.repeat(np.arange(b), r).reshape(b, r))
    _, counts = np.unique(pids.reshape(-1), return_counts=True)
    assert int(n_entries) == int(np.sum(-(-counts // g)))


@pytest.mark.parametrize("g", [1, 8, 256])
def test_group_pool_one_pid_every_slot(g):
    """One pid takes every slot: a single run of B * R requesters cut into
    entries of g, the same tables as the JAX package's."""
    b, r = 6, 50
    pids = np.full((b, r), 3, np.int32)
    lens = np.full((b, r), 5, np.int32)
    n = b * r
    e_cap = min(n, n // g + 10)
    want = [np.asarray(x) for x in jdedup.group_pool(jnp.asarray(pids), jnp.asarray(lens), g, e_cap)]
    got = [x.numpy() for x in tdedup.group_pool(torch.from_numpy(pids), torch.from_numpy(lens), g, e_cap)]
    for name, w, t in zip(("entry_pid", "entry_len", "entry_qidx", "inv", "n_entries"), want, got):
        np.testing.assert_array_equal(t, w, err_msg=name)
    assert int(got[4]) == -(-n // g)


_GRID = list(
    itertools.product(
        (1_000, 57_640, 123_000, 523_000),  # Np
        (1, 8, 256, 1024),  # B
        (1, 64, 2048),  # R
        (8, 16, 17, 32),  # Q
        (64, 96, 128, 256),  # D
    )
)


@pytest.mark.parametrize("env", [None, "0", "1", "auto"])
def test_dedup_viable_matches_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("FASTPLAID_RERANK_DEDUP", raising=False)
    else:
        monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", env)
    decisions = [tdedup.dedup_viable(*args) for args in _GRID]
    # D 64 and 96 only the CUDA kernel takes: there the JAX package decides
    # the same pool at D 128 (the grid's queries fit 8 MB at D 128 too).
    assert decisions == [
        jdedup.dedup_viable(*args[:4], args[4] if args[4] % 128 == 0 else 128)
        for args in _GRID
    ]
    if env in (None, "auto"):
        assert tdedup.dedup_viable(57_640, 256, 2048, 32, 128)  # the chip_smoke tile
        assert not tdedup.dedup_viable(523_000, 256, 2048, 32, 128)
        assert any(decisions) and not all(decisions)


@pytest.mark.parametrize("d", [64, 96, 128])
def test_dedup_viable_widths(d, monkeypatch):
    """Any D a multiple of 16 is legal: the TREC-COVID tile (171,336 rows
    of 96-d, B 256 x R 2,048, the worst case 0.45 of the slots) takes the
    dedup kernel at D 64, 96 and 128 alike, as the JAX package's gate does
    at 128; a width off the 16 grid never does. At B 180 (0.59 of the
    slots) and B 128 (0.78), and for quora's half a million rows, both
    gates keep kernel 2."""
    monkeypatch.delenv("FASTPLAID_RERANK_DEDUP", raising=False)
    assert tdedup.dedup_viable(171_336, 256, 2048, 32, d)
    assert jdedup.dedup_viable(171_336, 256, 2048, 32, 128)
    assert not tdedup.dedup_viable(171_336, 256, 2048, 32, d + 8)
    for np_rows, b in ((171_336, 180), (171_336, 128), (523_000, 256)):
        assert not tdedup.dedup_viable(np_rows, b, 2048, 32, d)
        assert not jdedup.dedup_viable(np_rows, b, 2048, 32, 128)
    monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", "1")
    assert tdedup.dedup_viable(523_000, 256, 2048, 32, d)
    assert not tdedup.dedup_viable(523_000, 256, 2048, 32, d + 8)


def _scores(emb16, emb_t, pids, lens, queries, g, chunk):
    want = np.asarray(
        jdedup.maxsim_gather_scores_dedup(
            emb16, jnp.asarray(pids), jnp.asarray(lens), jnp.asarray(queries),
            g=g, e_tile=8, chunk=chunk, interpret=True,
        )
    )
    args = (emb_t, torch.from_numpy(pids), torch.from_numpy(lens), torch.from_numpy(queries))
    before = tdedup.maxsim_gather_scores_dedup.launches
    got = tdedup.maxsim_gather_scores_dedup(*args, g=g).numpy()
    assert tdedup.maxsim_gather_scores_dedup.launches == before  # CPU: plain version
    per_query = maxsim_gather_scores_plain(*args).numpy()
    for ref in (want, per_query):
        assert np.array_equal(np.isneginf(got), np.isneginf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=TOL, atol=TOL)
    return got


def test_dedup_matches_jax_and_per_query():
    rng = np.random.default_rng(1)
    b, r, n_docs, doc_cap, d, q = 16, 64, 48, 12, 128, 16
    doc_lengths, emb16, emb_t = _corpus(rng, n_docs, doc_cap, d)
    pids = _pool(rng, b, r, n_docs)
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    got = _scores(emb16, emb_t, pids, doc_lengths[pids], queries, g=4, chunk=64)
    assert np.isfinite(got).sum() > 0.8 * got.size


@pytest.mark.parametrize("seed", [3, 4])
def test_dedup_heavy_overlap_and_skew(seed):
    """Zipf-skewed pools: hub documents requested by most queries, runs of
    many times G."""
    rng = np.random.default_rng(seed)
    b, r, n_docs, doc_cap, d, q = 8, 128, 24, 10, 128, 16
    doc_lengths, emb16, emb_t = _corpus(rng, n_docs, doc_cap, d)
    pids = np.clip(rng.zipf(1.5, (b, r)) - 1, 0, n_docs - 1).astype(np.int32)
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    _scores(emb16, emb_t, pids, doc_lengths[pids], queries, g=8, chunk=64)


@pytest.mark.parametrize("run", [8, 9], ids=["run_g", "run_g_plus_1"])
def test_dedup_runs_of_g_and_g_plus_one(run):
    """Every document requested by exactly G or G + 1 queries."""
    rng = np.random.default_rng(run)
    b, n_docs, doc_cap, d, q = run, 12, 16, 128, 16
    doc_lengths, emb16, emb_t = _corpus(rng, n_docs, doc_cap, d)
    pids = np.tile(np.arange(n_docs, dtype=np.int32), (b, 1))
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    _scores(emb16, emb_t, pids, doc_lengths[pids], queries, g=8, chunk=32)


def test_dedup_all_sentinel_rows_are_neg_inf():
    rng = np.random.default_rng(2)
    b, r, n_docs, doc_cap, d, q = 8, 32, 16, 8, 128, 16
    _, emb16, emb_t = _corpus(rng, n_docs, doc_cap, d)
    pids = np.full((b, r), n_docs, np.int32)
    lens = np.zeros((b, r), np.int32)
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    got = _scores(emb16, emb_t, pids, lens, queries, g=4, chunk=32)
    assert np.isneginf(got).all()


def _cache_index(seed, d):
    """A JAX-made index with its bf16 cache, opened by the port on the CPU,
    and 4 queries of 16 tokens."""
    rng = np.random.default_rng(seed)
    docs = testing.random_documents(rng, 60, 12, d, variable=True)
    dev_j, spec_j = testing.build_memory_index(docs, nbits=4, seed=0, k=32)
    dev_j = build_emb_cache(dev_j, spec_j)
    arrays = {
        f: np.asarray(getattr(dev_j, f))
        for f in dev_j._fields
        if getattr(dev_j, f) is not None and f != "buckets"
    }
    dev_t, spec_t = tlayout.device_index_from_arrays(
        arrays, dataclasses.asdict(spec_j), "cpu"
    )
    q = torch.from_numpy(testing.random_queries(rng, 4, 16, d).astype(np.float32))
    return dev_t, spec_t, q


def test_stage6_takes_the_gate(monkeypatch):
    """The engine's stage 6 calls the dedup wrapper exactly where
    ``dedup_viable`` holds (forced and disabled here by the override)."""
    from fast_plaid_tpu_torch.search import engine as tengine

    calls = []
    monkeypatch.setattr(
        tengine, "maxsim_gather_scores_dedup",
        lambda *a, **k: calls.append("dedup") or tdedup.maxsim_gather_scores_dedup(*a, **k),
    )
    monkeypatch.setattr(
        tengine, "maxsim_gather_scores",
        lambda *a, **k: calls.append("per_query") or maxsim_gather_scores_plain(*a, **k),
    )
    dev_t, spec_t, q = _cache_index(0, 128)
    kw = dict(ispec=spec_t, top_k=5, n_ivf_probe=4, n_full_scores=64, use_rerank_kernel=True)
    results = {}
    for env in ("1", "0"):
        monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", env)
        calls.clear()
        results[env] = tengine.search_impl(dev_t, q, None, **kw)
        assert calls == (["dedup"] if env == "1" else ["per_query"])
    np.testing.assert_allclose(results["1"][1].numpy(), results["0"][1].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [96, 128])
def test_stage6_route_counters(d, monkeypatch):
    """Each stage-6 call over the bf16 cache counts its route once:
    ``rerank.dedup`` where the gate holds, ``rerank.gather`` where it does
    not; at D 96 as at 128."""
    from fast_plaid_tpu_torch.search import engine as tengine

    dev_t, spec_t, q = _cache_index(d, d)
    kw = dict(ispec=spec_t, top_k=5, n_ivf_probe=4, n_full_scores=64, use_rerank_kernel=True)
    scores = {}
    for env, want in (("1", (1, 0)), ("0", (0, 1))):
        monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", env)
        tracing.disable()
        tracing.drain()
        tracing.enable()
        try:
            scores[env] = tengine.search_impl(dev_t, q, None, **kw)[1]
        finally:
            tracing.disable()
        counters = tracing.drain()["counters"]
        assert (counters.get("rerank.dedup", 0), counters.get("rerank.gather", 0)) == want
    np.testing.assert_allclose(scores["1"].numpy(), scores["0"].numpy(), rtol=TOL, atol=TOL)
