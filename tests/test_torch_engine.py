"""Engine parity: the PyTorch cascade against fast_plaid_tpu.search.engine on
one index, carried across with ``device_index_from_arrays``.

(a) Exhaustive parameters (every cell probed, pool covering the corpus):
    both engines equal brute-force MaxSim over the decompressed corpus.
(b) The budgeted ``cells`` branch with rank-1 admission, which the test
    asserts ``resolve_approx_mode`` picks: the rerank pools agree as sets
    except for ties at the R-th estimate, and the top-k agree except for
    score ties at the boundary.
Scores atol 1e-4 (bf16-rounded inputs, float32 sums in another order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu import testing
from fast_plaid_tpu.index.layout import build_emb_cache as j_build_emb_cache
from fast_plaid_tpu.search import engine as jengine
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.ops import codec as tcodec
from fast_plaid_tpu_torch.search import engine as tengine

torch.set_num_threads(2)

DIM = 128
TOL = 1e-4


def _carry(dev, ispec):
    arrays = {
        f: np.asarray(getattr(dev, f))
        for f in dev._fields
        if getattr(dev, f) is not None and f != "buckets"
    }
    return tlayout.device_index_from_arrays(arrays, dataclasses.asdict(ispec), "cpu")


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(21)
    docs = testing.random_documents(rng, 400, 24, DIM, variable=True)
    dev_j, spec_j = testing.build_memory_index(docs, nbits=4, seed=0, k=256)
    dev_jc = j_build_emb_cache(dev_j, spec_j)
    dev_t, spec_t = _carry(dev_j, spec_j)
    dev_tc, _ = _carry(dev_jc, spec_j)
    queries = testing.random_queries(rng, 6, 8, DIM)
    # Planted probes: verbatim 8-token prefixes of documents.
    planted = np.stack([docs[i][:8] for i in (3, 77, 151, 299)])
    queries = np.concatenate([queries, planted]).astype(np.float32)
    lens = np.asarray(dev_j.ivf_lengths)[: spec_j.n_partitions]
    return dict(
        docs=docs, dev_j=dev_j, dev_jc=dev_jc, spec_j=spec_j, dev_t=dev_t,
        dev_tc=dev_tc, spec_t=spec_t, queries=queries, ivf_lengths=lens,
    )


def assert_same_topk(ids_a, sc_a, ids_b, sc_b, tol=TOL):
    """Top-k lists agree position-wise in score, and in ids except where a
    document only one list holds ties the k-th score."""
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=tol)
    for ia, sa, ib, sb in zip(ids_a, sc_a, ids_b, sc_b):
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids.tolist()):
                if pid not in other.tolist():
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


def _brute_force(index, queries, k):
    """MaxSim over the decompressed corpus, bf16-rounded like the engines."""
    dev, spec = index["dev_t"], index["spec_t"]
    n = spec.n_docs
    emb = tcodec.decompress(
        dev.codes[:n],
        tlayout.gather_res(dev.residuals, torch.arange(n), spec.doc_cap),
        dev.centroids, dev.bucket_weights, spec.nbits, out_dtype=torch.bfloat16,
    ).double()
    q = torch.from_numpy(queries).to(torch.bfloat16).double()
    ts = torch.einsum("ntd,bqd->bntq", emb, q)
    valid = torch.arange(spec.doc_cap) < dev.doc_lengths[:n, None]
    ts = torch.where(valid[None, :, :, None], ts, float("-inf"))
    scores = ts.amax(dim=2).sum(dim=-1)  # [B, n]
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return i[:, :k].numpy(), s[:, :k].numpy()


def test_exhaustive_matches_brute_force(index):
    spec_j, spec_t = index["spec_j"], index["spec_t"]
    q = index["queries"]
    kw = dict(
        top_k=10, n_ivf_probe=spec_j.n_partitions,
        n_full_scores=4 * spec_j.n_docs, want_tokens=False,
    )
    pj, sj = (
        np.asarray(x)
        for x in jengine.search_core(index["dev_j"], jnp.asarray(q), None, ispec=spec_j, **kw)
    )
    pt, st = (
        x.numpy()
        for x in tengine.search_impl(index["dev_t"], torch.from_numpy(q), None, ispec=spec_t, **kw)
    )
    bi, bs = _brute_force(index, q, 10)
    assert_same_topk(pt, st, bi, bs)
    assert_same_topk(pt, st, pj, sj)


def _budgeted_kwargs(index, n_full):
    spec = index["spec_t"]
    lens = index["ivf_lengths"]
    q_cap, probe = index["queries"].shape[1], 8
    cand_cap = tengine.candidate_capacity(lens, min(q_cap * probe, spec.n_partitions), n_full)
    mode, rank_admit, slot_budget = tengine.resolve_approx_mode(
        "auto", lens, q_cap=q_cap, n_ivf_probe=probe, n_full_scores=n_full,
        n_partitions=spec.n_partitions, cand_cap=cand_cap,
        slot_budget=tengine.suggest_slot_budget(lens, n_full), n_docs=spec.n_docs,
    )
    assert (mode, rank_admit) == jengine.resolve_approx_mode(
        "auto", lens, q_cap=q_cap, n_ivf_probe=probe, n_full_scores=n_full,
        n_partitions=spec.n_partitions, cand_cap=cand_cap,
        slot_budget=jengine.suggest_slot_budget(lens, n_full), n_docs=spec.n_docs,
    )[:2]
    return dict(
        n_ivf_probe=probe, n_full_scores=n_full, cand_cap=cand_cap,
        approx_mode=mode, slot_budget=slot_budget, rank_admit=rank_admit,
    )


def test_budgeted_rank_admit_pool_matches_jax(index, monkeypatch):
    kw = _budgeted_kwargs(index, 128)
    # The configuration under test: budgeted cells with rank-1 admission.
    assert kw["approx_mode"] == "cells" and kw["rank_admit"] == 1
    q = index["queries"]
    pj = np.asarray(
        jengine.candidates_core(index["dev_j"], jnp.asarray(q), None, ispec=index["spec_j"], **kw)
    )
    seen = {}
    run_heads, top_k = tengine._run_heads, tengine._top_k

    def record_heads(pid_s, sent):
        seen["pid_s"] = pid_s
        return run_heads(pid_s, sent)

    def record_top_k(x, k):
        seen["approx"], seen["r"] = x, k
        return top_k(x, k)

    monkeypatch.setattr(tengine, "_run_heads", record_heads)
    monkeypatch.setattr(tengine, "_top_k", record_top_k)
    pt = tengine.candidates_impl(
        index["dev_t"], torch.from_numpy(q), None, ispec=index["spec_t"], **kw
    ).numpy()
    assert pt.shape == pj.shape
    sent = index["spec_t"].sentinel_pid
    pid_s, approx, r = seen["pid_s"].numpy(), seen["approx"].numpy(), seen["r"]
    for b in range(pt.shape[0]):
        est = {
            int(p): float(a)
            for p, a in zip(pid_s[b], approx[b])
            if np.isfinite(a)
        }
        boundary = np.sort(np.asarray(list(est.values())))[::-1][min(r, len(est)) - 1]
        diff = (set(pt[b].tolist()) ^ set(pj[b].tolist())) - {sent}
        for pid in diff:  # only ties at the R-th estimate may differ
            assert abs(est.get(pid, float("-inf")) - boundary) <= TOL, (b, pid)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_budgeted_search_matches_jax(index, use_kernels):
    """The emb_cache rerank branch; on the CPU the kernel wrappers run their
    plain versions, so both settings hold to the JAX result."""
    kw = dict(_budgeted_kwargs(index, 128), top_k=10, want_tokens=False)
    q = index["queries"]
    pj, sj = (
        np.asarray(x)
        for x in jengine.search_core(index["dev_jc"], jnp.asarray(q), None, ispec=index["spec_j"], **kw)
    )
    pt, st = (
        x.numpy()
        for x in tengine.search_impl(
            index["dev_tc"], torch.from_numpy(q), None, ispec=index["spec_t"],
            use_estimate_kernel=use_kernels, use_rerank_kernel=use_kernels, **kw,
        )
    )
    assert_same_topk(pt, st, pj, sj)
    planted = pt[-4:, 0]
    assert planted.tolist() == [3, 77, 151, 299]


@pytest.mark.parametrize("mode", ["cells_full", "cells"])
def test_explicit_modes_match_jax(index, mode):
    """Explicit estimators without rank admission: the untruncated
    ``cells_full`` and the plain budgeted ``cells`` (decompress rerank)."""
    kw = dict(
        _budgeted_kwargs(index, 128), top_k=10, want_tokens=False,
        approx_mode=mode, rank_admit=0, with_stats=True,
    )
    q = index["queries"]
    pj, sj, stj = (
        np.asarray(x)
        for x in jengine.search_core(index["dev_j"], jnp.asarray(q), None, ispec=index["spec_j"], **kw)
    )
    pt, st, stt = (
        x.numpy()
        for x in tengine.search_impl(
            index["dev_t"], torch.from_numpy(q), None, ispec=index["spec_t"],
            use_estimate_kernel=True, **kw,
        )
    )
    assert_same_topk(pt, st, pj, sj)
    np.testing.assert_array_equal(stt, stj)


def test_stats_match_jax(index):
    kw = dict(_budgeted_kwargs(index, 128), top_k=10, want_tokens=False, with_stats=True)
    q = index["queries"]
    *_, stj = jengine.search_core(index["dev_j"], jnp.asarray(q), None, ispec=index["spec_j"], **kw)
    *_, stt = tengine.search_impl(
        index["dev_t"], torch.from_numpy(q), None, ispec=index["spec_t"], **kw
    )
    np.testing.assert_array_equal(stt.numpy(), np.asarray(stj))


def test_unported_options_raise(index):
    """Every option runs: the ``tokens`` estimator (the JAX package's
    results, scores atol 1e-4), token matrices and subsets; an unknown
    estimator raises ValueError."""
    q = torch.from_numpy(index["queries"])
    base = dict(ispec=index["spec_t"], top_k=5, n_ivf_probe=4, n_full_scores=64)
    pt, st = tengine.search_impl(index["dev_t"], q, None, approx_mode="tokens", **base)
    pj, sj = jengine.search_core(
        index["dev_j"], jnp.asarray(index["queries"]), None, approx_mode="tokens",
        want_tokens=False, **dict(base, ispec=index["spec_j"]),
    )
    assert_same_topk(pt.numpy(), st.numpy(), np.asarray(pj), np.asarray(sj))
    assert pt[-4:, 0].tolist() == [3, 77, 151, 299]
    with pytest.raises(ValueError):
        tengine.search_impl(index["dev_t"], q, None, approx_mode="token", **base)
    _, _, tok, lens = tengine.search_impl(index["dev_t"], q, None, want_tokens=True, **base)
    assert tok.shape == (q.shape[0], 5, index["spec_t"].doc_cap, q.shape[1])
    assert lens.shape == (q.shape[0], 5) and (lens > 0).all()
    sub = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    ids, _ = tengine.search_impl(index["dev_t"], q, sub, **base)
    assert all(set(r[r >= 0].tolist()) <= set(s.tolist()) for r, s in zip(ids, sub))


def test_policy_functions_match_jax(index):
    lens = index["ivf_lengths"]
    for n_full in (64, 128, 1024, 4096):
        assert tengine.candidate_capacity(lens, 64, n_full) == jengine.candidate_capacity(lens, 64, n_full)
        assert tengine.suggest_slot_budget(lens, n_full) == jengine.suggest_slot_budget(lens, n_full)
        for ra in (0, 1, 2):
            assert tengine.suggest_safe_budget(lens, n_full, 8, ra) == jengine.suggest_safe_budget(
                lens, n_full, 8, ra
            )
    for top_k in (1, 10, 100):
        assert tengine.rescue_pool(top_k) == jengine.rescue_pool(top_k)
    assert tengine.suggest_query_tile(index["spec_t"], 32, 4096, slot_budget=2048) == (
        jengine.suggest_query_tile(index["spec_j"], 32, 4096, slot_budget=2048)
    )
