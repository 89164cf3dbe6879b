"""Estimator parity: ``cells``, ``cells_full``, ``tokens`` and ``auto`` in the
port against fast_plaid_tpu on the CPU.

Mirrors ``tests/test_approx_modes.py`` on an index the JAX ``FastPlaid``
creates and both packages open (one on-disk format), and adds the coarse
index on which ``auto`` resolves to the ``tokens`` estimator (64 documents,
16 partitions, ``n_full_scores=64``: the p90 cell holds over 32 documents),
searched through each package's ``search_on_device``. Scores atol 1e-4 (bf16
inputs, float32 sums in another order); ids equal except for score ties at
the boundary; the ``tokens`` rerank pools equal as sets except for ties at
the pool's last estimate (1e-3: bf16 table entries summed in float32 in
another order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu import testing
from fast_plaid_tpu.search import engine as jengine
from fast_plaid_tpu.search import load as jload
from fast_plaid_tpu.search import searcher as jsearcher
from fast_plaid_tpu_torch import search as tsearch
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.search import engine as tengine
from fast_plaid_tpu_torch.search import load as tload
from fast_plaid_tpu_torch.search import searcher as tsearcher

torch.set_num_threads(2)

TOL = 1e-4
EST_TOL = 1e-3


def _pair(path, docs):
    """The JAX package creates the index; both packages open it."""
    jsearch.FastPlaid(path, device="cpu").create(documents_embeddings=docs)
    return jsearch.FastPlaid(path, device="cpu"), tsearch.FastPlaid(path, device="cpu")


def assert_same(a, b, top=None):
    """Per query: the same ids (except for ties at the last score) and the
    same exact scores."""
    for ra, rb in zip(a, b):
        ra, rb = ra[:top], rb[:top]
        assert len(ra) == len(rb)
        np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb], rtol=0, atol=TOL)
        ids_b = [p for p, _ in rb]
        for p, s in ra:
            assert p in ids_b or abs(s - ra[-1][1]) <= TOL


def test_modes_agree_on_top_results(tmp_path):
    rng = np.random.default_rng(0)
    docs = testing.random_documents(rng, 40, 16, 32, variable=True)
    fj, ft = _pair(str(tmp_path / "idx"), docs)
    queries = testing.random_queries(rng, 4, 6, 32)
    kw = dict(top_k=5, show_progress=False)
    res = {
        mode: (fj.search(queries, approx_mode=mode, **kw), ft.search(queries, approx_mode=mode, **kw))
        for mode in ("cells", "tokens", "cells_full", "auto")
    }
    for mode, (rj, rt) in res.items():
        assert_same(rj, rt)  # the port answers as the JAX package, per mode
    r_cells = res["cells"][1]
    for mode in ("cells_full", "auto", "tokens"):
        for a, b in zip(r_cells, res[mode][1]):
            top = min(len(a), len(b), 3)
            assert [p for p, _ in a[:top]] == [p for p, _ in b[:top]]
            for (_, sa), (_, sb) in zip(a[:top], b[:top]):
                assert abs(sa - sb) < 1e-3


def test_exact_doc_found_in_both_modes(tmp_path):
    rng = np.random.default_rng(1)
    docs = testing.random_documents(rng, 30, 12, 32)
    fj, ft = _pair(str(tmp_path / "idx"), docs)
    for mode in ("cells", "cells_full", "tokens"):
        rt = ft.search(docs[7][None], top_k=1, show_progress=False, approx_mode=mode)
        rj = fj.search(docs[7][None], top_k=1, show_progress=False, approx_mode=mode)
        assert rt[0][0][0] == 7
        assert_same(rj, rt)


def test_auto_mode_selection(tmp_path):
    rng = np.random.default_rng(5)
    docs = testing.random_documents(rng, 60, 10, 32)
    fj, ft = _pair(str(tmp_path / "idx"), docs)
    queries = testing.random_queries(rng, 2, 4, 32)
    for kw, want in ((dict(top_k=3), "cells"), (dict(top_k=1, n_full_scores=1), "cells_full")):
        rt = ft.search(queries, show_progress=False, approx_mode="auto", **kw)
        assert tsearcher.last_search_stats()["approx_mode"] == want
        rj = fj.search(queries, show_progress=False, approx_mode="auto", **kw)
        assert jsearcher.last_search_stats()["approx_mode"] == want
        assert_same(rj, rt)


def test_pool_divisor_plumbs_and_keeps_winners(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    docs = testing.random_documents(rng, 60, 12, 32, variable=True)
    fj, ft = _pair(str(tmp_path / "idx"), docs)
    probe = docs[17][:6][None]
    base = ft.search(probe, top_k=5, show_progress=False)
    for div in (2, 4, 8):
        r = ft.search(probe, top_k=5, show_progress=False, pool_divisor=div)
        assert r[0][0][0] == 17
        assert_same(fj.search(probe, top_k=5, show_progress=False, pool_divisor=div), r)
        sa = dict(base[0])
        for pid, sc in r[0]:
            if pid in sa:
                assert abs(sa[pid] - sc) < 1e-4
    monkeypatch.setenv("FASTPLAID_POOL_DIV", "4")
    assert ft.search(probe, top_k=5, show_progress=False)[0][0][0] == 17


@pytest.fixture(scope="module")
def coarse():
    """64 documents over 16 partitions: the p90 cell holds >= 32 documents."""
    rng = np.random.default_rng(13)
    docs = testing.random_documents(rng, 64, 16, 64, variable=True)
    dev_j, spec_j = testing.build_memory_index(docs, seed=3, k=16, emb_cache=True)
    arrays = {f: np.asarray(getattr(dev_j, f)) for f in dev_j._fields
              if getattr(dev_j, f) is not None and f != "buckets"}
    dev_t, spec_t = tlayout.device_index_from_arrays(arrays, dataclasses.asdict(spec_j), "cpu")
    lens = np.asarray(dev_j.ivf_lengths)[: spec_j.n_partitions]
    queries = testing.random_queries(rng, 6, 8, 64)
    planted = np.stack([docs[i][:8] for i in (0, 21, 63)])
    return dict(dev_j=dev_j, spec_j=spec_j, dev_t=dev_t, spec_t=spec_t, lens=lens,
                queries=np.concatenate([queries, planted]).astype(np.float32),
                docs=docs)


def test_auto_resolves_to_tokens(coarse):
    """The default ``search`` on a coarse index runs ``tokens`` in both
    packages, with the same results."""
    c = coarse
    assert np.quantile(c["lens"], 0.9) >= 32
    kw = dict(top_k=5, n_full_scores=64, n_ivf_probe=8, subsets=None, want_tokens=False,
              approx_mode="auto")
    lj = jload.LoadedIndex(c["dev_j"], c["spec_j"], jax.devices("cpu")[0], ivf_lengths_host=c["lens"])
    lt = tload.LoadedIndex(c["dev_t"], c["spec_t"], torch.device("cpu"), ivf_lengths_host=c["lens"])
    # Random queries, and whole documents as planted probes.
    queries = list(c["queries"][:6]) + [c["docs"][i] for i in (0, 21, 63)]
    rj = jsearcher.search_on_device(lj, queries, **kw)
    assert jsearcher.last_search_stats()["approx_mode"] == "tokens"
    rt = tsearcher.search_on_device(lt, queries, **kw)
    assert tsearcher.last_search_stats()["approx_mode"] == "tokens"
    assert_same(rj, rt)
    assert [r[0][0] for r in rt[-3:]] == [0, 21, 63]


def test_tokens_pool_matches_jax(coarse, monkeypatch):
    """Stages 1-5 of ``tokens`` alone: the rerank pools equal as sets except
    for ties at the pool's last estimate; the stats equal."""
    c = coarse
    q = c["queries"]
    kw = dict(n_ivf_probe=4, n_full_scores=64, approx_mode="tokens", with_stats=True, cand_cap=256)
    pj, stj = (np.asarray(x) for x in jengine.candidates_core(
        c["dev_j"], jnp.asarray(q), None, ispec=c["spec_j"], **kw))
    seen = {}
    estimates = tengine._token_estimates

    def record(dev, cand, scores_qc, **k):
        seen["cand"], seen["est"] = cand, estimates(dev, cand, scores_qc, **k)
        return seen["est"]

    monkeypatch.setattr(tengine, "_token_estimates", record)
    pt, stt = (x.numpy() for x in tengine.candidates_impl(
        c["dev_t"], torch.from_numpy(q), None, ispec=c["spec_t"], **kw))
    assert pt.shape == pj.shape == (q.shape[0], 16)
    np.testing.assert_array_equal(stt, stj)
    assert stt[:, 1].sum() > 0  # cand_cap 256 cuts the probed cells: overflow counted
    sent = c["spec_t"].sentinel_pid
    for b in range(q.shape[0]):
        cand, e_b = seen["cand"][b].numpy(), seen["est"][b].numpy()
        est = {int(p): float(e) for p, e in zip(cand, e_b) if np.isfinite(e)}
        last = np.sort(np.asarray(list(est.values())))[::-1][min(pt.shape[1], len(est)) - 1]
        for pid in (set(pt[b].tolist()) ^ set(pj[b].tolist())) - {sent}:
            assert abs(est.get(pid, -np.inf) - last) <= EST_TOL, (b, pid)


def test_tokens_search_with_subset_matches_jax(coarse):
    """``tokens`` under a subset too large for the direct pool: membership
    filtering in the candidate buffer, in both packages."""
    c = coarse
    q = c["queries"]
    sub = np.tile(np.arange(0, 64, 2, dtype=np.int32), (q.shape[0], 1))
    kw = dict(top_k=5, n_ivf_probe=4, n_full_scores=8, approx_mode="tokens", want_tokens=False)
    pj, sj = (np.asarray(x) for x in jengine.search_core(
        c["dev_j"], jnp.asarray(q), jnp.asarray(sub), ispec=c["spec_j"], **kw))
    pt, st = (x.numpy() for x in tengine.search_impl(
        c["dev_t"], torch.from_numpy(q), torch.from_numpy(sub), ispec=c["spec_t"], **kw))
    np.testing.assert_allclose(st, sj, rtol=0, atol=TOL)
    assert set(pt[pt >= 0].tolist()) <= set(sub[0].tolist())
