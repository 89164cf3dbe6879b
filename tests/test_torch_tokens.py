"""Token-score matrices and ``get_embeddings``: the port against the JAX
package on one index, in each of its tiers.

Tiers: the bf16 emb-cache (resident), the codec (resident residuals, no
cache), and low_memory with the q4 prefilter (``load._construct`` with
low_memory on the CPU; ``reload_index`` would ignore it there). Token
matrices within 1e-4 and scores atol 1e-4, ids equal except for ties;
embeddings within 1e-5. Also the checks of ``tests/test_token_scores.py``
(shapes, agreement with ``search``, the MaxSim identity) and a
``compress_only`` index, where ``get_embeddings`` works and ``search``
raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu.index.storage import load_index_data as j_load_data
from fast_plaid_tpu.search import load as jload
from fast_plaid_tpu.testing import random_documents, random_queries
from fast_plaid_tpu_torch import search as tsearch
from fast_plaid_tpu_torch.index.storage import load_index_data as t_load_data
from fast_plaid_tpu_torch.search import load as tload

torch.set_num_threads(2)

DIM = 48
TOL = 1e-4
TIERS = ["emb_cache", "codec", "low_memory"]


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    rng = np.random.default_rng(0)
    docs = random_documents(rng, 150, 20, DIM, variable=True)
    path = str(tmp_path_factory.mktemp("tokens") / "idx")
    jsearch.FastPlaid(index=path, device="cpu").create(documents_embeddings=docs)
    planted = [2, 77, 149]
    queries = [*random_queries(rng, 3, 7, DIM), *[docs[p][:6] for p in planted]]
    engines = {}
    for tier in TIERS:
        budget = 1 << 30 if tier == "emb_cache" else 0
        kw = dict(device="cpu", emb_cache_budget_bytes=budget, length_buckets=0)
        t = tsearch.FastPlaid(index=path, **kw)
        j = jsearch.FastPlaid(index=path, **kw)
        if tier == "low_memory":
            budget = 1 << 30  # the q4 prefilter cache, built from host rows
            t.indices = {"cpu": tload._construct(t_load_data(path), torch.device("cpu"), True,
                                                 emb_cache_budget=budget)}
            cpu = jax.devices("cpu")[0]
            j.indices = {str(cpu): jload._construct(j_load_data(path), cpu, True,
                                                    emb_cache_budget=budget)}
        engines[tier] = (t, j)
    lm = engines["low_memory"][0].indices["cpu"]
    assert lm.low_memory and lm.dev.residuals is None and lm.dev.emb_q4 is not None
    assert engines["emb_cache"][0].indices["cpu"].dev.emb_cache is not None
    assert engines["codec"][0].indices["cpu"].dev.emb_cache is None
    return dict(docs=docs, queries=queries, planted=planted, engines=engines, path=path)


def _same_token_results(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        sg = np.asarray([s for _, s, _ in rg])
        sw = np.asarray([s for _, s, _ in rw])
        np.testing.assert_allclose(sg, sw, rtol=0, atol=TOL)
        by_pid = {p: m for p, _, m in rw}
        for pid, score, mat in rg:
            if pid in by_pid:
                assert mat.shape == by_pid[pid].shape
                np.testing.assert_allclose(mat, by_pid[pid], rtol=0, atol=TOL)
            else:  # a tie at the k-th score
                assert abs(score - sg[-1]) <= TOL


@pytest.mark.parametrize("tier", TIERS)
def test_token_scores_match_jax(index, tier):
    t, j = index["engines"][tier]
    kw = dict(top_k=5, n_full_scores=256, show_progress=False)
    got = t.search_token_scores(index["queries"], **kw)
    want = j.search_token_scores(index["queries"], **kw)
    _same_token_results(got, want)
    assert [got[3 + i][0][0] for i in range(3)] == index["planted"]


@pytest.mark.parametrize("tier", TIERS)
def test_token_scores_consistent_with_search(index, tier):
    """Shapes [q_tokens, doc_tokens]; ids and scores equal search()'s; the
    sum over query tokens of the max over document tokens is the score."""
    t, _ = index["engines"][tier]
    kw = dict(top_k=5, n_full_scores=256, show_progress=False)
    plain = t.search(index["queries"], **kw)
    with_tok = t.search_token_scores(index["queries"], **kw)
    for q, row_a, row_b in zip(index["queries"], plain, with_tok):
        assert [p for p, _ in row_a] == [p for p, _, _ in row_b]
        for (pid, sa), (_, sb, mat) in zip(row_a, row_b):
            assert sa == sb
            assert mat.shape == (q.shape[0], index["docs"][pid].shape[0])
            assert abs(float(mat.max(axis=1).sum()) - sb) < 1e-3


def test_token_scores_with_subset(index):
    t, j = index["engines"]["codec"]
    kw = dict(top_k=4, show_progress=False, subset=[[2, 5, 9, 30, 31], [1, 2], [7] * 3, [77], [2, 149], [149]])
    got = t.search_token_scores(index["queries"], **kw)
    _same_token_results(got, j.search_token_scores(index["queries"], **kw))
    assert got[3][0][0] == 77 and [p for p, _, _ in got[5]] == [149]


@pytest.mark.parametrize("tier", TIERS)
def test_get_embeddings_matches_jax(index, tier):
    t, j = index["engines"][tier]
    ids = [0, 149, 5, 5, *range(20, 300, 1)][:280]
    ids = [i for i in ids if i < 150]
    got = t.get_embeddings(ids)
    want = j.get_embeddings(ids)
    assert len(got) == len(want) == len(ids)
    for i, g, w in zip(ids, got, want):
        assert g.shape == w.shape == index["docs"][i].shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_get_embeddings_tiers_agree_and_approximate(index):
    """Every tier reconstructs from the codec in float32, so they agree; the
    reconstruction is close to the original tokens."""
    ids = list(range(150))
    ref = index["engines"]["codec"][0].get_embeddings(ids)
    for tier in ("emb_cache", "low_memory"):
        for a, b in zip(index["engines"][tier][0].get_embeddings(ids), ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    cos = np.concatenate(
        [np.sum(r * d, axis=-1) / np.linalg.norm(d, axis=-1) for r, d in zip(ref, index["docs"])]
    )
    assert cos.mean() > 0.8


def test_get_embeddings_bad_ids(index):
    t, _ = index["engines"]["low_memory"]
    assert t.get_embeddings([]) == []
    with pytest.raises(ValueError):
        t.get_embeddings([0, 150])
    with pytest.raises(ValueError):
        index["engines"]["codec"][0].get_embeddings([-1])


def test_compress_only_index(tmp_path):
    rng = np.random.default_rng(3)
    docs = random_documents(rng, 30, 10, 32, variable=True)
    path = str(tmp_path / "co")
    t = tsearch.FastPlaid(index=path, device="cpu")
    t.create(documents_embeddings=docs, compress_only=True)
    got = t.get_embeddings([0, 29, 7])
    want = jsearch.FastPlaid(index=path, device="cpu").get_embeddings([0, 29, 7])
    for g, w, i in zip(got, want, [0, 29, 7]):
        assert g.shape == docs[i].shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="compress_only"):
        t.search(random_queries(rng, 1, 4, 32), show_progress=False)
    with pytest.raises(ValueError, match="compress_only"):
        t.search_token_scores(random_queries(rng, 1, 4, 32), show_progress=False)
