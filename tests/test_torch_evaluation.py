"""Evaluation parity: the port's metrics, generators and exhaustive truth
against the JAX package's, on the same seeded numpy inputs.

Metrics and generators are copies, so they must be exactly equal. The host
truth is the same numpy code (ids equal, scores 1e-6). The blocked truth
rounds its inputs to bf16 as the JAX device path does, so against that path
it differs only by float32 summation order (``_order_tol``), and against the
float32 numpy path by at most ``bf16_score_tolerance``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from fast_plaid_tpu import evaluation as jeval
from fast_plaid_tpu.evaluation import synthetic as jsyn
from fast_plaid_tpu_torch import evaluation as teval
from fast_plaid_tpu_torch.evaluation import synthetic as tsyn

torch.set_num_threads(2)


# -- the three tests of test_evaluation.py, on the port ---------------------


def test_metrics_simple_case():
    scores = [
        [{"id": "a", "score": 0.9}, {"id": "b", "score": 0.8},
         {"id": "c", "score": 0.7}],
        [{"id": "x", "score": 0.5}, {"id": "y", "score": 0.4}],
    ]
    qrels = {"q1": {"a": 1, "c": 1}, "q2": {"y": 1}}
    queries = ["q1", "q2"]
    out = teval.evaluate(
        scores, qrels, queries,
        metrics=["ndcg@3", "hits@1", "recall@2", "mrr@3", "precision@2", "map@3"],
    )
    ndcg_q1 = (1 + 1 / math.log2(4)) / (1 + 1 / math.log2(3))
    ndcg_q2 = 1 / math.log2(3)
    assert abs(out["ndcg@3"] - (ndcg_q1 + ndcg_q2) / 2) < 1e-9
    assert out["hits@1"] == 0.5
    assert out["recall@2"] == (0.5 + 1.0) / 2
    assert abs(out["mrr@3"] - (1.0 + 0.5) / 2) < 1e-9
    assert out["precision@2"] == (0.5 + 0.5) / 2
    assert abs(out["map@3"] - ((1 + 2 / 3) / 2 + 0.5) / 2) < 1e-9


def test_add_duplicates():
    queries = ["a", "b", "a"]
    scores = [[{"id": "1", "score": 1.0}], [{"id": "2", "score": 1.0}]]
    out = teval.add_duplicates(queries, scores)
    assert len(out) == 3
    assert out[0] == out[2]


def test_unknown_metric_raises():
    with pytest.raises(ValueError):
        teval.evaluate(
            [[{"id": "a", "score": 1.0}]], {"q": {"a": 1}}, ["q"],
            metrics=["bogus@5"],
        )


def test_load_beir_is_an_optional_import():
    try:
        import beir  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="beir"):
            teval.load_beir("scifact")
    else:
        pytest.skip("beir is installed; load_beir would download")


# -- metric values equal to the JAX package's -------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n_docs, nq = 60, 25
    queries = [f"q{i}" for i in range(nq)] + ["q3", "q7"]  # duplicates
    scores = []
    for _ in range(nq):
        ids = rng.choice(n_docs, size=int(rng.integers(1, 40)), replace=False)
        sc = rng.standard_normal(len(ids)).round(2)  # ties in score
        scores.append([{"id": str(i), "score": float(s)} for i, s in zip(ids, sc)])
    qrels = {}
    for i in range(nq):
        if i % 6 == 5:
            continue  # a query without qrels
        rel = rng.choice(n_docs, size=int(rng.integers(1, 8)), replace=False)
        qrels[f"q{i}"] = {str(d): int(rng.integers(0, 4)) for d in rel}
    qrels["q1"] = {"0": True, "1": False}  # boolean relevance
    metrics = [f"{m}@{k}" for m in ("ndcg", "hits", "recall", "precision", "map", "mrr")
               for k in (1, 3, 10, 100)] + ["ndcg"]
    want = jeval.evaluate(scores, qrels, queries, metrics=metrics)
    got = teval.evaluate(scores, qrels, queries, metrics=metrics)
    assert got == want
    assert teval.evaluate(scores, qrels, queries) == jeval.evaluate(scores, qrels, queries)


# -- generators: bit-identical arrays ---------------------------------------


def _same_corpus(a, b):
    docs_a, q_a, t_a = a
    docs_b, q_b, t_b = b
    assert len(docs_a) == len(docs_b)
    for x, y in zip(docs_a, docs_b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert q_a.dtype == q_b.dtype and np.array_equal(q_a, q_b)
    assert np.array_equal(t_a, t_b)


GEN_CASES = [
    ("topic_corpus", 0, dict(n_docs=70, n_queries=9, dim=32, mean_len=30, max_len=60)),
    ("topic_corpus", 5, dict(n_docs=40, n_queries=4, dim=64, q_len=12, n_topics=8)),
    ("colbert_proxy_corpus", 0, dict(n_docs=70, n_queries=9, dim=32, mean_len=30, max_len=60)),
    ("colbert_proxy_corpus", 3, dict(n_docs=50, n_queries=6, dim=128, mean_len=20, max_len=40,
                                     q_len=16, lexical_frac=0.25, mask_frac=0.0)),
    ("colbert_proxy_corpus", 1, dict(n_docs=60, n_queries=8, dim=32, mean_len=30, max_len=60,
                                     graded_targets=5)),
    ("colbert_proxy_corpus", 9, dict(n_docs=30, n_queries=5, dim=64, mean_len=12, max_len=24,
                                     graded_targets=3, q_len=12)),
]


@pytest.mark.parametrize("name,seed,kw", GEN_CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}" for i, c in enumerate(GEN_CASES)])
def test_generators_bit_identical(name, seed, kw):
    a = getattr(jsyn, name)(np.random.default_rng(seed), **kw)
    b = getattr(tsyn, name)(np.random.default_rng(seed), **kw)
    _same_corpus(a, b)
    if kw.get("graded_targets"):
        assert jsyn.graded_qrels(a[2]) == tsyn.graded_qrels(b[2])


def test_graded_budget_line():
    """Reference fault 4: with m graded targets the lexical budget
    int(lexical_frac * q_len) must reach m (m + 1) / 2 for strictly
    descending grades. At the line the port's arrays equal the JAX
    package's; below it the JAX copy plants equal grades and the port
    raises."""
    kw = dict(n_docs=30, n_queries=4, dim=32, mean_len=20, max_len=40, graded_targets=5)
    at_line = dict(kw, q_len=30)  # n_lex = 15 = 5 * 6 / 2
    _same_corpus(jsyn.colbert_proxy_corpus(np.random.default_rng(0), **at_line),
                 tsyn.colbert_proxy_corpus(np.random.default_rng(0), **at_line))
    below = dict(kw, q_len=28)  # n_lex = 14
    jsyn.colbert_proxy_corpus(np.random.default_rng(0), **below)  # silently breaks
    n_lex, m = 14, 5
    w = np.arange(m, 0, -1).astype(np.float64)
    alloc = np.maximum(1, (n_lex * w / w.sum()).astype(np.int64))
    assert alloc.tolist() == [4, 3, 2, 1, 1]  # grades 4 and 5 tie in the JAX copy
    with pytest.raises(ValueError, match="graded_targets=5"):
        tsyn.colbert_proxy_corpus(np.random.default_rng(0), **below)
    with pytest.raises(ValueError):
        tsyn.colbert_proxy_corpus(
            np.random.default_rng(0), 10, 2, dim=16, mean_len=10, max_len=20,
            graded_targets=2, q_len=4, lexical_frac=0.5,  # n_lex 2 < 3
        )
    _same_corpus(  # m = 2 at its line, n_lex 3
        jsyn.colbert_proxy_corpus(np.random.default_rng(2), 10, 2, dim=16, mean_len=10,
                                  max_len=20, graded_targets=2, q_len=6, lexical_frac=0.5),
        tsyn.colbert_proxy_corpus(np.random.default_rng(2), 10, 2, dim=16, mean_len=10,
                                  max_len=20, graded_targets=2, q_len=6, lexical_frac=0.5),
    )


def test_truth_qrels_equal_jax():
    rng = np.random.default_rng(4)
    truth = [[(int(p), float(s)) for p, s in zip(rng.permutation(50)[:20], rng.random(20))]
             for _ in range(6)]
    assert tsyn.truth_qrels(truth, depth=10) == jsyn.truth_qrels(truth, depth=10)


# -- exhaustive truth --------------------------------------------------------


@pytest.fixture(scope="module")
def ragged():
    """Ragged documents (a 1-token one among them), 37 of them: not a
    multiple of the blocks; 7 queries: not a multiple of the query block."""
    docs, queries, _ = tsyn.colbert_proxy_corpus(
        np.random.default_rng(11), 37, 7, dim=64, mean_len=24, max_len=48, q_len=16
    )
    docs[5] = docs[5][:1]
    docs[20] = docs[20][:2]
    return docs, queries


def _assert_same_topk(a, b, tol):
    """Per query: scores rank by rank within tol; an id only one list holds
    lies within tol of that list's last score."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        sa = np.asarray([s for _, s in ra])
        sb = np.asarray([s for _, s in rb])
        np.testing.assert_allclose(sa, sb, rtol=0, atol=tol)
        ia, ib = [p for p, _ in ra], [p for p, _ in rb]
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids):
                if pid not in other:
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


def _order_tol(docs, queries):
    """float32 sums in another order of the same bf16-rounded products: D
    products a token, Lq maxima a score (unit-norm vectors, scores <= Lq)."""
    lq, dim = queries.shape[1], queries.shape[2]
    return lq * 2 * dim * 2.0**-24 + 2 * lq * lq * 2.0**-24


def test_host_truth_equals_jax_host(ragged):
    docs, queries = ragged
    want = jsyn.exact_maxsim_topk(docs, queries, top_k=12, device=False)
    for dev in ("cpu", False):
        got = tsyn.exact_maxsim_topk(docs, queries, top_k=12, device=dev)
        assert [[p for p, _ in r] for r in got] == [[p for p, _ in r] for r in want]
        np.testing.assert_allclose([[s for _, s in r] for r in got],
                                   [[s for _, s in r] for r in want], rtol=0, atol=1e-6)


@pytest.mark.parametrize("doc_block,q_block", [(256, 64), (8, 3), (1, 1)])
def test_blocked_truth_matches_jax_device_and_host(ragged, doc_block, q_block):
    docs, queries = ragged
    jax_dev = jsyn._exact_maxsim_topk_device(docs, queries, 37, doc_block=16, q_block=4)
    got = tsyn._exact_maxsim_topk_blocked(docs, queries, 37, torch.device("cpu"),
                                          doc_block=doc_block, q_block=q_block)
    _assert_same_topk(got, jax_dev, _order_tol(docs, queries))
    host = tsyn.exact_maxsim_topk(docs, queries, top_k=37, device="cpu")
    tol = tsyn.bf16_score_tolerance(docs, queries)
    assert 0.0625 < tol < 0.063  # 16 unit-norm query tokens: 16 * (2^-8 + ...)
    _assert_same_topk(got, host, tol)
    assert got[0][-1][1] != 0.0 and len(got[0]) == 37


def test_blocked_truth_public_entry(ragged):
    docs, queries = ragged
    a = tsyn.exact_maxsim_topk(docs, queries, top_k=5, device=torch.device("cpu"))
    b = tsyn._exact_maxsim_topk_blocked(docs, queries, 5, torch.device("cpu"))
    assert a == b and all(len(r) == 5 for r in a)
    assert len(tsyn.exact_maxsim_topk(docs[:3], queries, top_k=10,
                                      device=torch.device("cpu"))[0]) == 3


def test_truth_on_the_card_by_default(ragged):
    """device=None (and True) mean the CUDA card; there is none here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    docs, queries = ragged
    for dev in (None, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            tsyn.exact_maxsim_topk(docs, queries, top_k=5, device=dev)
