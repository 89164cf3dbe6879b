"""FastPlaid parity: the PyTorch port against the JAX package on the CPU.

The on-disk index is shared (``layout_version: 1``): an index created by the
JAX ``FastPlaid`` is searched by the port and the reverse, and both give the
same results (ids equal except for score ties at the boundary, scores
atol 1e-4).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu import testing
from fast_plaid_tpu.index import builder as jbuilder
from fast_plaid_tpu_torch import search as tsearch
from fast_plaid_tpu_torch.index import builder as tbuilder
from fast_plaid_tpu_torch.search.searcher import last_search_stats

torch.set_num_threads(2)

DIM = 128
TOL = 1e-4


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    docs = testing.random_documents(rng, 150, 32, DIM, variable=True)
    queries = testing.random_queries(rng, 5, 8, DIM)
    planted = np.stack([docs[i][:8] for i in (0, 42, 149)])
    return docs, np.concatenate([queries, planted]).astype(np.float32)


def _as_arrays(results):
    ids = np.asarray([[p for p, _ in r] for r in results])
    scores = np.asarray([[s for _, s in r] for r in results])
    return ids, scores


def assert_same_results(a, b):
    ids_a, sc_a = _as_arrays(a)
    ids_b, sc_b = _as_arrays(b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=TOL)
    for ia, sa, ib in zip(ids_a, sc_a, ids_b):
        for j, pid in enumerate(ia.tolist()):
            if pid not in ib.tolist():
                assert abs(sa[j] - sa[-1]) <= TOL


def _search(engine, queries):
    return engine.search(queries, top_k=5, show_progress=False)


def test_create_and_search(tmp_path, corpus):
    docs, queries = corpus
    fp = tsearch.FastPlaid(index=str(tmp_path / "idx"), device="cpu")
    fp.create(documents_embeddings=docs)
    results = _search(fp, queries)
    assert len(results) == len(queries) and all(len(r) == 5 for r in results)
    assert [r[0][0] for r in results[-3:]] == [0, 42, 149]
    stats = last_search_stats()
    assert stats["queries"] == len(queries) and stats["approx_mode"] in ("cells", "cells_full")
    scores = np.asarray([[s for _, s in r] for r in results])
    assert np.isfinite(scores).all() and (np.diff(scores, axis=1) <= 0).all()


@pytest.mark.parametrize("creator", ["jax", "torch"])
def test_cross_load(tmp_path, corpus, creator):
    """An index created by one package is searched by both, alike."""
    docs, queries = corpus
    path = str(tmp_path / f"idx_{creator}")
    make = jsearch.FastPlaid if creator == "jax" else tsearch.FastPlaid
    make(index=path, device="cpu").create(documents_embeddings=docs)
    rj = _search(jsearch.FastPlaid(index=path, device="cpu"), queries)
    rt = _search(tsearch.FastPlaid(index=path, device="cpu"), queries)
    assert_same_results(rt, rj)
    assert [r[0][0] for r in rt[-3:]] == [0, 42, 149]


def test_create_index_files_match(tmp_path, corpus):
    """From the same centroids both builders write the same files: codes equal
    (the corpus has no near-ties), residual bytes and IVF identical."""
    docs, _ = corpus
    flat = np.concatenate(docs)
    cent = testing.train_kmeans(flat, k=64, niters=2, seed=0)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jbuilder.create_index(pj, docs, cent, nbits=4, batch_size=60, seed=3)
    tbuilder.create_index(pt, docs, cent, nbits=4, batch_size=60, seed=3)
    names = sorted(os.listdir(pj))
    assert names == sorted(os.listdir(pt))
    for name in names:
        a, b = os.path.join(pj, name), os.path.join(pt, name)
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=name)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


@pytest.fixture
def twins(tmp_path, corpus):
    """One index created with metadata by the port, and a copy of it for the
    JAX package (two builds train different k-means)."""
    import shutil

    docs, _ = corpus
    meta = [{"cat": i % 3, "name": f"d{i}"} for i in range(40)]
    pt, pj = str(tmp_path / "torch"), str(tmp_path / "jax")
    ft = tsearch.FastPlaid(index=pt, device="cpu").create(docs[:40], metadata=meta)
    shutil.copytree(pt, pj)
    return {"jax": (pj, jsearch.FastPlaid(index=pj, device="cpu")), "torch": (pt, ft), "meta": meta}


@pytest.mark.parametrize(
    "call",
    ["create_metadata", "search_subset", "search_token_scores", "get_embeddings", "update", "delete"],
)
def test_mutable_entry_points_match_jax(twins, corpus, call):
    """The six entry points the port once refused now run and match the JAX
    package on the same index."""
    from fast_plaid_tpu import filtering as jfilt
    from fast_plaid_tpu_torch import filtering as tfilt

    docs, queries = corpus
    (pj, fj), (pt, ft) = twins["jax"], twins["torch"]
    if call == "create_metadata":
        pk = os.path.join(os.path.dirname(pt), "jax_created")
        jsearch.FastPlaid(index=pk, device="cpu").create(docs[:40], metadata=twins["meta"])
        assert tfilt.get(index=pt) == jfilt.get(index=pk) == jfilt.get(index=pj)
        assert_same_results(_search(ft, queries), _search(fj, queries))
    elif call == "search_subset":
        ids = tfilt.where(pt, "cat = ?", (1,))
        assert ids == jfilt.where(pj, "cat = ?", (1,)) == list(range(1, 40, 3))
        rt = ft.search(queries, top_k=5, subset=ids, show_progress=False)
        assert_same_results(rt, fj.search(queries, top_k=5, subset=ids, show_progress=False))
        assert all({p for p, _ in r} <= set(ids) for r in rt)
    elif call == "search_token_scores":
        rt = ft.search_token_scores(queries, top_k=5, show_progress=False)
        rj = fj.search_token_scores(queries, top_k=5, show_progress=False)
        assert_same_results([[(p, s) for p, s, _ in r] for r in rt],
                            [[(p, s) for p, s, _ in r] for r in rj])
        for row_t, row_j in zip(rt, rj):
            mats = {p: m for p, _, m in row_j}
            for p, _, m in row_t:
                if p in mats:
                    np.testing.assert_allclose(m, mats[p], rtol=0, atol=TOL)
    elif call == "get_embeddings":
        ids = [0, 39, 17, 17]
        for a, b in zip(ft.get_embeddings(ids), fj.get_embeddings(ids)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    elif call == "update":
        new = docs[40:46]
        meta = [{"cat": 7}] * 6
        ft.update(new, metadata=meta, start_from_scratch=0)
        fj.update(new, metadata=meta, start_from_scratch=0)
        assert tfilt.where(pt, "cat = 7") == jfilt.where(pj, "cat = 7") == list(range(40, 46))
        rt = _search(ft, queries)
        assert_same_results(rt, _search(fj, queries))
        assert _search(ft, docs[44][None, :8])[0][0][0] == 44
    else:
        ft.delete([0, 7, 21])
        fj.delete([0, 7, 21])
        assert tfilt.get(index=pt) == jfilt.get(index=pj)
        assert len(tfilt.get(index=pt)) == 37
        assert_same_results(_search(ft, queries), _search(fj, queries))
        assert _search(ft, docs[22][None, :8])[0][0][0] == 19


def test_resolve_devices():
    assert tsearch.resolve_devices("cpu") == [torch.device("cpu")]
    assert tsearch.resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")]
    with pytest.raises(RuntimeError):
        tsearch.resolve_devices("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsearch.resolve_devices(None)
        with pytest.raises(RuntimeError):
            tsearch.resolve_devices("cuda:0")
