"""Per-shard low_memory: the port's ``load_sharded_lm`` against
fast_plaid_tpu's over one index directory written by the JAX package.

Mirrors ``tests/test_lm_sharded.py`` on a mesh of ``[cpu] * n`` (low_memory
is off on CPU devices, as in the JAX package). The merge is an exact host
top-k of the shards' codec-exact scores, so exhaustive parameters
reproduce the single-device results; both packages' merged lists agree
(ids except at score ties, scores within atol 1e-4).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from fast_plaid_tpu import parallel as jpar
from fast_plaid_tpu.search import FastPlaid as JFastPlaid
from fast_plaid_tpu_torch.parallel import load_sharded_lm
from fast_plaid_tpu_torch.parallel.lm_sharded import shard_index_data
from fast_plaid_tpu_torch.index.storage import load_index_data
from fast_plaid_tpu_torch.search import FastPlaid
from fast_plaid_tpu_torch.search.load import reload_index
from fast_plaid_tpu_torch.search.searcher import search_on_device

torch.set_num_threads(2)

N_DOCS, DIM = 210, 64  # 210 docs over 4 shards: an uneven last shard
TOL = 1e-4
CPU = torch.device("cpu")


def as_arrays(rows):
    return (np.asarray([[p for p, _ in r] for r in rows]),
            np.asarray([[s for _, s in r] for r in rows]))


def assert_same_rows(got, want, tol=TOL):
    """Per query: scores agree position-wise, ids except where a document
    only one list holds ties the last score."""
    for g, w in zip(got, want):
        assert len(g) == len(w)
        (gi,), (gs,) = (np.asarray(x) for x in as_arrays([g]))
        (wi,), (ws,) = (np.asarray(x) for x in as_arrays([w]))
        np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
        for ids, sc, other in ((gi, gs, wi), (wi, ws, gi)):
            for j, pid in enumerate(ids.tolist()):
                if pid not in other.tolist():
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


@pytest.fixture(scope="module")
def disk_index(tmp_path_factory):
    rng = np.random.default_rng(4)
    docs = [
        np.asarray(rng.standard_normal((int(rng.integers(8, 30)), DIM)), np.float32)
        for _ in range(N_DOCS)
    ]
    path = str(tmp_path_factory.mktemp("tlmsh") / "idx")
    JFastPlaid(index=path, device="cpu").create(documents_embeddings=docs, show_progress=False)
    rng_q = np.random.default_rng(9)
    queries = [np.asarray(rng_q.standard_normal((12, DIM)), np.float32) for _ in range(6)]
    return path, queries


def test_exhaustive_matches_single_device_and_jax(disk_index):
    path, queries = disk_index
    sharded = load_sharded_lm(path, [CPU] * 4)
    assert sharded.n_docs_total == N_DOCS
    assert sharded.doc_base == [0, 53, 106, 159]
    kwargs = dict(top_k=8, n_full_scores=2 * N_DOCS, n_ivf_probe=10**6)  # brute force
    got = sharded.search(queries, **kwargs)
    single = reload_index(path, [CPU])[str(CPU)]
    want = search_on_device(single, queries, subsets=None, want_tokens=False,
                            show_progress=False, **kwargs)
    for g, w in zip(got, want):
        assert [p for p, _ in g] == [p for p, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5)
    jgot = jpar.load_sharded_lm(path, jax.devices("cpu")[:4]).search(queries, **kwargs)
    assert_same_rows(got, jgot)


def test_default_params_find_planted(disk_index):
    """Near-copies of documents in different shards (the short last one
    included) come back first with default-like parameters, as in the JAX
    package."""
    path, _ = disk_index
    sharded = load_sharded_lm(path, [CPU] * 4)
    targets = [3, 60, 120, 205]
    embs = FastPlaid(index=path, device="cpu").get_embeddings(targets)
    rng = np.random.default_rng(1)
    probes = []
    for e in embs:
        src = rng.integers(0, len(e), 12)
        q = e[src] + 0.01 * rng.standard_normal((12, e.shape[1])).astype(np.float32)
        probes.append(q.astype(np.float32))
    kw = dict(top_k=3, n_full_scores=128, n_ivf_probe=8)
    res = sharded.search(probes, **kw)
    for t, row in zip(targets, res):
        assert row[0][0] == t, (t, row)
    jres = jpar.load_sharded_lm(path, jax.devices("cpu")[:4]).search(probes, **kw)
    assert_same_rows(res, jres)


def test_more_shards_than_docs_ok(tmp_path):
    rng = np.random.default_rng(0)
    docs = [np.asarray(rng.standard_normal((10, DIM)), np.float32) for _ in range(3)]
    path = str(tmp_path / "tiny")
    JFastPlaid(index=path, device="cpu").create(documents_embeddings=docs, show_progress=False)
    sharded = load_sharded_lm(path, [CPU] * 8)
    assert sum(ld is not None for ld in sharded.shards) <= 3
    kw = dict(top_k=2, n_full_scores=6, n_ivf_probe=64)
    res = sharded.search([np.asarray(docs[2][:6], np.float32)], **kw)
    assert res[0][0][0] == 2
    jres = jpar.load_sharded_lm(path, jax.devices("cpu")[:8]).search(
        [np.asarray(docs[2][:6], np.float32)], **kw
    )
    assert_same_rows(res, jres)


def test_shard_index_data_slices_views(disk_index):
    """Shards are contiguous views of the index arrays with local IVFs."""
    path, _ = disk_index
    data = load_index_data(path)
    parts = shard_index_data(data, 4)
    assert [len(p.doc_lengths) for p in parts] == [53, 53, 53, 51]
    assert sum(int(p.codes.shape[0]) for p in parts) == int(data.codes.shape[0])
    for p in parts:
        assert np.shares_memory(p.residuals, data.residuals)
        assert int(p.ivf_lengths.sum()) == len(p.ivf)
        assert p.ivf.max() < len(p.doc_lengths)
