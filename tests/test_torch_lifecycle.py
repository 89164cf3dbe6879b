"""The mutable index in the port: update, delete, reload, concurrency.

The cases of ``tests/test_update_delete.py`` and ``tests/test_concurrency.py``
run against ``fast_plaid_tpu_torch``. Then one update / delete sequence on
two copies of one index, with the same ``compute_kmeans`` injected into both
packages' update modules (their k-means re-seeds empty clusters from
different generators), must leave the same files in both: every ``.npy``
equal, ``metadata.json`` equal with ``cluster_threshold`` within 1e-6, and
both packages must then search the result alike (scores atol 1e-4, ids equal
except for ties).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu.search import update as jupdate
from fast_plaid_tpu.testing import random_documents, random_queries
from fast_plaid_tpu_torch import filtering as tfilt
from fast_plaid_tpu_torch import search as tsearch
from fast_plaid_tpu_torch.index import ivf as tivf
from fast_plaid_tpu_torch.index import storage
from fast_plaid_tpu_torch.index.appender import update_index
from fast_plaid_tpu_torch.search import update as tupdate
from fast_plaid_tpu_torch.utils.locking import FileLock

torch.set_num_threads(2)

DIM = 32
TOL = 1e-4


def _docs(seed, n, ln=12, dim=DIM):
    return random_documents(np.random.default_rng(seed), n, ln, dim)


def _queries(seed, n=2, ln=5):
    return random_queries(np.random.default_rng(seed), n, ln, DIM)


def _engine(path):
    return tsearch.FastPlaid(index=path, device="cpu")


def _meta(path):
    return storage.load_metadata(path)


def _assert_same_npy(a: str, b: str) -> None:
    """Equal arrays; object arrays (embeddings.npy, buffer.npy) element-wise."""
    x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert x.dtype == y.dtype and x.shape == y.shape, a
    if x.dtype == object:
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v, err_msg=a)
    else:
        np.testing.assert_array_equal(x, y, err_msg=a)


# ---------------------------------------------------------------------------
# tests/test_update_delete.py, against the port
# ---------------------------------------------------------------------------


def test_update_grows_ids(test_index_path):
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(0, 20))
    eng.update(documents_embeddings=_docs(1, 10))
    assert _meta(test_index_path)["num_documents"] == 30
    results = eng.search(_queries(2), top_k=30, show_progress=False)
    assert max(p for row in results for p, _ in row) < 30


def test_update_searchable_immediately(test_index_path):
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(3, 30))
    new_docs = _docs(4, 5)
    eng.update(documents_embeddings=new_docs, start_from_scratch=0)
    res = eng.search(new_docs[2][None], top_k=3, show_progress=False)
    assert res[0][0][0] == 32


def test_update_creates_when_missing(test_index_path):
    eng = _engine(test_index_path)
    eng.update(documents_embeddings=_docs(5, 15))
    assert _meta(test_index_path)["num_documents"] == 15


def test_small_index_rebuild_path(test_index_path):
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(6, 10), start_from_scratch=1000)
    assert os.path.exists(os.path.join(test_index_path, "embeddings.npy"))
    eng.update(documents_embeddings=_docs(7, 10), start_from_scratch=999)
    assert _meta(test_index_path)["num_documents"] == 20


def test_buffer_trip_expands_centroids(test_index_path):
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(8, 30), start_from_scratch=0)
    k0 = _meta(test_index_path)["num_partitions"]
    eng.update(documents_embeddings=_docs(9, 3), start_from_scratch=0, buffer_size=10)
    assert os.path.exists(os.path.join(test_index_path, "buffer.npy"))
    assert _meta(test_index_path)["num_documents"] == 33
    eng.update(documents_embeddings=_docs(10, 12), start_from_scratch=0, buffer_size=10)
    assert not os.path.exists(os.path.join(test_index_path, "buffer.npy"))
    meta = _meta(test_index_path)
    assert meta["num_documents"] == 45
    assert meta["num_partitions"] >= k0
    loaded = eng.indices["cpu"]
    assert loaded.ispec.n_docs == 45 and loaded.ispec.n_partitions == meta["num_partitions"]


def test_update_delete_update_with_metadata(test_index_path):
    """The phantom-buffer regression: buffered docs deleted, then more added."""
    eng = _engine(test_index_path)
    eng.create(
        documents_embeddings=_docs(11, 20),
        metadata=[{"tag": f"c{i}"} for i in range(20)],
        start_from_scratch=0,
    )
    eng.update(
        documents_embeddings=_docs(12, 5),
        metadata=[{"tag": f"u{i}"} for i in range(5)],
        start_from_scratch=0,
        buffer_size=100,
    )
    assert _meta(test_index_path)["num_documents"] == 25
    eng.delete(subset=[20, 21])
    assert _meta(test_index_path)["num_documents"] == 23
    assert len(storage.load_object_npy(os.path.join(test_index_path, "buffer.npy"))) == 3
    eng.update(
        documents_embeddings=_docs(13, 4),
        metadata=[{"tag": f"v{i}"} for i in range(4)],
        start_from_scratch=0,
        buffer_size=100,
    )
    assert _meta(test_index_path)["num_documents"] == 27
    rows = tfilt.get(index=test_index_path)
    assert len(rows) == 27
    assert [r["tag"] for r in rows[18:]] == ["c18", "c19", "u2", "u3", "u4", "v0", "v1", "v2", "v3"]


def test_delete_resequences_ids(test_index_path):
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(20, 25))
    eng.delete(subset=[0, 5, 10])
    assert _meta(test_index_path)["num_documents"] == 22
    results = eng.search(_queries(21), top_k=25, show_progress=False)
    assert all(0 <= p < 22 for row in results for p, _ in row)


def test_delete_shifts_content(test_index_path):
    eng = _engine(test_index_path)
    docs = _docs(22, 15)
    eng.create(documents_embeddings=docs)
    eng.delete(subset=[0])
    res = eng.search(docs[1][None], top_k=1, show_progress=False)
    assert res[0][0][0] == 0
    # embeddings.npy lost the deleted row
    stored = storage.load_object_npy(os.path.join(test_index_path, "embeddings.npy"))
    assert len(stored) == 14
    np.testing.assert_array_equal(stored[0], docs[1])


def test_delete_multiple_rounds(test_index_path):
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(23, 20))
    eng.delete(subset=[0, 1])
    eng.delete(subset=[0])
    assert _meta(test_index_path)["num_documents"] == 17


def test_splice_matches_rebuild():
    rng = np.random.default_rng(5)
    k = 37
    old_codes = rng.integers(0, k, 400).astype(np.int32)
    old_lens = rng.integers(3, 9, 60).astype(np.int64)
    old_lens[-1] += 400 - old_lens.sum()
    new_codes = rng.integers(0, k, 150).astype(np.int32)
    new_lens = rng.integers(3, 9, 22).astype(np.int64)
    new_lens[-1] += 150 - new_lens.sum()
    assert old_lens.sum() == 400 and new_lens.sum() == 150
    assert (old_lens > 0).all() and (new_lens > 0).all()
    old_ivf, old_l = tivf.build_ivf(old_codes, old_lens, k)
    spliced, spliced_l = tivf.splice_ivf(old_ivf, old_l, new_codes, new_lens, len(old_lens))
    full, full_l = tivf.build_ivf(
        np.concatenate([old_codes, new_codes]), np.concatenate([old_lens, new_lens]), k
    )
    np.testing.assert_array_equal(spliced_l, full_l)
    np.testing.assert_array_equal(spliced, full)


def test_splice_empty_new():
    old_ivf, old_l = tivf.build_ivf(
        np.array([0, 1, 2, 1], np.int32), np.array([2, 2], np.int64), 4
    )
    s, sl = tivf.splice_ivf(
        old_ivf, old_l, np.zeros((0,), np.int32), np.zeros((0,), np.int64), 2
    )
    assert (s == old_ivf).all() and (sl == old_l).all()


def test_update_index_streams_a_generator(tmp_path):
    """A generator input, consumed in batch_size blocks, writes the same files
    as the list input."""
    docs = _docs(30, 40)
    paths = []
    for name, make in (("list", lambda: list(docs[20:])), ("gen", lambda: iter(docs[20:]))):
        path = str(tmp_path / name)
        _engine(path).create(documents_embeddings=docs[:20])
        update_index(path, make(), batch_size=6)
        paths.append(path)
    a, b = paths
    assert _meta(a) == _meta(b) and _meta(a)["num_documents"] == 40
    for name in sorted(os.listdir(a)):
        if name.endswith(".npy") and not name.startswith("merged_"):
            _assert_same_npy(os.path.join(a, name), os.path.join(b, name))


# ---------------------------------------------------------------------------
# tests/test_concurrency.py, against the port
# ---------------------------------------------------------------------------


def test_second_instance_sees_updates(test_index_path):
    rng = np.random.default_rng(0)
    eng_a = _engine(test_index_path)
    eng_a.create(documents_embeddings=random_documents(rng, 20, 10, DIM))
    eng_b = _engine(test_index_path)
    q = random_queries(rng, 1, 4, DIM)
    res = eng_b.search(q, top_k=30, show_progress=False)
    assert all(p < 20 for p, _ in res[0])
    eng_a.update(
        documents_embeddings=random_documents(rng, 10, 10, DIM), start_from_scratch=0
    )
    res = eng_b.search(q, top_k=40, show_progress=False)
    assert len(res[0]) > 0
    assert eng_b.indices["cpu"].ispec.n_docs == 30


def test_search_proceeds_when_lock_held(test_index_path):
    rng = np.random.default_rng(1)
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=random_documents(rng, 15, 8, DIM))
    other = FileLock(os.path.join(test_index_path, "plaid.lock"))
    other.acquire()
    try:
        os.utime(os.path.join(test_index_path, "metadata.json"))
        res = eng.search(random_queries(rng, 1, 4, DIM), top_k=5, show_progress=False)
        assert len(res[0]) > 0
    finally:
        other.release()


def test_search_during_update_on_the_same_instance(test_index_path):
    """An update frees the device index before reloading it; searches on
    other threads meanwhile wait for the reload or use the old index, and
    always return results."""
    eng = _engine(test_index_path)
    eng.create(documents_embeddings=_docs(40, 30), start_from_scratch=0)
    reloading = threading.Event()
    real_reload = eng._reload

    def slow_reload():
        reloading.set()
        time.sleep(0.3)
        return real_reload()

    eng._reload = slow_reload
    errors: list = []

    def run_update():
        try:
            eng.update(documents_embeddings=_docs(41, 5), start_from_scratch=0)
        except Exception as exc:  # surfaced by the assertion below
            errors.append(exc)

    worker = threading.Thread(target=run_update)
    worker.start()
    assert reloading.wait(timeout=30)
    n_searches = 0
    while worker.is_alive() or n_searches == 0:
        res = eng.search(_queries(42), top_k=5, show_progress=False)
        assert len(res) == 2 and all(len(r) == 5 for r in res)
        n_searches += 1
    worker.join(timeout=30)
    assert not worker.is_alive() and not errors, errors
    assert eng.indices["cpu"].ispec.n_docs == 35
    assert eng.get_embeddings([34])[0].shape == (12, DIM)


# ---------------------------------------------------------------------------
# One sequence through both packages: identical files
# ---------------------------------------------------------------------------


def _fixed_kmeans(documents_embeddings, num_partitions=None, **_):
    """A deterministic stand-in for compute_kmeans: evenly spaced points,
    normalized."""
    flat = np.concatenate([np.asarray(d, np.float32) for d in documents_embeddings])
    k = min(num_partitions, flat.shape[0])
    pick = flat[np.linspace(0, flat.shape[0] - 1, k).astype(np.int64)]
    return pick / np.linalg.norm(pick, axis=-1, keepdims=True)


def _run_sequence(make, path):
    eng = make(index=path, device="cpu")
    eng.update(documents_embeddings=_docs(51, 4, ln=14), metadata=[{"g": 1}] * 4,
               start_from_scratch=0, buffer_size=10)
    eng.delete(subset=[3, 70, 81])
    eng.update(documents_embeddings=_docs(52, 9, ln=14), metadata=[{"g": 2}] * 9,
               start_from_scratch=0, buffer_size=10)
    eng.delete(subset=[0, 1, 40])
    eng.close()


def test_update_delete_sequence_files_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jupdate, "compute_kmeans", _fixed_kmeans)
    monkeypatch.setattr(tupdate, "compute_kmeans", _fixed_kmeans)
    base = str(tmp_path / "base")
    docs = random_documents(np.random.default_rng(50), 90, 14, DIM, variable=True)
    jsearch.FastPlaid(index=base, device="cpu").create(
        documents_embeddings=docs, metadata=[{"g": 0}] * 90, batch_size=40
    )
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(base, pj)
    shutil.copytree(base, pt)
    k0 = _meta(base)["num_partitions"]
    _run_sequence(jsearch.FastPlaid, pj)
    _run_sequence(tsearch.FastPlaid, pt)

    meta_j, meta_t = _meta(pj), _meta(pt)
    assert meta_t == meta_j
    assert meta_t["num_documents"] == 90 + 4 + 9 - 6 and meta_t["num_partitions"] > k0
    names = sorted(
        n for n in os.listdir(pj)
        if not n.startswith("merged_") and n not in ("plaid.lock", "metadata.db")
    )
    assert names == sorted(
        n for n in os.listdir(pt)
        if not n.startswith("merged_") and n not in ("plaid.lock", "metadata.db")
    )
    for name in names:
        a, b = os.path.join(pj, name), os.path.join(pt, name)
        if name == "cluster_threshold.npy":
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0, atol=1e-6)
        elif name.endswith(".npy"):
            _assert_same_npy(b, a)
        elif name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fb) == json.load(fa), name
    assert tfilt.get(index=pt) == tfilt.get(index=pj)

    queries = random_queries(np.random.default_rng(53), 5, 6, DIM)
    planted = [docs[5][:8], docs[60][:8]]  # ids 2 and 56 after the deletes
    queries = [*queries, *planted]
    kw = dict(top_k=5, show_progress=False)
    rt = tsearch.FastPlaid(index=pt, device="cpu").search(queries, **kw)
    rj = jsearch.FastPlaid(index=pj, device="cpu").search(queries, **kw)
    for a, b in zip(rt, rj):
        sa, sb = np.asarray([s for _, s in a]), np.asarray([s for _, s in b])
        np.testing.assert_allclose(sa, sb, rtol=0, atol=TOL)
        for (pid, sc) in a:
            if pid not in [p for p, _ in b]:
                assert abs(sc - sa[-1]) <= TOL
    assert [rt[-2][0][0], rt[-1][0][0]] == [2, 56]


@pytest.mark.parametrize("dim", [32, 64])
def test_min_dists_sq_matches_jax(dim):
    rng = np.random.default_rng(dim)
    flat = rng.standard_normal((700, dim)).astype(np.float32)
    cent = rng.standard_normal((90, dim)).astype(np.float32)
    got = tupdate._min_dists_sq(flat, cent, block=256)
    want = jupdate._min_dists_sq(flat, cent, block=256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
