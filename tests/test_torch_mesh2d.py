"""2-D (replica x shard) mesh search: the port against its 1-D path and
against fast_plaid_tpu.

Mirrors ``tests/test_mesh2d.py`` on the port's mesh of ``torch.device``
slots, over a sharded streaming index built with the JAX package's trained
codec; then a 2 x 2 mesh of both packages over the same 2-shard build: ids
equal except at score ties, scores within atol 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from fast_plaid_tpu import testing
from fast_plaid_tpu.index import streaming as jstream
from fast_plaid_tpu.parallel import mesh2d as jmesh2d
from fast_plaid_tpu_torch import parallel
from fast_plaid_tpu_torch.index import device_build as tdb
from fast_plaid_tpu_torch.index import streaming as tstream
from fast_plaid_tpu_torch.parallel import sharded_search
from fast_plaid_tpu_torch.parallel.mesh2d import (
    make_mesh_2d,
    replicate_sharded_index,
    sharded_search_2d,
)

torch.set_num_threads(2)

DIM = 32
TOL = 1e-4
CPU = torch.device("cpu")


def np_out(out):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in out)


def assert_same_topk(ids_a, sc_a, ids_b, sc_b, tol=TOL):
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=tol)
    for ia, sa, ib, sb in zip(ids_a, sc_a, ids_b, sc_b):
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids.tolist()):
                if pid not in other.tolist():
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(9)
    n_docs = 300
    lens = rng.integers(8, 17, n_docs).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    flat = rng.standard_normal((int(lens.sum()), DIM)).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=-1, keepdims=True)
    flat_j, flat_t = jnp.asarray(flat), torch.from_numpy(flat)

    def jgen(a, b):
        return flat_j[int(starts[a]) : int(starts[b])]

    def tgen(a, b):
        return flat_t[int(starts[a]) : int(starts[b])]

    cent, params, _ = jstream.train_global_codec(jgen, lens, nbits=4, k=128)
    codec = tdb.DeviceCodec(
        bucket_cutoffs=torch.from_numpy(np.array(params.bucket_cutoffs)),
        bucket_weights=torch.from_numpy(np.array(params.bucket_weights)),
    )
    kw = dict(nbits=4, centroids=torch.from_numpy(np.array(cent)), codec_params=codec,
              chunk_docs=64)
    sharded = tstream.build_sharded_index_streaming(
        tgen, lens, parallel.make_mesh(devices=[CPU] * 4), **kw
    )
    return dict(sharded=sharded, lens=lens, jgen=jgen, tgen=tgen, cent=cent, params=params,
                kw=kw)


def test_2d_matches_1d(built):
    sharded, lens = built["sharded"], built["lens"]
    rep = replicate_sharded_index(sharded, make_mesh_2d(2, 4, [CPU] * 8))
    queries = testing.random_queries(np.random.default_rng(1), 6, 6, DIM)
    k = sharded.ispec.n_partitions
    kw = dict(top_k=5, n_ivf_probe=k, n_full_scores=2 * len(lens))
    p1, s1 = np_out(sharded_search(sharded, queries, **kw))
    p2, s2 = np_out(sharded_search_2d(rep, queries, **kw))
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-5)


def test_2d_pads_odd_batches(built):
    rep = replicate_sharded_index(built["sharded"], make_mesh_2d(2, 4, [CPU] * 8))
    queries = testing.random_queries(np.random.default_rng(2), 5, 6, DIM)  # 5 % 2 != 0
    p, _ = np_out(sharded_search_2d(rep, queries, top_k=3))
    assert p.shape == (5, 3)
    assert (p[:, 0] >= 0).all()


def test_mesh_validation(built):
    with pytest.raises(ValueError, match="need"):
        make_mesh_2d(4, 4, [CPU] * 8)
    with pytest.raises(ValueError, match="slots for 4 shards"):
        replicate_sharded_index(built["sharded"], make_mesh_2d(2, 2, [CPU] * 4))


def test_2d_subset_and_tokens_match_1d(built):
    """Subsets and token scores on the (r, d) mesh agree with the 1-D path
    over the same sharded index."""
    sharded, lens = built["sharded"], built["lens"]
    rng = np.random.default_rng(11)
    queries = rng.standard_normal((4, 6, DIM)).astype(np.float32)
    subsets = [sorted(rng.choice(len(lens), 40, replace=False).tolist()) for _ in range(4)]
    rep = replicate_sharded_index(sharded, make_mesh_2d(2, 4, [CPU] * 8))
    out2 = sharded_search_2d(rep, queries, top_k=3, subset=subsets, want_tokens=True,
                             with_stats=True)
    assert len(out2) == 5
    p2, s2, t2, l2, st2 = np_out(out2)
    assert st2.shape == (4, 2)
    p1, s1, t1, l1 = np_out(sharded_search(sharded, queries, top_k=3, subset=subsets,
                                           want_tokens=True))
    for b in range(4):
        assert {int(p) for p in p2[b] if p >= 0} <= set(subsets[b])
        if p1[b, 0] >= 0:
            assert p2[b, 0] == p1[b, 0]
            np.testing.assert_allclose(s2[b, 0], s1[b, 0], rtol=1e-5)
            dlen = int(l2[b, 0])
            assert dlen == int(l1[b, 0])
            np.testing.assert_allclose(t2[b, 0, :dlen], t1[b, 0, :dlen], rtol=1e-4, atol=1e-5)


def test_2x2_matches_jax(built):
    """One 2-shard streaming build in each package, laid on a 2 x 2 mesh:
    the same results, with subsets, token scores and stats."""
    lens = built["lens"]
    jsh = jstream.build_sharded_index_streaming(
        built["jgen"], lens, JMesh(np.array(jax.devices("cpu")[:2]), ("d",)), nbits=4,
        centroids=built["cent"], codec_params=built["params"], chunk_docs=64,
    )
    tsh = tstream.build_sharded_index_streaming(
        built["tgen"], lens, parallel.make_mesh(devices=[CPU] * 2), **built["kw"]
    )
    jrep = jmesh2d.replicate_sharded_index(jsh, jmesh2d.make_mesh_2d(2, 2, jax.devices("cpu")[:4]))
    trep = replicate_sharded_index(tsh, make_mesh_2d(2, 2, [CPU] * 4))
    rng = np.random.default_rng(12)
    queries = rng.standard_normal((5, 6, DIM)).astype(np.float32)
    subsets = [sorted(rng.choice(len(lens), 60, replace=False).tolist()) for _ in range(5)]
    for kw in (dict(top_k=5), dict(top_k=3, subset=subsets, want_tokens=True, with_stats=True)):
        got = np_out(sharded_search_2d(trep, queries, **kw))
        want = np_out(jmesh2d.sharded_search_2d(jrep, queries, **kw))
        assert len(got) == len(want)
        assert_same_topk(got[0], got[1], want[0], want[1])
        if "want_tokens" in kw:
            both = got[0] == want[0]
            np.testing.assert_array_equal(got[3][both], want[3][both])
            np.testing.assert_allclose(got[2][both], want[2][both], rtol=0, atol=TOL)
            np.testing.assert_array_equal(got[4], want[4])
