"""The sharded streaming build: the port against its single-device build and
against fast_plaid_tpu.

Mirrors the two sharded tests of ``tests/test_streaming.py`` (marked slow
there; the port's build is small enough here) on a mesh of ``[cpu] * 8``,
then one build of each package from the JAX package's trained codec: every
shard tensor equal (IVF cells equal as sets, pids ascending in the port's),
and search results equal except at score ties (scores atol 1e-4). Also the
aligned IVF padding those builds need (``layout.aligned_ivf_len``,
``align_ivf_device(pad_ivf_to=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from fast_plaid_tpu import testing
from fast_plaid_tpu.index import layout as jlayout
from fast_plaid_tpu.index import streaming as jstream
from fast_plaid_tpu.parallel.sharded import sharded_search as jsharded_search
from fast_plaid_tpu_torch import parallel
from fast_plaid_tpu_torch.index import device_build as tdb
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.index import streaming as tstream
from fast_plaid_tpu_torch.search import engine as tengine

torch.set_num_threads(2)

DIM = 48
TOL = 1e-4
CPU = torch.device("cpu")


def make_corpus(n_docs=500, base_len=24, dim=DIM, seed=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(base_len // 2, base_len + 1, n_docs).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    flat = rng.standard_normal((int(lens.sum()), dim)).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=-1, keepdims=True)
    flat_t = torch.from_numpy(flat)

    def chunk_gen(d0, d1):
        return flat_t[starts[d0] : starts[d1]]

    return chunk_gen, lens, flat, starts


def mesh(n):
    return parallel.make_mesh(devices=[CPU] * n)


def np_out(out):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in out)


def assert_same_topk(ids_a, sc_a, ids_b, sc_b, tol=TOL):
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=tol)
    for ia, sa, ib, sb in zip(ids_a, sc_a, ids_b, sc_b):
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids.tolist()):
                if pid not in other.tolist():
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


def test_sharded_matches_single_device():
    """Exhaustive parameters on both sides: every document exact-scored, so
    the merged shard results equal the single-device streaming results."""
    chunk_gen, lens, _, _ = make_corpus()
    cent, params, k = tstream.train_global_codec(chunk_gen, lens, nbits=4, k=256, seed=9)
    kw = dict(nbits=4, centroids=cent, codec_params=params)
    sharded = tstream.build_sharded_index_streaming(chunk_gen, lens, mesh(8), chunk_docs=50, **kw)
    dev, ispec = tstream.build_memory_index_streaming(chunk_gen, lens, **kw)
    queries = testing.random_queries(np.random.default_rng(4), 8, 8, DIM)
    n = len(lens)
    sp, ss = np_out(parallel.sharded_search(sharded, queries, top_k=10, n_ivf_probe=k,
                                            n_full_scores=2 * n))
    with torch.inference_mode():
        gp, gs = np_out(tengine.search_impl(
            dev, torch.from_numpy(queries), None, ispec=ispec, top_k=10, n_ivf_probe=k,
            n_full_scores=2 * n))
    np.testing.assert_array_equal(sp, gp)
    np.testing.assert_allclose(ss, gs, rtol=1e-4, atol=1e-4)


def test_sharded_empty_tail_shards():
    """More shards than needed: the tail shards hold no documents."""
    chunk_gen, lens, _, _ = make_corpus(n_docs=11, seed=8)
    cent, params, _ = tstream.train_global_codec(chunk_gen, lens, nbits=4, k=64, seed=9)
    sharded = tstream.build_sharded_index_streaming(
        chunk_gen, lens, mesh(8), nbits=4, centroids=cent, codec_params=params, chunk_docs=3
    )
    assert list(sharded.doc_base) == [0, 2, 4, 6, 8, 10, 11, 11]
    assert sharded.ispec.n_docs == 2
    queries = testing.random_queries(np.random.default_rng(1), 3, 6, DIM)
    sp, _ = np_out(parallel.sharded_search(sharded, queries, top_k=5, n_ivf_probe=8,
                                           n_full_scores=32))
    assert (sp[:, 0] >= 0).all() and (sp < 11).all()


@pytest.fixture(scope="module")
def both_builds():
    """The JAX package's trained codec through both packages' sharded
    streaming builds (4 shards, 160 documents)."""
    _, lens, flat, starts = make_corpus(n_docs=160, base_len=20, seed=6)

    def jgen(d0, d1):
        return jnp.asarray(flat[starts[d0] : starts[d1]])

    def tgen(d0, d1):
        return torch.from_numpy(flat[starts[d0] : starts[d1]])

    cent, params, k = jstream.train_global_codec(jgen, lens, nbits=4, k=64, seed=9)
    jsh = jstream.build_sharded_index_streaming(
        jgen, lens, JMesh(np.array(jax.devices("cpu")[:4]), ("d",)), nbits=4,
        centroids=cent, codec_params=params, chunk_docs=16,
    )
    codec = tdb.DeviceCodec(
        bucket_cutoffs=torch.from_numpy(np.array(params.bucket_cutoffs)),
        bucket_weights=torch.from_numpy(np.array(params.bucket_weights)),
    )
    tsh = tstream.build_sharded_index_streaming(
        tgen, lens, mesh(4), nbits=4, centroids=torch.from_numpy(np.array(cent)),
        codec_params=codec, chunk_docs=16,
    )
    return jsh, tsh, lens, k


def test_sharded_streaming_matches_jax_build(both_builds):
    jsh, tsh, _, k = both_builds
    assert dataclasses.asdict(tsh.ispec) == dataclasses.asdict(jsh.ispec)
    np.testing.assert_array_equal(tsh.doc_base, np.asarray(jsh.doc_base))
    np.testing.assert_array_equal(tsh.ivf_lengths_host, jsh.ivf_lengths_host)
    assert tsh.n_docs_total == jsh.n_docs_total
    for name in ("codes", "residuals", "doc_lengths", "ivf_offsets", "ivf_lengths",
                 "centroids", "bucket_weights"):
        leaf = np.asarray(getattr(jsh.dev, name))
        for j, shard in enumerate(tsh.shards):
            np.testing.assert_array_equal(getattr(shard, name).numpy(), leaf[j], err_msg=name)
    ivf_j = np.asarray(jsh.dev.ivf)
    for j, shard in enumerate(tsh.shards):
        got = shard.ivf.numpy()
        assert got.shape == ivf_j[j].shape
        off, ln = shard.ivf_offsets.numpy(), shard.ivf_lengths.numpy()
        in_cell = np.zeros(got.shape, bool)
        for c in range(k):
            cell = got[off[c] : off[c] + ln[c]]
            np.testing.assert_array_equal(cell, np.sort(ivf_j[j][off[c] : off[c] + ln[c]]))
            in_cell[off[c] : off[c] + ln[c]] = True
        # Padding: the shard's own document count, up to the largest shard.
        np.testing.assert_array_equal(got[~in_cell], ivf_j[j][~in_cell])


@pytest.mark.parametrize("exhaustive", [False, True])
def test_sharded_streaming_searches_like_jax(both_builds, exhaustive):
    jsh, tsh, lens, k = both_builds
    queries = testing.random_queries(np.random.default_rng(3), 6, 8, DIM)
    kw = dict(top_k=10, n_ivf_probe=k, n_full_scores=2 * len(lens)) if exhaustive else dict(
        top_k=10, n_ivf_probe=4, n_full_scores=32)
    tp, ts_, tst = np_out(parallel.sharded_search(tsh, queries, with_stats=True, **kw))
    jp, js_, jst = np_out(jsharded_search(jsh, queries, with_stats=True, **kw))
    assert_same_topk(tp, ts_, jp, js_)
    np.testing.assert_array_equal(tst, jst)


@pytest.mark.parametrize("pad_ivf_to", [None, 0, 700, 1024])
def test_align_ivf_device_pads_like_jax(pad_ivf_to):
    rng = np.random.default_rng(2)
    k, kp, n_docs = 20, 128, 50
    lens = rng.integers(0, 300, k)
    lens[3] = 0
    pids = rng.integers(0, n_docs, int(lens.sum())).astype(np.int32)
    assert tlayout.aligned_ivf_len(lens) == jlayout.aligned_ivf_len(lens)
    cell_cap = tlayout.round_up(int(lens.max()), 8)
    got = tlayout.align_ivf_device(torch.from_numpy(pids), lens, k=k, kp=kp, n_docs=n_docs,
                                   cell_cap=cell_cap, pad_ivf_to=pad_ivf_to)
    want = jlayout.align_ivf_device(jnp.asarray(pids), lens, k=k, kp=kp, n_docs=n_docs,
                                    cell_cap=cell_cap, pad_ivf_to=pad_ivf_to)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
