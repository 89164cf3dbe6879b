"""In-memory device and streaming builds: the port against fast_plaid_tpu.

Mirrors ``tests/test_device_build.py``, ``tests/test_flat_build.py`` and the
single-device tests of ``tests/test_streaming.py``. Across the packages the
build is given the same centroids (k-means parity is
``test_torch_kmeans.py``'s, and its empty-cluster re-seed draws differ), and
then: codes equal except at bf16 near-ties (the two scores within 1e-5),
packed residuals equal byte for byte wherever the codes agree, IVF cells
equal as sets, codec parameters within 1e-6. Within the port the device
build is held to the host build as the JAX test holds its own (codes equal,
residual bytes > 99.9% equal, top-10 ids > 95% equal, scores atol 1e-3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu import testing as jtesting
from fast_plaid_tpu.index import device_build as jdb
from fast_plaid_tpu.index import streaming as jstream
from fast_plaid_tpu.index.ivf import build_ivf
from fast_plaid_tpu_torch import testing
from fast_plaid_tpu_torch.index import device_build as tdb
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.index import streaming as tstream
from fast_plaid_tpu_torch.ops import codec as tcodec
from fast_plaid_tpu_torch.search import engine as tengine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    flat, lens = testing.random_flat_corpus(rng, 400, 48, 64, variable=True)
    queries = testing.random_queries(rng, 8, 12, 64)
    return flat, lens, queries


def _search(dev, ispec, queries, **kw):
    kw = dict(dict(top_k=10, n_ivf_probe=8, n_full_scores=256), **kw)
    return tuple(x.numpy() for x in tengine.search_impl(dev, torch.from_numpy(queries), None, ispec=ispec, **kw))


def assert_codes_match(flat, codes_t, codes_j, centroids):
    """Codes equal except where the two centroids' bf16 scores tie (1e-5)."""
    diff = np.nonzero(codes_t != codes_j)[0]
    assert diff.size <= max(3, codes_t.size // 1000)
    if diff.size:
        x = torch.from_numpy(np.asarray(flat[diff], np.float32))
        s = tcodec.bf16_matmul(x, torch.from_numpy(np.asarray(centroids)).t()).numpy()
        rows = np.arange(diff.size)
        assert np.abs(s[rows, codes_t[diff]] - s[rows, codes_j[diff]]).max() <= 1e-5
    return codes_t == codes_j


def assert_ivf_sets_match(ivf_t, off_t, len_t, ivf_j, off_j, len_j, k):
    np.testing.assert_array_equal(len_t[:k], len_j[:k])
    np.testing.assert_array_equal(off_t[:k], off_j[:k])
    for c in range(k):
        a = ivf_t[off_t[c] : off_t[c] + len_t[c]]
        b = ivf_j[off_j[c] : off_j[c] + len_j[c]]
        assert set(a.tolist()) == set(b.tolist()), c


def test_matches_host_build(corpus):
    flat, lens, queries = corpus
    dev_h, spec_h = testing.build_memory_index_flat(flat, lens, nbits=4, seed=3, device="cpu")
    dev_d, spec_d = tdb.build_memory_index_device(torch.from_numpy(flat), lens, nbits=4, seed=3)
    assert spec_d == spec_h
    for f in ("doc_lengths", "codes", "ivf_lengths", "ivf_offsets", "ivf"):
        assert torch.equal(getattr(dev_d, f), getattr(dev_h, f)), f
    assert (dev_d.residuals == dev_h.residuals).float().mean() > 0.999
    ph, sh = _search(dev_h, spec_h, queries)
    pd_, sd = _search(dev_d, spec_d, queries)
    assert (ph == pd_).mean() > 0.95
    np.testing.assert_allclose(sh, sd, rtol=1e-3, atol=1e-3)


def test_matches_jax_device_build(corpus, monkeypatch):
    """The same centroids through both packages' device builds."""
    flat, lens, queries = corpus
    dev_j, spec_j = jdb.build_memory_index_device(jnp.asarray(flat), lens, nbits=4, seed=3, k=32)
    cent = np.asarray(dev_j.centroids)[:32]
    monkeypatch.setattr(tdb, "train_kmeans", lambda *a, **kw: torch.from_numpy(cent.copy()))
    dev_t, spec_t = tdb.build_memory_index_device(torch.from_numpy(flat), lens, nbits=4, seed=3, k=32)
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    np.testing.assert_allclose(dev_t.bucket_weights.numpy(), np.asarray(dev_j.bucket_weights), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dev_t.doc_lengths.numpy(), np.asarray(dev_j.doc_lengths))
    ct, cj = dev_t.codes.numpy(), np.asarray(dev_j.codes)
    tok = np.arange(ct.shape[1])[None, :] < dev_t.doc_lengths.numpy()[:, None]
    starts = np.concatenate([[0], np.cumsum(lens)])
    rows, cols = np.nonzero(tok)
    same = assert_codes_match(flat[starts[rows] + cols], ct[rows, cols], cj[rows, cols], cent)
    pd = dev_t.residuals.shape[1] // ct.shape[1]
    rt = dev_t.residuals.numpy().reshape(ct.shape[0], ct.shape[1], pd)[rows, cols][same]
    rj = np.asarray(dev_j.residuals).reshape(ct.shape[0], ct.shape[1], pd)[rows, cols][same]
    np.testing.assert_array_equal(rt, rj)
    assert_ivf_sets_match(
        dev_t.ivf.numpy(), dev_t.ivf_offsets.numpy(), dev_t.ivf_lengths.numpy(),
        np.asarray(dev_j.ivf), np.asarray(dev_j.ivf_offsets), np.asarray(dev_j.ivf_lengths), 32,
    )
    from fast_plaid_tpu.search.engine import search_core as jsearch_core

    pj, sj = (np.asarray(x) for x in jsearch_core(
        dev_j, jnp.asarray(queries), None, ispec=spec_j, top_k=10, n_ivf_probe=8,
        n_full_scores=256, want_tokens=False))
    pt, st = _search(dev_t, spec_t, queries)
    assert (pt == pj).mean() > 0.95
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-3)


def test_flat_builder_dispatches_device_path(corpus):
    flat, lens, queries = corpus
    dev, ispec = testing.build_memory_index_flat(torch.from_numpy(flat), lens, nbits=4, seed=3, emb_cache=True)
    assert dev.emb_cache is not None and dev.residuals is not None
    direct, _ = tdb.build_memory_index_device(torch.from_numpy(flat), lens, nbits=4, seed=3)
    assert torch.equal(dev.codes, direct.codes) and torch.equal(dev.ivf, direct.ivf)
    pids, scores = _search(dev, ispec, queries, use_rerank_kernel=True)
    assert (pids[:, 0] >= 0).all() and np.isfinite(scores[:, 0]).all()


def test_ivf_device_matches_host(corpus):
    """One int64 sort groups the host build's per-cell pids, ascending."""
    flat, lens, _ = corpus
    rng = np.random.default_rng(11)
    n_docs = len(lens)
    k, kp = 100, 128
    codes_flat = rng.integers(0, k, flat.shape[0]).astype(np.int32)
    ivf_h, len_h = build_ivf(codes_flat, lens, k)
    doc_cap = tlayout.round_up(int(lens.max()), 16)
    npd = tlayout.round_up(n_docs + 1, 8)
    codes2d = np.zeros((npd, doc_cap), np.int32)
    lengths = np.zeros((npd,), np.int32)
    lengths[:n_docs] = lens
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
    for i, (s, ln) in enumerate(zip(starts, lens)):
        codes2d[i, :ln] = codes_flat[s : s + ln]
    pids, ivf_len = tdb._ivf_device(torch.from_numpy(codes2d), torch.from_numpy(lengths), kp=kp, n_docs=n_docs)
    np.testing.assert_array_equal(ivf_len.numpy()[:k], len_h)
    np.testing.assert_array_equal(pids.numpy(), ivf_h)  # pids ascend within each cell
    pj, len_j, n_ivf = jdb._ivf_device_big(jnp.asarray(codes2d), jnp.asarray(lengths), kp=kp, n_docs=n_docs)
    np.testing.assert_array_equal(ivf_len.numpy(), np.asarray(len_j))
    off = np.concatenate([[0], np.cumsum(len_h)])
    pj = np.asarray(pj)[: int(n_ivf)]
    for c in range(k):
        np.testing.assert_array_equal(np.sort(pj[off[c] : off[c + 1]]), ivf_h[off[c] : off[c + 1]])


def test_device_build_2bit(corpus):
    flat, lens, queries = corpus
    dev, ispec = tdb.build_memory_index_device(torch.from_numpy(flat), lens, nbits=2, seed=3)
    assert dev.residuals.shape[1] == ispec.doc_cap * 64 * 2 // 8
    pids, _ = _search(dev, ispec, queries)
    assert (pids[:, 0] >= 0).all()


def test_train_codec_device_past_quantile_limit():
    """50,000 held-out tokens at D 384 (19.2M residuals, past
    ``torch.quantile``'s 2^24): one sort, the JAX package's quantiles."""
    rng = np.random.default_rng(2)
    held = rng.standard_normal((50_000, 384)).astype(np.float32)
    held /= np.linalg.norm(held, axis=-1, keepdims=True)
    cent = held[rng.choice(50_000, 64, replace=False)]
    got = tdb.train_codec_device(torch.from_numpy(held), torch.from_numpy(cent), 4)
    want = jdb.train_codec_device(jnp.asarray(held), jnp.asarray(cent), 4)
    np.testing.assert_allclose(got.bucket_cutoffs.numpy(), np.asarray(want.bucket_cutoffs), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.bucket_weights.numpy(), np.asarray(want.bucket_weights), rtol=0, atol=1e-7)


def test_flat_corpus_shapes():
    flat, lens = testing.random_flat_corpus(np.random.default_rng(0), 20, 12, 16, variable=True)
    assert flat.shape == (int(lens.sum()), 16)
    np.testing.assert_allclose(np.linalg.norm(flat, axis=-1), 1.0, atol=1e-5)
    flat_j, lens_j = jtesting.random_flat_corpus(np.random.default_rng(0), 20, 12, 16, variable=True)
    np.testing.assert_array_equal(flat, flat_j)
    np.testing.assert_array_equal(lens, lens_j)
    dflat, dlens = testing.random_flat_corpus_device(3, 20, 12, 16, variable=True, device="cpu")
    np.testing.assert_array_equal(dlens, jtesting.random_flat_corpus_device(3, 20, 12, 16, variable=True)[1])
    assert dflat.shape == (int(dlens.sum()), 16)
    torch.testing.assert_close(torch.linalg.vector_norm(dflat, dim=-1), torch.ones(dflat.shape[0]))


def test_flat_build_searches_like_list_build():
    rng = np.random.default_rng(1)
    docs = testing.random_documents(rng, 40, 12, 32, variable=True)
    flat = np.concatenate(docs)
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    dev_a, spec_a = testing.build_memory_index(docs, nbits=4, seed=2, device="cpu")
    dev_b, spec_b = testing.build_memory_index_flat(flat, lens, nbits=4, seed=2, device="cpu")
    assert spec_a.n_docs == spec_b.n_docs and spec_a.n_partitions == spec_b.n_partitions
    for target in (0, 17, 39):
        q = docs[target][None, :5, :]
        pa, sa = _search(dev_a, spec_a, q, top_k=1)
        pb, sb = _search(dev_b, spec_b, q, top_k=1)
        assert pa[0, 0] == target and pb[0, 0] == target
        np.testing.assert_allclose(sa[0, 0], sb[0, 0], atol=0.1)


def _stream_corpus(n_docs=500, base_len=24, dim=48, seed=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(base_len // 2, base_len + 1, n_docs).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    flat = rng.standard_normal((int(lens.sum()), dim)).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=-1, keepdims=True)
    return flat, lens, starts


@pytest.fixture(scope="module")
def stream():
    flat, lens, starts = _stream_corpus()
    ft = torch.from_numpy(flat)

    def chunk_gen(d0, d1):
        return ft[starts[d0] : starts[d1]]

    cent, params, k = tstream.train_global_codec(chunk_gen, lens, nbits=4, k=256, seed=9)
    return chunk_gen, flat, lens, starts, cent, params, k


def test_chunked_equals_single_chunk(stream):
    chunk_gen, _, lens, _, cent, params, _ = stream
    kw = dict(nbits=4, centroids=cent, codec_params=params)
    dev_a, spec_a = tstream.build_memory_index_streaming(chunk_gen, lens, chunk_docs=77, q4_cache=True, **kw)
    dev_b, spec_b = tstream.build_memory_index_streaming(chunk_gen, lens, chunk_docs=len(lens), **kw)
    assert spec_a == spec_b
    for name in ("codes", "residuals", "doc_lengths", "ivf_lengths", "ivf", "ivf_offsets"):
        assert torch.equal(getattr(dev_a, name), getattr(dev_b, name)), name
    # The q4 cache built during the stream equals the one built afterwards.
    q4 = tlayout.build_q4_cache(dev_b, spec_b)
    assert torch.equal(dev_a.emb_q4, q4.emb_q4) and torch.equal(dev_a.q4_scale, q4.q4_scale)


def test_streaming_matches_jax_and_brute_force(stream):
    """The JAX package's trained codec through both streaming builds; the
    port's index searched exhaustively equals brute force (2e-3, as the JAX
    test holds its own)."""
    chunk_gen, flat, lens, starts, _, _, _ = stream
    jgen = lambda d0, d1: jnp.asarray(flat[starts[d0] : starts[d1]])  # noqa: E731
    cent_j, params_j, k = jstream.train_global_codec(jgen, lens, nbits=4, k=256, seed=9)
    dev_j, spec_j = jstream.build_memory_index_streaming(
        jgen, lens, nbits=4, centroids=cent_j, codec_params=params_j, chunk_docs=77)
    cent = torch.from_numpy(np.array(cent_j))
    params = tdb.DeviceCodec(
        bucket_cutoffs=torch.from_numpy(np.array(params_j.bucket_cutoffs)),
        bucket_weights=torch.from_numpy(np.array(params_j.bucket_weights)),
    )
    dev, ispec = tstream.build_memory_index_streaming(
        chunk_gen, lens, nbits=4, centroids=cent, codec_params=params, chunk_docs=77)
    assert dataclasses.asdict(ispec) == dataclasses.asdict(spec_j)
    ct, cj = dev.codes.numpy(), np.asarray(dev_j.codes)
    rows, cols = np.nonzero(np.arange(ct.shape[1])[None, :] < dev.doc_lengths.numpy()[:, None])
    same = assert_codes_match(flat[starts[rows] + cols], ct[rows, cols], cj[rows, cols], cent.numpy())
    pd = dev.residuals.shape[1] // ct.shape[1]
    np.testing.assert_array_equal(
        dev.residuals.numpy().reshape(*ct.shape, pd)[rows, cols][same],
        np.asarray(dev_j.residuals).reshape(*ct.shape, pd)[rows, cols][same],
    )
    assert_ivf_sets_match(
        dev.ivf.numpy(), dev.ivf_offsets.numpy(), dev.ivf_lengths.numpy(),
        np.asarray(dev_j.ivf), np.asarray(dev_j.ivf_offsets), np.asarray(dev_j.ivf_lengths), k,
    )

    queries = testing.random_queries(np.random.default_rng(3), 6, 8, 48)
    pids, scores = _search(dev, ispec, queries, n_ivf_probe=k, n_full_scores=2 * len(lens))
    n = len(lens)
    emb = tcodec.decompress(
        dev.codes[:n], tlayout.gather_res(dev.residuals, torch.arange(n), ispec.doc_cap),
        dev.centroids, dev.bucket_weights, 4,
    ).numpy()
    valid = np.arange(ispec.doc_cap)[None, :] < lens[:, None]
    for qi in range(len(queries)):
        ts = np.where(valid[..., None], emb @ queries[qi].T, -np.inf)
        truth = ts.max(axis=1).sum(axis=-1)
        order = np.argsort(-truth)[:10]
        np.testing.assert_allclose(truth[pids[qi]], truth[order], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(scores[qi], truth[pids[qi]], rtol=2e-3, atol=2e-3)


def test_memory_index_searches_a_build(corpus):
    """``MemoryIndex`` answers as ``FastPlaid.search`` does, over an index
    that was never written: planted prefixes rank their documents first,
    with the engine's top-1 score on the same index (float16 query wire)."""
    flat, lens, _ = corpus
    dev, ispec = tdb.build_memory_index_device(torch.from_numpy(flat), lens, nbits=4, seed=3)
    mem = testing.MemoryIndex(dev, ispec, "cpu")
    starts = np.concatenate([[0], np.cumsum(lens)])
    planted = [0, 17, 399]
    probes = np.stack([flat[starts[i] : starts[i] + 12] for i in planted])
    res = mem.search(probes, top_k=10, n_full_scores=256, n_ivf_probe=8)
    assert [r[0][0] for r in res] == planted and all(len(r) == 10 for r in res)
    pids, scores = _search(dev, ispec, probes)
    assert pids[:, 0].tolist() == planted
    np.testing.assert_allclose([r[0][1] for r in res], scores[:, 0], rtol=0, atol=2e-2)
