"""Length-bucketed layout parity: the port against fast_plaid_tpu on the CPU.

Mirrors ``tests/test_length_buckets.py``. The JAX package's bucketed index
is carried across with ``device_index_from_arrays`` (buckets included); the
port's own ``to_device`` builds the same tensors from the same host arrays,
and both engines search the carried index. Tolerances: ids equal, scores
atol 1e-4 between the packages on one index (bf16 inputs, float32 sums in
another order); the bucketed against the single-cap layout as the JAX test
holds it (ids equal, 2e-2); reconstruction 1e-5; the bf16 caches within one
bf16 ulp; API token matrices 5e-4 (one bf16 ulp of a token).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu import testing
from fast_plaid_tpu.index import layout as jlayout
from fast_plaid_tpu.search import engine as jengine
from fast_plaid_tpu_torch import search as tsearch
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.search import engine as tengine

torch.set_num_threads(2)

DIM = 64
TOL = 1e-4


def _mixed_corpus(rng, n_short=400, n_long=40, short=48, long=320, dim=DIM):
    """90% short documents, 10% long (the JAX test's corpus)."""
    lens = np.concatenate(
        [
            rng.integers(short // 2, short + 1, size=n_short),
            rng.integers(long - 32, long + 1, size=n_long),
        ]
    ).astype(np.int64)
    rng.shuffle(lens)
    docs = []
    for ln in lens:
        x = rng.standard_normal((int(ln), dim)).astype(np.float32)
        docs.append(x / np.linalg.norm(x, axis=-1, keepdims=True))
    return docs


def carry(dev, ispec):
    """A JAX DeviceIndex (bucketed or not) as the port's."""
    arrays = {
        f: np.asarray(getattr(dev, f))
        for f in dev._fields
        if getattr(dev, f) is not None and f != "buckets"
    }
    arrays["buckets"] = [
        {f: np.asarray(getattr(bk, f)) for f in bk._fields if getattr(bk, f) is not None}
        for bk in dev.buckets
    ]
    return tlayout.device_index_from_arrays(arrays, dataclasses.asdict(ispec), "cpu")


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _search_both(dev_j, spec_j, dev_t, spec_t, queries, **kw):
    out_j = [np.asarray(x) for x in jengine.search_core(dev_j, jnp.asarray(queries), None, ispec=spec_j, **kw)]
    out_t = [x.numpy() for x in tengine.search_impl(dev_t, torch.from_numpy(queries), None, ispec=spec_t, **kw)]
    return out_j, out_t


def test_plan_buckets_uniform_skips():
    lens = np.full(1000, 160)
    assert tlayout.plan_buckets(lens, 160) is None
    lens = np.random.default_rng(0).integers(120, 161, size=1000)
    assert tlayout.plan_buckets(lens, 160) is None
    assert jlayout.plan_buckets(lens, 160) is None


def test_plan_buckets_skewed_engages():
    rng = np.random.default_rng(0)
    lens = np.where(rng.random(1000) < 0.9, 100, 1000).astype(np.int64)
    caps = tlayout.plan_buckets(lens, 1000)
    assert caps == jlayout.plan_buckets(lens, 1000)
    assert caps is not None and caps[-1] == 1000 and caps == sorted(caps)
    assert all(c % 16 == 0 for c in caps[:-1]) and caps[0] >= 100
    # A lognormal spread like real ColBERT corpora: the same caps.
    ln = np.clip(np.round(90 * np.exp(0.6 * rng.standard_normal(5000))), 8, 300)
    assert tlayout.plan_buckets(ln, 304) == jlayout.plan_buckets(ln, 304) is not None


def test_bucket_quota_bounds():
    ispec = tlayout.IndexSpec(
        dim=64, nbits=4, n_docs=1000, n_partitions=64, doc_cap=320, cell_cap=64,
        has_ivf=True, bucket_caps=(64, 320), bucket_counts=(900, 100),
    )
    r = 512
    q0, q1 = tengine._bucket_quota(r, ispec, 0), tengine._bucket_quota(r, ispec, 1)
    assert q0 == r and 64 <= q1 <= r and q1 >= int(r * 0.1 * 2)
    jspec = jlayout.IndexSpec(**dataclasses.asdict(ispec))
    for counts in ((900, 100), (31_428, 18_731, 7_479), (5, 5, 990)):
        for rr in (8, 300, 2048):
            for bi in range(len(counts)):
                spec_t = dataclasses.replace(ispec, bucket_caps=(1,) * len(counts), bucket_counts=counts)
                spec_j = dataclasses.replace(jspec, bucket_caps=(1,) * len(counts), bucket_counts=counts)
                assert tengine._bucket_quota(rr, spec_t, bi) == jengine._bucket_quota(rr, spec_j, bi)


@pytest.fixture(scope="module")
def skewed():
    rng = np.random.default_rng(7)
    docs = _mixed_corpus(rng)
    queries = testing.random_queries(rng, 8, 12, DIM)
    planted = np.stack([docs[i][:12] for i in (2, 111, 397)])
    return docs, np.concatenate([queries, planted]).astype(np.float32)


@pytest.mark.parametrize("emb_cache", [False, True])
def test_bucketed_search_matches_single_cap(skewed, emb_cache):
    docs, queries = skewed
    dev0, spec0 = testing.build_memory_index(docs, nbits=4, seed=1, emb_cache=emb_cache, length_buckets=0)
    dev1, spec1 = testing.build_memory_index(docs, nbits=4, seed=1, emb_cache=emb_cache, length_buckets=4)
    assert spec1.bucket_caps
    t0, s0 = carry(dev0, spec0)
    t1, s1 = carry(dev1, spec1)
    assert t1.residuals is None and t1.emb_cache is None and len(t1.buckets) == len(s1.bucket_caps)
    assert (t1.buckets[0].emb is not None) == emb_cache
    kw = dict(top_k=10, n_ivf_probe=8, n_full_scores=256, want_tokens=False, with_stats=True)
    (pj, sj, stj), (pt, st, stt) = _search_both(dev1, spec1, t1, s1, queries, **kw)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=TOL)
    np.testing.assert_array_equal(stt, stj)  # quota drops counted alike
    # Through the kernel wrappers (their plain versions on the CPU).
    pk, sk, _ = (x.numpy() for x in tengine.search_impl(
        t1, torch.from_numpy(queries), None, ispec=s1, use_rerank_kernel=True,
        use_estimate_kernel=True, **kw))
    np.testing.assert_array_equal(pk, pj)
    np.testing.assert_allclose(sk, sj, rtol=0, atol=TOL)
    # Against the port's single-cap layout, as the JAX test holds its own.
    p0, sc0, _ = (x.numpy() for x in tengine.search_impl(t0, torch.from_numpy(queries), None, ispec=s0, **kw))
    np.testing.assert_array_equal(p0, pt)
    np.testing.assert_allclose(sc0, st, rtol=2e-2, atol=2e-2)
    assert pt[-3:, 0].tolist() == [2, 111, 397]


def test_bucketed_token_scores_match():
    rng = np.random.default_rng(3)
    docs = _mixed_corpus(rng, n_short=120, n_long=16)
    queries = testing.random_queries(rng, 4, 8, DIM)
    dev1, spec1 = testing.build_memory_index(docs, seed=2, length_buckets=4)
    dev0, spec0 = testing.build_memory_index(docs, seed=2, length_buckets=0)
    assert spec1.bucket_caps
    t1, s1 = carry(dev1, spec1)
    t0, s0 = carry(dev0, spec0)
    kw = dict(top_k=5, n_ivf_probe=8, n_full_scores=128, want_tokens=True)
    (pj, sj, tj, lj), (pt, st, tt, lt) = _search_both(dev1, spec1, t1, s1, queries, **kw)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=TOL)
    p0, _, tok0, l0 = (x.numpy() for x in tengine.search_impl(t0, torch.from_numpy(queries), None, ispec=s0, **kw))
    np.testing.assert_array_equal(p0, pt)
    np.testing.assert_array_equal(l0, lt)
    np.testing.assert_allclose(tok0, tt, rtol=2e-2, atol=2e-2)


def test_bucketed_reconstruct_matches():
    rng = np.random.default_rng(5)
    docs = _mixed_corpus(rng, n_short=100, n_long=12)
    dev1, spec1 = testing.build_memory_index(docs, seed=4, length_buckets=4, emb_cache=True)
    dev0, spec0 = testing.build_memory_index(docs, seed=4, length_buckets=0)
    assert spec1.bucket_caps
    t1, s1 = carry(dev1, spec1)
    t0, s0 = carry(dev0, spec0)
    pids = np.asarray([0, 3, 50, 111], np.int32)
    ej, lj = (np.asarray(x) for x in jengine.reconstruct_core(dev1, jnp.asarray(pids), ispec=spec1))
    et, lt = (x.numpy() for x in tengine.reconstruct_core(t1, torch.from_numpy(pids), ispec=s1))
    e0, l0 = (x.numpy() for x in tengine.reconstruct_core(t0, torch.from_numpy(pids), ispec=s0))
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(l0, lt)
    np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e0, et, rtol=1e-5, atol=1e-6)  # codec, not the bf16 cache


def test_bucketed_layout_saves_memory(skewed):
    """The port's own bucketed to_device builds the JAX package's tensors
    from the same host arrays, and saves the same memory."""
    from fast_plaid_tpu.index import ivf as jivf
    from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
    from fast_plaid_tpu.ops.kmeans import train_kmeans

    docs, _ = skewed
    flat = np.concatenate(docs)
    cent = train_kmeans(flat, k=64, niters=2, seed=6)
    params = train_codec_from_documents(docs, cent, 4, 6)
    codes, packed = compress_documents(docs, cent, params.bucket_cutoffs, 4)
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    ivf, ivf_lengths = jivf.build_ivf(codes, lens, cent.shape[0])
    host = dict(centroids=cent, bucket_weights=params.bucket_weights, codes=codes,
                residuals=packed, doc_lengths=lens, ivf=ivf, ivf_lengths=ivf_lengths, nbits=4)
    dev_j, spec_j = jlayout.to_device(**host, length_buckets=4)
    dev_j = jlayout.build_emb_cache(dev_j, spec_j)
    carried, spec_c = carry(dev_j, spec_j)
    own, spec_t = tlayout.to_device(**host, length_buckets=4, device="cpu")
    own = tlayout.build_emb_cache(own, spec_t, block=64)
    assert spec_t == spec_c and spec_t.bucket_caps
    for f in ("codes", "doc_lengths", "doc_bucket", "doc_bucket_row", "ivf", "ivf_offsets"):
        assert torch.equal(getattr(own, f), getattr(carried, f)), f
    for a, b in zip(own.buckets, carried.buckets):
        assert torch.equal(a.codes, b.codes) and torch.equal(a.residuals, b.residuals)
        ea, eb = a.emb.float().numpy(), b.emb.float().numpy()
        assert (np.abs(ea - eb) <= ulp_bf16(eb)).all()
    flat_t, flat_spec = tlayout.to_device(**host, length_buckets=0, device="cpu")
    full = flat_t.residuals.numel()
    bucketed = sum(bk.residuals.numel() for bk in own.buckets)
    assert bucketed < 0.55 * full
    assert tlayout.emb_cache_bytes(spec_t) == jlayout.emb_cache_bytes(spec_j)
    assert tlayout.emb_cache_bytes(spec_t) < 0.55 * tlayout.emb_cache_bytes(flat_spec)
    assert sum(bk.emb.numel() * 2 for bk in own.buckets) == tlayout.emb_cache_bytes(spec_t)
    # The q4 tier stays single-cap: a bucketed index gets no q4 cache.
    assert tlayout.build_q4_cache(own, spec_t).emb_q4 is None


def test_bucketed_via_fastplaid_api(tmp_path):
    """End to end through FastPlaid on a skewed corpus: the port's own
    create + resident load buckets it; the JAX package's index, opened by
    both packages, answers search, token scores and get_embeddings alike."""
    rng = np.random.default_rng(11)
    docs = _mixed_corpus(rng, n_short=150, n_long=18)
    queries = testing.random_queries(rng, 3, 8, DIM)

    fp = tsearch.FastPlaid(str(tmp_path / "t"), device="cpu", low_memory=False)
    fp.create(documents_embeddings=docs)
    assert next(iter(fp.indices.values())).ispec.bucket_caps
    res = fp.search(queries_embeddings=list(queries), top_k=5, show_progress=False)
    assert len(res) == 3 and all(len(r) == 5 for r in res)
    emb = fp.get_embeddings(list(range(len(docs))))
    scores = {i: float(np.max(queries[0] @ emb[i].T, axis=1).sum()) for i in range(len(docs))}
    ranked = sorted(scores, key=scores.get, reverse=True)
    assert res[0][0][0] in ranked[:3]

    path = str(tmp_path / "j")
    jsearch.FastPlaid(path, device="cpu", low_memory=False).create(documents_embeddings=docs)
    fj = jsearch.FastPlaid(path, device="cpu", low_memory=False)
    ft = tsearch.FastPlaid(path, device="cpu", low_memory=False)
    assert next(iter(ft.indices.values())).ispec.bucket_caps
    kw = dict(top_k=5, show_progress=False)
    for a, b in zip(fj.search(queries, **kw), ft.search(queries, **kw)):
        assert [p for p, _ in a] == [p for p, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=TOL)
    for a, b in zip(fj.search_token_scores(queries, **kw), ft.search_token_scores(queries, **kw)):
        for (pa, _, ma), (pb, _, mb) in zip(a, b):
            assert pa == pb and ma.shape == mb.shape
            # The JAX instance reads its bf16 caches, the port (no cache on
            # the CPU) rounds each decompressed token to bf16 itself: a
            # token may differ by one bf16 ulp, 5e-4 at most here.
            np.testing.assert_allclose(ma, mb, rtol=0, atol=5e-4)
    ids = [0, 7, len(docs) - 1]
    for a, b in zip(fj.get_embeddings(ids), ft.get_embeddings(ids)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for f in (fp, fj, ft):
        f.close()


@pytest.fixture(scope="module")
def budget_index(tmp_path_factory):
    """A skewed corpus whose q4 cache is smaller than its bucketed bf16
    caches (40% long documents), written by the port's create."""
    rng = np.random.default_rng(13)
    docs = _mixed_corpus(rng, n_short=90, n_long=60)
    path = str(tmp_path_factory.mktemp("budget"))
    tsearch.FastPlaid(path, device="cpu", low_memory=False).create(documents_embeddings=docs)
    return path, docs


@pytest.mark.parametrize("budget", ["bf16", "bf16_buckets", "q4", "none"])
def test_resident_layout_follows_cache_budget(budget_index, budget):
    """The resident load buckets only where that is what lets the bf16
    cache fit, or where no cache fits at all; otherwise the single cap with
    the bf16 cache or the q4 tier. Every layout ranks the planted documents
    first."""
    from fast_plaid_tpu_torch.search.load import layout_cache_bytes

    path, docs = budget_index
    sizes = layout_cache_bytes([d.shape[0] for d in docs], DIM, 4)
    assert sizes["q4"] < sizes["bf16_buckets"] < sizes["bf16"]
    fp = tsearch.FastPlaid(path, device="cpu", low_memory=False,
                           emb_cache_budget_bytes=sizes.get(budget, 0))
    loaded = next(iter(fp.indices.values()))
    dev, ispec = loaded.dev, loaded.ispec
    assert bool(ispec.bucket_caps) == (budget in ("bf16_buckets", "none"))
    assert (dev.emb_cache is not None) == (budget == "bf16")
    assert (dev.emb_q4 is not None) == (budget == "q4")
    assert all((bk.emb is not None) == (budget == "bf16_buckets") for bk in dev.buckets)
    if ispec.bucket_caps:
        assert tlayout.emb_cache_bytes(ispec) == sizes["bf16_buckets"]
    planted = [3, 40, 120]
    res = fp.search(np.stack([docs[i][:12] for i in planted]), top_k=5, show_progress=False)
    assert [r[0][0] for r in res] == planted
    fp.close()
