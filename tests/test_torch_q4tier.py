"""q4 tier parity: the port's resident-q4 and low_memory(+q4) searches against
the JAX package's, over one index built from the same host arrays.

Both packages build three ``LoadedIndex``es directly (``reload_index``
ignores low_memory on the CPU): plain (device-resident residuals, codec
rerank), resident q4 (prefilter from the 4-bit cache, codec rescore of the
top ``rescue_pool``) and low_memory + q4 (host-RAM residuals, q4 cache built
from host rows). The tier only narrows the exact pool, so every result list
must equal the plain cascade's, and the port's must equal the JAX package's:
pids equal except where scores tie exactly, scores within 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from fast_plaid_tpu.index import ivf as jivf
from fast_plaid_tpu.index import layout as jlayout
from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
from fast_plaid_tpu.ops.kmeans import train_kmeans
from fast_plaid_tpu.search import load as jload
from fast_plaid_tpu.search import searcher as jsearcher
from fast_plaid_tpu.testing import random_documents, random_queries
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.search import load as tload
from fast_plaid_tpu_torch.search import searcher as tsearcher

torch.set_num_threads(2)

TOL = 1e-5


def _common(docs, nbits=4):
    flat = np.concatenate(docs)
    centroids = train_kmeans(flat, k=64, niters=4, seed=3)
    params = train_codec_from_documents(docs, centroids, nbits, 3)
    codes, packed = compress_documents(docs, centroids, params.bucket_cutoffs, nbits)
    doc_lengths = np.asarray([d.shape[0] for d in docs], np.int64)
    ivf, ivf_lengths = jivf.build_ivf(codes, doc_lengths, centroids.shape[0])
    return dict(
        centroids=centroids,
        bucket_weights=params.bucket_weights,
        codes=codes,
        residuals=packed,
        doc_lengths=doc_lengths,
        ivf=ivf,
        ivf_lengths=ivf_lengths,
        nbits=nbits,
    )


def _host(common):
    lens = common["doc_lengths"]
    return dict(
        low_memory=True,
        host_codes=common["codes"].astype(np.int32),
        host_residuals=common["residuals"],
        host_doc_offsets=np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64),
        host_doc_lengths=lens.astype(np.int32),
    )


def _build_jax(common, block=64):
    cpu = jax.devices("cpu")[0]
    ivf_l = common["ivf_lengths"]
    dev_plain, ispec = jlayout.to_device(**common, device=cpu)
    dev_q4 = jlayout.build_q4_cache(dev_plain, ispec)
    dev_lm, _ = jlayout.to_device(**common, device=cpu, residuals_on_device=False)
    plain = jload.LoadedIndex(dev_plain, ispec, cpu, ivf_lengths_host=ivf_l)
    resident = jload.LoadedIndex(dev_q4, ispec, cpu, ivf_lengths_host=ivf_l)
    lm = jload.LoadedIndex(dev_lm, ispec, cpu, ivf_lengths_host=ivf_l, **_host(common))
    jload._build_q4_from_host(lm, block=block)
    return plain, resident, lm


def _build_torch(common, block=64):
    cpu = torch.device("cpu")
    ivf_l = common["ivf_lengths"]
    dev_plain, ispec = tlayout.to_device(**common, device=cpu)
    dev_q4 = tlayout.build_q4_cache(dev_plain, ispec, block=48)
    dev_lm, _ = tlayout.to_device(**common, device=cpu, residuals_on_device=False)
    plain = tload.LoadedIndex(dev_plain, ispec, cpu, ivf_lengths_host=ivf_l)
    resident = tload.LoadedIndex(dev_q4, ispec, cpu, ivf_lengths_host=ivf_l)
    lm = tload.LoadedIndex(dev_lm, ispec, cpu, ivf_lengths_host=ivf_l, **_host(common))
    tload._build_q4_from_host(lm, block=block)  # several blocks at this size
    return plain, resident, lm


def _results_match(a, b, tol=TOL):
    """Same pids except where scores tie exactly, scores within ``tol``."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        sa = np.asarray([s for _, s in ra])
        sb = np.asarray([s for _, s in rb])
        np.testing.assert_allclose(sa, sb, rtol=tol, atol=tol)
        for (pa, xa), (pb, _) in zip(ra, rb):
            if pa != pb:  # an exact tie may order two documents either way
                assert sum(abs(x - xa) <= tol for x in sb) >= 2, (pa, pb)


@pytest.fixture(scope="module")
def tier():
    rng = np.random.default_rng(11)
    docs = random_documents(rng, 120, 14, 32, variable=True)
    queries = [q for q in random_queries(rng, 6, 5, 32)]
    common = _common(docs)
    return dict(
        docs=docs,
        queries=queries,
        jax=_build_jax(common),
        torch=_build_torch(common),
        kwargs=dict(
            top_k=5,
            n_full_scores=128,  # pool 64 > rescue_pool(5) = 32: the tier engages
            n_ivf_probe=16,
            show_progress=False,
        ),
    )


def _search_jax(loaded, queries, **kw):
    return jsearcher.search_on_device(
        loaded, queries, subsets=None, want_tokens=False, **kw
    )


@pytest.mark.parametrize("which", [0, 1, 2], ids=["plain", "resident_q4", "low_memory_q4"])
def test_tier_matches_jax(tier, which):
    got = tsearcher.search_on_device(tier["torch"][which], tier["queries"], **tier["kwargs"])
    want = _search_jax(tier["jax"][which], tier["queries"], **tier["kwargs"])
    _results_match(got, want)


@pytest.mark.parametrize("which", [1, 2], ids=["resident_q4", "low_memory_q4"])
def test_tier_matches_plain_cascade(tier, which):
    plain = tsearcher.search_on_device(tier["torch"][0], tier["queries"], **tier["kwargs"])
    got = tsearcher.search_on_device(tier["torch"][which], tier["queries"], **tier["kwargs"])
    _results_match(got, plain)


def test_tier_engages(tier, monkeypatch):
    """The q4 prefilter narrows the pool on both tiers (not only the fallback
    through the plain cascade)."""
    from fast_plaid_tpu_torch.search import engine as tengine

    calls = []
    orig = tengine._q4_scores

    def record(*args, **kwargs):
        calls.append(args[1].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tengine, "_q4_scores", record)
    for which in (1, 2):
        tsearcher.search_on_device(tier["torch"][which], tier["queries"], **tier["kwargs"])
    assert len(calls) == 2 and all(s[1] == 64 for s in calls), calls


def test_host_and_device_q4_caches_agree(tier):
    """The device-built and host-row-built caches hold the same bytes for
    every real document, and scales equal to float32 precision."""
    _, resident, lm = tier["torch"]
    n_real = len(tier["docs"])
    caph = resident.ispec.doc_cap // 2
    a = resident.dev.emb_q4.numpy()
    b = lm.dev.emb_q4.numpy()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[: n_real * caph], b[: n_real * caph])
    np.testing.assert_allclose(
        resident.dev.q4_scale[:n_real].numpy(), lm.dev.q4_scale[:n_real].numpy(), rtol=1e-6
    )


def test_q4_cache_matches_jax(tier):
    """The port's cache against the JAX package's from the same arrays: scales
    to 1e-6 relative, and levels equal except where float32 decompression
    rounds a value across a rounding boundary (at most one level apart)."""
    for t_loaded, j_loaded in zip(tier["torch"][1:], tier["jax"][1:]):
        t_q4 = t_loaded.dev.emb_q4.numpy()
        j_q4 = np.asarray(j_loaded.dev.emb_q4)
        n = len(tier["docs"]) * (t_loaded.ispec.doc_cap // 2)
        for shift in (0, 4):
            lt = (t_q4[:n] >> shift) & 15
            lj = (j_q4[:n] >> shift) & 15
            diff = np.abs(lt.astype(int) - lj.astype(int))
            assert diff.max() <= 1 and diff.mean() < 1e-3
        np.testing.assert_allclose(
            t_loaded.dev.q4_scale.numpy()[: len(tier["docs"])],
            np.asarray(j_loaded.dev.q4_scale)[: len(tier["docs"])],
            rtol=1e-6,
        )


@pytest.mark.parametrize("max_tile", [1, 2, 4])
def test_low_memory_pipeline_keeps_query_order(tier, max_tile):
    """Several tiles through the two-tile pipeline give, query for query, the
    results of one tile."""
    lm = tier["torch"][2]
    one = tsearcher.search_on_device(lm, tier["queries"], **tier["kwargs"])
    tiled = tsearcher.search_on_device(
        lm, tier["queries"], max_tile=max_tile, **tier["kwargs"]
    )
    assert tiled == one


def test_exhaustive_params_bypass_prefilter(tier):
    """Corpus-covering parameters promise brute-force identity: every tier
    gives the plain cascade's results, in both packages."""
    kw = dict(tier["kwargs"], n_full_scores=2 * len(tier["docs"]), n_ivf_probe=64)
    plain = tsearcher.search_on_device(tier["torch"][0], tier["queries"], **kw)
    for which in (1, 2):
        got = tsearcher.search_on_device(tier["torch"][which], tier["queries"], **kw)
        _results_match(got, plain)
        _results_match(got, _search_jax(tier["jax"][which], tier["queries"], **kw))


def test_carry_jax_q4_and_low_memory_indexes(tier):
    """``device_index_from_arrays`` carries a JAX index's q4 cache across, and
    a low_memory one without residuals; the carried resident-q4 index
    searches like the JAX one through the engine."""
    import dataclasses

    import jax.numpy as jnp

    from fast_plaid_tpu.search import engine as jengine
    from fast_plaid_tpu_torch.search import engine as tengine

    carried = []
    for j_loaded in tier["jax"][1:]:
        dev = j_loaded.dev
        arrays = {
            f: np.asarray(getattr(dev, f))
            for f in dev._fields
            if getattr(dev, f) is not None and f != "buckets"
        }
        spec = dataclasses.asdict(j_loaded.ispec)
        t_dev, t_spec = tlayout.device_index_from_arrays(arrays, spec, "cpu")
        np.testing.assert_array_equal(t_dev.emb_q4.numpy(), np.asarray(dev.emb_q4))
        assert t_dev.emb_q4.dtype == torch.uint8 and t_dev.emb_q4.ndim == 2
        np.testing.assert_array_equal(t_dev.q4_scale.numpy(), np.asarray(dev.q4_scale))
        carried.append((t_dev, t_spec))
    assert carried[0][0].residuals is not None and carried[1][0].residuals is None

    (t_dev, t_spec), j_dev = carried[0], tier["jax"][1].dev
    q = np.stack(tier["queries"]).astype(np.float32)
    kw = dict(top_k=5, n_ivf_probe=16, n_full_scores=128, want_tokens=False)
    pj, sj = (np.asarray(x) for x in jengine.search_core(
        j_dev, jnp.asarray(q), None, ispec=tier["jax"][1].ispec, **kw))
    pt, st = (x.numpy() for x in tengine.search_impl(
        t_dev, torch.from_numpy(q), None, ispec=t_spec, **kw))
    _results_match(
        [list(zip(a.tolist(), b.tolist())) for a, b in zip(pt, st)],
        [list(zip(a.tolist(), b.tolist())) for a, b in zip(pj, sj)],
    )


def test_q4_cache_bytes_accounting(tier):
    _, resident, _ = tier["torch"]
    dev, ispec = resident.dev, resident.ispec
    assert dev.q4_scale.ndim == 1
    real = dev.emb_q4.numel() + dev.q4_scale.numel() * 4
    assert tlayout.q4_cache_bytes(ispec) == real == jlayout.q4_cache_bytes(ispec)


def test_host_gather_rows_matches_jax(tier):
    """The host gather (windows, zero padding, out-of-range pids) equals the
    JAX package's."""
    t_lm, j_lm = tier["torch"][2], tier["jax"][2]
    n = len(tier["docs"])
    pids = np.asarray([[0, 5, n - 1, n, -1, 119], [n + 7, 3, 3, 60, 1, 2]], np.int64)
    got = tsearcher.host_gather_rows(t_lm, pids)
    want = jsearcher.host_gather_rows(j_lm, pids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_low_memory_matches_full():
    """low_memory without a q4 cache (the budget excludes it) reranks the
    whole pool from host rows: results equal the device-resident cascade's,
    in both packages."""
    rng = np.random.default_rng(4)
    docs = random_documents(rng, 50, 16, 32, variable=True)
    queries = [q for q in random_queries(rng, 5, 6, 32)]
    common = _common(docs)
    cpu = torch.device("cpu")
    dev_full, ispec = tlayout.to_device(**common, device=cpu)
    dev_lm, _ = tlayout.to_device(**common, device=cpu, residuals_on_device=False)
    assert dev_lm.residuals is None
    ivf_l = common["ivf_lengths"]
    full = tload.LoadedIndex(dev_full, ispec, cpu, ivf_lengths_host=ivf_l)
    lm = tload.LoadedIndex(dev_lm, ispec, cpu, ivf_lengths_host=ivf_l, **_host(common))
    kw = dict(top_k=7, n_full_scores=64, n_ivf_probe=8, show_progress=False)
    r_full = tsearcher.search_on_device(full, queries, **kw)
    r_lm = tsearcher.search_on_device(lm, queries, **kw)
    _results_match(r_lm, r_full)
    j_plain = _build_jax(common)[0]
    _results_match(r_lm, _search_jax(j_plain, queries, **kw))


def test_reload_ignores_low_memory_on_cpu(tmp_path):
    """``reload_index`` on the CPU keeps residuals on the device whatever
    low_memory says, as the JAX package does."""
    from fast_plaid_tpu_torch.search import FastPlaid

    rng = np.random.default_rng(2)
    docs = random_documents(rng, 40, 12, 32, variable=True)
    fp = FastPlaid(str(tmp_path / "idx"), device="cpu")  # low_memory=True default
    fp.create(docs)
    loaded = fp.indices["cpu"]
    assert not loaded.low_memory and loaded.dev.residuals is not None
    res = fp.search(random_queries(rng, 2, 4, 32), top_k=3, show_progress=False)
    assert len(res) == 2 and all(len(r) == 3 for r in res)
