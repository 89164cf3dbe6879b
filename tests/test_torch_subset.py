"""Subset-restricted search: the port against the JAX package on the CPU.

(a) Engine level, one index carried across with ``device_index_from_arrays``:
    the subset's cell mask, the cascade with a subset (``candidates_impl``,
    budgeted and exhaustive, with its density-scaled stats) and the
    direct-subset pool of ``search_impl`` (emb_cache and decompress rerank).
(b) The low_memory cascade with a subset, through ``LoadedIndex``es built in
    both packages from one set of host arrays.
(c) API level: the shared, per-query, int, empty and unsorted-with-duplicates
    subsets of ``tests/test_filtering.py`` / ``tests/test_subset_paths.py``.
Scores atol 1e-4 (1e-5 for the q4 tier); ids equal except for ties.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu import testing
from fast_plaid_tpu.index import ivf as jivf
from fast_plaid_tpu.index import layout as jlayout
from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
from fast_plaid_tpu.index.layout import build_emb_cache as j_build_emb_cache
from fast_plaid_tpu.ops.kmeans import train_kmeans
from fast_plaid_tpu.search import engine as jengine
from fast_plaid_tpu.search import load as jload
from fast_plaid_tpu.search import searcher as jsearcher
from fast_plaid_tpu_torch import search as tsearch
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.search import engine as tengine
from fast_plaid_tpu_torch.search import load as tload
from fast_plaid_tpu_torch.search import searcher as tsearcher

torch.set_num_threads(2)

DIM = 64
TOL = 1e-4


def _carry(dev, ispec):
    arrays = {
        f: np.asarray(getattr(dev, f))
        for f in dev._fields
        if getattr(dev, f) is not None and f != "buckets"
    }
    return tlayout.device_index_from_arrays(arrays, dataclasses.asdict(ispec), "cpu")


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(31)
    docs = testing.random_documents(rng, 300, 16, DIM, variable=True)
    dev_j, spec_j = testing.build_memory_index(docs, nbits=4, seed=0, k=128)
    dev_jc = j_build_emb_cache(dev_j, spec_j)
    dev_t, spec_t = _carry(dev_j, spec_j)
    dev_tc, _ = _carry(dev_jc, spec_j)
    planted = [11, 97, 150, 283]
    queries = np.concatenate(
        [testing.random_queries(rng, 4, 8, DIM), np.stack([docs[p][:8] for p in planted])]
    ).astype(np.float32)
    return dict(
        docs=docs, dev_j=dev_j, dev_jc=dev_jc, spec=spec_j, dev_t=dev_t, dev_tc=dev_tc,
        spec_t=spec_t, queries=queries, planted=planted,
        ivf_lengths=np.asarray(dev_j.ivf_lengths)[: spec_j.n_partitions],
    )


def _subsets(index, size, seed, with_planted=True):
    """[B, S] sorted int32 subsets, sentinel padded to a multiple of 8; planted
    queries' own documents included."""
    rng = np.random.default_rng(seed)
    n = index["spec"].n_docs
    rows = []
    for qi in range(index["queries"].shape[0]):
        ids = set(rng.choice(n, size=size, replace=False).tolist())
        if with_planted and qi >= 4:
            ids.discard(next(iter(ids)))
            ids.add(index["planted"][qi - 4])
        rows.append(sorted(ids))
    s_cap = -(-max(len(r) for r in rows) // 8) * 8
    out = np.full((len(rows), s_cap), n, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def assert_same_topk(ids_a, sc_a, ids_b, sc_b, tol=TOL):
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=tol)
    for ia, sa, ib, sb in zip(ids_a, sc_a, ids_b, sc_b):
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids.tolist()):
                if pid not in other.tolist():
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


def _budgeted(index, n_full):
    spec, lens = index["spec_t"], index["ivf_lengths"]
    q_cap, probe = index["queries"].shape[1], 8
    cand_cap = tengine.candidate_capacity(lens, min(q_cap * probe, spec.n_partitions), n_full)
    return dict(
        n_ivf_probe=probe, n_full_scores=n_full, cand_cap=cand_cap, approx_mode="cells",
        slot_budget=tengine.suggest_slot_budget(lens, n_full), rank_admit=0,
    )


@pytest.mark.parametrize("chunk", [8, 24, 1000])
def test_allowed_cells_mask_matches_jax(index, chunk):
    sub = _subsets(index, 37, seed=chunk)
    kp = index["dev_t"].centroids.shape[0]
    got = tengine._allowed_cells_mask(
        index["dev_t"], torch.from_numpy(sub), index["spec_t"], kp, chunk
    ).numpy()
    want = np.asarray(
        jengine._allowed_cells_mask(index["dev_j"], jnp.asarray(sub), index["spec"], kp, chunk)
    )
    np.testing.assert_array_equal(got, want)
    # exactly the cells of the subset documents' tokens
    codes, lens = index["dev_t"].codes.numpy(), index["dev_t"].doc_lengths.numpy()
    cells = {int(c) for p in sub[0] for c in codes[p, : lens[p]]}
    assert set(np.nonzero(got[0])[0].tolist()) == cells


@pytest.mark.parametrize("mode", ["budgeted", "exhaustive"])
def test_candidates_with_subset_match_jax(index, mode, monkeypatch):
    """The cascade with a subset (S > 2 R): the rerank pools agree as sets
    except for ties at the R-th estimate, and the stats agree exactly."""
    kw = _budgeted(index, 64)
    if mode == "exhaustive":
        kw["n_ivf_probe"] = index["spec"].n_partitions
    sub = _subsets(index, 160, seed=4)
    q = index["queries"]
    pj, stj = (
        np.asarray(x)
        for x in jengine.candidates_core(
            index["dev_j"], jnp.asarray(q), jnp.asarray(sub), ispec=index["spec"],
            with_stats=True, **kw,
        )
    )
    seen = {}
    top_k = tengine._top_k

    def record_top_k(x, k):
        seen["approx"], seen["r"] = x, k
        return top_k(x, k)

    monkeypatch.setattr(tengine, "_top_k", record_top_k)
    pt, stt = (
        x.numpy()
        for x in tengine.candidates_impl(
            index["dev_t"], torch.from_numpy(q), torch.from_numpy(sub),
            ispec=index["spec_t"], with_stats=True, use_estimate_kernel=True, **kw,
        )
    )
    np.testing.assert_array_equal(stt, stj)
    sent = index["spec"].sentinel_pid
    approx = seen["approx"].numpy()
    for b in range(pt.shape[0]):
        members = set(sub[b].tolist())
        assert set(pt[b].tolist()) <= members and set(pj[b].tolist()) <= members
        diff = (set(pt[b].tolist()) ^ set(pj[b].tolist())) - {sent}
        if diff:  # only ties at the R-th estimate may differ
            fin = np.sort(approx[b][np.isfinite(approx[b])])[::-1]
            boundary = fin[min(seen["r"], fin.size) - 1]
            assert np.sum(np.abs(fin - boundary) <= TOL) >= 2, (b, diff)


@pytest.mark.parametrize("cache", [True, False], ids=["emb_cache", "decompress"])
@pytest.mark.parametrize("size", [24, 160], ids=["direct_pool", "cascade"])
def test_search_with_subset_matches_jax(index, cache, size):
    kw = dict(_budgeted(index, 64), top_k=6, want_tokens=False, with_stats=True)
    sub = _subsets(index, size, seed=size)
    q = index["queries"]
    dev_j, dev_t = (index["dev_jc"], index["dev_tc"]) if cache else (index["dev_j"], index["dev_t"])
    pj, sj, stj = (
        np.asarray(x)
        for x in jengine.search_core(dev_j, jnp.asarray(q), jnp.asarray(sub), ispec=index["spec"], **kw)
    )
    pt, st, stt = (
        x.numpy()
        for x in tengine.search_impl(
            dev_t, torch.from_numpy(q), torch.from_numpy(sub), ispec=index["spec_t"],
            use_estimate_kernel=True, use_rerank_kernel=True, **kw,
        )
    )
    assert_same_topk(pt, st, pj, sj)
    np.testing.assert_array_equal(stt, stj)
    for b in range(pt.shape[0]):
        assert set(pt[b][pt[b] >= 0].tolist()) <= set(sub[b].tolist())
    assert pt[4:, 0].tolist() == index["planted"]


def test_direct_pool_is_subset_brute_force(index):
    """A direct pool reranks every subset document: the top-k equals
    brute-force MaxSim over the decompressed subset (bf16 inputs)."""
    spec, dev = index["spec_t"], index["dev_tc"]
    sub = _subsets(index, 30, seed=9, with_planted=False)
    q = torch.from_numpy(index["queries"])
    ids, scores = tengine.search_impl(
        dev, q, torch.from_numpy(sub), ispec=spec, top_k=5, n_ivf_probe=8, n_full_scores=64,
    )
    emb = dev.emb_cache.double()
    valid = torch.arange(spec.doc_cap) < dev.doc_lengths[:, None]
    for b in range(q.shape[0]):
        members = torch.from_numpy(sub[b][sub[b] < spec.n_docs]).long()
        ts = torch.einsum("ntd,qd->ntq", emb[members], q[b].to(torch.bfloat16).double())
        ts = torch.where(valid[members][..., None], ts, float("-inf"))
        truth = ts.amax(dim=1).sum(dim=-1)
        order = torch.argsort(-truth, stable=True)[:5]
        assert_same_topk(
            ids[b : b + 1].numpy(), scores[b : b + 1].numpy(),
            members[order][None].numpy(), truth[order][None].numpy(),
        )


def test_direct_pool_unsorted_duplicates_and_out_of_range(index):
    """Unsorted ids, duplicates, negative and out-of-range ids: the direct
    pool sorts, dedups and drops them, in both packages."""
    q = index["queries"][:2]
    n = index["spec"].n_docs
    messy = np.asarray([[9, 3, 3, 41, -4, 7, 9, n + 3], [60, 2, 2, 2, 7, 1, 0, n]], np.int32)
    kw = dict(top_k=5, n_ivf_probe=8, n_full_scores=64, want_tokens=False)
    pt, st = tengine.search_impl(
        index["dev_tc"], torch.from_numpy(q), torch.from_numpy(messy), ispec=index["spec_t"], **kw
    )
    pj, sj = jengine.search_core(
        index["dev_jc"], jnp.asarray(q), jnp.asarray(messy), ispec=index["spec"], **kw
    )
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=TOL)
    assert sorted(pt[0][pt[0] >= 0].tolist()) == [3, 7, 9, 41]


# ---------------------------------------------------------------------------
# (b) low_memory with a subset, LoadedIndexes in both packages
# ---------------------------------------------------------------------------


def _common(docs, nbits=4):
    flat = np.concatenate(docs)
    centroids = train_kmeans(flat, k=64, niters=4, seed=3)
    params = train_codec_from_documents(docs, centroids, nbits, 3)
    codes, packed = compress_documents(docs, centroids, params.bucket_cutoffs, nbits)
    doc_lengths = np.asarray([d.shape[0] for d in docs], np.int64)
    ivf, ivf_lengths = jivf.build_ivf(codes, doc_lengths, centroids.shape[0])
    return dict(
        centroids=centroids, bucket_weights=params.bucket_weights, codes=codes,
        residuals=packed, doc_lengths=doc_lengths, ivf=ivf, ivf_lengths=ivf_lengths,
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


@pytest.fixture(scope="module")
def low_memory():
    rng = np.random.default_rng(12)
    docs = testing.random_documents(rng, 200, 14, 32, variable=True)
    common = _common(docs)
    ivf_l = common["ivf_lengths"]
    cpu_j = jax.devices("cpu")[0]
    dev_j, spec_j = jlayout.to_device(**common, device=cpu_j, residuals_on_device=False)
    lm_j = jload.LoadedIndex(dev_j, spec_j, cpu_j, ivf_lengths_host=ivf_l, **_host(common))
    jload._build_q4_from_host(lm_j, block=64)
    cpu = torch.device("cpu")
    dev_t, spec_t = tlayout.to_device(**common, device=cpu, residuals_on_device=False)
    lm_t = tload.LoadedIndex(dev_t, spec_t, cpu, ivf_lengths_host=ivf_l, **_host(common))
    tload._build_q4_from_host(lm_t, block=64)
    planted = [5, 77, 123, 199]
    queries = [*testing.random_queries(rng, 3, 5, 32), *[docs[p][:6] for p in planted]]
    sub_rng = np.random.default_rng(1)
    subsets = []
    for qi in range(len(queries)):
        ids = sorted(set(sub_rng.choice(200, 90, replace=False).tolist()) - set(planted))
        if qi >= 3:
            ids = sorted(ids[:89] + [planted[qi - 3]])
        subsets.append(ids)
    return dict(jax=lm_j, torch=lm_t, queries=queries, subsets=subsets, planted=planted)


def _results_match(a, b, tol):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        sa, sb = np.asarray([s for _, s in ra]), np.asarray([s for _, s in rb])
        np.testing.assert_allclose(sa, sb, rtol=tol, atol=tol)
        for (pa, xa), (pb, _) in zip(ra, rb):
            if pa != pb:
                assert sum(abs(x - xa) <= tol for x in sb) >= 2, (pa, pb)


@pytest.mark.parametrize("n_full", [64, 512], ids=["q4_prefilter", "no_prefilter"])
def test_low_memory_subset_matches_jax(low_memory, n_full):
    kw = dict(top_k=5, n_full_scores=n_full, n_ivf_probe=16, show_progress=False)
    got = tsearcher.search_on_device(
        low_memory["torch"], low_memory["queries"], subsets=low_memory["subsets"], **kw
    )
    want = jsearcher.search_on_device(
        low_memory["jax"], low_memory["queries"], subsets=low_memory["subsets"],
        want_tokens=False, **kw,
    )
    _results_match(got, want, 1e-5)
    for row, sub in zip(got, low_memory["subsets"]):
        assert row and {p for p, _ in row} <= set(sub)
    assert [got[3 + i][0][0] for i in range(4)] == low_memory["planted"]


def test_low_memory_subset_takes_the_cascade(low_memory, monkeypatch):
    """Even a subset within the direct pool's size goes through the cascade
    in low_memory, as in the JAX package."""
    calls = []
    real = tsearcher.candidates_impl

    def record(*args, **kwargs):
        calls.append(args[2].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tsearcher, "candidates_impl", record)
    small = [s[:20] for s in low_memory["subsets"]]
    kw = dict(top_k=5, n_full_scores=512, n_ivf_probe=16, show_progress=False)
    got = tsearcher.search_on_device(low_memory["torch"], low_memory["queries"], subsets=small, **kw)
    assert calls and calls[0] == (len(small), 24)
    want = jsearcher.search_on_device(
        low_memory["jax"], low_memory["queries"], subsets=small, want_tokens=False, **kw
    )
    _results_match(got, want, 1e-5)


# ---------------------------------------------------------------------------
# (c) the API: subset forms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    rng = np.random.default_rng(2)
    docs = testing.random_documents(rng, 60, 12, 32)
    path = str(tmp_path_factory.mktemp("subset_api") / "idx")
    jsearch.FastPlaid(index=path, device="cpu").create(documents_embeddings=docs)
    return dict(
        docs=docs,
        t=tsearch.FastPlaid(index=path, device="cpu"),
        j=jsearch.FastPlaid(index=path, device="cpu"),
        queries=testing.random_queries(rng, 3, 5, 32),
    )


@pytest.mark.parametrize(
    "subset",
    [
        [1, 3, 5, 7, 9, 11],
        [[0, 1, 2], [10, 11, 12, 13], [40, 59, 3, 3, 80]],
        7,
        [],
        [9, 3, 3, 41, 7, 9, 60, 2],
    ],
    ids=["shared", "per_query", "int", "empty", "unsorted_duplicates"],
)
def test_api_subset_forms_match_jax(api, subset):
    kw = dict(top_k=10, show_progress=False)
    got = api["t"].search(api["queries"], subset=subset, **kw)
    want = api["j"].search(api["queries"], subset=subset, **kw)
    _results_match(got, want, TOL)
    rows = tsearcher.normalize_subset(subset, len(api["queries"]))
    for qi, row in enumerate(got):
        assert row
        if rows is not None:
            allowed = {p for p in rows[qi] if 0 <= p < 60}
            assert {p for p, _ in row} <= allowed
            assert len(row) == min(10, len(allowed))


def test_api_subset_length_mismatch_raises(api):
    with pytest.raises(ValueError):
        api["t"].search(api["queries"], subset=[[1], [2]], show_progress=False)


def test_api_subset_scores_match_unfiltered(api):
    q = api["docs"][4][None]
    full = dict(api["t"].search(q, top_k=60, show_progress=False)[0])
    sub = api["t"].search(q, top_k=5, subset=[4, 8, 15], show_progress=False)[0]
    assert [p for p, _ in sub][0] == 4
    for p, s in sub:
        assert abs(full[p] - s) < 1e-5
