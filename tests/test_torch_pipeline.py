"""Stage 6's one chunk loop and the search's one tile loop, on the CPU.

Every plain exact MaxSim runs in ``engine._chunked_maxsim``; its callers say
only where a chunk's rows come from: the resident codec (rows decompressed
from device-resident residuals), a length bucket's codec rows, and
low_memory's rows gathered on the host. Cutting a pool into chunks must not
change a score (``torch.equal``), and the searches must still match the JAX
package's on the same index: ids equal except at exact ties and scores
within 1e-5 for the resident codec and low_memory (``test_torch_q4tier``),
ids equal and scores within 1e-4 for the buckets (``test_torch_buckets``).

``searcher.search_on_device`` keeps two tiles in flight on both paths; a
RuntimeError in one tile's work, on the device or on the gather worker,
empties that tile's results with a warning and leaves the others alone.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_plaid_tpu import testing as jtesting
from fast_plaid_tpu.index import ivf as jivf
from fast_plaid_tpu.index import layout as jlayout
from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
from fast_plaid_tpu.ops.kmeans import train_kmeans
from fast_plaid_tpu.search import engine as jengine
from fast_plaid_tpu.search import load as jload
from fast_plaid_tpu.search import searcher as jsearcher
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.search import engine as tengine
from fast_plaid_tpu_torch.search import load as tload
from fast_plaid_tpu_torch.search import searcher as tsearcher

torch.set_num_threads(2)

DIM = 32
TOL = 1e-5
BUCKET_TOL = 1e-4
SEARCH = dict(top_k=5, n_full_scores=128, n_ivf_probe=16)
ONE_CHUNK = 1 << 40
FLOOR_CHUNK = 4  # the chunk rule's floor: mem_budget 1 gives chunks of 4 rows


def _unit(rng, n: int, dim: int = DIM) -> np.ndarray:
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _codec_arrays(docs, nbits: int = 4) -> dict:
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


def _host_rows(common: dict) -> dict:
    lens = common["doc_lengths"]
    return dict(
        low_memory=True,
        host_codes=common["codes"].astype(np.int32),
        host_residuals=common["residuals"],
        host_doc_offsets=np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64),
        host_doc_lengths=lens.astype(np.int32),
    )


def _carry(dev, ispec):
    """A JAX bucketed DeviceIndex as the port's."""
    arrays = {f: np.asarray(getattr(dev, f)) for f in dev._fields
              if getattr(dev, f) is not None and f != "buckets"}
    arrays["buckets"] = [{f: np.asarray(getattr(bk, f)) for f in bk._fields
                          if getattr(bk, f) is not None} for bk in dev.buckets]
    return tlayout.device_index_from_arrays(arrays, dataclasses.asdict(ispec), "cpu")


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(19)
    docs = [_unit(rng, int(n)) for n in rng.integers(6, 32, 150)]
    common = _codec_arrays(docs)
    ivf_l = common["ivf_lengths"]
    cpu_j, cpu_t = jax.devices("cpu")[0], torch.device("cpu")
    dev_j, spec_j = jlayout.to_device(**common, device=cpu_j)
    dev_t, spec_t = tlayout.to_device(**common, device=cpu_t)
    lm_j, _ = jlayout.to_device(**common, device=cpu_j, residuals_on_device=False)
    lm_t, _ = tlayout.to_device(**common, device=cpu_t, residuals_on_device=False)
    # 90% short documents, 10% long: the bucketed layout splits them.
    mixed_lens = np.concatenate([rng.integers(12, 25, 180), rng.integers(140, 161, 20)])
    mixed = [_unit(rng, int(n)) for n in mixed_lens]
    bk_j, bk_spec_j = jtesting.build_memory_index(mixed, seed=2, length_buckets=4)
    assert bk_spec_j.bucket_caps
    bk_t, bk_spec_t = _carry(bk_j, bk_spec_j)
    assert bk_t.residuals is None and bk_t.emb_cache is None and bk_t.buckets
    assert all(bk.emb is None for bk in bk_t.buckets)
    return dict(
        queries=[q for q in _unit(rng, 6 * 8).reshape(6, 8, DIM)],
        resident=(dev_j, spec_j, dev_t, spec_t),
        bucketed=(bk_j, bk_spec_j, bk_t, bk_spec_t),
        low_memory=(
            jload.LoadedIndex(lm_j, spec_j, cpu_j, ivf_lengths_host=ivf_l, **_host_rows(common)),
            tload.LoadedIndex(lm_t, spec_t, cpu_t, ivf_lengths_host=ivf_l, **_host_rows(common)),
        ),
        plain=tload.LoadedIndex(dev_t, spec_t, cpu_t, ivf_lengths_host=ivf_l),
    )


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


@pytest.mark.parametrize("budget", [ONE_CHUNK, 1], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("source", ["resident_codec", "bucketed_codec", "low_memory"])
def test_stage6_row_sources_chunk_alike(indexes, source, budget, monkeypatch):
    loops, real = [], tengine._chunked_maxsim

    def recorded(take, queries, n, cap, mem_budget):
        spans = []

        def counted(lo, hi):
            spans.append((lo, min(hi, n)))
            return take(lo, hi)

        got = real(counted, queries, n, cap, mem_budget)
        loops.append((spans, n, got, real(take, queries, n, cap, ONE_CHUNK)))
        return got

    monkeypatch.setattr(tengine, "_chunked_maxsim", recorded)
    queries = np.stack(indexes["queries"])
    if source == "low_memory":
        lm_j, lm_t = indexes["low_memory"]
        want = jsearcher.search_on_device(lm_j, list(queries), subsets=None, want_tokens=False,
                                          show_progress=False, **SEARCH)
        got = tsearcher.search_on_device(lm_t, queries, mem_budget=budget, show_progress=False,
                                         **SEARCH)
        _results_match(got, want)
    else:
        dev_j, spec_j, dev_t, spec_t = indexes["resident" if source == "resident_codec" else "bucketed"]
        kw = dict(top_k=10, n_ivf_probe=8, n_full_scores=256) if source == "bucketed_codec" else SEARCH
        kw = dict(kw, want_tokens=False)
        pj, sj = (np.asarray(x) for x in jengine.search_core(dev_j, jnp.asarray(queries), None,
                                                              ispec=spec_j, **kw))
        pt, st = (x.numpy() for x in tengine.search_impl(dev_t, torch.from_numpy(queries), None,
                                                          ispec=spec_t, mem_budget=budget, **kw))
        if source == "bucketed_codec":
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_allclose(st, sj, rtol=0, atol=BUCKET_TOL)
        else:
            _results_match(
                [list(zip(p.tolist(), s.tolist())) for p, s in zip(pt, st)],
                [list(zip(p.tolist(), s.tolist())) for p, s in zip(pj, sj)],
            )
    want_loops = len(spec_t.bucket_caps) if source == "bucketed_codec" else 1
    assert len(loops) >= want_loops
    for spans, n, got, whole in loops:
        assert spans[0][0] == 0 and spans[-1][1] == n  # every row, in order, once
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        if budget == ONE_CHUNK:
            assert len(spans) == 1
        else:
            assert len(spans) >= 3 and all(hi - lo == FLOOR_CHUNK for lo, hi in spans[:-1])
        assert got.shape == whole.shape and torch.equal(got, whole)


def _failing(fn, fail_call: int):
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(None)
        if len(calls) == fail_call:
            raise RuntimeError("injected failure")
        return fn(*args, **kwargs)

    return wrapped, calls


@pytest.mark.parametrize(
    ("path", "target"),
    [("resident", "search_impl"), ("low_memory", "candidates_impl"), ("low_memory", "_pack_rows")],
    ids=["resident", "low_memory_device", "low_memory_gather_worker"],
)
def test_a_failed_tile_is_contained(indexes, path, target, monkeypatch):
    loaded = indexes["plain"] if path == "resident" else indexes["low_memory"][1]
    queries = np.stack(indexes["queries"])
    kw = dict(max_tile=2, show_progress=False, **SEARCH)  # three tiles of two
    clean = tsearcher.search_on_device(loaded, queries, **kw)
    assert all(clean)
    wrapped, calls = _failing(getattr(tsearcher, target), 2)
    monkeypatch.setattr(tsearcher, target, wrapped)
    with pytest.warns(RuntimeWarning, match=re.escape("search failed for queries [2, 4)")):
        got = tsearcher.search_on_device(loaded, queries, **kw)
    assert len(calls) == 3
    assert got[2:4] == [[], []]
    assert got[:2] + got[4:] == clean[:2] + clean[4:]
