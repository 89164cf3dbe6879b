"""Long documents in the port, on the CPU.

* The plain versions of kernels 2, 3 and 4 against the JAX package's Pallas
  kernels in interpret mode at doc_cap 1,040 (ColPali-like pages, caph 520):
  lengths 0, 1, <= caph, caph + 1 and doc_cap, the sentinel row; for the
  dedup kernel also pids with more than G requesters and an all-sentinel
  pool; atol 1e-3 (float32 sums in another order), identical -inf patterns.
* Stage 6 at doc_cap 1,040 on a dedup-viable pool calls the dedup wrapper
  (its shared memory does not depend on doc_cap) and gives the plain engine
  path's result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu import testing
from fast_plaid_tpu.index.layout import build_emb_cache
from fast_plaid_tpu.ops import rerank_dedup as jdedup
from fast_plaid_tpu.ops.rerank_kernel import maxsim_gather_scores as j_rerank
from fast_plaid_tpu.ops.rerank_kernel import maxsim_q4_gather_scores as j_q4
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.ops import rerank_dedup as tdedup
from fast_plaid_tpu_torch.ops.rerank_kernel import (
    maxsim_gather_scores_plain,
    maxsim_q4_gather_scores_plain,
)

torch.set_num_threads(2)

CAP = 1040
EDGE_LENS = [0, 1, 63, 64, 65, 519, 520, 521, 1039, 1040]


def _pool(rng, npd, b, r):
    pids = rng.integers(0, npd - 1, (b, r)).astype(np.int32)
    lens = rng.integers(1, CAP + 1, (b, r)).astype(np.int32)
    lens[0, : len(EDGE_LENS)] = EDGE_LENS
    pids[1, :2] = npd - 1  # the zero-length sentinel row
    lens[1, :2] = 0
    return pids, lens


def test_kernel2_plain_matches_pallas_interpret_long_docs():
    rng = np.random.default_rng(1040)
    npd, d, b, r, q = 9, 128, 2, 16, 8
    emb16 = jnp.asarray(rng.standard_normal((npd, CAP, d)), dtype=jnp.bfloat16)
    pids, lens = _pool(rng, npd, b, r)
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    want = np.asarray(
        j_rerank(emb16, jnp.asarray(pids), jnp.asarray(lens), jnp.asarray(queries),
                 interpret=True)
    )
    emb_t = torch.from_numpy(np.asarray(emb16, np.float32)).to(torch.bfloat16)
    got = maxsim_gather_scores_plain(
        emb_t, torch.from_numpy(pids), torch.from_numpy(lens), torch.from_numpy(queries)
    ).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 3  # one zero length, two sentinel slots
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-3)


def test_kernel3_plain_matches_pallas_interpret_long_docs():
    rng = np.random.default_rng(520)
    npd, d, b, r, q = 9, 128, 2, 16, 8
    caph = CAP // 2
    flat = rng.integers(0, 256, (npd * caph, d)).astype(np.uint8)
    scale = (rng.random(npd) + 0.05).astype(np.float32)
    pids, lens = _pool(rng, npd, b, r)
    pids[1, 2] = npd + 7  # out of range: clamped to the last document
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    want = np.asarray(
        j_q4(jnp.asarray(flat), jnp.asarray(scale), jnp.asarray(pids), jnp.asarray(lens),
             jnp.asarray(queries), interpret=True)
    )
    got = maxsim_q4_gather_scores_plain(
        torch.from_numpy(flat), torch.from_numpy(scale), torch.from_numpy(pids),
        torch.from_numpy(lens), torch.from_numpy(queries),
    ).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 3
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-3)


def _dedup_pool(rng, case, npd, b, r):
    """pids over documents 0..npd-2 whose lengths are EDGE_LENS (the last
    document is the zero-length sentinel), lens those of the documents."""
    if case == "edge_lens":
        pids = rng.integers(0, npd - 1, (b, r)).astype(np.int32)
        pids[0, : npd - 1] = np.arange(npd - 1)  # every length at least once
        pids[1, :3] = npd - 1
    elif case == "runs_past_g":  # every query asks for documents 1-4: runs of b > G
        pids = np.tile(np.arange(r, dtype=np.int32) % 4 + 1, (b, 1))
        pids[:, -3:] = rng.integers(5, npd - 1, (b, 3))
    else:  # all_sentinel
        pids = np.full((b, r), npd - 1, np.int32)
    return pids


@pytest.mark.parametrize("case", ["edge_lens", "runs_past_g", "all_sentinel"])
def test_dedup_plain_matches_pallas_interpret_long_docs(case):
    rng = np.random.default_rng(len(case))
    npd, d, b, r, q, g = len(EDGE_LENS) + 1, 128, 12, 16, 16, 8
    doc_lengths = np.array([*EDGE_LENS, 0], np.int32)
    emb16 = jnp.asarray(rng.standard_normal((npd, CAP, d)), dtype=jnp.bfloat16)
    emb_t = torch.from_numpy(np.asarray(emb16, np.float32)).to(torch.bfloat16)
    pids = _dedup_pool(rng, case, npd, b, r)
    lens = doc_lengths[pids]
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    want = np.asarray(
        jdedup.maxsim_gather_scores_dedup(
            emb16, jnp.asarray(pids), jnp.asarray(lens), jnp.asarray(queries),
            g=g, e_tile=8, chunk=32, interpret=True,
        )
    )
    args = (emb_t, torch.from_numpy(pids), torch.from_numpy(lens), torch.from_numpy(queries))
    got = tdedup.maxsim_gather_scores_dedup_plain(*args, g=g).numpy()
    per_query = maxsim_gather_scores_plain(*args).numpy()
    for ref in (want, per_query):
        assert np.array_equal(np.isneginf(got), np.isneginf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-3, atol=1e-3)
    n_neg = int(np.isneginf(got).sum())
    if case == "all_sentinel":
        assert n_neg == b * r
    elif case == "runs_past_g":
        assert n_neg == 0
    else:
        assert n_neg == int((lens == 0).sum()) >= 4


def test_stage6_takes_the_dedup_kernel_at_long_docs(monkeypatch):
    from fast_plaid_tpu_torch.search import engine as tengine

    calls = []
    monkeypatch.setattr(
        tengine, "maxsim_gather_scores_dedup",
        lambda *a, **k: calls.append("dedup") or tdedup.maxsim_gather_scores_dedup(*a, **k),
    )
    monkeypatch.setattr(
        tengine, "maxsim_gather_scores",
        lambda *a, **k: calls.append("per_query") or maxsim_gather_scores_plain(*a, **k),
    )
    monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", "1")  # the pool is dedup-viable
    rng = np.random.default_rng(0)
    docs = []
    for n in [1030, *rng.integers(1000, 1031, 15)]:
        x = rng.standard_normal((int(n), 128)).astype(np.float32)
        docs.append(x / np.linalg.norm(x, axis=-1, keepdims=True))
    dev_j, spec_j = testing.build_memory_index(docs, nbits=4, seed=0, k=32)
    dev_j = build_emb_cache(dev_j, spec_j)
    arrays = {
        f: np.asarray(getattr(dev_j, f))
        for f in dev_j._fields
        if getattr(dev_j, f) is not None and f != "buckets"
    }
    dev_t, spec_t = tlayout.device_index_from_arrays(arrays, dataclasses.asdict(spec_j), "cpu")
    assert spec_t.doc_cap == CAP
    q = torch.from_numpy(np.stack([d[:16] for d in docs[:4]]))
    kw = dict(ispec=spec_t, top_k=5, n_ivf_probe=4, n_full_scores=32)
    k_ids, k_sc = tengine.search_impl(dev_t, q, None, use_rerank_kernel=True, **kw)
    assert calls == ["dedup"]
    p_ids, p_sc = tengine.search_impl(dev_t, q, None, use_rerank_kernel=False, **kw)
    np.testing.assert_allclose(k_sc.numpy(), p_sc.numpy(), rtol=1e-5, atol=1e-5)
    assert k_ids[:, 0].tolist() == [0, 1, 2, 3]
