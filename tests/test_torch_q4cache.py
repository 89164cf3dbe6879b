"""q4 codec and q4 rerank parity: the port's ``ops/q4cache.py`` and
``maxsim_q4_gather_scores`` against the JAX package on the same seeded inputs.

* ``quantize_emb_q4``: packed bytes equal, scales equal to 1e-7 relative.
* ``dequantize_emb_q4`` and ``score_q4``: within 1e-5 (float32 sums in
  another order).
* ``maxsim_q4_gather_scores`` (its plain version on the CPU) against the
  JAX wrapper run with ``interpret=True``, at doc_cap 16 and 48 (caph 24,
  not a multiple of 16) with lengths on both sides of caph, sentinel and
  out-of-range pids: 1e-5, identical -inf patterns.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu.ops import q4cache as jq4
from fast_plaid_tpu.ops.rerank_kernel import maxsim_q4_gather_scores as j_q4_kernel
from fast_plaid_tpu_torch.ops import q4cache as tq4
from fast_plaid_tpu_torch.ops.rerank_kernel import (
    maxsim_q4_gather_scores,
    maxsim_q4_gather_scores_plain,
)

torch.set_num_threads(2)

TOL = 1e-5


def _docs(seed, npd, cap, d, short_frac=0.4):
    """Unit-norm token rows, zero past each length; the last row is the
    zero-length sentinel. Some lengths at or below caph, some above."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((npd, cap, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    lens = rng.integers(cap // 2 + 1, cap + 1, npd).astype(np.int32)
    short = rng.random(npd) < short_frac
    lens[short] = rng.integers(1, cap // 2 + 1, int(short.sum()))
    lens[-1] = 0
    for i in range(npd):
        emb[i, lens[i] :] = 0
    return rng, emb, lens


@pytest.mark.parametrize("shape", [(8, 16, 128), (5, 48, 32), (3, 6, 10)])
def test_quantize_bytes_equal(shape):
    rng = np.random.default_rng(sum(shape))
    emb = rng.standard_normal(shape).astype(np.float32)
    emb[0] = 0.0  # an all-zero document: scale 0
    pj, sj = jq4.quantize_emb_q4(jnp.asarray(emb))
    pt, st = tq4.quantize_emb_q4(torch.from_numpy(emb))
    assert pt.dtype == torch.uint8 and tuple(pt.shape) == pj.shape
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7, atol=0)
    assert float(st[0]) == 0.0


def test_quantize_rounds_half_to_even():
    """Values exactly halfway between levels round to even in both."""
    emb = np.zeros((1, 2, 8), np.float32)
    emb[0, 0, :6] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5]  # peak 7 -> scale 1
    pj, _ = jq4.quantize_emb_q4(jnp.asarray(emb))
    pt, _ = tq4.quantize_emb_q4(torch.from_numpy(emb))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    levels = (pt.numpy()[0, 0, :6] & 15).astype(int) - 8
    assert levels.tolist() == [7, 0, 2, 2, 0, -2]


def test_quantize_odd_token_count_rejected():
    with pytest.raises(ValueError, match="even"):
        tq4.quantize_emb_q4(torch.zeros((3, 8)))


def test_dequantize_matches_jax():
    _, emb, _ = _docs(1, 6, 16, 64)
    pj, sj = jq4.quantize_emb_q4(jnp.asarray(emb))
    pt, st = tq4.quantize_emb_q4(torch.from_numpy(emb))
    want = np.asarray(jq4.dequantize_emb_q4(pj, sj))
    got = tq4.dequantize_emb_q4(pt, st).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    step = np.abs(emb).max(axis=(1, 2), keepdims=True) / 14.0
    assert np.all(np.abs(got - emb) <= step + 1e-6)


def _q4_inputs(seed, npd, cap, d, b, r, q):
    rng, emb, lens = _docs(seed, npd, cap, d)
    pj, sj = jq4.quantize_emb_q4(jnp.asarray(emb))
    flat = np.array(pj).reshape(npd * (cap // 2), d)
    scale = np.array(sj)
    pids = rng.integers(0, npd - 1, (b, r)).astype(np.int32)
    pids[0, :4] = [npd - 1, -3, npd, npd + 50]  # sentinel, out of range
    queries = rng.standard_normal((b, q, d)).astype(np.float32)
    return flat, scale, lens, pids, queries


@pytest.mark.parametrize("cap,d", [(16, 128), (48, 128), (48, 32)])
def test_score_q4_matches_jax(cap, d):
    flat, scale, lens, pids, queries = _q4_inputs(cap + d, 40, cap, d, 3, 20, 8)
    want = np.asarray(
        jq4.score_q4(
            jnp.asarray(flat), jnp.asarray(scale), jnp.asarray(lens),
            jnp.asarray(pids), jnp.asarray(queries),
        )
    )
    got = tq4.score_q4(
        torch.from_numpy(flat), torch.from_numpy(scale), torch.from_numpy(lens),
        torch.from_numpy(pids), torch.from_numpy(queries),
    ).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    chunked = tq4.score_q4(
        torch.from_numpy(flat), torch.from_numpy(scale), torch.from_numpy(lens),
        torch.from_numpy(pids), torch.from_numpy(queries), mem_budget=4096,
    ).numpy()
    np.testing.assert_allclose(chunked, got, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cap,q", [(16, 8), (48, 16), (48, 24)])
def test_q4_kernel_matches_pallas_interpret(cap, q):
    npd, d = 40, 128
    flat, scale, lens, pids, queries = _q4_inputs(cap * q, npd, cap, d, 3, 32, q)
    row_lens = lens[np.clip(pids, 0, npd - 1)]
    want = np.asarray(
        j_q4_kernel(
            jnp.asarray(flat), jnp.asarray(scale), jnp.asarray(pids),
            jnp.asarray(row_lens), jnp.asarray(queries), interpret=True,
        )
    )
    before = maxsim_q4_gather_scores.launches
    got = maxsim_q4_gather_scores(
        torch.from_numpy(flat), torch.from_numpy(scale), torch.from_numpy(pids),
        torch.from_numpy(row_lens), torch.from_numpy(queries),
    ).numpy()
    assert maxsim_q4_gather_scores.launches == before  # CPU tensors never launch
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[0, 0])  # the sentinel row has length 0
    fin = np.isfinite(want)
    assert fin.sum() > 0.9 * fin.size
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    # Lengths on both sides of caph were exercised.
    live = row_lens[fin]
    assert (live <= cap // 2).any() and (live > cap // 2).any()


def test_q4_plain_matches_dense_dequantized_maxsim():
    """The plain version equals MaxSim over the dequantized rows in document
    token order (the two-plane max-combine is the same reduction)."""
    npd, cap, d = 12, 48, 32
    flat, scale, lens, pids, queries = _q4_inputs(3, npd, cap, d, 2, 10, 8)
    row_lens = lens[np.clip(pids, 0, npd - 1)]
    got = maxsim_q4_gather_scores_plain(
        torch.from_numpy(flat), torch.from_numpy(scale), torch.from_numpy(pids),
        torch.from_numpy(row_lens), torch.from_numpy(queries),
    ).numpy()
    deq = tq4.dequantize_emb_q4(
        torch.from_numpy(flat).reshape(npd, cap // 2, d), torch.ones(npd)
    ).numpy()
    qb = np.asarray(jnp.asarray(queries).astype(jnp.bfloat16), np.float32)
    for bi in range(pids.shape[0]):
        for ri in range(pids.shape[1]):
            p = int(np.clip(pids[bi, ri], 0, npd - 1))
            n = int(row_lens[bi, ri])
            if n <= 0:
                assert np.isneginf(got[bi, ri])
                continue
            want = (deq[p, :n] @ qb[bi].T).max(axis=0).sum() * scale[p]
            np.testing.assert_allclose(got[bi, ri], want, rtol=1e-5, atol=1e-5)


def test_q4_plain_chunking_invariant():
    flat, scale, lens, pids, queries = _q4_inputs(9, 30, 16, 64, 3, 17, 8)
    args = [torch.from_numpy(x) for x in (flat, scale, pids, lens[np.clip(pids, 0, 29)], queries)]
    whole = maxsim_q4_gather_scores_plain(*args)
    chunked = maxsim_q4_gather_scores_plain(*args, mem_budget=1)
    assert torch.equal(whole, chunked)
