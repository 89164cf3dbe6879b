"""Fused gather+MaxSim parity: the port's plain version against the JAX
Pallas rerank kernel in interpret mode.

Includes zero-length rows and the sentinel pid; rtol and atol 1e-5, and
empty rows must be exactly -inf in both.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu.ops.rerank_kernel import maxsim_gather_scores as j_rerank
from fast_plaid_tpu_torch.ops.rerank_kernel import (
    maxsim_gather_scores,
    maxsim_gather_scores_plain,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus():
    npd, cap, d = 64, 16, 128
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((npd, cap, d)).astype(np.float32)
    doc_lens = rng.integers(1, cap + 1, npd).astype(np.int32)
    doc_lens[-1] = 0  # zero-length sentinel row
    b, r, qn = 3, 24, 8
    pids = rng.integers(0, npd, (b, r)).astype(np.int32)
    pids[0, :4] = npd - 1  # sentinel hits must score -inf
    lens = doc_lens[pids]
    lens[1, :3] = 0  # zero-length rows of real documents
    queries = rng.standard_normal((b, qn, d)).astype(np.float32)
    emb16 = jnp.asarray(emb).astype(jnp.bfloat16)
    return emb16, pids, lens, queries


def _port(emb16, pids, lens, queries, fn=maxsim_gather_scores):
    emb_t = torch.from_numpy(np.asarray(emb16, np.float32)).to(torch.bfloat16)
    return fn(
        emb_t, torch.from_numpy(pids), torch.from_numpy(lens), torch.from_numpy(queries)
    ).numpy()


def test_matches_pallas_interpret(corpus):
    emb16, pids, lens, queries = corpus
    want = np.asarray(
        j_rerank(
            emb16, jnp.asarray(pids), jnp.asarray(lens), jnp.asarray(queries),
            interpret=True,
        )
    )
    got = _port(emb16, pids, lens, queries)
    empty = lens == 0
    assert np.isneginf(want[empty]).all() and np.isneginf(got[empty]).all()
    assert np.isfinite(got[~empty]).all()
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=1e-5, atol=1e-5)


def test_chunking_does_not_change_scores(corpus):
    emb16, pids, lens, queries = corpus
    emb_t = torch.from_numpy(np.asarray(emb16, np.float32)).to(torch.bfloat16)
    args = (emb_t, torch.from_numpy(pids), torch.from_numpy(lens), torch.from_numpy(queries))
    whole = maxsim_gather_scores_plain(*args)
    chunked = maxsim_gather_scores_plain(*args, mem_budget=1)  # one column a chunk
    assert torch.equal(whole, chunked)


def test_out_of_range_pids_are_empty(corpus):
    emb16, pids, lens, queries = corpus
    pids = pids.copy()
    lens = lens.copy()
    pids[2, :3] = [-1, emb16.shape[0], 10_000]
    lens[2, :3] = 5
    before = maxsim_gather_scores.launches
    got = _port(emb16, pids, lens, queries)
    assert np.isneginf(got[2, :3]).all()
    assert maxsim_gather_scores.launches == before  # CPU tensors never launch
