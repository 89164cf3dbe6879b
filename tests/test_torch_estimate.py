"""Segmented-estimate parity: the port's plain version against the JAX
Pallas kernel in interpret mode and the JAX engine's fallback.

On the CPU the port's ``segmented_estimate`` wrapper runs its plain PyTorch
version (the CUDA kernel is held against the same plain version on the card
by chip_smoke.py). Compared at run heads, where the estimate is defined;
atol 1e-5 because the Q-sum runs in another order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu.ops.estimate_kernel import segmented_estimate as j_estimate
from fast_plaid_tpu.search import engine as jengine
from fast_plaid_tpu_torch.ops.estimate_kernel import (
    segmented_estimate,
    segmented_estimate_plain,
)
from fast_plaid_tpu_torch.search import engine as tengine

torch.set_num_threads(2)


def _heads(pid):
    heads = np.ones_like(pid, dtype=bool)
    heads[:, 1:] = pid[:, 1:] != pid[:, :-1]
    return heads


def _inputs(seed, w, b=3, c=12, q=16):
    rng = np.random.default_rng(seed)
    pid = np.sort(rng.integers(0, w // 3, (b, w)).astype(np.int32), axis=1)
    pid[:, -5:] = 10_000  # sentinel-style tail run
    own = rng.integers(0, c, (b, w)).astype(np.int32)
    table = rng.standard_normal((b, c, q)).astype(np.float32)
    return pid, own, table


def _port(pid, own, table):
    return segmented_estimate(
        torch.from_numpy(pid), torch.from_numpy(own), torch.from_numpy(table)
    ).numpy()


@pytest.mark.parametrize("w,t_tile", [(96, 32), (512, 128), (130, 64)])
def test_matches_pallas_interpret(w, t_tile):
    pid, own, table = _inputs(0, w)
    want = np.asarray(
        j_estimate(
            jnp.asarray(pid), jnp.asarray(own), jnp.asarray(table),
            t_tile=t_tile, interpret=True,
        )
    )
    got = _port(pid, own, table)
    heads = _heads(pid)
    np.testing.assert_allclose(got[heads], want[heads], rtol=0, atol=1e-5)


def test_single_giant_run_across_all_tiles():
    rng = np.random.default_rng(1)
    b, w, c, q, t = 2, 256, 7, 8, 64
    pid = np.zeros((b, w), np.int32)  # ONE run spanning every tile
    own = rng.integers(0, c, (b, w)).astype(np.int32)
    table = rng.standard_normal((b, c, q)).astype(np.float32)
    want = np.asarray(
        j_estimate(
            jnp.asarray(pid), jnp.asarray(own), jnp.asarray(table),
            t_tile=t, interpret=True,
        )
    )
    got = _port(pid, own, table)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", [96, 512])
def test_slot_estimates_fallback_matches_jax(w):
    """engine._slot_estimates(use_kernel=False) in both packages (the
    doubling capped at C) agree at run heads."""
    pid, own, table = _inputs(2, w)
    want = np.asarray(
        jengine._slot_estimates(
            jnp.asarray(pid), jnp.asarray(own),
            jnp.asarray(table).astype(jnp.bfloat16),
            mem_budget=1 << 20, use_kernel=False,
        )
    )
    got = tengine._slot_estimates(
        torch.from_numpy(pid), torch.from_numpy(own),
        torch.from_numpy(table).to(torch.bfloat16), use_kernel=False,
    ).numpy()
    heads = _heads(pid)
    np.testing.assert_allclose(got[heads], want[heads], rtol=0, atol=1e-5)


def test_plain_is_full_run_suffix_at_every_slot():
    """The plain version (the kernel's contract) holds the whole run suffix
    at every slot, not only at heads."""
    pid, own, table = _inputs(3, 200, c=5, q=8)
    got = segmented_estimate_plain(
        torch.from_numpy(pid), torch.from_numpy(own), torch.from_numpy(table)
    ).numpy()
    t16 = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    for bi in range(pid.shape[0]):
        for i in range(pid.shape[1]):
            j = i
            while j < pid.shape[1] and pid[bi, j] == pid[bi, i]:
                j += 1
            want = t16[bi, own[bi, i:j]].max(axis=0).sum()
            assert abs(got[bi, i] - want) <= 1e-5


def test_cpu_tensors_take_plain_version_and_do_not_count():
    before = segmented_estimate.launches
    pid, own, table = _inputs(4, 64)
    _port(pid, own, table)
    assert segmented_estimate.launches == before
