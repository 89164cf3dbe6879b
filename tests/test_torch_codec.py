"""Codec parity: the PyTorch port against fast_plaid_tpu.ops.codec.

Same inputs (numpy, seeded) through both. Packed bytes must be identical
wherever the codes agree; codes may differ only at true near-ties (top-2
score gap within bf16 epsilon); decompression agrees within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu.ops import codec as jcodec
from fast_plaid_tpu_torch.ops import codec as tcodec

torch.set_num_threads(2)

BF16_EPS = 2.0**-7


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    k, d, t = 64, 128, 3000
    cent = _unit(rng.standard_normal((k, d)))
    emb = _unit(rng.standard_normal((t, d)))
    codes = np.asarray(jcodec.assign_codes(jnp.asarray(emb), jnp.asarray(cent)))
    params = jcodec.train_codec(emb - cent[codes], 4)
    return cent, emb, params


@pytest.mark.parametrize("nbits", [2, 4])
def test_compress_matches_jax(setup, nbits):
    cent, emb, _ = setup
    codes0 = np.asarray(jcodec.assign_codes(jnp.asarray(emb), jnp.asarray(cent)))
    cuts = jcodec.train_codec(emb - cent[codes0], nbits).bucket_cutoffs
    cj, pj = (
        np.asarray(x)
        for x in jcodec.compress(jnp.asarray(emb), jnp.asarray(cent), jnp.asarray(cuts), nbits)
    )
    ct, pt = (
        x.numpy()
        for x in tcodec.compress(
            torch.from_numpy(emb), torch.from_numpy(cent), torch.from_numpy(cuts), nbits
        )
    )
    assert ct.dtype == np.int32 and pt.dtype == np.uint8 and pt.shape == pj.shape
    agree = cj == ct
    np.testing.assert_array_equal(pt[agree], pj[agree])
    # Disagreements only at near-ties of the bf16-rounded scores.
    e16 = np.asarray(jnp.asarray(emb).astype(jnp.bfloat16), np.float64)
    c16 = np.asarray(jnp.asarray(cent).astype(jnp.bfloat16), np.float64)
    scores = e16 @ c16.T
    idx = np.nonzero(~agree)[0]
    gaps = np.abs(scores[idx, cj[idx]] - scores[idx, ct[idx]])
    assert (gaps <= BF16_EPS).all(), gaps.max()
    assert agree.mean() > 0.99


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_pack_unpack_match_jax(nbits):
    rng = np.random.default_rng(nbits)
    ids = rng.integers(0, 1 << nbits, (37, 128)).astype(np.uint8)
    pj = np.asarray(jcodec.pack_nibbles(jnp.asarray(ids), nbits))
    pt = tcodec.pack_nibbles(torch.from_numpy(ids), nbits).numpy()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(
        tcodec.unpack_nibbles(torch.from_numpy(pt), nbits, 128).numpy(), ids
    )


def test_quantize_residuals_matches_jax(setup):
    cent, emb, params = setup
    res = emb[:500] - cent[:1]
    qj = np.asarray(
        jcodec.quantize_residuals(jnp.asarray(res), jnp.asarray(params.bucket_cutoffs))
    )
    qt = tcodec.quantize_residuals(
        torch.from_numpy(res), torch.from_numpy(params.bucket_cutoffs)
    ).numpy()
    np.testing.assert_array_equal(qt, qj)


@pytest.mark.parametrize("out_dtype", [None, "bf16"])
def test_decompress_matches_jax(setup, out_dtype):
    cent, emb, params = setup
    rng = np.random.default_rng(3)
    codes = rng.integers(0, cent.shape[0], (7, 11)).astype(np.int32)
    packed = rng.integers(0, 256, (7, 11, 64)).astype(np.uint8)
    w = params.bucket_weights
    dj = np.asarray(
        jcodec.decompress(
            jnp.asarray(codes), jnp.asarray(packed), jnp.asarray(cent), jnp.asarray(w), 4,
            out_dtype=jnp.bfloat16 if out_dtype else None,
        ),
        np.float32,
    )
    dt = (
        tcodec.decompress(
            torch.from_numpy(codes), torch.from_numpy(packed), torch.from_numpy(cent),
            torch.from_numpy(w), 4,
            out_dtype=torch.bfloat16 if out_dtype else None,
        )
        .float()
        .numpy()
    )
    # float32: within 1e-6; bf16 output: within one bf16 ulp of |x| <= 1.
    atol = 2.0**-8 if out_dtype else 1e-6
    np.testing.assert_allclose(dt, dj, rtol=0, atol=atol)
