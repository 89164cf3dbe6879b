"""Device-layout parity: the JAX package's to_device + build_emb_cache,
carried across with ``device_index_from_arrays``, equals the port's own
to_device + build_emb_cache from the same host arrays.

Integer fields identical; the bf16 emb_cache within one bf16 ulp.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu import testing
from fast_plaid_tpu.index import ivf as jivf
from fast_plaid_tpu.index import layout as jlayout
from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
from fast_plaid_tpu.ops import codec as jcodec
from fast_plaid_tpu.ops.kmeans import train_kmeans
from fast_plaid_tpu_torch.index import layout as tlayout

torch.set_num_threads(2)

DIM = 128


def export(dev, ispec):
    """A JAX DeviceIndex/IndexSpec as numpy arrays + spec fields."""
    arrays = {
        f: np.asarray(getattr(dev, f))
        for f in dev._fields
        if getattr(dev, f) is not None and f != "buckets"
    }
    return arrays, dataclasses.asdict(ispec)


def host_arrays(seed: int, n: int, length: int):
    rng = np.random.default_rng(seed)
    docs = testing.random_documents(rng, n, length, DIM, variable=True)
    flat = np.concatenate(docs)
    cent = train_kmeans(flat, k=32, niters=2, seed=seed)
    params = train_codec_from_documents(docs, cent, 4, seed)
    codes, packed = compress_documents(docs, cent, params.bucket_cutoffs, 4)
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    ivf, ivf_lengths = jivf.build_ivf(codes, lens, cent.shape[0])
    return dict(
        centroids=cent,
        bucket_weights=params.bucket_weights,
        codes=codes,
        residuals=packed,
        doc_lengths=lens,
        ivf=ivf,
        ivf_lengths=ivf_lengths,
        nbits=4,
    )


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("n,length", [(30, 12), (75, 20)])
def test_carried_index_equals_port_layout(n, length):
    host = host_arrays(n, n, length)
    dev_j, spec_j = jlayout.to_device(**host)
    dev_j = jlayout.build_emb_cache(dev_j, spec_j, block=16)
    carried, spec_c = tlayout.device_index_from_arrays(*export(dev_j, spec_j), "cpu")
    own, spec_t = tlayout.to_device(**host, device="cpu")
    own = tlayout.build_emb_cache(own, spec_t, block=16)
    assert spec_c == spec_t
    for f in ("codes", "residuals", "doc_lengths", "ivf", "ivf_offsets", "ivf_lengths"):
        a, b = getattr(carried, f), getattr(own, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert torch.equal(carried.centroids, own.centroids)
    assert torch.equal(carried.bucket_weights, own.bucket_weights)
    a = carried.emb_cache.float().numpy()
    b = own.emb_cache.float().numpy()
    assert carried.emb_cache.dtype == own.emb_cache.dtype == torch.bfloat16
    assert (np.abs(a - b) <= ulp_bf16(a)).all(), np.abs(a - b).max()
    assert own.emb_cache.numel() * 2 == tlayout.emb_cache_bytes(spec_t)


def test_decompress_2d_partial_final_block():
    """Blocks that do not divide the row count land every doc's rows at its
    own offset (mirrors the JAX package's tail-block regression test)."""
    rng = np.random.default_rng(13)
    n, cap, nbits, kp = 40, 16, 4, 64
    pd = DIM * nbits // 8
    codes = rng.integers(0, kp, (n, cap)).astype(np.int32)
    res = rng.integers(0, 256, (n, cap, pd)).astype(np.uint8)
    cents = rng.normal(size=(kp, DIM)).astype(np.float32)
    weights = np.sort(rng.normal(size=(1 << nbits,))).astype(np.float32)
    want = np.asarray(
        jcodec.decompress(
            jnp.asarray(codes), jnp.asarray(res), jnp.asarray(cents),
            jnp.asarray(weights), nbits, out_dtype=jnp.bfloat16,
        ),
        np.float32,
    )
    args = [torch.from_numpy(x) for x in (codes, res, cents, weights)]
    for block in (8, 16, 24, 40):
        got = tlayout._decompress_2d(*args, nbits=nbits, block=block).float().numpy()
        assert (np.abs(got - want) <= ulp_bf16(want)).all(), f"block={block}"


def test_build_emb_cache_block_independent():
    host = host_arrays(14, 30, 12)
    dev, spec = tlayout.to_device(**host, device="cpu")
    full = tlayout.build_emb_cache(dev, spec).emb_cache
    for block in (8, 12):
        assert torch.equal(tlayout.build_emb_cache(dev, spec, block=block).emb_cache, full)


def test_length_buckets_raise_rather_than_fall_back():
    """Where plan_buckets chooses buckets the port builds the JAX package's
    bucketed layout (it no longer raises, and never falls back to the
    single-cap layout); length_buckets=0 keeps the single cap."""
    host = host_arrays(5, 40, 80)
    lens = host["doc_lengths"].copy()
    lens[:30] = 4  # strong length skew: plan_buckets chooses buckets
    host["doc_lengths"] = lens
    host["codes"] = host["codes"][: lens.sum()]
    host["residuals"] = host["residuals"][: lens.sum()]
    assert tlayout.plan_buckets(lens, 80) is not None
    own, spec_t = tlayout.to_device(**host, length_buckets=4, device="cpu")
    dev_j, spec_j = jlayout.to_device(**host, length_buckets=4)
    assert spec_t.bucket_caps == spec_j.bucket_caps != ()
    assert spec_t.bucket_counts == spec_j.bucket_counts
    assert own.residuals is None and len(own.buckets) == len(spec_t.bucket_caps)
    for a, b in zip(own.buckets, dev_j.buckets):
        assert np.array_equal(a.codes.numpy(), np.asarray(b.codes))
        assert np.array_equal(a.residuals.numpy(), np.asarray(b.residuals))
    for f in ("doc_bucket", "doc_bucket_row", "codes"):
        assert np.array_equal(getattr(own, f).numpy(), np.asarray(getattr(dev_j, f))), f
    flat, spec0 = tlayout.to_device(**host, length_buckets=0, device="cpu")  # the single-cap layout
    assert not spec0.bucket_caps and flat.residuals is not None and not flat.buckets
