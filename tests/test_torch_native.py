"""The port's C++ host kernels against the JAX package's and the numpy / torch
paths they replace, on the CPU.

Mirrors ``tests/test_native.py``: ``build_ivf`` at >= 1M codes (the native
dispatch) equals the JAX package's and the port's ``np.unique`` path array
for array; ``gather_windows_u8`` equals the JAX package's and the torch
gather byte for byte, at windows cut short by the end of the source,
lengths past ``doc_cap``, negative and out-of-range starts, and into a
preallocated output tensor, and its packed layout (``out_rows``) equals the
padded windows' valid rows; ``host_gather_rows`` on a low_memory index
equals the JAX package's. Where g++ is missing here the native tests skip
and the fallback tests still run.
"""

from __future__ import annotations

import subprocess
import threading

import numpy as np
import pytest
import torch

from fast_plaid_tpu import native as jnative
from fast_plaid_tpu.index import ivf as jivf
from fast_plaid_tpu_torch import native as tnative
from fast_plaid_tpu_torch.index import ivf as tivf
from fast_plaid_tpu_torch.search import searcher as tsearcher

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib_ok():
    if tnative._load() is None or jnative._load() is None:
        pytest.skip("native library unavailable (no toolchain)")
    assert tnative.AVAILABLE
    return True


def _ivf_inputs(seed: int, n_docs: int, k: int, lo: int, hi: int):
    rng = np.random.default_rng(seed)
    doc_lengths = rng.integers(lo, hi, n_docs).astype(np.int64)
    codes = rng.integers(0, k, int(doc_lengths.sum())).astype(np.int32)
    return codes, doc_lengths


def test_build_ivf_native_matches_jax_and_numpy(lib_ok):
    """At >= 1M codes ``build_ivf`` takes the native path in both packages."""
    codes, doc_lengths = _ivf_inputs(0, 8_000, 2_048, 100, 160)
    assert codes.size >= 1_000_000
    calls = tnative.build_ivf_native.calls
    got = tivf.build_ivf(codes, doc_lengths, 2_048)
    assert tnative.build_ivf_native.calls == calls + 1
    want = jivf.build_ivf(codes, doc_lengths, 2_048)
    plain = tivf.build_ivf_numpy(codes, doc_lengths, 2_048)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype == p.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("n_docs,k", [(200, 64), (1, 8), (300, 1)])
def test_build_ivf_native_small_matches_numpy(lib_ok, n_docs, k):
    codes, doc_lengths = _ivf_inputs(n_docs, n_docs, k, 0, 30)
    if codes.size == 0:
        doc_lengths[0] = 3
        codes = np.zeros(3, np.int32)
    got = tnative.build_ivf_native(codes, doc_lengths, k)
    want = jnative.build_ivf_native(codes, doc_lengths, k)
    plain = tivf.build_ivf_numpy(codes, doc_lengths, k)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def test_build_ivf_small_stays_numpy(lib_ok):
    codes, doc_lengths = _ivf_inputs(2, 10, 8, 2, 6)
    calls = tnative.build_ivf_native.calls
    ivf, lengths = tivf.build_ivf(codes, doc_lengths, 8)
    assert tnative.build_ivf_native.calls == calls
    assert lengths.sum() == len(ivf)


# Windows: ordinary, cut short by the end of src, past doc_cap, empty,
# negative start, start past the end, start on the last row.
STARTS = np.asarray([0, 10, 95, 50, -3, 200, 99, 40, 7], np.int64)
LENS = np.asarray([4, 6, 10, 0, 3, 5, 6, 9, 1], np.int64)


def _torch_gather(src, starts, lens, cap):
    lens = np.minimum(lens, cap)  # host_gather_rows clamps before gathering
    return tsearcher._gather_windows(src, starts, lens, cap, False, use_native=False)


def _out_rows(lens, cap, seed: int) -> np.ndarray:
    """Packed destinations for windows of ``lens``: each window's clamped
    length, in a shuffled order, with a gap of 0-2 rows before each."""
    rng = np.random.default_rng(seed)
    valid = np.clip(np.asarray(lens), 0, cap)
    order = rng.permutation(len(valid))
    rows = np.empty(len(valid), np.int64)
    at = 0
    for w in order:
        at += int(rng.integers(0, 3))
        rows[w] = at
        at += int(valid[w])
    return rows


def _packed_from_padded(padded: np.ndarray, lens, out_rows, cap) -> np.ndarray:
    """The packed layout built from padded windows: window w's first
    min(len, cap) rows at out_rows[w], zeros elsewhere."""
    valid = np.clip(np.asarray(lens), 0, cap)
    ends = out_rows + valid
    want = np.zeros((int(ends.max()) if len(ends) else 0, *padded.shape[2:]), padded.dtype)
    for w, (r, v) in enumerate(zip(out_rows, valid)):
        want[r : r + v] = padded[w, :v]
    return want


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("row", [(8,), (4,), ()], ids=["u8x8", "u8x4", "int32"])
@pytest.mark.parametrize("cap", [6, 1, 128])
def test_gather_windows_matches_jax_and_torch(lib_ok, row, cap, layout):
    """Padded, the windows equal the JAX package's and the torch gather's;
    packed, each window's valid rows equal its padded rows byte for byte,
    zeros past the end of src included."""
    rng = np.random.default_rng(1)
    if row:
        src = rng.integers(0, 255, (100, *row)).astype(np.uint8)
    else:
        src = rng.integers(-(2**31), 2**31 - 1, 100).astype(np.int32)
    padded = tnative.gather_windows_u8(src, STARTS, LENS, cap)
    jsrc = src if row else src.view(np.uint8).reshape(-1, 4)
    if layout == "packed":
        out_rows = _out_rows(LENS, cap, seed=cap)
        got = tnative.gather_windows_u8(src, STARTS, LENS, cap, out_rows=out_rows)
        np.testing.assert_array_equal(got, _packed_from_padded(padded, LENS, out_rows, cap))
        if cap >= 6:  # the window cut short at the end of src, zero past it
            np.testing.assert_array_equal(got[out_rows[2] : out_rows[2] + 5], jsrc[95:100])
            assert not got[out_rows[2] + 5 : out_rows[2] + 6].any()
        return
    got = padded
    want = jnative.gather_windows_u8(jsrc, STARTS, LENS.astype(np.int32), cap)
    np.testing.assert_array_equal(got, want)
    plain = _torch_gather(src, STARTS, LENS, cap).numpy()
    np.testing.assert_array_equal(got.reshape(-1), plain.view(np.uint8).reshape(-1))
    # The window cut short at the end of src is zero past it.
    if cap >= 6:
        np.testing.assert_array_equal(got[2, :5], jsrc[95:100])
        assert not got[2, 5:].any() and not got[3].any() and not got[5, 5:].any()


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_gather_windows_into_out_tensor(lib_ok, layout):
    """A preallocated contiguous tensor (the pinned buffer's stand-in on the
    CPU) of any dtype is filled in place and returned; packed, the rows no
    window owns keep what they held."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 1000, 100).astype(np.int32)
    calls = tnative.gather_windows_u8.calls
    if layout == "packed":
        out_rows = _out_rows(LENS, 6, seed=2)
        out = torch.full((int((out_rows + np.minimum(LENS, 6)).max()) + 3,), -7, dtype=torch.int32)
        got = tnative.gather_windows_u8(codes, STARTS, LENS, 6, out=out, out_rows=out_rows)
        assert got is out and tnative.gather_windows_u8.calls == calls + 1
        padded = _torch_gather(codes, STARTS, LENS, 6).numpy()
        want = np.full(out.shape, -7, np.int32)
        for w, r in enumerate(out_rows):
            want[r : r + min(LENS[w], 6)] = padded[w, : min(LENS[w], 6)]
        np.testing.assert_array_equal(out.numpy(), want)
        with pytest.raises(ValueError, match="bytes"):
            tnative.gather_windows_u8(codes, STARTS, LENS, 6, out=out[:-4], out_rows=out_rows)
        with pytest.raises(ValueError, match="negative"):
            tnative.gather_windows_u8(codes, STARTS, LENS, 6, out=out, out_rows=out_rows - out_rows.max())
        with pytest.raises(ValueError, match="output rows"):
            tnative.gather_windows_u8(codes, STARTS, LENS, 6, out=out, out_rows=out_rows[:-1])
        return
    out = torch.full((len(STARTS), 6), -7, dtype=torch.int32)
    got = tnative.gather_windows_u8(codes, STARTS, LENS, 6, out=out)
    assert got is out and tnative.gather_windows_u8.calls == calls + 1
    assert torch.equal(out, _torch_gather(codes, STARTS, LENS, 6))
    with pytest.raises(ValueError, match="bytes"):
        tnative.gather_windows_u8(codes, STARTS, LENS, 7, out=out)
    with pytest.raises(ValueError, match="contiguous"):
        tnative.gather_windows_u8(codes, STARTS, LENS, 3, out=torch.empty(12, len(STARTS)).t())
    with pytest.raises(ValueError, match="lengths"):
        tnative.gather_windows_u8(codes, STARTS, LENS[:-1], 6)


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_gather_windows_concurrent_calls(lib_ok, layout):
    """Eight threads gathering at once (as the shards of ``load_sharded_lm``
    do) each get the single-thread bytes, and every call is counted."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 255, (5_000, 68)).astype(np.uint8)
    starts = rng.integers(-10, 5_100, 512)
    lens = rng.integers(0, 200, 512)
    kw = {"out_rows": _out_rows(lens, 160, seed=3)} if layout == "packed" else {}
    want = tnative.gather_windows_u8(src, starts, lens, 160, **kw)
    if kw:
        padded = tnative.gather_windows_u8(src, starts, lens, 160)
        np.testing.assert_array_equal(want, _packed_from_padded(padded, lens, kw["out_rows"], 160))
    calls = tnative.gather_windows_u8.calls
    results, errors = [None] * 8, []

    def work(i):
        try:
            for _ in range(5):
                results[i] = tnative.gather_windows_u8(src, starts, lens, 160, **kw)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert tnative.gather_windows_u8.calls == calls + 40
    for r in results:
        np.testing.assert_array_equal(r, want)


def _low_memory_pair():
    """One low_memory LoadedIndex in each package from the same host arrays."""
    from fast_plaid_tpu.index import layout as jlayout
    from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
    from fast_plaid_tpu.ops.kmeans import train_kmeans
    from fast_plaid_tpu.search import load as jload
    from fast_plaid_tpu.testing import random_documents
    from fast_plaid_tpu_torch.index import layout as tlayout
    from fast_plaid_tpu_torch.search import load as tload

    import jax

    rng = np.random.default_rng(4)
    docs = random_documents(rng, 60, 20, 32, variable=True)
    flat = np.concatenate(docs)
    centroids = train_kmeans(flat, k=32, niters=2, seed=3)
    params = train_codec_from_documents(docs, centroids, 4, 3)
    codes, packed = compress_documents(docs, centroids, params.bucket_cutoffs, 4)
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    ivf, ivf_lengths = jivf.build_ivf(codes, lens, 32)
    common = dict(centroids=centroids, bucket_weights=params.bucket_weights, codes=codes,
                  residuals=packed, doc_lengths=lens, ivf=ivf, ivf_lengths=ivf_lengths, nbits=4)
    host = dict(low_memory=True, host_codes=codes.astype(np.int32), host_residuals=packed,
                host_doc_lengths=lens, host_doc_offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]))
    dev_t, spec_t = tlayout.to_device(**common, device="cpu", residuals_on_device=False)
    t_lm = tload.LoadedIndex(dev_t, spec_t, torch.device("cpu"), ivf_lengths_host=ivf_lengths, **host)
    cpu = jax.devices("cpu")[0]
    dev_j, spec_j = jlayout.to_device(**common, device=cpu, residuals_on_device=False)
    j_lm = jload.LoadedIndex(dev_j, spec_j, cpu, ivf_lengths_host=ivf_lengths, **host)
    return t_lm, j_lm, len(docs)


def test_host_gather_rows_native_matches_jax(lib_ok):
    """The low_memory host gather (codes as 4-byte rows and residuals through
    the native kernel) equals the JAX package's and the torch gather's."""
    from fast_plaid_tpu.search import searcher as jsearcher

    t_lm, j_lm, n = _low_memory_pair()
    pids = np.asarray([[0, 5, n - 1, n, -1, 19], [n + 7, 3, 3, 50, 1, 2]], np.int64)
    calls = tnative.gather_windows_u8.calls
    got = tsearcher.host_gather_rows(t_lm, pids)
    assert tnative.gather_windows_u8.calls == calls + 2  # codes, residuals
    want = jsearcher.host_gather_rows(j_lm, pids)
    plain = tsearcher.host_gather_rows(t_lm, pids, use_native=False)
    assert tnative.gather_windows_u8.calls == calls + 2
    for g, w, p in zip(got, want, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, p)


def test_unbuilt_library_falls_back(monkeypatch, tmp_path, capsys):
    """A failed build is printed to stderr, leaves AVAILABLE False and the
    entry points None; build_ivf and host_gather_rows take their numpy /
    torch paths with the same results."""
    def fail(_path):
        raise subprocess.CalledProcessError(1, "g++")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_failed", False)
    monkeypatch.setattr(tnative, "AVAILABLE", False)
    monkeypatch.setattr(tnative, "build_root", lambda: tmp_path)
    monkeypatch.setattr(tnative, "_compile", fail)
    assert tnative.gather_windows_u8(np.zeros((4, 2), np.uint8), [0], [1], 2) is None
    assert "build skipped" in capsys.readouterr().err
    assert not tnative.AVAILABLE
    codes, doc_lengths = _ivf_inputs(5, 8_000, 512, 120, 140)
    assert codes.size >= 1_000_000
    got = tivf.build_ivf(codes, doc_lengths, 512)
    for g, w in zip(got, jivf.build_ivf(codes, doc_lengths, 512)):
        np.testing.assert_array_equal(g, w)
    src = np.random.default_rng(6).integers(0, 255, (100, 8)).astype(np.uint8)
    lens = np.minimum(LENS, 6)
    out = tsearcher._gather_windows(src, STARTS, lens, 6, False, use_native=True)
    want = jnative.gather_windows_u8(src, STARTS, lens.astype(np.int32), 6)
    if want is not None:
        np.testing.assert_array_equal(out.numpy(), want)
