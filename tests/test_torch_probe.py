"""Stages 1-2, the IVF probe: ``ops/probe_kernel.py`` on the CPU.

``probe_topk_plain`` is the table route's arithmetic (bf16-rounded inputs,
float32 sums, a bf16 table masked at padding cells and all-zero query rows,
``torch.topk``); here it is held against that arithmetic written out and
against a stable sort, with zero rows, ``k_real < Kp``, exact ties and a
ragged N. The engine's gate (``engine._fused_probe``) keeps the table for
``tokens``, subsets and fewer than 32k cells, and the counters
``probe.fused`` / ``probe.table`` say which route ran. The kernel itself is
held against ``probe_topk_plain`` on the card (``test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fast_plaid_tpu_torch.index import ivf as ivf_mod
from fast_plaid_tpu_torch.index.builder import (
    compress_documents,
    train_codec_from_documents,
)
from fast_plaid_tpu_torch.index.layout import to_device
from fast_plaid_tpu_torch.ops import codec
from fast_plaid_tpu_torch.ops.probe_kernel import (
    probe_table,
    probe_topk,
    probe_topk_plain,
)
from fast_plaid_tpu_torch.search import engine
from fast_plaid_tpu_torch.utils import tracing

DIM = 32
KP = 32768
PROBES = (1, 8, 32)


def _inputs(n: int, k_real: int, seed: int = 0):
    """[n, DIM] float32 queries with two all-zero rows, and [KP, DIM]
    centroids whose rows >= k_real are zero and with repeated rows, so that
    exact score ties reach every row's top k."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, DIM), generator=g)
    q[3] = 0.0
    q[n - 1] = 0.0
    c = torch.randn((KP, DIM), generator=g)
    c[100:164] = c[0]  # 65 identical cells
    c[5000:5040] = c[7]
    c[k_real:] = 0.0
    return q, c


def _table_route(q, c, k_real, k):
    """The table route's arithmetic as ``engine._probe_scores`` and
    ``engine._probe_topk`` wrote it before the probe kernel."""
    scores = codec.bf16_matmul(q, c.t()).to(torch.bfloat16)
    tok_ok = torch.sum(torch.abs(q), dim=-1) > 0
    cell_valid = torch.arange(c.shape[0]) < k_real
    masked = torch.where(cell_valid[None, :] & tok_ok[:, None], scores, float("-inf"))
    return scores, masked, torch.topk(masked, k, dim=-1)


@pytest.mark.parametrize("k", PROBES)
def test_plain_probe_is_the_table_route(k):
    n, k_real = 203, 32700  # N not a multiple of 128, k_real < Kp
    q, c = _inputs(n, k_real)
    scores, masked, (want_v, want_i) = _table_route(q, c, k_real, k)
    got_s, got_m = probe_table(q, c, k_real)
    assert torch.equal(got_s, scores) and torch.equal(got_m, masked)
    vals, cells = probe_topk_plain(q, c, k_real, k)
    assert vals.dtype == torch.bfloat16 and cells.dtype == torch.int32
    assert torch.equal(vals, want_v) and torch.equal(cells.long(), want_i)
    # The wrapper takes the plain version for CPU tensors, on bf16 centroids.
    v2, c2 = probe_topk(q, c.to(torch.bfloat16), k_real, k)
    assert torch.equal(v2, vals) and torch.equal(c2, cells)


@pytest.mark.parametrize("k", PROBES)
def test_plain_probe_against_a_stable_sort(k):
    """Against the kernel's order (stable: ties to the lower cell): the same
    scores everywhere, the same cells wherever the slot's score is not tied
    with another row entry, -inf for all-zero rows and past ``k_real``."""
    n, k_real = 67, 32700
    q, c = _inputs(n, k_real, seed=1)
    _, masked, _ = _table_route(q, c, k_real, k)
    s_vals, s_idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, cells = probe_topk_plain(q, c, k_real, k)
    assert torch.equal(vals, s_vals[:, :k])
    assert bool(torch.isneginf(vals[3]).all()) and bool(torch.isneginf(vals[n - 1]).all())
    live = torch.isfinite(vals)
    assert bool((cells[live] < k_real).all())
    # A slot's cell may differ from the stable sort's only among equal scores.
    counts = (masked[:, None, :] == vals[:, :, None]).sum(dim=-1)  # [n, k]
    unique = counts == 1
    assert bool(unique.any()) and bool((~unique).any())  # both kinds occur
    assert torch.equal(cells[unique & live].long(), s_idx[:, :k][unique & live])
    # Where scores tie, the cell sets agree up to the tied group.
    got = torch.gather(masked, 1, cells.long())
    assert torch.equal(got[live], vals[live])


@pytest.mark.parametrize("k", PROBES)
def test_topk_order_permutes_each_row(k):
    """``_topk_order`` (the kernel's rows put in ``torch.topk``'s order on a
    GPU) keeps each row's (score, cell) pairs and their descending scores."""
    from fast_plaid_tpu_torch.ops.probe_kernel import _topk_order

    n, k_real = 67, 32700
    q, c = _inputs(n, k_real, seed=2)
    _, masked, _ = _table_route(q, c, k_real, k)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, cells = vals[:, :k], idx[:, :k].to(torch.int32)
    cells = torch.where(torch.isfinite(vals), cells, KP)
    ov, oc = _topk_order(vals, cells, KP)
    assert torch.equal(ov, vals) and oc.dtype == torch.int32
    # The same (score, cell) pairs: the cells sorted, each with its score.
    mine, theirs = torch.sort(oc, dim=-1), torch.sort(cells, dim=-1)
    assert torch.equal(mine.values, theirs.values)
    assert torch.equal(torch.gather(ov, 1, mine.indices), torch.gather(vals, 1, theirs.indices))


@pytest.mark.parametrize(
    "device,kp,d,mode,subset,probe,fused",
    [
        ("cuda", 32768, 128, "cells", None, 8, True),
        ("cuda", 32768, 128, "cells_full", None, 32, True),
        ("cuda", 65536, 96, "cells", None, 1, True),
        ("cuda", 32768, 128, "tokens", None, 8, False),
        ("cuda", 32768, 128, "cells", "subset", 8, False),
        ("cuda", 16384, 128, "cells", None, 8, False),
        ("cuda", 32768, 128, "cells", None, 33, False),
        ("cuda", 32768, 100, "cells", None, 8, False),
        ("cuda", 32768, 272, "cells", None, 8, False),
        ("cpu", 32768, 128, "cells", None, 8, False),
    ],
)
def test_probe_gate(device, kp, d, mode, subset, probe, fused):
    sub = None if subset is None else torch.zeros((1, 1), dtype=torch.int32)
    assert engine._fused_probe(torch.device(device), kp, d, mode, sub, probe) is fused


@pytest.fixture(scope="module")
def wide_index():
    """An index of 32,700 cells (Kp 32,768) at D 32 on the CPU: 120
    documents of 6-20 tokens, centroids drawn at random (no k-means)."""
    rng = np.random.default_rng(5)
    docs = [rng.standard_normal((int(rng.integers(6, 21)), DIM)).astype(np.float32)
            for _ in range(120)]
    docs = [d / np.linalg.norm(d, axis=-1, keepdims=True) for d in docs]
    cent = rng.standard_normal((32700, DIM)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=-1, keepdims=True)
    params = train_codec_from_documents(docs, cent, 4, 0, "cpu")
    codes, packed = compress_documents(docs, cent, params.bucket_cutoffs, 4, device="cpu")
    lens = np.asarray([d.shape[0] for d in docs], np.int64)
    ivf, ivf_lengths = ivf_mod.build_ivf(codes, lens, cent.shape[0])
    dev, ispec = to_device(
        centroids=cent, bucket_weights=params.bucket_weights, codes=codes,
        residuals=packed, doc_lengths=lens, ivf=ivf, ivf_lengths=ivf_lengths,
        nbits=4, device="cpu",
    )
    assert dev.centroids.shape[0] == KP and ispec.n_partitions == 32700
    queries = torch.from_numpy(np.stack([d[:6] for d in docs[:5]]))
    queries[1, 4:] = 0.0  # zero-padded query tokens
    return dev, ispec, queries


def _candidates(dev, ispec, queries, probe, **kw):
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        p2 = engine.candidates_impl(
            dev, queries, kw.pop("subset", None), ispec=ispec, n_ivf_probe=probe,
            n_full_scores=64, **kw,
        )
    finally:
        tracing.disable()
    counters = tracing.drain()["counters"]
    return p2, counters.get("probe.fused", 0), counters.get("probe.table", 0)


@pytest.mark.parametrize("probe", PROBES)
def test_candidates_route_and_counters(wide_index, monkeypatch, probe):
    """On the CPU the table route runs and counts ``probe.table``; with the
    gate opened the probe goes through ``probe_topk`` (its plain version
    here), counts ``probe.fused``, and hands stage 3 the same rerank pool."""
    dev, ispec, queries = wide_index
    for mode in ("cells", "cells_full"):
        want, fused, table = _candidates(dev, ispec, queries, probe, approx_mode=mode)
        assert (fused, table) == (0, 1)
        with monkeypatch.context() as m:
            m.setattr(engine, "_fused_probe", lambda *a: True)
            got, fused, table = _candidates(dev, ispec, queries, probe, approx_mode=mode)
        assert (fused, table) == (1, 0)
        assert torch.equal(got, want)


@pytest.mark.parametrize("probe", PROBES)
def test_table_kept_for_tokens_and_subsets(wide_index, monkeypatch, probe):
    """``tokens`` and a subset need the table: with the gate's device test
    passed (the CPU here stands in for a GPU) they still count
    ``probe.table`` and never reach ``probe_topk``."""
    dev, ispec, queries = wide_index
    real = engine._fused_probe
    monkeypatch.setattr(
        engine, "_fused_probe", lambda dv, *a: real(torch.device("cuda"), *a)
    )
    monkeypatch.setattr(engine, "probe_topk", None)  # a call would raise
    subset = torch.arange(0, 60, 2, dtype=torch.int32)[None].expand(5, -1).contiguous()
    for kw in ({"approx_mode": "tokens"}, {"approx_mode": "cells", "subset": subset}):
        _, fused, table = _candidates(dev, ispec, queries, probe, **kw)
        assert (fused, table) == (0, 1)
