"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they build the kernels with nvcc and need a CUDA device, so
they skip on a machine without one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: ``tests/conftest.py`` imports jax, which the GPU machine
need not have.) The three rerank kernels hold at rtol = atol = 1e-3
(tensor-core accumulation order) with identical -inf patterns. They stream
fixed 64-row tiles, so they also hold at doc_cap 336, 1,040 and 2,048; the
dedup kernel at D 128, 256 and 384 too, and at D 16, 64, 80 and 96 (the
columns past a multiple of 64 zero-filled) at doc_cap 304 and 336. The estimate kernel holds at 1e-4
(float32 sums in another order) at every slot, for any table size.
"""

from __future__ import annotations

import pytest
import torch

from fast_plaid_tpu_torch.ops.estimate_kernel import (
    segmented_estimate,
    segmented_estimate_plain,
)
from fast_plaid_tpu_torch.ops.probe_kernel import (
    probe_table,
    probe_topk,
    probe_topk_plain,
)
from fast_plaid_tpu_torch.ops.rerank_dedup import (
    maxsim_gather_scores_dedup,
    maxsim_gather_scores_dedup_plain,
)
from fast_plaid_tpu_torch.ops.rerank_kernel import (
    maxsim_gather_scores,
    maxsim_gather_scores_plain,
    maxsim_q4_gather_scores,
    maxsim_q4_gather_scores_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "b,w,c,q,hi",
    [(4, 1000, 12, 16, 300), (3, 2049, 7, 8, 1), (2, 130, 40, 32, 50), (2, 300, 5, 100, 90),
     (3, 12_152, 4000, 32, 20_000), (4, 12_152, 90, 32, 57_639), (2, 5000, 2000, 64, 900)],
    ids=["q16", "one_run", "q32", "q100", "table_256KB", "main_width", "table_256KB_q64"],
)
def test_estimate_kernel_matches_plain(cuda, b, w, c, q, hi):
    g = torch.Generator(device=cuda).manual_seed(w)
    pid = torch.sort(
        torch.randint(0, hi, (b, w), generator=g, device=cuda, dtype=torch.int32), dim=-1
    ).values
    own = torch.randint(0, c, (b, w), generator=g, device=cuda, dtype=torch.int32)
    tbl = torch.randn((b, c, q), generator=g, device=cuda)
    before = segmented_estimate.launches
    got = segmented_estimate(pid, own, tbl)
    assert segmented_estimate.launches == before + 1
    want = segmented_estimate_plain(pid, own, tbl)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_rerank_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    emb = torch.randn((300, 64, 128), generator=g, device=cuda).to(torch.bfloat16)
    pids = torch.randint(0, 300, (5, 77), generator=g, device=cuda, dtype=torch.int32)
    lens = torch.randint(0, 65, (5, 77), generator=g, device=cuda, dtype=torch.int32)
    pids[0, :3] = torch.tensor([-1, 300, 299], dtype=torch.int32, device=cuda)
    lens[1, :2] = 0
    queries = torch.randn((5, 24, 128), generator=g, device=cuda)
    before = maxsim_gather_scores.launches
    got = maxsim_gather_scores(emb, pids, lens, queries)
    assert maxsim_gather_scores.launches == before + 1
    want = maxsim_gather_scores_plain(emb, pids, lens, queries)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-3, atol=1e-3)
    assert torch.isneginf(got[0, :2]).all() and torch.isneginf(got[1, :2]).all()


def _close(got, want):
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("caph,q", [(80, 32), (24, 32), (8, 24), (5, 16)])
def test_q4_kernel_matches_plain(cuda, caph, q):
    g = torch.Generator(device=cuda).manual_seed(caph * q)
    npd, d, b, r = 200, 128, 4, 150
    emb_q4 = torch.randint(0, 256, (npd * caph, d), generator=g, device=cuda).to(torch.uint8)
    scale = torch.rand((npd,), generator=g, device=cuda)
    pids = torch.randint(0, npd, (b, r), generator=g, device=cuda, dtype=torch.int32)
    lens = torch.randint(1, 2 * caph + 1, (b, r), generator=g, device=cuda, dtype=torch.int32)
    lens[0, :6] = torch.tensor([0, 0, 1, caph, caph + 1, 2 * caph + 7], device=cuda)
    pids[1, :4] = torch.tensor([-7, npd, npd + 1000, npd - 1], dtype=torch.int32, device=cuda)
    lens[2] = torch.randint(1, caph + 1, (r,), generator=g, device=cuda, dtype=torch.int32)
    queries = torch.randn((b, q, d), generator=g, device=cuda)
    before = maxsim_q4_gather_scores.launches
    got = maxsim_q4_gather_scores(emb_q4, scale, pids, lens, queries)
    assert maxsim_q4_gather_scores.launches == before + 1
    want = maxsim_q4_gather_scores_plain(emb_q4, scale, pids, lens, queries)
    _close(got, want)
    assert torch.isneginf(got[0, :2]).all() and torch.isfinite(got[0, 2:]).all()


def _dedup_pools(cuda, g, n_docs, b, r):
    """Main-path-like overlap, one pid for every slot, runs of exactly G and
    G + 1, and all-sentinel rows."""
    rand = torch.randint(0, n_docs, (b, r), generator=g, device=cuda, dtype=torch.int32)
    one = torch.full((b, r), 7, dtype=torch.int32, device=cuda)
    run_g = torch.arange(r, dtype=torch.int32, device=cuda).repeat(8, 1)
    run_g1 = torch.arange(r, dtype=torch.int32, device=cuda).repeat(9, 1)
    sent = torch.full((b, r), n_docs, dtype=torch.int32, device=cuda)
    mixed = rand.clone()
    mixed[:, ::5] = n_docs
    return {"random": rand, "one_pid": one, "run_g": run_g, "run_g1": run_g1,
            "all_sentinel": sent, "mixed_sentinel": mixed}


@pytest.mark.parametrize("doc_cap,q", [(160, 32), (48, 16)])
def test_dedup_kernel_matches_plain(cuda, doc_cap, q):
    g = torch.Generator(device=cuda).manual_seed(doc_cap)
    n_docs, d, b, r = 300, 128, 12, 200
    emb = torch.randn((n_docs + 1, doc_cap, d), generator=g, device=cuda).to(torch.bfloat16)
    doc_lengths = torch.randint(1, doc_cap + 1, (n_docs + 1,), generator=g, device=cuda,
                                dtype=torch.int32)
    doc_lengths[-1] = 0
    for name, pids in _dedup_pools(cuda, g, n_docs, b, r).items():
        lens = doc_lengths[pids.long()]
        queries = torch.randn((pids.shape[0], q, d), generator=g, device=cuda)
        before = maxsim_gather_scores_dedup.launches
        got = maxsim_gather_scores_dedup(emb, pids, lens, queries)
        assert maxsim_gather_scores_dedup.launches == before + 1, name
        _close(got, maxsim_gather_scores_dedup_plain(emb, pids, lens, queries))
        _close(got, maxsim_gather_scores_plain(emb, pids, lens, queries))
        if name == "all_sentinel":
            assert torch.isneginf(got).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    emb = torch.zeros((8, 24, 128), dtype=torch.bfloat16, device=cuda)  # doc_cap % 16
    ids = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        maxsim_gather_scores(emb, ids, ids, torch.zeros((1, 8, 128), device=cuda))
    with pytest.raises(TypeError):
        segmented_estimate(ids.long(), ids.long(), torch.zeros((1, 2, 8), device=cuda))
    q4 = torch.zeros((8 * 4, 40), dtype=torch.uint8, device=cuda)  # D % 16
    with pytest.raises(ValueError):
        maxsim_q4_gather_scores(q4, torch.ones(8, device=cuda), ids, ids,
                                torch.zeros((1, 8, 40), device=cuda))
    emb40 = torch.zeros((8, 16, 40), dtype=torch.bfloat16, device=cuda)  # D % 16
    with pytest.raises(ValueError):
        maxsim_gather_scores_dedup(emb40, ids, ids, torch.zeros((1, 16, 40), device=cuda))


@pytest.mark.parametrize("r", [8, 24, 256, 3608])
def test_rerank_kernels_ragged_pool_widths(cuda, r):
    """The direct-subset pool hands stage 6 any multiple of 8 as R: sorted
    pids with duplicates and sentinel padding. Kernels 2, 3 and 4 hold
    against their plain versions there."""
    g = torch.Generator(device=cuda).manual_seed(r)
    npd, doc_cap, d, b, q = 400, 48, 128, 6, 32
    sent = npd - 1
    emb = torch.randn((npd, doc_cap, d), generator=g, device=cuda).to(torch.bfloat16)
    doc_lengths = torch.randint(1, doc_cap + 1, (npd,), generator=g, device=cuda, dtype=torch.int32)
    doc_lengths[sent] = 0
    pids = torch.sort(
        torch.randint(0, sent, (b, r), generator=g, device=cuda, dtype=torch.int32), dim=-1
    ).values
    pids[:, -min(r, 5):] = sent
    pids = pids.contiguous()
    lens = doc_lengths[pids.long()]
    queries = torch.randn((b, q, d), generator=g, device=cuda)
    before = (maxsim_gather_scores.launches, maxsim_gather_scores_dedup.launches,
              maxsim_q4_gather_scores.launches)
    got2 = maxsim_gather_scores(emb, pids, lens, queries)
    _close(got2, maxsim_gather_scores_plain(emb, pids, lens, queries))
    got4 = maxsim_gather_scores_dedup(emb, pids, lens, queries)
    _close(got4, maxsim_gather_scores_dedup_plain(emb, pids, lens, queries))
    _close(got4, got2)
    caph = doc_cap // 2
    emb_q4 = torch.randint(0, 256, (npd * caph, d), generator=g, device=cuda).to(torch.uint8)
    scale = torch.rand((npd,), generator=g, device=cuda)
    got3 = maxsim_q4_gather_scores(emb_q4, scale, pids, lens, queries)
    _close(got3, maxsim_q4_gather_scores_plain(emb_q4, scale, pids, lens, queries))
    after = (maxsim_gather_scores.launches, maxsim_gather_scores_dedup.launches,
             maxsim_q4_gather_scores.launches)
    assert after == tuple(x + 1 for x in before)
    assert torch.isneginf(got2[:, -1]).all() and got2.shape == (b, r)


def _long_pool(cuda, g, npd, doc_cap, b, r):
    """Ragged lengths over [0, doc_cap] with 0, 1, <= caph, caph, caph + 1,
    doc_cap - 1 and doc_cap spelled out, plus sentinel and out-of-range pids."""
    caph = doc_cap // 2
    pids = torch.randint(0, npd, (b, r), generator=g, device=cuda, dtype=torch.int32)
    lens = torch.randint(0, doc_cap + 1, (b, r), generator=g, device=cuda, dtype=torch.int32)
    edge = [0, 1, 63, 64, 65, caph - 1, caph, caph + 1, doc_cap - 1, doc_cap]
    lens[0, : len(edge)] = torch.tensor(edge, dtype=torch.int32, device=cuda)
    lens[1] = torch.randint(1, caph + 1, (r,), generator=g, device=cuda, dtype=torch.int32)
    lens[2] = doc_cap
    pids[3, :4] = torch.tensor([-1, npd, npd + 5000, npd - 1], dtype=torch.int32, device=cuda)
    return pids, lens


@pytest.mark.parametrize("doc_cap", [336, 1040, 2048])
@pytest.mark.parametrize("q", [32, 24])
def test_long_documents_kernel2(cuda, doc_cap, q):
    """Kernel 2 takes any doc_cap: ragged lengths up to doc_cap, empty rows,
    sentinel and out-of-range pids (-inf), against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(doc_cap + q)
    npd, d, b, r = 97, 128, 5, 70
    emb = torch.randn((npd, doc_cap, d), generator=g, device=cuda).to(torch.bfloat16)
    pids, lens = _long_pool(cuda, g, npd, doc_cap, b, r)
    queries = torch.randn((b, q, d), generator=g, device=cuda)
    before = maxsim_gather_scores.launches
    got = maxsim_gather_scores(emb, pids, lens, queries)
    assert maxsim_gather_scores.launches == before + 1
    _close(got, maxsim_gather_scores_plain(emb, pids, lens, queries))
    assert torch.isneginf(got[0, 0]) and torch.isneginf(got[3, :3]).all()
    assert torch.isfinite(got[2]).all()


@pytest.mark.parametrize("doc_cap", [336, 1040, 2048])
@pytest.mark.parametrize("q", [32, 16])
def test_long_documents_kernel3(cuda, doc_cap, q):
    """Kernel 3 takes any doc_cap: both nibble planes, lengths <= caph and
    = doc_cap, clamped pids, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(doc_cap * q)
    npd, d, b, r = 61, 128, 5, 70
    caph = doc_cap // 2
    emb_q4 = torch.randint(0, 256, (npd * caph, d), generator=g, device=cuda).to(torch.uint8)
    scale = torch.rand((npd,), generator=g, device=cuda) + 0.05
    pids, lens = _long_pool(cuda, g, npd, doc_cap, b, r)
    queries = torch.randn((b, q, d), generator=g, device=cuda)
    before = maxsim_q4_gather_scores.launches
    got = maxsim_q4_gather_scores(emb_q4, scale, pids, lens, queries)
    assert maxsim_q4_gather_scores.launches == before + 1
    _close(got, maxsim_q4_gather_scores_plain(emb_q4, scale, pids, lens, queries))
    assert torch.isneginf(got[0, 0]) and torch.isfinite(got[3, :4]).all()


def test_long_queries_run_in_chunks(cuda):
    """Q above 64 runs as chunks of 64 query tokens whose scores add."""
    g = torch.Generator(device=cuda).manual_seed(5)
    npd, doc_cap, d, b, r, q = 50, 160, 128, 4, 40, 100
    emb = torch.randn((npd, doc_cap, d), generator=g, device=cuda).to(torch.bfloat16)
    pids, lens = _long_pool(cuda, g, npd, doc_cap, b, r)
    queries = torch.randn((b, q, d), generator=g, device=cuda)
    before = maxsim_gather_scores.launches
    got = maxsim_gather_scores(emb, pids, lens, queries)
    assert maxsim_gather_scores.launches == before + 2
    _close(got, maxsim_gather_scores_plain(emb, pids, lens, queries))
    emb_q4 = torch.randint(0, 256, (npd * doc_cap // 2, d), generator=g, device=cuda).to(torch.uint8)
    scale = torch.rand((npd,), generator=g, device=cuda)
    _close(maxsim_q4_gather_scores(emb_q4, scale, pids, lens, queries),
           maxsim_q4_gather_scores_plain(emb_q4, scale, pids, lens, queries))


@pytest.mark.parametrize("doc_cap", [336, 1040, 2048])
@pytest.mark.parametrize("d", [128, 256, 384])
def test_dedup_kernel_long_docs_and_widths(cuda, doc_cap, d):
    """The dedup kernel streams 64-row tiles: any doc_cap, D 128 to 384,
    against its plain version and kernel 2 on runs of G and G + 1, one pid
    for every slot, a main-path-like overlap and an all-sentinel pool."""
    _dedup_against_plain_and_kernel2(cuda, doc_cap, d)


@pytest.mark.parametrize("doc_cap", [304, 336])
@pytest.mark.parametrize("d", [16, 64, 80, 96])
def test_dedup_kernel_narrow_widths(cuda, doc_cap, d):
    """D a multiple of 16 below 128: ceil(D / 64) column halves, TMA filling
    the columns past D with zeros in the query and row tiles (D 96 is
    answerai-colbert-small-v1's width, doc_cap 304 its document_length 300);
    against the plain version and kernel 2 on the same pools."""
    _dedup_against_plain_and_kernel2(cuda, doc_cap, d)


def _dedup_against_plain_and_kernel2(cuda, doc_cap, d):
    g = torch.Generator(device=cuda).manual_seed(doc_cap + d)
    n_docs, b, r, q = 40, 9, 24, 32
    emb = torch.randn((n_docs + 1, doc_cap, d), generator=g, device=cuda).to(torch.bfloat16)
    doc_lengths = torch.randint(1, doc_cap + 1, (n_docs + 1,), generator=g, device=cuda,
                                dtype=torch.int32)
    doc_lengths[:4] = torch.tensor([1, 64, 65, doc_cap], dtype=torch.int32, device=cuda)
    doc_lengths[-1] = 0
    for name, pids in _dedup_pools(cuda, g, n_docs, b, r).items():
        lens = doc_lengths[pids.long()]
        queries = torch.randn((pids.shape[0], q, d), generator=g, device=cuda)
        before = maxsim_gather_scores_dedup.launches
        got = maxsim_gather_scores_dedup(emb, pids, lens, queries)
        assert maxsim_gather_scores_dedup.launches == before + 1, name
        _close(got, maxsim_gather_scores_dedup_plain(emb, pids, lens, queries))
        _close(got, maxsim_gather_scores(emb, pids, lens, queries))
        if name == "all_sentinel":
            assert torch.isneginf(got).all()


@pytest.mark.parametrize("d", [400, 512, 1024])
def test_dedup_kernel_wide_rows(cuda, d):
    """Past D 384 the query rows stream with the row tiles, chunk by chunk,
    D 400 in seven one-half chunks, the last zero-filled past column 400
    (kernel 2 does not take D 1,024: held against the plain versions)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    n_docs, doc_cap, b, r, q = 30, 336, 9, 24, 32
    emb = torch.randn((n_docs + 1, doc_cap, d), generator=g, device=cuda).to(torch.bfloat16)
    doc_lengths = torch.randint(1, doc_cap + 1, (n_docs + 1,), generator=g, device=cuda,
                                dtype=torch.int32)
    doc_lengths[-1] = 0
    for name, pids in _dedup_pools(cuda, g, n_docs, b, r).items():
        lens = doc_lengths[pids.long()]
        queries = torch.randn((pids.shape[0], q, d), generator=g, device=cuda)
        got = maxsim_gather_scores_dedup(emb, pids, lens, queries)
        _close(got, maxsim_gather_scores_dedup_plain(emb, pids, lens, queries))
        _close(got, maxsim_gather_scores_plain(emb, pids, lens, queries))


def test_dedup_kernel_groups_and_long_queries(cuda):
    """G from 1 to 256 (entries wider than the kernel's warps take several
    passes) and Q 96 (two chunks whose scores add)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    n_docs, doc_cap, d, b, r = 30, 160, 128, 40, 64
    emb = torch.randn((n_docs + 1, doc_cap, d), generator=gen, device=cuda).to(torch.bfloat16)
    doc_lengths = torch.randint(1, doc_cap + 1, (n_docs + 1,), generator=gen, device=cuda,
                                dtype=torch.int32)
    doc_lengths[-1] = 0
    pids = torch.randint(0, n_docs + 1, (b, r), generator=gen, device=cuda, dtype=torch.int32)
    lens = doc_lengths[pids.long()]
    for q, gs in ((32, (1, 3, 8, 17, 256)), (96, (8,))):
        queries = torch.randn((b, q, d), generator=gen, device=cuda)
        want = maxsim_gather_scores_plain(emb, pids, lens, queries)
        for g in gs:
            _close(maxsim_gather_scores_dedup(emb, pids, lens, queries, g=g), want)


def test_kernel_plans_do_not_depend_on_doc_cap(cuda):
    from fast_plaid_tpu_torch.ops._build import load_library

    lib = load_library()
    for q in (8, 32, 64):
        assert 0 < lib.fp_maxsim_gather_smem_bytes(128, q) <= 227 * 1024
        assert 0 < lib.fp_maxsim_q4_gather_smem_bytes(128, q) <= 227 * 1024
        for d in (16, 64, 96, 128, 256, 384, 512, 1024):
            assert 0 < lib.fp_maxsim_dedup_smem_bytes(d, q) <= 227 * 1024
        for d in (8, 40, 72):  # not a multiple of 16
            assert lib.fp_maxsim_dedup_smem_bytes(d, q) == -1


def test_stage6_takes_the_dedup_kernel_at_long_docs(cuda, monkeypatch, tmp_path):
    """A dedup-viable pool at doc_cap 1,040: the engine's stage 6 launches
    the dedup kernel (kernel 2 with FASTPLAID_RERANK_DEDUP=0), and both give
    the plain path's result."""
    import numpy as np

    from fast_plaid_tpu_torch.search import FastPlaid, engine

    rng = np.random.default_rng(0)
    lens = rng.integers(1000, 1031, 40)
    lens[0] = 1030
    docs = [rng.standard_normal((n, 128)).astype(np.float32) for n in lens]
    fp = FastPlaid(str(tmp_path / "idx"), device="cuda", low_memory=False)
    fp.create(docs, kmeans_niters=2)
    loaded = next(iter(fp.indices.values()))
    ispec = loaded.ispec
    assert loaded.dev.emb_cache is not None and ispec.doc_cap == 1040
    qs = torch.from_numpy(np.stack([d[:16] for d in docs[:8]])).to(cuda)
    kw = dict(ispec=ispec, top_k=5, n_ivf_probe=4, n_full_scores=32)
    p_ids, p_sc = engine.search_impl(loaded.dev, qs, None, use_rerank_kernel=False, **kw)
    for env, which in (("1", 1), ("0", 0)):
        monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", env)
        before = (maxsim_gather_scores.launches, maxsim_gather_scores_dedup.launches)
        k_ids, k_sc = engine.search_impl(loaded.dev, qs, None, use_rerank_kernel=True, **kw)
        after = (maxsim_gather_scores.launches, maxsim_gather_scores_dedup.launches)
        assert after == (before[0] + 1 - which, before[1] + which), env
        torch.testing.assert_close(k_sc, p_sc, rtol=1e-3, atol=1e-3)
        assert k_ids[:, 0].cpu().tolist() == list(range(8))
    fp.close()


def _bucketed_index(cuda, g, caps, counts, d=128):
    """A length-bucketed DeviceIndex over random bf16 bucket caches (pid i
    lives in bucket i % len(caps)); codes and residuals are never read when
    the caches are resident."""
    from fast_plaid_tpu_torch.index.layout import DeviceIndex, DocBucket, IndexSpec

    n_docs = sum(counts)
    npd = (n_docs + 1 + 7) // 8 * 8
    doc_bucket = torch.zeros(npd, dtype=torch.int32, device=cuda)
    doc_row = torch.full((npd,), counts[0], dtype=torch.int32, device=cuda)
    lengths = torch.zeros(npd, dtype=torch.int32, device=cuda)
    buckets, start = [], 0
    for bi, (cap, nb) in enumerate(zip(caps, counts)):
        lo = caps[bi - 1] + 1 if bi else 8
        doc_bucket[start : start + nb] = bi
        doc_row[start : start + nb] = torch.arange(nb, dtype=torch.int32, device=cuda)
        lengths[start : start + nb] = torch.randint(lo, cap + 1, (nb,), generator=g, device=cuda,
                                                    dtype=torch.int32)
        emb = torch.randn((nb + 1, cap, d), generator=g, device=cuda).to(torch.bfloat16)
        buckets.append(DocBucket(
            codes=torch.zeros((nb + 1, cap), dtype=torch.int32, device=cuda),
            residuals=torch.zeros((nb + 1, cap * d // 2), dtype=torch.uint8, device=cuda),
            emb=emb,
        ))
        start += nb
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    dev = DeviceIndex(
        centroids=torch.zeros((128, d), device=cuda), bucket_weights=torch.zeros(16, device=cuda),
        codes=torch.zeros((npd, caps[-1]), dtype=torch.int32, device=cuda), residuals=None,
        doc_lengths=lengths, ivf=empty, ivf_offsets=empty, ivf_lengths=empty,
        doc_bucket=doc_bucket, doc_bucket_row=doc_row, buckets=tuple(buckets),
    )
    spec = IndexSpec(dim=d, nbits=4, n_docs=n_docs, n_partitions=1, doc_cap=caps[-1], cell_cap=8,
                     has_ivf=True, bucket_caps=tuple(caps), bucket_counts=tuple(counts))
    return dev, spec


@pytest.mark.parametrize("dedup", ["auto", "0"])
def test_bucketed_stage6_kernels_match_plain(cuda, monkeypatch, dedup):
    """Per-bucket stage 6 at the skewed corpus's caps 96 / 176 / 304 (R
    2,048: quotas 2,048 / 1,400 / 600): the dedup kernel once per bucket (all
    three pass its gate), or kernel 2 once per bucket with the gate off,
    against the plain ``_score_bucket_rows``."""
    from fast_plaid_tpu_torch.search import engine

    monkeypatch.setenv("FASTPLAID_RERANK_DEDUP", dedup)
    g = torch.Generator(device=cuda).manual_seed(6)
    caps, counts = (96, 176, 304), (3143, 1873, 748)  # the skewed split, cut 10x
    dev, spec = _bucketed_index(cuda, g, caps, counts)
    assert [engine._bucket_quota(2048, spec, i) for i in range(3)] == [2048, 1400, 600]
    b, r = 256, 2048
    p2 = torch.argsort(torch.rand((b, spec.n_docs), generator=g, device=cuda), dim=-1)[:, :r]
    p2 = p2.to(torch.int32)
    p2[:, -50:] = spec.n_docs  # sentinel tail
    qs = torch.randn((b, 32, 128), generator=g, device=cuda)
    before = (maxsim_gather_scores_dedup.launches, maxsim_gather_scores.launches)
    got, drop_k = engine._rerank_bucketed(dev, qs, p2, ispec=spec, mem_budget=1 << 28, use_kernel=True)
    launched = (maxsim_gather_scores_dedup.launches - before[0], maxsim_gather_scores.launches - before[1])
    assert launched == ((3, 0) if dedup == "auto" else (0, 3))
    want, drop_p = engine._rerank_bucketed(dev, qs, p2, ispec=spec, mem_budget=1 << 28, use_kernel=False)
    assert torch.equal(drop_k, drop_p)
    _close(got, want)


def test_train_codec_device_past_quantile_limit(cuda):
    """50,000 held-out tokens at D 384: 19.2M residuals, past
    ``torch.quantile``'s 2^24 elements; the card gives the CPU's quantiles."""
    from fast_plaid_tpu_torch.index.device_build import _quantile, train_codec_device

    g = torch.Generator(device=cuda).manual_seed(4)
    held = torch.randn((50_000, 384), generator=g, device=cuda)
    held = held / torch.linalg.vector_norm(held, dim=-1, keepdim=True)
    cent = held[torch.randperm(50_000, generator=g, device=cuda)[:64]]
    got = train_codec_device(held, cent, 4)
    res = held - cent[torch.argmax(held @ cent.t(), dim=-1)]
    with pytest.raises(RuntimeError):
        torch.quantile(res.reshape(-1), torch.tensor([0.5], device=cuda))
    q = torch.arange(1, 16, device=cuda, dtype=torch.float32) / 16
    want = _quantile(res.reshape(-1).cpu(), q.cpu())
    torch.testing.assert_close(_quantile(res.reshape(-1), q).cpu(), want, rtol=0, atol=0)
    assert got.bucket_cutoffs.shape == (15,) and got.bucket_weights.shape == (16,)
    assert (got.bucket_cutoffs[1:] >= got.bucket_cutoffs[:-1]).all()


def test_probe_topk_differs_from_a_stable_sort_only_at_ties(cuda):
    """The plain probe's ``torch.topk`` over a bf16 [B*Q, 32,768] table
    (exact ties are common in bf16): its cell set equals a stable sort's top
    k wherever the k-th and (k+1)-th scores differ."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((256 * 32, 128), generator=g, device=cuda)
    c = torch.randn((32_768, 128), generator=g, device=cuda).to(torch.bfloat16)
    k = 8
    _, idx = probe_topk_plain(q, c, 32_768, k)
    _, scores = probe_table(q, c, 32_768)
    vals_s, idx_s = torch.sort(scores, dim=-1, descending=True, stable=True)
    same = (torch.sort(idx, dim=-1).values == torch.sort(idx_s[:, :k], dim=-1).values).all(dim=-1)
    tie = vals_s[:, k - 1] == vals_s[:, k]
    assert bool((same | tie).all())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp above |x| (x finite), as float32."""
    a = x.float().abs().to(torch.bfloat16)
    up = (a.view(torch.int16) + 1).view(torch.bfloat16)
    return up.float() - a.float()


@pytest.mark.parametrize(
    "n,kp,k_real,d,k",
    [(8192, 32_768, 32_768, 128, 8), (1000, 33_000, 32_900, 128, 8),
     (1000, 33_000, 32_900, 128, 1), (1000, 33_000, 32_900, 128, 32),
     (300, 40_000, 39_990, 96, 16), (257, 32_768, 20, 64, 32), (130, 70_000, 70_000, 256, 8),
     (200, 32_768, 32_768, 32, 8)],
    ids=["cells_shape", "ragged_k8", "ragged_k1", "ragged_k32", "d96_k16", "k_real_below_k",
         "two_spans_d256", "d32"],
)
def test_probe_kernel_matches_plain(cuda, n, kp, k_real, d, k):
    """The probe kernel against ``probe_topk_plain`` (``torch.topk`` over the
    table) on bf16 centroids, with all-zero query rows and exact ties: -inf
    where the plain version has it (with the cell Kp), scores within one bf16
    ulp (float32 sums in another order), descending, and wherever the two
    give the same scores, the same cells in the same order, ties included."""
    g = torch.Generator(device=cuda).manual_seed(n + kp + k)
    q = torch.randn((n, d), generator=g, device=cuda)
    q[5] = 0.0
    q[n - 1] = 0.0
    c = torch.randn((kp, d), generator=g, device=cuda)
    c[k_real:] = 0.0
    c[200:230] = c[3]  # exact ties
    cb = c.to(torch.bfloat16)
    before = probe_topk.launches
    vals, cells = probe_topk(q, cb, k_real, k)
    torch.cuda.synchronize()
    assert probe_topk.launches == before + 1
    assert vals.dtype == torch.bfloat16 and cells.dtype == torch.int32
    pv, pc = probe_topk_plain(q, cb, k_real, k)
    _, table = probe_table(q, cb, k_real)
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(vals), fin)
    assert bool(torch.isneginf(vals[~fin]).all()) and bool((cells[~fin] == kp).all())
    ulp = _bf16_ulp(pv)
    assert bool(((vals.float() - pv.float()).abs()[fin] <= ulp[fin]).all())
    assert bool((cells[fin] >= 0).all()) and bool((cells[fin] < k_real).all())
    # Each cell's plain score is within an ulp of the kernel's.
    got = torch.gather(table, 1, cells.clamp(max=kp - 1).long())
    assert bool(((got.float() - vals.float()).abs()[fin] <= ulp[fin]).all())
    v = vals.float()
    assert bool((v[:, 1:] <= v[:, :-1])[fin[:, 1:] & fin[:, :-1]].all())
    # The same cell set except at a near-tie at the k-th place; with the same
    # set and the same scores, the same order (torch.topk's, ties included).
    mine = torch.where(fin, cells, -1)
    theirs = torch.where(fin, pc, -1)
    same_set = (torch.sort(mine, dim=-1).values == torch.sort(theirs, dim=-1).values).all(-1)
    nxt = torch.topk(table, min(k + 1, kp), dim=-1).values.float()
    near = (nxt[:, k - 1] - nxt[:, -1]).abs() <= _bf16_ulp(nxt[:, k - 1])
    assert bool((same_set | near | ~fin[:, k - 1]).all())
    agree = same_set & (vals == pv).all(dim=-1)
    same = (mine == theirs).all(dim=-1)
    assert bool((same | ~agree).all())
    if k_real >= k:
        assert float(same.float().mean()) > 0.99


def test_exact_truth_on_the_card_matches_numpy(cuda):
    """The blocked bf16-input truth on the card against the float32 numpy
    path, within ``bf16_score_tolerance``, at default and tiny blocks."""
    import numpy as np

    from fast_plaid_tpu_torch.evaluation import synthetic

    docs, queries, _ = synthetic.colbert_proxy_corpus(
        np.random.default_rng(2), 700, 70, dim=128, mean_len=60, max_len=120
    )
    docs[3] = docs[3][:1]
    host = synthetic.exact_maxsim_topk(docs, queries, top_k=20, device="cpu")
    tol = synthetic.bf16_score_tolerance(docs, queries)
    for got in (synthetic.exact_maxsim_topk(docs, queries, top_k=20),
                synthetic._exact_maxsim_topk_blocked(docs, queries, 20, cuda,
                                                     doc_block=33, q_block=5)):
        for ra, rb in zip(got, host):
            sa, sb = [s for _, s in ra], [s for _, s in rb]
            np.testing.assert_allclose(sa, sb, rtol=0, atol=tol)
            ib = [p for p, _ in rb]
            for j, (pid, _) in enumerate(ra):
                assert pid in ib or abs(sa[j] - sa[-1]) <= tol


def test_server_on_the_card_matches_search(cuda, tmp_path):
    """A port server over a card index (device=None: every CUDA device)
    answers concurrent single-query requests with FastPlaid.search's
    results up to ties (1e-3), in fewer dispatches than requests."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from fast_plaid_tpu_torch.search import FastPlaid
    from fast_plaid_tpu_torch.serving import make_server
    from fast_plaid_tpu_torch.testing import random_documents, random_queries

    rng = np.random.default_rng(0)
    docs = random_documents(rng, 2000, 64, 128, variable=True)
    path = str(tmp_path / "idx")
    FastPlaid(index=path).create(documents_embeddings=docs)
    httpd, core = make_server(path, port=0, max_wait_ms=5)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    queries = random_queries(rng, 48, 32, 128)
    out = [None] * len(queries)

    def ask(i):
        req = urllib.request.Request(
            base + "/v1/search",
            data=json.dumps({"queries": [queries[i].tolist()], "top_k": 10}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = json.loads(r.read())["results"][0]

    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(o is not None for o in out)
        want = core.engine.search(queries, top_k=10, show_progress=False)
        stats = core.batcher.stats.snapshot()
        assert core.health()["devices"] == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    finally:
        httpd.shutdown()
        core.close()
    assert stats["dispatches"] < stats["requests"] == len(queries)
    for got, exp in zip(out, want):
        sg, se = [h["score"] for h in got], [s for _, s in exp]
        np.testing.assert_allclose(sg, se, rtol=0, atol=1e-3)
        ie = [p for p, _ in exp]
        for j, h in enumerate(got):
            assert h["id"] in ie or abs(sg[j] - sg[-1]) <= 1e-3


def _random_bert(seed: int, hidden: int = 256, layers: int = 2, heads: int = 4):
    """A random BertColbert in the JAX params layout: std 0.02 weights, LayerNorm
    gains 1, biases 0 (the colbertv2.0 init at a smaller width)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    config = {"hidden_size": hidden, "num_hidden_layers": layers, "num_attention_heads": heads,
              "intermediate_size": 4 * hidden, "vocab_size": 1000, "max_position_embeddings": 192,
              "type_vocab_size": 2, "layer_norm_eps": 1e-12}

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    def dense(i, o):
        return {"w": w(i, o), "b": np.zeros(o, np.float32)}

    def ln(n):
        return {"g": np.ones(n, np.float32), "b": np.zeros(n, np.float32)}

    h = hidden
    params = {
        "word_emb": w(1000, h), "pos_emb": w(192, h), "type_emb": w(2, h), "emb_ln": ln(h),
        "layers": [{"q": dense(h, h), "k": dense(h, h), "v": dense(h, h), "attn_out": dense(h, h),
                    "attn_ln": ln(h), "ffn_in": dense(h, 4 * h), "ffn_out": dense(4 * h, h),
                    "ffn_ln": ln(h)} for _ in range(layers)],
        "projection": w(h, 128),
    }
    return params, config


def test_bert_forward_bf16_on_the_card_matches_f32(cuda, monkeypatch):
    """The card's bf16 forward (f32 results through ``out_dtype`` where the
    installed PyTorch has it) against the float32 forward of the same module
    on the card and on the CPU: min token cosine >= 0.99 (the bf16 bound of
    ``jax_encoder.py``); the float32 forwards agree within 1e-4."""
    from fast_plaid_tpu_torch.models import bert_forward, params_from_jax

    params, config = _random_bert(0)
    model = params_from_jax(params, config, device=cuda)
    cpu_model = params_from_jax(params, config, device="cpu")
    g = torch.Generator().manual_seed(1)
    lens = torch.tensor([180, 64, 120, 33, 2])
    ids = torch.randint(1000, (5, 180), generator=g)
    mask = (torch.arange(180) < lens[:, None]).long()
    keep = mask.bool()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # full f32
    with torch.inference_mode():
        bf16 = bert_forward(model, ids.to(cuda), mask.to(cuda))[keep.to(cuda)].cpu()
        f32 = bert_forward(model, ids.to(cuda), mask.to(cuda), compute_dtype=torch.float32)
        f32 = f32[keep.to(cuda)].cpu()
        ref = bert_forward(cpu_model, ids, mask, compute_dtype=torch.float32)[keep]
    assert bf16.dtype == torch.float32 and bf16.shape == (int(lens.sum()), 128)
    assert float((bf16 * f32).sum(-1).min()) >= 0.99
    assert float((f32 - ref).abs().max()) <= 1e-4


def test_native_gather_into_pinned_out(cuda):
    """The native host gather writes straight into a pinned buffer, byte for
    byte what the torch gather gives, and the buffer copies to the card."""
    import numpy as np

    from fast_plaid_tpu_torch import native
    from fast_plaid_tpu_torch.search import searcher

    rng = np.random.default_rng(2)
    res = rng.integers(0, 255, (20_000, 64)).astype(np.uint8)
    codes = rng.integers(0, 2**31 - 1, 20_000).astype(np.int32)
    starts = rng.integers(-5, 20_050, 1024)
    lens = np.minimum(rng.integers(0, 300, 1024), 160)
    for src in (res, codes):
        out = torch.empty((1024, 160, *src.shape[1:]), dtype=torch.from_numpy(src).dtype,
                          pin_memory=True)
        calls = native.gather_windows_u8.calls
        assert native.gather_windows_u8(src, starts, lens, 160, out=out) is out
        assert native.AVAILABLE and native.gather_windows_u8.calls == calls + 1
        assert out.is_pinned()
        want = searcher._gather_windows(src, starts, lens, 160, False, use_native=False)
        assert torch.equal(out, want)
        assert torch.equal(out.to(cuda, non_blocking=True).cpu(), want)


def test_packed_rows_expand_on_the_card(cuda, tmp_path):
    """low_memory's rows packed on the host into pinned memory, copied up
    without blocking and expanded on the card: byte for byte the padded
    rows of ``host_gather_rows``, with three pools in flight at once; and a
    low_memory search finds each planted document as the resident one does."""
    import numpy as np

    from fast_plaid_tpu_torch.index.storage import load_index_data
    from fast_plaid_tpu_torch.search import FastPlaid, load, searcher

    rng = np.random.default_rng(8)
    docs = [rng.standard_normal((int(n), 128)).astype(np.float32) for n in rng.integers(32, 180, 3000)]
    fp = FastPlaid(str(tmp_path / "idx"), device="cuda", low_memory=False)
    fp.create(docs, kmeans_niters=2)
    lm = load._construct(load_index_data(str(tmp_path / "idx")), cuda, True)
    assert lm.low_memory and lm.dev.emb_q4 is not None
    n, cap = lm.ispec.n_docs, lm.ispec.doc_cap
    pools = []
    for seed in range(3):
        pids = np.random.default_rng(seed).integers(0, n, (256, 40))
        pids[:, 20:] = pids[:, :20]
        pids[seed, ::3] = n
        pools.append(pids)
    with torch.inference_mode():
        packed = [searcher._pack_rows(lm, p, pin=True) for p in pools]
        assert all(x.is_pinned() for rows in packed for x in rows)
        got = [searcher._expand_rows(searcher.PackedRows(*(x.to(cuda, non_blocking=True) for x in rows)), cap)
               for rows in packed]
        for g, pids in zip(got, pools):
            for a, b in zip(g, searcher.host_gather_rows(lm, pids)):
                assert a.device == cuda and torch.equal(a.cpu(), b)
    qs = np.stack([d[:32] for d in docs[:256]])  # each query's top-1 is its own document
    kw = dict(top_k=10, n_full_scores=4096, show_progress=False)
    resident = fp.search(qs, **kw)
    fp.indices[str(cuda)] = lm
    low = fp.search(qs, **kw)
    for res in (resident, low):
        assert sum(r[0][0] == i for i, r in enumerate(res)) >= 250
    fp.close()


def test_staged_query_tile_rounds_like_numpy_on_the_card(cuda):
    """The search head's query tile crosses as float32 through pinned memory
    and is rounded to float16 on the card: bit for bit numpy's host cast, at
    random values, ties between float16 neighbours, overflow and subnormals,
    with three tiles in flight at once."""
    import numpy as np

    from fast_plaid_tpu_torch.search import searcher

    rng = np.random.default_rng(4)
    h = np.arange(0, 0x7BFF, dtype=np.uint16).view(np.float16)  # every finite float16 >= 0
    lo, hi = h.astype(np.float32), np.nextafter(h, np.float16(np.inf)).astype(np.float32)
    ties = lo + (hi - lo) / 2
    near = np.concatenate([np.nextafter(ties, np.float32(0)), np.nextafter(ties, np.float32(np.inf))])
    big = np.array([65504, 65519, 65519.996, 65520, 65536, 1e6, 3.0e38], np.float32)
    sub = np.arange(-3000, 3000, dtype=np.float32) * np.float32(2.0**-26)
    rand = rng.standard_normal(300_000).astype(np.float32) * np.float32(4.0)
    flat = np.concatenate([rand, ties, near, big, sub])
    flat = np.concatenate([flat, -flat])
    n = -(-flat.size // (32 * 128))
    x = np.resize(flat, (n, 32, 128)).astype(np.float32)
    with np.errstate(over="ignore"):
        want = x.astype(np.float16).view(np.uint16)
    thirds = np.array_split(np.arange(n), 3)
    tiles = [searcher._stage_tile(x[i], len(i) + 5, cuda, half=True) for i in thirds]
    torch.cuda.synchronize()
    for i, got in zip(thirds, tiles):
        assert got.device.type == "cuda" and got.dtype == torch.float16
        got = got.cpu().numpy()
        np.testing.assert_array_equal(got[: len(i)].view(np.uint16), want[i])
        assert not got[len(i):].any()
