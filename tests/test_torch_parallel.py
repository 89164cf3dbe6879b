"""Multi-device search: the port's ``parallel/`` against fast_plaid_tpu's.

Mirrors ``tests/test_parallel.py`` on the port, whose mesh is a list of
``torch.device`` slots (``[cpu] * 4`` here), and holds every path against
the JAX package on its virtual 8-CPU-device mesh, fed the same numpy
artifacts: ids equal except at score ties, scores within atol 1e-4
(``test_torch_engine.py``'s tolerance). The shard tensors of
``build_sharded_index`` equal the JAX leaves byte for byte.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax

from fast_plaid_tpu import parallel as jpar
from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu import testing
from fast_plaid_tpu.index import ivf as jivf
from fast_plaid_tpu.index.builder import compress_documents, train_codec_from_documents
from fast_plaid_tpu.index.layout import to_device as jto_device
from fast_plaid_tpu.ops.kmeans import train_kmeans
from fast_plaid_tpu.parallel.sharded import _resolve_shard_params as j_resolve
from fast_plaid_tpu_torch import parallel
from fast_plaid_tpu_torch.index import layout as tlayout
from fast_plaid_tpu_torch.parallel import mesh as tmesh
from fast_plaid_tpu_torch.parallel import sharded as tsharded
from fast_plaid_tpu_torch.search import FastPlaid
from fast_plaid_tpu_torch.search import engine as tengine
from fast_plaid_tpu_torch.search.searcher import kernel_flags, last_search_stats

torch.set_num_threads(2)

TOL = 1e-4
CPU4 = [torch.device("cpu")] * 4
LEAVES = ("codes", "residuals", "doc_lengths", "ivf", "ivf_offsets", "ivf_lengths",
          "centroids", "bucket_weights")


def jmesh(n=4):
    return jpar.make_mesh(devices=jax.devices("cpu")[:n])


def tmesh4():
    return parallel.make_mesh(devices=CPU4)


def np_out(out):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in out)


def assert_same_topk(ids_a, sc_a, ids_b, sc_b, tol=TOL):
    """Scores agree position-wise; ids agree except where a document only
    one list holds ties the k-th score."""
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=tol)
    for ia, sa, ib, sb in zip(ids_a, sc_a, ids_b, sc_b):
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids.tolist()):
                if pid not in other.tolist():
                    assert abs(sc[j] - sc[-1]) <= tol, (pid, sc[j], sc[-1])


def artifacts(docs, k=64, niters=4, seed=1):
    flat = np.concatenate(docs)
    centroids = np.asarray(train_kmeans(flat, k=k, niters=niters, seed=seed))
    params = train_codec_from_documents(docs, centroids, 4, seed)
    codes, packed = compress_documents(docs, centroids, params.bucket_cutoffs, 4)
    return dict(
        centroids=centroids,
        bucket_weights=np.asarray(params.bucket_weights),
        codes=np.asarray(codes),
        residuals=np.asarray(packed),
        doc_lengths=np.asarray([d.shape[0] for d in docs], np.int64),
        nbits=4,
    )


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs = testing.random_documents(rng, 64, 20, 32, variable=True)
    queries = testing.random_queries(rng, 8, 6, 32)
    return docs, queries


@pytest.fixture(scope="module")
def shared(corpus):
    """One set of artifacts: the sharded index of both packages and the
    port's single-device index."""
    docs, _ = corpus
    art = artifacts(docs)
    ivf, ivf_lengths = jivf.build_ivf(art["codes"], art["doc_lengths"], 64)
    dev, ispec = tlayout.to_device(ivf=ivf, ivf_lengths=ivf_lengths, **art, device="cpu")
    return dict(
        art=art,
        js=jpar.build_sharded_index(mesh=jmesh(), **art),
        ts=parallel.build_sharded_index(mesh=tmesh4(), **art),
        dev=dev,
        ispec=ispec,
    )


def t_search(dev, ispec, queries, subset=None, **kw):
    kw = dict(dict(top_k=5, n_ivf_probe=8, n_full_scores=4096, want_tokens=False), **kw)
    sub = None if subset is None else torch.from_numpy(subset)
    with torch.inference_mode():
        return np_out(tengine.search_impl(dev, torch.from_numpy(np.asarray(queries)), sub, ispec=ispec, **kw))


def test_build_sharded_index_matches_jax_leaves(shared):
    js, ts = shared["js"], shared["ts"]
    assert dataclasses.asdict(ts.ispec) == dataclasses.asdict(js.ispec)
    np.testing.assert_array_equal(ts.doc_base, np.asarray(js.doc_base))
    np.testing.assert_array_equal(ts.ivf_lengths_host, js.ivf_lengths_host)
    assert ts.n_docs_total == js.n_docs_total
    for name in LEAVES:
        leaf = np.asarray(getattr(js.dev, name))
        for j, shard in enumerate(ts.shards):
            got = getattr(shard, name).numpy()
            assert got.dtype == leaf[j].dtype, name
            np.testing.assert_array_equal(got, leaf[j].reshape(got.shape), err_msg=name)
            assert got.tobytes() == np.ascontiguousarray(leaf[j]).tobytes(), name


def test_doc_sharded_matches_single_device_and_jax(shared, corpus):
    _, queries = corpus
    pids, scores = np_out(parallel.sharded_search(shared["ts"], queries, top_k=5))
    ref_p, ref_s = t_search(shared["dev"], shared["ispec"], queries)
    # Per-shard probing gives each shard its own pool: the top-1 and its
    # score agree with one device, the lists are sorted.
    for b in range(pids.shape[0]):
        assert pids[b, 0] == ref_p[b, 0]
        np.testing.assert_allclose(scores[b, 0], ref_s[b, 0], rtol=1e-5)
        valid = scores[b][pids[b] >= 0]
        assert np.all(np.diff(valid) <= 1e-6)
    jp, js_ = np_out(jpar.sharded_search(shared["js"], queries, top_k=5))
    assert_same_topk(pids, scores, jp, js_)


@pytest.mark.parametrize("n_queries", [8, 7])
def test_query_sharded_matches_single_device_and_jax(shared, corpus, n_queries):
    """Every query's result equals one device's; a batch of 7 over 4 slots
    is padded and trimmed."""
    _, queries = corpus
    q = queries[:n_queries]
    dev, ispec = shared["dev"], shared["ispec"]
    pids, scores = np_out(parallel.query_sharded_search(dev, ispec, q, tmesh4(), top_k=5))
    assert pids.shape == (n_queries, 5)
    ref_p, ref_s = t_search(dev, ispec, q)
    np.testing.assert_array_equal(pids, ref_p)
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5)
    jdev, jspec = testing.build_memory_index(corpus[0], nbits=4, seed=1)
    jp, js_ = np_out(jpar.query_sharded_search(jdev, jspec, q, jmesh(), top_k=5))
    arrays = {f: np.asarray(getattr(jdev, f)) for f in jdev._fields
              if getattr(jdev, f) is not None and f != "buckets"}
    tdev, tspec = tlayout.device_index_from_arrays(arrays, dataclasses.asdict(jspec), "cpu")
    tp, ts_ = np_out(parallel.query_sharded_search(tdev, tspec, q, tmesh4(), top_k=5))
    assert_same_topk(tp, ts_, jp, js_)


def test_query_sharded_subset_matches_jax(shared, corpus):
    _, queries = corpus
    rng = np.random.default_rng(13)
    subsets = [sorted(rng.choice(64, 20, replace=False).tolist()) for _ in range(7)]
    q = queries[:7]
    dev, ispec = shared["dev"], shared["ispec"]
    tp, ts_ = np_out(parallel.query_sharded_search(dev, ispec, q, tmesh4(), top_k=5, subset=subsets))
    art = shared["art"]
    ivf, ivf_lengths = jivf.build_ivf(art["codes"], art["doc_lengths"], 64)
    jdev, jspec = jto_device(ivf=ivf, ivf_lengths=ivf_lengths, **art)
    jp, js_ = np_out(jpar.query_sharded_search(jdev, jspec, q, jmesh(), top_k=5, subset=subsets))
    assert_same_topk(tp, ts_, jp, js_)
    for b in range(7):
        assert {int(p) for p in tp[b] if p >= 0} <= set(subsets[b])


def test_sharded_auto_resolves_like_single_chip():
    """Past the candidates/budget crossover the sharded path engages the
    single-device recall machinery, resolves as the JAX package does on the
    same statistics, and finds planted verbatim copies at rank 1."""
    rng = np.random.default_rng(9)
    docs = testing.random_documents(rng, 1500, 8, 32, variable=True)
    art = artifacts(docs, niters=2, seed=2)
    ts = parallel.build_sharded_index(mesh=tmesh4(), **art)
    n_full = 16
    got = tsharded._resolve_shard_params(ts.ivf_lengths_host, ts.ispec, 8, 8, n_full, "auto", None)
    mode, r_adm, slot_budget, cand_cap = got
    assert mode == "cells_full" or r_adm > 0, (mode, r_adm)
    ref = tengine.resolve_approx_mode(
        "auto", ts.ivf_lengths_host, q_cap=8, n_ivf_probe=8, n_full_scores=n_full,
        n_partitions=ts.ispec.n_partitions, cand_cap=cand_cap,
    )
    assert (mode, r_adm, slot_budget) == ref
    js = jpar.build_sharded_index(mesh=jmesh(), **art)
    assert got == j_resolve(js.ivf_lengths_host, js.ispec, 8, 8, n_full, "auto", None)

    probe_ids = [3, 700, 1499]
    q_cap = max(docs[i].shape[0] for i in probe_ids)
    queries = np.zeros((len(probe_ids), q_cap, 32), np.float32)
    for i, pid in enumerate(probe_ids):
        queries[i, : docs[pid].shape[0]] = docs[pid]
    pids, scores = np_out(parallel.sharded_search(ts, queries, top_k=5, n_full_scores=n_full))
    assert list(pids[:, 0]) == probe_ids, pids[:, 0]
    jp, js_ = np_out(jpar.sharded_search(js, queries, top_k=5, n_full_scores=n_full))
    assert_same_topk(pids, scores, jp, js_)


@pytest.fixture(scope="module")
def disk_index(tmp_path_factory):
    """One index directory written by the JAX package."""
    rng = np.random.default_rng(3)
    docs = testing.random_documents(rng, 48, 14, 32, variable=True)
    path = str(tmp_path_factory.mktemp("tpar") / "idx")
    jsearch.FastPlaid(index=path, device="cpu").create(documents_embeddings=docs)
    return path, rng


def test_sharded_fastplaid_from_disk(disk_index):
    """Both packages' ShardedFastPlaid over one JAX-made index answer alike,
    and agree with the port's single-device FastPlaid on the top result."""
    path, _ = disk_index
    queries = testing.random_queries(np.random.default_rng(4), 4, 5, 32)
    ref = FastPlaid(index=path, device="cpu").search(queries, top_k=3, show_progress=False)
    sharded = parallel.ShardedFastPlaid(path, mesh=tmesh4())
    got = sharded.search(queries, top_k=3)
    assert len(got) == 4
    for a, b in zip(got, ref):
        assert a[0][0] == b[0][0]
        assert abs(a[0][1] - b[0][1]) < 1e-3
    want = jpar.ShardedFastPlaid(path, mesh=jmesh()).search(queries, top_k=3)
    assert_same_topk(
        np.asarray([[p for p, _ in r] for r in got]), np.asarray([[s for _, s in r] for r in got]),
        np.asarray([[p for p, _ in r] for r in want]), np.asarray([[s for _, s in r] for r in want]),
    )


def test_sharded_subset_matches_single_device_and_jax(shared, corpus):
    """Global subset ids, rebased per shard: results stay inside the subset,
    the top hit agrees with one device and the lists with the JAX mesh."""
    _, queries = corpus
    rng = np.random.default_rng(5)
    subsets = [sorted(rng.choice(64, 24, replace=False).tolist()) for _ in range(len(queries))]
    pids, scores = np_out(parallel.sharded_search(shared["ts"], queries, top_k=5, subset=subsets))
    sub = np.full((len(queries), 24), shared["ispec"].sentinel_pid, np.int32)
    for i, s in enumerate(subsets):
        sub[i, : len(s)] = s
    ref_p, ref_s = t_search(shared["dev"], shared["ispec"], queries, sub)
    for b in range(pids.shape[0]):
        assert {int(p) for p in pids[b] if p >= 0} <= set(subsets[b])
        if ref_p[b, 0] >= 0:
            assert pids[b, 0] == ref_p[b, 0]
            np.testing.assert_allclose(scores[b, 0], ref_s[b, 0], rtol=1e-5)
    jp, js_ = np_out(jpar.sharded_search(shared["js"], queries, top_k=5, subset=subsets))
    assert_same_topk(pids, scores, jp, js_)


def test_rebase_subset_matches_jax():
    from fast_plaid_tpu.parallel.sharded import _rebase_subset as j_rebase

    ispec = tlayout.IndexSpec(dim=8, nbits=4, n_docs=16, n_partitions=4, doc_cap=16,
                              cell_cap=8, has_ivf=True)
    sub = jpar.sharded.pad_global_subsets([[0, 15, 16, 31, 32, 40], [], [17]], 48)
    np.testing.assert_array_equal(
        sub, tsharded.pad_global_subsets([[0, 15, 16, 31, 32, 40], [], [17]], 48)
    )
    for base in (0, 16, 32):
        got = tsharded._rebase_subset(torch.from_numpy(sub), base, ispec).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_rebase(sub, base, ispec)))


def test_sharded_token_scores_match_single_device_and_jax(shared, corpus):
    """want_tokens: merged winners carry the [doc_cap, Q] token matrices one
    device computes, and the JAX mesh's."""
    _, queries = corpus
    pids, scores, tok, doc_lens = np_out(
        parallel.sharded_search(shared["ts"], queries, top_k=3, want_tokens=True)
    )
    ref_p, _, ref_tok, ref_lens = t_search(shared["dev"], shared["ispec"], queries, top_k=3,
                                           want_tokens=True)
    same = 0
    for b in range(pids.shape[0]):
        for k in range(pids.shape[1]):
            if pids[b, k] < 0 or pids[b, k] != ref_p[b, k]:
                continue
            same += 1
            dlen = int(doc_lens[b, k])
            assert dlen == int(ref_lens[b, k])
            np.testing.assert_allclose(tok[b, k, :dlen], ref_tok[b, k, :dlen], rtol=1e-4, atol=1e-5)
    assert same >= pids.shape[0]
    jp, js_, jt, jl = np_out(jpar.sharded_search(shared["js"], queries, top_k=3, want_tokens=True))
    assert_same_topk(pids, scores, jp, js_)
    both = pids == jp
    np.testing.assert_array_equal(doc_lens[both], jl[both])
    np.testing.assert_allclose(tok[both], jt[both], rtol=0, atol=TOL)


def test_sharded_stats_overflow_accounting(shared, corpus):
    """with_stats: the [B, 2] pruned/overflow accounting summed over shards,
    equal to the JAX mesh's."""
    _, queries = corpus
    out = parallel.sharded_search(shared["ts"], queries, top_k=5, with_stats=True)
    assert len(out) == 3
    stats = out[2].numpy()
    assert stats.shape == (len(queries), 2) and stats.dtype == np.int32
    assert (stats >= 0).all()
    jout = jpar.sharded_search(shared["js"], queries, top_k=5, with_stats=True)
    np.testing.assert_array_equal(stats, np.asarray(jout[2]))
    # The budgeted path prunes: the counts are not trivially zero.
    _, _, small = np_out(parallel.sharded_search(
        shared["ts"], queries, top_k=5, n_full_scores=16, with_stats=True))
    _, _, jsmall = np_out(jpar.sharded_search(
        shared["js"], queries, top_k=5, n_full_scores=16, with_stats=True))
    np.testing.assert_array_equal(small, jsmall)


def test_sharded_fastplaid_subset_and_tokens(disk_index):
    """ShardedFastPlaid surfaces subsets and token scores like FastPlaid and
    like the JAX package's ShardedFastPlaid."""
    path, _ = disk_index
    queries = testing.random_queries(np.random.default_rng(7), 3, 5, 32)
    subset = [list(range(0, 30))] * 3
    eng = FastPlaid(index=path, device="cpu")
    sharded = parallel.ShardedFastPlaid(path, mesh=tmesh4())
    jsharded = jpar.ShardedFastPlaid(path, mesh=jmesh())
    got = sharded.search(queries, top_k=3, subset=subset)
    ref = eng.search(queries, top_k=3, subset=subset, show_progress=False)
    want = jsharded.search(queries, top_k=3, subset=subset)
    for a, b, c in zip(got, ref, want):
        assert {p for p, _ in a} <= set(subset[0])
        assert a[0][0] == b[0][0] == c[0][0]
        assert abs(a[0][1] - b[0][1]) < 1e-3
        assert [p for p, _ in a] == [p for p, _ in c]

    toks = sharded.search_token_scores(queries, top_k=3)
    st = last_search_stats()
    assert st["queries"] == 3 and st["cap_overflow_slots"] >= 0
    assert st["approx_mode"] == "sharded"
    ref_t = eng.search_token_scores(queries, top_k=3, show_progress=False)
    want_t = jsharded.search_token_scores(queries, top_k=3)
    for a, b, c in zip(toks, ref_t, want_t):
        assert a[0][0] == b[0][0] == c[0][0]
        assert a[0][2].shape == b[0][2].shape == c[0][2].shape
        np.testing.assert_allclose(a[0][2], b[0][2], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a[0][2], c[0][2], rtol=0, atol=TOL)


def test_sharded_fastplaid_warns_on_overflow(disk_index, monkeypatch):
    """Static-buffer truncation beyond the budget's pruning warns, as the
    single-device searcher does."""
    path, _ = disk_index
    sharded = parallel.ShardedFastPlaid(path, mesh=tmesh4())
    real = tsharded._doc_sharded

    def overflowing(*args, **kw):
        out = list(real(*args, **kw))
        out[-1] = out[-1] + torch.tensor([0, 2], dtype=torch.int32)
        return tuple(out)

    monkeypatch.setattr(tsharded, "_doc_sharded", overflowing)
    queries = testing.random_queries(np.random.default_rng(8), 2, 5, 32)
    with pytest.warns(RuntimeWarning, match="overflow on the mesh"):
        sharded.search(queries, top_k=3)
    assert last_search_stats()["cap_overflow_slots"] == 4


def test_sharded_index_from_arrays_searches_like_jax(shared, corpus):
    """A JAX-built ShardedIndex carried across leaf by leaf: both packages
    search it alike."""
    _, queries = corpus
    js = shared["js"]
    arrays = {f: np.asarray(getattr(js.dev, f)) for f in js.dev._fields
              if getattr(js.dev, f) is not None and f != "buckets"}
    arrays.update(doc_base=np.asarray(js.doc_base), ispec=dataclasses.asdict(js.ispec),
                  n_docs_total=js.n_docs_total, ivf_lengths_host=js.ivf_lengths_host)
    ts = tsharded.sharded_index_from_arrays(arrays, tmesh4())
    assert ts.ispec == shared["ts"].ispec
    for name in LEAVES:
        for a, b in zip(ts.shards, shared["ts"].shards):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    tp, ts_ = np_out(parallel.sharded_search(ts, queries, top_k=5))
    jp, js_ = np_out(jpar.sharded_search(js, queries, top_k=5))
    assert_same_topk(tp, ts_, jp, js_)
    with pytest.raises(ValueError, match="shards for a mesh"):
        tsharded.sharded_index_from_arrays(arrays, parallel.make_mesh(devices=CPU4[:2]))


def test_merge_topk_ties_go_to_the_lower_shard():
    """Equal scores keep the shard-major order of the gathered layout, as
    lax.top_k does; -inf maps to id -1."""
    gp = [torch.tensor([[5, -1]], dtype=torch.int32), torch.tensor([[9, 8]], dtype=torch.int32)]
    sc = [torch.tensor([[1.0, float("-inf")]]), torch.tensor([[1.0, 0.5]])]
    mp, ms, mi = tsharded._merge_topk(gp, sc, 4)
    assert mp.tolist() == [[5, 9, 8, -1]]
    assert mi.tolist() == [[0, 2, 3, 1]]


def test_no_cpu_fallback(disk_index, monkeypatch):
    """Without CUDA, or with fewer CUDA devices than asked, the entry points
    raise: no path of parallel/ falls back to the CPU by itself."""
    path, _ = disk_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (
        lambda: tmesh.pick_devices(1),
        lambda: tmesh.pick_devices(),
        lambda: parallel.make_mesh(),
        lambda: parallel.ShardedFastPlaid(path),
        lambda: parallel.load_sharded_lm(path),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        parallel.make_mesh_2d(1, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="only 2 CUDA"):
        tmesh.pick_devices(4)
    assert tmesh.pick_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_kernel_flags_follow_the_index_device(shared):
    """The flags come from the device the index lives on: a CPU index runs
    the plain versions even where the process has a GPU."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert kernel_flags(shared["dev"]) == (False, False)
        for shard in shared["ts"].shards:
            assert kernel_flags(shard) == (False, False)


def test_mesh_holds_repeated_devices():
    m = parallel.make_mesh(devices=["cpu", torch.device("cpu")])
    assert m.shape == {"d": 2}
    assert m.device_list() == [torch.device("cpu")] * 2


def test_launch_counts_are_exact_across_threads():
    """The shards of one device launch kernels from several threads at once;
    a wrapper's count loses no launch to the race."""
    from concurrent.futures import ThreadPoolExecutor

    from fast_plaid_tpu_torch.ops._build import count_launch

    def wrapper():
        pass

    wrapper.launches = 0

    def many(_):
        for _ in range(2000):
            count_launch(wrapper)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(many, range(8)))
    assert wrapper.launches == 8 * 2000
