"""The port's span and counter recorder (``utils/tracing.py``) on the CPU:
off it records nothing and changes no answer; on, each search call is one
tree of spans (the host gather's worker included), the counters match the
work of a call of known size, and the spans reach a profiler trace's clock.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from fast_plaid_tpu_torch.index.storage import load_index_data
from fast_plaid_tpu_torch.ops import rerank_dedup
from fast_plaid_tpu_torch.ops.kmeans import train_kmeans
from fast_plaid_tpu_torch.search import FastPlaid, load, searcher
from fast_plaid_tpu_torch.utils import tracing

torch.set_num_threads(2)

DIM = 32
SEARCH = {"top_k": 5, "n_full_scores": 256, "show_progress": False}
RESIDENT = {
    "search", "search.prepare", "search.plan", "search.upload", "engine.probe",
    "engine.candidates", "engine.estimate", "engine.prune", "engine.rerank",
    "engine.topk", "search.emit", "search.emit.wait",
}
LOW_MEMORY = RESIDENT | {"engine.q4_prefilter", "search.host_gather", "search.gather_wait"}


def _docs(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    docs = [rng.standard_normal((int(rng.integers(8, 40)), DIM)).astype(np.float32) for _ in range(n)]
    return [d / np.linalg.norm(d, axis=1, keepdims=True) for d in docs]


def _queries(n: int, seed: int = 1, tokens: int = 8) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal((n, tokens, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "index")
    FastPlaid(path, device="cpu").create(_docs(400), kmeans_niters=2)
    return path


def _instance(index_dir: str, path: str) -> FastPlaid:
    """A CPU instance on ``index_dir``: resident, or a low_memory load with the
    q4 cache (``reload_index`` keeps the CPU resident)."""
    fp = FastPlaid(index_dir, device="cpu")
    if path == "low_memory":
        cpu = torch.device("cpu")
        loaded = load._construct(load_index_data(index_dir), cpu, True, emb_cache_budget=10**9)
        assert loaded.low_memory and loaded.dev.emb_q4 is not None
        fp.indices[str(cpu)] = loaded
    return fp


def _roots(spans, name="search"):
    return [s for s in spans if s["name"] == name and s["parent"] == 0]


@pytest.mark.parametrize("path", ["resident", "low_memory"])
def test_recorder_off_records_nothing_and_answers_alike(index_dir, path):
    fp = _instance(index_dir, path)
    q = _queries(6)
    off = fp.search(q, **SEARCH)
    got = tracing.drain()
    assert got["spans"] == [] and got["counters"] == {}
    assert tracing.span("a") is tracing.span("b")  # the shared no-op
    tracing.enable()
    on = fp.search(q, **SEARCH)
    tracing.disable()
    assert _roots(tracing.drain()["spans"])
    assert [[p for p, _ in r] for r in on] == [[p for p, _ in r] for r in off]
    assert [[s for _, s in r] for r in on] == [[s for _, s in r] for r in off]  # bit for bit


@pytest.mark.parametrize("path", ["resident", "low_memory"])
def test_a_call_is_one_tree(index_dir, path):
    fp = _instance(index_dir, path)
    tracing.enable()
    fp.search(_queries(6), **SEARCH)
    spans = tracing.drain()["spans"]
    (root,) = _roots(spans)
    assert all(s["call"] == root["id"] for s in spans)
    assert {s["name"] for s in spans} == (LOW_MEMORY if path == "low_memory" else RESIDENT)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"]:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"], s["name"]
    if path == "low_memory":
        (gather,) = [s for s in spans if s["name"] == "search.host_gather"]
        assert gather["thread"] != root["thread"] and gather["parent"] == root["id"]


def test_two_threads_keep_their_trees_apart(index_dir):
    fp = _instance(index_dir, "resident")
    tracing.enable()
    barrier = threading.Barrier(2)

    def run(seed):
        barrier.wait()
        fp.search(_queries(4, seed=seed), **SEARCH)

    threads = [threading.Thread(target=run, args=(s,)) for s in (2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tracing.drain()["spans"]
    roots = _roots(spans)
    assert len(roots) == 2 and roots[0]["thread"] != roots[1]["thread"]
    for root in roots:
        mine = [s for s in spans if s["call"] == root["id"]]
        assert {s["thread"] for s in mine} == {root["thread"]}
        assert {s["name"] for s in mine} == RESIDENT
    assert len(spans) == 2 * (len(RESIDENT) + 2)  # engine.candidates opens three times a call


def test_tiles_count_the_padded_slots(index_dir):
    fp = _instance(index_dir, "resident")
    tracing.enable()
    fp.search(_queries(256 + 64, tokens=4), **SEARCH)  # a full tile and 64 queries
    counters = tracing.drain()["counters"]
    assert counters["search.queries"] == 320
    assert counters["search.tiles"] == 2
    assert counters["search.query_slots"] == 512


@pytest.mark.parametrize("path", ["resident", "low_memory"])
def test_bytes_across_the_bus(index_dir, path, monkeypatch):
    fp = _instance(index_dir, path)
    pools, pack = [], searcher._pack_rows

    def recorded(lm, p2, **kw):
        pools.append(p2)
        return pack(lm, p2, **kw)

    monkeypatch.setattr(searcher, "_pack_rows", recorded)
    tracing.enable()
    fp.search(_queries(5), **SEARCH)
    counters = tracing.drain()["counters"]
    tile = 5 * 8 * DIM * 4  # one tile of 5 queries of 8 tokens, float32 on the CPU
    loaded = next(iter(fp.indices.values()))
    if path == "resident":
        assert counters["h2d.bytes"] == tile
        assert "gather.rows" not in counters and not pools
    else:
        cap, pd = loaded.ispec.doc_cap, loaded.host_residuals.shape[1]
        rows = counters["gather.rows"]
        assert rows == counters["rerank.rows"] and rows % 5 == 0
        # Each distinct document's valid tokens once; then doc_cap spare
        # rows and each slot's (first row, length) cross with them.
        (pool,) = pools
        distinct = np.unique(pool[(pool >= 0) & (pool < loaded.ispec.n_docs)])
        tokens = int(np.minimum(loaded.host_doc_lengths[distinct], cap).sum())
        assert counters["gather.distinct"] == len(distinct) == counters["rerank.distinct_rows"]
        assert counters["gather.bytes"] == tokens * (4 + pd) < rows * cap * (4 + pd)
        assert counters["h2d.bytes"] == tile + counters["gather.bytes"] + cap * (4 + pd) + rows * 2 * 4
    # pids (int32), scores (float32) and stats (2 x int32) of the tile
    assert counters["d2h.bytes"] == 5 * 5 * 4 * 2 + 5 * 2 * 4
    assert 0 < counters["rerank.distinct_rows"] <= counters["rerank.rows"]
    assert counters["candidates"] > 0


def test_device_counter_adds_without_reading(index_dir):
    tracing.enable()
    tracing.count_device("ones", torch.ones(7, dtype=torch.bool))
    tracing.count_device("ones", torch.tensor([2, 3]))
    tracing.count("host", 4)
    tracing.count("host", 5)
    got = tracing.drain()["counters"]
    assert got == {"ones": 12, "host": 9}
    assert tracing.drain()["counters"] == {}


def test_dedup_grouping_span_and_entries():
    """The dedup wrapper's plain path marks its grouping ``rerank.group`` and
    adds its live entries, one a (document, group of at most g requesters),
    to ``rerank.entries``."""
    emb = torch.randn(4, 16, 128).to(torch.bfloat16)
    pids = torch.tensor([[0, 0, 0, 1], [0, 2, 2, 2]], dtype=torch.int32)
    lens = torch.full_like(pids, 16)
    queries = torch.randn(2, 16, 128)
    tracing.enable()
    rerank_dedup.maxsim_gather_scores_dedup(emb, pids, lens, queries, g=2)
    got = tracing.drain()
    assert [s["name"] for s in got["spans"]] == ["rerank.group"]
    assert got["counters"] == {"rerank.entries": 5}  # pid 0: 2 entries, pid 1: 1, pid 2: 2


@pytest.mark.parametrize(("t", "k", "chunk", "points"), [
    (900, 8, 16384, 900),  # under k * 256: every point
    (3000, 4, 16384, 1024),  # over: subsampled to k * 256
    (3000, 8, 1000, 2000),  # over, then trimmed to whole chunks
])
def test_kmeans_counts_the_points_it_trains_on(t, k, chunk, points):
    data = np.random.default_rng(0).standard_normal((t, DIM)).astype(np.float32)
    tracing.enable()
    train_kmeans(data, k, niters=1, chunk=chunk)
    assert tracing.drain()["counters"] == {"kmeans.points": points}


def test_bound_work_joins_the_call():
    tracing.enable()
    out = {}

    def inner():
        with tracing.span("inner"):
            out["thread"] = threading.get_ident()

    with tracing.span("outer") as outer:
        t = threading.Thread(target=tracing.bind(inner))
        t.start()
        t.join()
    spans = {s["name"]: s for s in tracing.drain()["spans"]}
    assert spans["inner"]["call"] == outer.sid == spans["inner"]["parent"]
    assert spans["inner"]["thread"] == out["thread"] != spans["outer"]["thread"]


def test_spans_map_onto_the_profiler_clock(tmp_path):
    """Each span, mapped onto the trace's clock, lies inside its
    ``record_function`` twin (which also holds the twin's own entry and exit
    costs), to within 100 us at either end."""
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("warm_up"):  # the process's first record_function
            pass
        for i in range(3):
            with tracing.span(f"mapped_{i}"):
                torch.ones(256, 256).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    rec = tracing.drain()
    events = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    base = int(doc["baseTimeNanoseconds"])
    mapped = [s for s in rec["spans"] if s["name"].startswith("mapped_")]
    assert len(mapped) == 3
    for s in mapped:
        twin = events[s["name"]]
        start = tracing.trace_us(s["start_ns"], base, rec["clock"])
        end = start + (s["end_ns"] - s["start_ns"]) / 1e3
        t0, t1 = float(twin["ts"]), float(twin["ts"]) + float(twin["dur"])
        assert t0 - 100.0 <= start and end <= t1 + 100.0, (s["name"], start - t0, end - t1)


def test_trace_writes_the_worker_gather(index_dir, tmp_path):
    fp = _instance(index_dir, "low_memory")
    log_dir = str(tmp_path / "trace")
    with tracing.trace(log_dir):
        fp.search(_queries(4), **SEARCH)
    assert not tracing.enabled()
    with open(os.path.join(log_dir, os.listdir(log_dir)[0])) as f:
        events = json.load(f)["traceEvents"]
    program = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in program] == ["search.host_gather"]
    search = [e for e in events if e.get("name") == "search" and e.get("cat") == "user_annotation"]
    (gather,) = program
    (root,) = search
    assert root["ts"] <= gather["ts"] and gather["ts"] + gather["dur"] <= root["ts"] + root["dur"] + 100
    assert gather["args"]["call"] == gather["args"]["parent"]
