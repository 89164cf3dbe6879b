"""Serving on the port: micro-batching and the HTTP surface.

The 11 tests of ``test_serving.py`` on ``fast_plaid_tpu_torch.serving``
(``device="cpu"``), and the JAX server and the port's server over one
JAX-made index answering the same JSON and b64 requests alike (ids equal
up to score ties, scores within 1e-3).
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fast_plaid_tpu import search as jsearch
from fast_plaid_tpu import serving as jserving
from fast_plaid_tpu_torch.search import FastPlaid
from fast_plaid_tpu_torch.serving import MicroBatcher, SearchServer, make_server
from fast_plaid_tpu_torch.testing import random_documents, random_queries

torch.set_num_threads(2)

DIM = 32
TIE_TOL = 1e-3


class TestMicroBatcher:
    def test_coalesces_concurrent_requests(self):
        calls = []

        def fake_search(queries, subsets, key):
            calls.append(len(queries))
            return [[(i, 1.0)] for i in range(len(queries))]

        mb = MicroBatcher(fake_search, max_batch=64, max_wait_ms=30)
        try:
            futs = [mb.submit([np.zeros((2, DIM))], ("k",)) for _ in range(10)]
            outs = [f.result(timeout=10) for f in futs]
        finally:
            mb.close()
        assert all(len(o) == 1 for o in outs)
        assert len(calls) < 10
        assert sum(calls) == 10
        snap = mb.stats.snapshot()
        assert snap["requests"] == 10 and snap["merged_batches"] >= 1

    def test_groups_by_params(self):
        keys_seen = []

        def fake_search(queries, subsets, key):
            keys_seen.append(key)
            return [[] for _ in queries]

        mb = MicroBatcher(fake_search, max_batch=8, max_wait_ms=10)
        try:
            fa = mb.submit([np.zeros((1, DIM))], ("a",))
            fb = mb.submit([np.zeros((1, DIM))], ("b",))
            fa.result(timeout=10), fb.result(timeout=10)
        finally:
            mb.close()
        assert set(keys_seen) == {("a",), ("b",)}

    def test_errors_propagate(self):
        def boom(queries, subsets, key):
            msg = "kaboom"
            raise ValueError(msg)

        mb = MicroBatcher(boom, max_batch=8, max_wait_ms=1)
        try:
            fut = mb.submit([np.zeros((1, DIM))], ("k",))
            with pytest.raises(ValueError, match="kaboom"):
                fut.result(timeout=10)
        finally:
            mb.close()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "idx")
    rng = np.random.default_rng(0)
    docs = random_documents(rng, 80, 12, DIM, variable=True)
    FastPlaid(index=path, device="cpu").create(documents_embeddings=docs)
    httpd, core = make_server(path, port=0, device="cpu", max_wait_ms=5)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, docs
    httpd.shutdown()
    core.close()


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _b64(q):
    return {"queries_b64": base64.b64encode(q.astype(np.float32).tobytes()).decode(),
            "shape": list(q.shape)}


class TestHTTP:
    def test_health(self, server):
        base, docs = server
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok"
        assert h["n_docs"] == len(docs)
        assert h["devices"] == ["cpu"]

    def test_search_json_and_b64_match_engine(self, server):
        base, docs = server
        rng = np.random.default_rng(1)
        q = np.asarray(random_queries(rng, 3, 5, DIM))
        out = _post(base, "/v1/search", {"queries": q.tolist(), "top_k": 4})
        rows = out["results"]
        assert len(rows) == 3 and all(len(r) == 4 for r in rows)
        out2 = _post(base, "/v1/search", {**_b64(q), "top_k": 4})
        assert out2["results"] == rows
        probe = docs[7][:5]
        out3 = _post(base, "/v1/search", {"queries": [probe.tolist()], "top_k": 3})
        assert out3["results"][0][0]["id"] == 7

    def test_subset_and_errors(self, server):
        base, docs = server
        rng = np.random.default_rng(2)
        q = np.asarray(random_queries(rng, 2, 4, DIM))
        out = _post(
            base,
            "/v1/search",
            {"queries": q.tolist(), "top_k": 3, "subset": [[1, 2, 3], [4, 5]]},
        )
        ids0 = {hit["id"] for hit in out["results"][0]}
        ids1 = {hit["id"] for hit in out["results"][1]}
        assert ids0 <= {1, 2, 3} and ids1 <= {4, 5}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/search", {"top_k": 3})
        assert ei.value.code == 400

    def test_concurrent_requests_batch(self, server):
        base, docs = server
        rng = np.random.default_rng(3)
        qs = [np.asarray(random_queries(rng, 1, 4, DIM)) for _ in range(12)]
        results = [None] * 12

        def hit(i):
            results[i] = _post(base, "/v1/search", {"queries": qs[i].tolist(), "top_k": 2})

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in results)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["batcher"]["dispatches"] < h["batcher"]["requests"]

    def test_update_delete_lifecycle(self, server):
        base, docs = server
        rng = np.random.default_rng(4)
        new = rng.standard_normal((2, 10, DIM)).astype(np.float32)
        flat = np.concatenate([new[0], new[1]])
        out = _post(
            base,
            "/v1/update",
            {
                "documents_b64": base64.b64encode(flat.tobytes()).decode(),
                "dim": DIM,
                "lengths": [10, 10],
            },
        )
        assert out["added"] == 2
        n_after = out["n_docs"]
        out2 = _post(base, "/v1/delete", {"subset": [0]})
        assert out2["n_docs"] == n_after - 1


class TestLanesAndMetrics:
    def test_interactive_lane_preempts_batch_lane(self):
        order = []
        gate = threading.Event()

        def slow_search(queries, subsets, key):
            order.append(key[0])
            if key[0] == "first":
                gate.wait(timeout=10)
            return [[] for _ in queries]

        mb = MicroBatcher(slow_search, max_batch=8, max_wait_ms=1)
        try:
            f0 = mb.submit([np.zeros((1, DIM))], ("first",))
            time.sleep(0.05)
            fb = [mb.submit([np.zeros((1, DIM))], ("bulk", i), lane=1) for i in range(3)]
            fi = mb.submit([np.zeros((1, DIM))], ("urgent",), lane=0)
            gate.set()
            fi.result(timeout=10)
            for f in fb:
                f.result(timeout=10)
            f0.result(timeout=10)
        finally:
            mb.close()
        assert order[1] == "urgent"
        snap = mb.stats.snapshot()
        assert snap["lane_requests"]["interactive"] == 2
        assert snap["lane_requests"]["batch"] == 3

    def test_latency_histogram_counts(self):
        def ok(queries, subsets, key):
            return [[] for _ in queries]

        mb = MicroBatcher(ok, max_batch=8, max_wait_ms=1)
        try:
            futs = [mb.submit([np.zeros((1, DIM))], ("k",)) for _ in range(5)]
            for f in futs:
                f.result(timeout=10)
        finally:
            mb.close()
        text = mb.stats.prometheus()
        assert "fastplaid_requests_total 5" in text
        assert 'le="+Inf"} 5' in text
        assert mb.stats.snapshot()["avg_latency_ms"] >= 0

    def test_http_metrics_and_priority(self, server):
        base, docs = server
        rng = np.random.default_rng(9)
        q = np.asarray(random_queries(rng, 1, 4, DIM))
        _post(base, "/v1/search", {"queries": q.tolist(), "top_k": 2, "priority": "batch"})
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert "fastplaid_request_latency_seconds_bucket" in text
        assert 'fastplaid_lane_requests_total{lane="batch"}' in text


def test_server_defaults_to_the_card(tmp_path):
    """device=None means every CUDA device; without one the server raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "idx")
    docs = random_documents(np.random.default_rng(0), 20, 8, DIM)
    FastPlaid(index=path, device="cpu").create(documents_embeddings=docs)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchServer(path)


def _same_rows(a, b):
    """Per query: scores within TIE_TOL rank by rank; an id only one side
    returns ties that side's last score."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        sa = [h["score"] for h in ra]
        sb = [h["score"] for h in rb]
        np.testing.assert_allclose(sa, sb, rtol=0, atol=TIE_TOL)
        ia, ib = [h["id"] for h in ra], [h["id"] for h in rb]
        for ids, sc, other in ((ia, sa, ib), (ib, sb, ia)):
            for j, pid in enumerate(ids):
                if pid not in other:
                    assert abs(sc[j] - sc[-1]) <= TIE_TOL


def test_jax_and_port_servers_answer_alike(tmp_path):
    path = str(tmp_path / "idx")
    rng = np.random.default_rng(6)
    docs = random_documents(rng, 120, 16, DIM, variable=True)
    jsearch.FastPlaid(index=path, device="cpu").create(documents_embeddings=docs)
    servers = []
    try:
        for make in (jserving.make_server, make_server):
            httpd, core = make(path, port=0, device="cpu", max_wait_ms=5)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers.append((httpd, core, f"http://127.0.0.1:{httpd.server_address[1]}"))
        q = np.concatenate([random_queries(rng, 5, 6, DIM),
                            np.stack([docs[i][:6] for i in (3, 50, 119)])])
        subset = [[1, 2, 3, 50]] * 4 + [list(range(60))] * 4
        payloads = [{"queries": q.tolist(), "top_k": 5}, {**_b64(q), "top_k": 5},
                    {"queries": q.tolist(), "top_k": 3, "subset": subset}]
        outs = [[_post(base, "/v1/search", p)["results"] for _, _, base in servers]
                for p in payloads]
        for jax_out, port_out in outs:
            _same_rows(port_out, jax_out)
        assert [r[0]["id"] for r in outs[0][1][-3:]] == [3, 50, 119]
        assert outs[1][1] == outs[0][1]  # b64 and JSON alike
        assert all({h["id"] for h in r} <= {1, 2, 3, 50} for r in outs[2][1][:4])
        for _, _, base in servers:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                assert json.loads(r.read())["n_docs"] == len(docs)
    finally:
        for httpd, core, _ in servers:
            httpd.shutdown()
            core.close()
