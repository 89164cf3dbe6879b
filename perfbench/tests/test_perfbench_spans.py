"""The readers of the program's spans (``perfbench/spans.py`` and the metric
files that use it) on small synthetic records of two traced calls."""

import copy

import pytest
from conftest import BENCH

from perfbench import harness, spans

NEW = ["prep_ms.batch", "emit_ms.batch", "gather_wait_ms.batch", "probe_ms.batch", "cands_ms.batch"]
OLD = ["api_ms.batch", "gather_ms.batch", "torch_ms.batch", "roofline.estimate.batch",
       "roofline.q4.batch", "roofline.rerank.batch", "idle.batch"]


def _call(t: float) -> tuple[list, list]:
    """One call at ``t`` us: (host ops, device ops). Prepare 100, plan 300,
    upload 50; probe launches two kernels (10 + 20 us of device time),
    candidates one (30), prune one (5), rerank one (40, the q4 kernel); a
    gather wait of 500; emit 200 of which the wait is 150."""
    host = [
        ("search", t, 2000.0),
        ("search.prepare", t + 10, 100.0),
        ("search.plan", t + 120, 300.0),
        ("search.upload", t + 430, 50.0),
        ("engine.probe", t + 500, 100.0),
        ("cudaLaunchKernel", t + 510, 5.0),
        ("cudaLaunchKernel", t + 540, 5.0),
        ("aten::mm", t + 505, 60.0),
        ("engine.candidates", t + 610, 100.0),
        ("cudaLaunchKernel", t + 620, 5.0),
        ("engine.prune", t + 720, 50.0),
        ("cuLaunchKernelEx", t + 730, 5.0),
        ("search.gather_wait", t + 780, 500.0),
        ("native.gather_windows_u8 (host row gather)", t + 700, 580.0),
        ("engine.rerank", t + 1290, 100.0),
        ("cudaLaunchKernel", t + 1300, 5.0),
        ("search.emit", t + 1400, 200.0),
        ("search.emit.wait", t + 1410, 150.0),
        ("cudaMemcpyAsync", t + 1420, 140.0),
    ]
    device = [
        ("sgemm", t + 515, 10.0, "kernel"),
        ("topk", t + 545, 20.0, "kernel"),
        ("gather", t + 625, 30.0, "kernel"),
        ("sort", t + 735, 5.0, "kernel"),
        ("maxsim_q4_gather_kernel<4>", t + 1305, 40.0, "kernel"),
        ("Memcpy DtoH", t + 1500, 8.0, "gpu_memcpy"),
    ]
    return host, device


def _record() -> dict:
    host, device = [], []
    for t in (0.0, 2000.0):
        h, d = _call(t)
        host += h
        device += d
    return {"calls": [(0.0, 2000.0), (2000.0, 4000.0)], "host_ops": host,
            "device_ops": sorted(device, key=lambda x: x[1]), "gather_s": [0.0005, 0.0006],
            "launches": {"estimate": [], "q4": [], "rerank": []},
            "kernels": {"estimate": ("estimate_kernel",), "q4": ("maxsim_q4_gather_kernel",),
                        "rerank": ("maxsim_dedup_kernel", "maxsim_gather_kernel")}}


def _read(name, rec):
    return harness.metric_reader(name, BENCH)(rec)


def test_new_readers_on_a_known_record():
    rec = _record()
    assert _read("prep_ms.batch", rec) == pytest.approx(0.4)
    assert _read("emit_ms.batch", rec) == pytest.approx(0.05)
    assert _read("gather_wait_ms.batch", rec) == pytest.approx(0.5)
    assert _read("probe_ms.batch", rec) == pytest.approx(0.03)
    assert _read("cands_ms.batch", rec) == pytest.approx(0.035)


def test_new_readers_find_nothing_without_the_program_spans():
    """The parent's program has no spans: each new reader returns None."""
    rec = _record()
    rec["host_ops"] = [h for h in rec["host_ops"] if not spans.is_program_span(h[0])]
    assert [_read(n, rec) for n in NEW] == [None] * len(NEW)


def test_launch_span_and_pairing_agree():
    rec = _record()
    paired = spans.device_ms_by_span(rec)
    rec["launch_span"] = []
    for t in (0.0, 2000.0):
        for name, ts, dur, cat in _call(t)[1]:
            where = {515: "engine.probe", 545: "engine.probe", 625: "engine.candidates",
                     735: "engine.prune", 1305: "engine.rerank", 1500: "search.emit.wait"}[int(ts - t)]
            rec["launch_span"].append([name, ts, dur, cat, where])
    by_launch = spans.device_ms_by_span(rec)
    assert paired == by_launch
    assert by_launch[0] == pytest.approx({"engine.probe": 0.06, "engine.candidates": 0.06,
                                          "engine.prune": 0.01, "engine.rerank": 0.08})


def test_a_call_with_a_lost_launch_is_left_out():
    rec = _record()
    rec["host_ops"] = [h for h in rec["host_ops"] if not (h[0] == "cudaLaunchKernel" and h[1] == 2510)]
    by_span, used = spans.device_ms_by_span(rec)
    assert used == 1 and by_span["engine.probe"] == pytest.approx(0.03)
    assert _read("probe_ms.batch", rec) == pytest.approx(0.03)


def test_old_readers_ignore_the_new_keys():
    rec = _record()
    before = {n: _read(n, rec) for n in OLD}
    more = copy.deepcopy(rec)
    more["spans"] = [("search", 0.0, 2000.0, 1, 1, 0, 1)]
    more["counters"] = {"search.tiles": 1.0}
    more["launch_span"] = [["sgemm", 515.0, 10.0, "kernel", "engine.probe"]]
    assert {n: _read(n, more) for n in OLD} == before
    assert before["api_ms.batch"] is not None and before["torch_ms.batch"] is not None
