"""The traced run's record: a profiler trace of a stretch of timed calls, and
the work of each kernel launch, counted by wrappers installed around the
program's kernel entry points from here (the program is not edited).

``Tracer.record()`` is what every per-layer reader (``metrics/<name>.py``)
reads: the calls' host spans, the device operations, the host operations,
the launches' work and the host row gathers' seconds, all on the profiler's
clock in microseconds.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from perfbench import work

__all__ = ["Tracer", "CALL_SPAN", "KERNELS", "breakdown", "busy_intervals", "roofline_share"]

CALL_SPAN = "perfbench.search"
GATHER_SPAN = "native.gather_windows_u8 (host row gather)"
# The program's four CUDA kernels, by symbol name, and the work wrapper that
# counts their launches.
KERNELS = {
    "estimate": ("estimate_kernel",),
    "q4": ("maxsim_q4_gather_kernel",),
    "rerank": ("maxsim_dedup_kernel", "maxsim_gather_kernel"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
GAPS_NAMED = 400  # the longest idle gaps, each named by its host operation


class Tracer:
    """Wraps the engine's kernel entry points and the native host gather
    while ``active``, and profiles the calls between ``start`` and ``stop``."""

    def __init__(self):
        from fast_plaid_tpu_torch import native
        from fast_plaid_tpu_torch.search import engine

        self._engine, self._native = engine, native
        self.launches: dict[str, list] = {"estimate": [], "q4": [], "rerank": []}
        self.gather_s: list[tuple[float, float]] = []  # (perf_counter start, seconds)
        self.call_t0: list[float] = []  # perf_counter start of each traced call
        self._saved: dict = {}
        self._prof = None
        self._trace: dict | None = None

    def _wrap(self):
        eng, nat = self._engine, self._native
        est, q4 = eng.segmented_estimate, eng.maxsim_q4_gather_scores
        dd, k2, gw = eng.maxsim_gather_scores_dedup, eng.maxsim_gather_scores, nat.gather_windows_u8
        self._saved = {"segmented_estimate": est, "maxsim_q4_gather_scores": q4,
                       "maxsim_gather_scores_dedup": dd, "maxsim_gather_scores": k2}
        self._saved_native = gw
        launches, gather_s = self.launches, self.gather_s

        def w_est(pid_s, own_s, cell_scores, *a, **kw):
            launches["estimate"].append(("estimate", pid_s, own_s, cell_scores))
            return est(pid_s, own_s, cell_scores, *a, **kw)

        def w_q4(emb_q4, q4_scale, pids, lens, queries, *a, **kw):
            launches["q4"].append(("q4", pids, lens, queries, q4_scale.shape[0],
                                   2 * (emb_q4.shape[0] // q4_scale.shape[0]), emb_q4.shape[1]))
            return q4(emb_q4, q4_scale, pids, lens, queries, *a, **kw)

        def rerank(fn):
            def wrapped(emb, pids, lens, queries, *a, **kw):
                launches["rerank"].append(("rerank", pids, lens, queries, emb.shape[0], emb.shape[1], emb.shape[2]))
                return fn(emb, pids, lens, queries, *a, **kw)
            return wrapped

        def w_gather(*a, **kw):
            t0 = time.perf_counter()
            out = gw(*a, **kw)
            gather_s.append((t0, time.perf_counter() - t0))
            return out

        # The native module counts its calls on the name it looks up itself.
        w_gather.calls = gw.calls
        eng.segmented_estimate, eng.maxsim_q4_gather_scores = w_est, w_q4
        eng.maxsim_gather_scores_dedup, eng.maxsim_gather_scores = rerank(dd), rerank(k2)
        nat.gather_windows_u8 = w_gather

    def _unwrap(self):
        for name, fn in self._saved.items():
            setattr(self._engine, name, fn)
        self._saved_native.calls = self._native.gather_windows_u8.calls
        self._native.gather_windows_u8 = self._saved_native

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._wrap()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._unwrap()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self._trace = json.load(f)
        finally:
            os.remove(path)
        self._prof = None

    def record(self) -> dict:
        """The traced stretch, reduced to plain lists (microseconds)."""
        events = [e for e in self._trace.get("traceEvents", []) if e.get("ph") == "X"]
        calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("cat") == "user_annotation" and e.get("name") == CALL_SPAN)
        device = sorted((e["name"], float(e["ts"]), float(e["dur"]), e.get("cat"))
                        for e in events if e.get("cat") in DEVICE_CATS)
        host = [(e["name"], float(e["ts"]), float(e["dur"]))
                for e in events if e.get("cat") in HOST_CATS and e.get("name") != CALL_SPAN]
        # The gathers run on a worker thread that the profiler does not
        # follow: place them on its clock by the calls' offset from perf_counter.
        if calls and self.call_t0:
            off = float(np.median([c[0] - t * 1e6 for c, t in zip(calls, self.call_t0)]))
            host += [(GATHER_SPAN, t * 1e6 + off, d * 1e6) for t, d in self.gather_s]
        launches = {k: [_work(item) for item in v] for k, v in self.launches.items()}
        self.launches = {k: [] for k in self.launches}  # free the held inputs
        return {"calls": calls, "device_ops": device, "host_ops": host, "launches": launches,
                "gather_s": [d for _, d in self.gather_s], "kernels": KERNELS}


def _work(item) -> dict:
    if item[0] == "estimate":
        return work.estimate_work(*item[1:])
    if item[0] == "q4":
        _, pids, lens, queries, n_docs, cap, d = item
        return work.rerank_work(pids, lens, queries, n_docs, cap, d, q4_half=cap // 2)
    _, pids, lens, queries, n_docs, cap, d = item
    return work.rerank_work(pids, lens, queries, n_docs, cap, d)


def busy_intervals(rec: dict) -> list[tuple[float, float]]:
    """Merged [start, end] intervals in which a device operation ran, inside
    the traced calls' span."""
    if not rec["calls"]:
        return []
    lo, hi = rec["calls"][0][0], rec["calls"][-1][1]
    spans = sorted((max(ts, lo), min(ts + dur, hi)) for _, ts, dur, _ in rec["device_ops"]
                   if ts + dur > lo and ts < hi)
    merged: list[list[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    (the ``GAPS_NAMED`` longest), named by the innermost host operation at
    their middle and summed by name (seconds)."""
    by_op: dict[str, float] = {}
    for name, _, dur, _ in rec["device_ops"]:
        by_op[name[:160]] = by_op.get(name[:160], 0.0) + dur * 1e-6
    busy = busy_intervals(rec)
    gaps: dict[str, float] = {}
    if busy:
        edges = [rec["calls"][0][0], *[x for iv in busy for x in iv], rec["calls"][-1][1]]
        idle = sorted(((e - s, s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s), reverse=True)
        names = [name for name, _, _ in rec["host_ops"]]
        ts = np.array([t for _, t, _ in rec["host_ops"]], dtype=np.float64)
        dur = np.array([d for _, _, d in rec["host_ops"]], dtype=np.float64)
        for length, s, e in idle[:GAPS_NAMED]:
            mid = (s + e) / 2
            hit = np.nonzero((ts <= mid) & (ts + dur >= mid))[0]
            name = names[hit[np.argmin(dur[hit])]][:160] if hit.size else "host: Python, no torch operation"
            gaps[name] = gaps.get(name, 0.0) + length * 1e-6
    return {
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top],
    }


def roofline_share(rec: dict, kind: str) -> float | None:
    """Least time of the ``kind`` launches' work over the device time of the
    kernels of that kind (%); None where no such kernel ran."""
    names = rec["kernels"][kind]
    kernel_us = sum(dur for name, _, dur, cat in rec["device_ops"]
                    if cat == "kernel" and any(k in name for k in names))
    if kernel_us <= 0 or not rec["launches"][kind]:
        return None
    return 100.0 * sum(w["bound_ms"] for w in rec["launches"][kind]) * 1e3 / kernel_us
