"""The program's own spans and counters in the traced run.

``fast_plaid_tpu_torch.utils.tracing`` marks the layers of a search with
spans (``search.prepare``, ``engine.probe``, ...). Under the profiler, the
spans of the calling thread are ``user_annotation`` events of the trace,
so they are among a record's ``host_ops`` (``perfbench/tracing.py``).
The readers here find them there:

- ``span_ms``: host time of the spans of some names, a traced call;
- ``device_ms_by_span``: device time of the kernels, summed by the
  innermost program span around their launch. From a record's
  ``launch_span`` where it has one; otherwise each call's kernel launches
  (runtime events) are paired in order with its kernels, which run on one
  stream in launch order, and a call whose counts differ is left out.

``SpanTracer`` is the harness's ``Tracer`` with the program's recorder on:
its record adds ``spans`` (the recorder's spans on the trace's clock),
``counters`` (a search call's mean of each counter) and ``launch_span``
(each device operation with the innermost program span around its launch,
joined by the trace's ``correlation``). Run as a script, it drives one cell
with it and writes what the program's spans show::

    python3 perfbench/spans.py --workload fiqa.batch --seed 7 --seconds 30 \\
        --trace 1 --recorder 1 --out chiprun_out/spans_fiqa.json

``--recorder 0 --trace 0`` is the driver's untraced run; ``--recorder 1
--trace 0`` the same with the recorder on (its cost).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import tracing as tr  # noqa: E402

__all__ = ["PREFIXES", "is_program_span", "span_ms", "device_ms_by_span", "SpanTracer"]

PREFIXES = ("search", "engine.", "create", "open", "kernels.")
LAUNCH = ("LaunchKernel", "LaunchCooperativeKernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


def is_program_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def span_ms(rec: dict, names, minus=()) -> float | None:
    """Host ms a traced call in the program spans named ``names``, less those
    named ``minus``; None where no span of ``names`` was traced."""
    if not rec["calls"]:
        return None
    lo, hi = rec["calls"][0][0], rec["calls"][-1][1]
    total, seen = 0.0, False
    for name, ts, dur in rec["host_ops"]:
        if lo <= ts <= hi and (name in names or name in minus):
            seen |= name in names
            total += dur if name in names else -dur
    return total / len(rec["calls"]) / 1e3 if seen else None


def _innermost(spans, t: float):
    """Name of the shortest (start, end, name) span holding ``t``."""
    best, best_len = None, float("inf")
    for s, e, name in spans:
        if s <= t <= e and e - s < best_len:
            best, best_len = name, e - s
    return best


def device_ms_by_span(rec: dict) -> tuple[dict, int] | None:
    """({span name or None: kernel device ms}, calls counted); the sums are
    over the calls counted. None where no call could be attributed."""
    if not rec["calls"]:
        return None
    if "launch_span" in rec:
        out: dict = {}
        for _, _, dur, cat, name in rec["launch_span"]:
            if cat == "kernel":
                out[name] = out.get(name, 0.0) + dur / 1e3
        return (out, len(rec["calls"])) if out else None
    spans = sorted((ts, ts + dur, name) for name, ts, dur in rec["host_ops"] if is_program_span(name))
    launches = sorted(ts for name, ts, _ in rec["host_ops"] if any(k in name for k in LAUNCH))
    kernels = sorted((ts, dur) for _, ts, dur, cat in rec["device_ops"] if cat == "kernel")
    l_ts = np.array(launches, dtype=np.float64)
    k_ts = np.array([t for t, _ in kernels], dtype=np.float64)
    out, used = {}, 0
    for lo, hi in rec["calls"]:
        li = np.searchsorted(l_ts, [lo, hi], side="left")
        ki = np.searchsorted(k_ts, [lo, hi], side="left")
        if li[1] - li[0] != ki[1] - ki[0] or li[1] == li[0]:
            continue
        inside = [s for s in spans if s[1] >= lo and s[0] <= hi]
        for t, (_, dur) in zip(l_ts[li[0]:li[1]], kernels[ki[0]:ki[1]]):
            name = _innermost(inside, t)
            out[name] = out.get(name, 0.0) + dur / 1e3
        used += 1
    return (out, used) if used else None


def device_ms(rec: dict, names) -> float | None:
    """Kernel device ms a call launched inside the spans named ``names``."""
    got = device_ms_by_span(rec)
    if got is None:
        return None
    by_span, n = got
    if not any(k in by_span for k in names):
        return None
    return sum(v for k, v in by_span.items() if k in names) / n


class SpanTracer(tr.Tracer):
    """``Tracer`` with the program's recorder on from its construction (or
    from earlier, where the caller enabled it) to ``stop``; with
    ``recorder`` False, the same record from the profiler alone (no
    ``spans``, no ``counters``)."""

    recorder = True
    last: dict | None = None  # the latest record and its trace's events,
    last_events: list | None = None  # for the script below

    def __init__(self):
        super().__init__()
        from fast_plaid_tpu_torch.utils import tracing as program

        self._program = program
        if self.recorder and not program.enabled():
            program.enable()
        self._drained: dict | None = None

    def stop(self) -> None:
        super().stop()
        if self.recorder:
            self._drained = self._program.drain()
            self._program.disable()

    def record(self) -> dict:
        events = [e for e in self._trace.get("traceEvents", []) if e.get("ph") == "X"]
        base = int(self._trace.get("baseTimeNanoseconds", 0))
        rec = super().record()
        drained = self._drained or {"spans": [], "counters": {}, "clock": (0, 0)}
        spans = [(s["name"], self._program.trace_us(s["start_ns"], base, drained["clock"]),
                  (s["end_ns"] - s["start_ns"]) / 1e3, s["thread"], s["id"], s["parent"], s["call"])
                 for s in drained["spans"]]
        roots = {s[4]: s[0] for s in spans if s[5] == 0}
        lo, hi = (rec["calls"][0][0], rec["calls"][-1][1]) if rec["calls"] else (0.0, 0.0)
        rec["spans"] = [s for s in spans if roots.get(s[6]) in ("create", "open") or lo <= s[1] <= hi]
        n_calls = sum(1 for name in roots.values() if name == "search")
        rec["counters"] = {k: v / n_calls for k, v in drained["counters"].items()} if n_calls else {}
        rec["launch_span"] = _launch_spans(events, lo, hi)
        SpanTracer.last, SpanTracer.last_events = rec, events
        return rec


def _launch_spans(events: list, lo: float, hi: float) -> list:
    """[device op name, ts, dur, cat, innermost program span of its launch]
    for every device operation of the traced calls, by ``correlation``."""
    annots: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and is_program_span(e["name"]):
            annots.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") not in tr.DEVICE_CATS or not lo <= float(e["ts"]) <= hi:
            continue
        src = launch.get(e.get("args", {}).get("correlation"))
        name = _innermost(annots.get(src.get("tid"), []), float(src["ts"])) if src else None
        out.append([e["name"], float(e["ts"]), float(e["dur"]), e.get("cat"), name])
    return out


def sync_calls(events: list, lo: float, hi: float) -> dict:
    """Synchronizing CUDA runtime calls in [lo, hi], by name; the memcpys
    counted are those whose device copy runs device to host."""
    d2h = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")}
    out: dict = {}
    for e in events:
        if e.get("cat") != "cuda_runtime" or not lo <= float(e["ts"]) <= hi:
            continue
        name = e["name"]
        if name in SYNC_CALLS or (name.startswith("cudaMemcpy") and e.get("args", {}).get("correlation") in d2h):
            out[name] = out.get(name, 0) + 1
    return out


def _summary(rec: dict, events: list) -> dict:
    """What the spans show about the traced calls (ms a call)."""
    calls = rec["calls"]
    n = len(calls)
    lo, hi = calls[0][0], calls[-1][1]
    host: dict = {}
    for name, ts, dur, *_ in rec["spans"]:
        if lo <= ts <= hi:
            host[name] = host.get(name, 0.0) + dur / 1e3 / n
    setup = {}
    for name, _, dur, *_ in rec["spans"]:
        if name.startswith(("create", "open", "kernels.")):
            setup[name] = setup.get(name, 0.0) + dur / 1e6
    dev_corr, _ = device_ms_by_span(rec) or ({}, 1)
    paired = device_ms_by_span({k: v for k, v in rec.items() if k != "launch_span"})
    named = [n_ for names in rec["kernels"].values() for n_ in names]
    torch_by_span: dict = {}
    for name, _, dur, cat, span in rec["launch_span"]:
        if cat == "kernel" and not any(k in name for k in named):
            torch_by_span[span] = torch_by_span.get(span, 0.0) + dur / 1e3 / n
    # every idle gap named by the innermost host operation at its middle
    busy = tr.busy_intervals(rec)
    edges = [lo, *[x for iv in busy for x in iv], hi]
    names = [h[0] for h in rec["host_ops"]]
    ts = np.array([h[1] for h in rec["host_ops"]])
    dur = np.array([h[2] for h in rec["host_ops"]])
    gaps: dict = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        hit = np.nonzero((ts <= mid) & (ts + dur >= mid))[0]
        name = names[hit[np.argmin(dur[hit])]][:120] if hit.size else "host: Python, no torch operation"
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e3 / n
    idle = sum(gaps.values())
    api = tr_api_ms(rec)
    ends = sum(host.get(k, 0.0) for k in ("search.prepare", "search.plan", "search.upload", "search.emit"))
    ends -= host.get("search.emit.wait", 0.0)
    syncs = sync_calls(events, lo, hi)
    return {
        "calls": n,
        "host_ms_by_span": dict(sorted(host.items(), key=lambda kv: -kv[1])),
        "device_ms_by_span": {str(k): v / n for k, v in sorted(dev_corr.items(), key=lambda kv: -kv[1])},
        "device_ms_by_span_paired": ({str(k): v / paired[1] for k, v in paired[0].items()}
                                     if paired else None),
        "torch_ms_by_span": {str(k): v for k, v in sorted(torch_by_span.items(), key=lambda kv: -kv[1])},
        "idle_ms_by_name": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:25]),
        "idle_ms": idle,
        "idle_unnamed_share": (gaps.get("host: Python, no torch operation", 0.0) + gaps.get("search", 0.0))
        / idle if idle else None,
        "api_ms": api,
        "ends_ms": ends,
        "sync_calls_per_call": {k: v / n for k, v in syncs.items()},
        "counters_per_call": rec["counters"],
        "setup_s_by_span": setup,
    }


def _by_call(rec: dict) -> list:
    """Each traced call's host ms in its main-thread spans, by name."""
    out = []
    for lo, hi in rec["calls"]:
        row: dict = {}
        for name, ts, dur, *_ in rec["spans"]:
            if lo <= ts <= hi:
                row[name] = round(row.get(name, 0.0) + dur / 1e3, 3)
        out.append(row)
    return out


def tr_api_ms(rec: dict) -> float | None:
    from perfbench.harness import metric_reader

    return metric_reader("api_ms.batch")(rec)


def main() -> int:
    import argparse
    import json
    import time

    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from fast_plaid_tpu_torch.utils import tracing as program
    from perfbench import harness

    import gc

    gc_pauses = {"n": [0, 0, 0], "ms": [0.0, 0.0, 0.0]}
    t_gc = [0.0]

    def on_gc(phase, gcinfo):  # the interpreter's collections, by generation
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            g = gcinfo["generation"]
            gc_pauses["n"][g] += 1
            gc_pauses["ms"][g] += (time.perf_counter() - t_gc[0]) * 1e3

    gc.callbacks.append(on_gc)
    torch.cuda.set_device(0)
    tr.Tracer = SpanTracer
    SpanTracer.recorder = bool(args.recorder)
    if args.recorder:
        program.enable()
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=t_start, spec=harness.load_spec(root))
    info = result.pop("_info")
    out = {"workload": args.workload, "seed": args.seed, "recorder": args.recorder, "trace": args.trace,
           "correct": result["correct"], "e2e": info["e2e"], "card": info.get("nvidia_smi"),
           "metrics": result["metrics"], "breakdown": result.get("breakdown")}
    if args.recorder and not args.trace:
        drained = program.drain()
        calls = sum(1 for s in drained["spans"] if s["name"] == "search" and s["parent"] == 0)
        out["counters_per_call"] = {k: v / calls for k, v in drained["counters"].items()} if calls else {}
    if args.trace and SpanTracer.last is not None:
        rec = SpanTracer.last
        out["spans"] = _summary(rec, SpanTracer.last_events)
        out["spans_by_call"] = _by_call(rec)
    out["gc"] = gc_pauses
    out["lat_ms"] = info.get("lat_ms")
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps({k: out[k] for k in ("workload", "seed", "recorder", "trace", "correct", "e2e")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
