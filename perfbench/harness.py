"""One run of one cell: build the inputs, create and open the index through
the public API, drive ``FastPlaid.search`` for a window, judge the answers
against the plain reference, and make the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives: ``configs/<config>.json``, ``mixes/<traffic>.json`` and
``metrics/<metric>.py`` (a ``read(record)`` over the traced run's record).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

__all__ = ["HERE", "load_spec", "cell_files", "metric_reader", "end_to_end_of", "per_layer_of",
           "forbidden_modules", "run_cell", "result_line", "log"]

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_plaid_tpu")


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(spec: dict, workload: str, bench_dir: Path = HERE):
    """(cell, configuration entry, configuration file, mix file) of a cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        msg = f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}"
        raise SystemExit(msg)
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(bench_dir.parent / entry["file"]) as f:
        cfg = json.load(f)
    with open(bench_dir / "mixes" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, entry, cfg, mix


def end_to_end_of(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(spec: dict, cell: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def metric_reader(name: str, bench_dir: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``fast_plaid_tpu_torch`` is not ``fast_plaid_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_info() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20, check=False)
        return {"nvidia_smi": out.stdout.strip()}
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"nvidia_smi": f"unavailable: {exc}"}


class Reservoir:
    """A uniform sample of ``m`` of the window's calls, drawn from the seed."""

    def __init__(self, m: int, seed: int):
        self.m, self.items, self.seen = m, [], 0
        self.rng = np.random.default_rng([seed, 0x5A3B])

    def offer(self, item) -> None:
        if self.seen < self.m:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.m:
                self.items[j] = item
        self.seen += 1


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device=None, ctor_overrides: dict | None = None, spec: dict | None = None,
             bench_dir: Path = HERE, break_path=None) -> dict:
    """Run one cell once and return the result (``result_line`` prints it).

    ``device``/``ctor_overrides`` let the CPU tests drive the same steps with
    the program's plain paths; ``break_path`` lets them break the timed path.
    """
    import torch

    from fast_plaid_tpu_torch.search import FastPlaid
    from fast_plaid_tpu_torch.search import searcher

    from perfbench import corpus, judge
    from perfbench import tracing as tr

    spec = load_spec(bench_dir.parent) if spec is None else spec
    _, _, cfg, mix = cell_files(spec, workload, bench_dir)
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_gpu = device.type == "cuda"
    s = mix["search"]
    q_per_call, pool_n = int(mix["queries_per_call"]), int(mix["query_pool"])

    # 1. inputs from the seed, on the device; the API takes numpy.
    data = corpus.generate(cfg, pool_n, seed, device)
    lengths = data.lengths.cpu().numpy()
    flat = data.tokens.cpu().numpy()
    pool = data.queries.cpu().numpy()
    del data
    docs = np.split(flat, np.cumsum(lengths)[:-1])

    index_dir = tempfile.mkdtemp(prefix="perfbench-index-")
    try:
        # 2-3. create through the public API, opened as the configuration says.
        ctor = dict(cfg["instance"])
        ctor.update(ctor_overrides or {})
        fp = FastPlaid(index_dir, **ctor)
        fp.create(documents_embeddings=docs, **cfg["create"])
        del docs
        # A served index was written long ago: flush the new files now, so
        # that their writeback does not land in the window.
        os.sync()
        kw = {"top_k": s["top_k"], "n_ivf_probe": s["n_ivf_probe"], "n_full_scores": s["n_full_scores"],
              "approx_mode": s["approx_mode"], "show_progress": False}
        n_batches = pool_n // q_per_call
        batches = [pool[i * q_per_call : (i + 1) * q_per_call] for i in range(n_batches)]
        search = fp.search if break_path is None else break_path(fp.search)

        def call(i):
            out = search(batches[i % n_batches], **kw)
            if on_gpu:
                torch.cuda.synchronize()
            return out

        for i in range(int(mix["warmup_calls"])):
            call(i)
        gc.collect()
        if on_gpu:
            torch.cuda.reset_peak_memory_stats(device)

        # 4. the window: one client in a closed loop.
        tracer = tr.Tracer() if trace else None
        traced = range(int(mix["traced_from"]), int(mix["traced_from"]) + int(mix["traced_calls"]))
        sample = Reservoir(int(mix["judged_calls"]), seed)
        lat, attempted, failed, errors = [], 0, 0, []
        launches0 = _launch_counts()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        deadline = t_window + seconds
        i = 0
        while True:
            if tracer is not None and i == traced.start:
                tracer.start()
            t0 = time.perf_counter()
            try:
                if tracer is not None and i in traced:
                    tracer.call_t0.append(t0)
                    with torch.profiler.record_function(tr.CALL_SPAN):
                        res = call(i)
                else:
                    res = call(i)
            except Exception as exc:  # noqa: BLE001 - a failed call is counted, not fatal
                res = [[] for _ in range(q_per_call)]
                errors.append(repr(exc)[:300])
            t1 = time.perf_counter()
            if tracer is not None and i == traced.stop - 1:
                tracer.stop()
            lat.append(t1 - t0)
            attempted += q_per_call
            failed += sum(len(r) != s["top_k"] for r in res)
            sample.offer((i % n_batches, res))
            del res
            i += 1
            if t1 >= deadline and (tracer is None or i >= traced.stop):
                break
        t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
        info = {
            "calls": i, "errors": errors[:3], "launches": _diff(launches0, _launch_counts()),
            "last_search_stats": searcher.last_search_stats(), **_index_info(fp),
        }
        fp.close()
        del fp
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()

        # 5. judge the sampled calls against the plain reference.
        t_ref = time.perf_counter()
        tokens = torch.from_numpy(flat).to(device)
        side = judge.read_index(index_dir, device)
        mem_budget = (torch.cuda.get_device_properties(device).total_memory // 8
                      if on_gpu else 256 * 1024 * 1024)
        calls = [(batches[b], res) for b, res in sample.items]
        numbers = judge.judge(tokens, lengths, side, calls, cfg=cfg, mix=mix,
                              mem_budget=mem_budget, wire=np.float16 if on_gpu else np.float32)
        info["reference_s"] = time.perf_counter() - t_ref
        info["reference"] = {k: numbers.pop(k) for k in [k for k in numbers if k.startswith("_")]}
    finally:
        shutil.rmtree(index_dir, ignore_errors=True)

    limits = cfg["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    window_s = t_end - t_window
    answered = attempted - failed
    e2e = {
        "qps": (answered / window_s, "queries/s"),
        "p95_ms": (float(np.percentile(np.array(lat) * 1e3, 95)), "ms"),
        "peak_gb": (peak / 1e9, "GB"),
        "setup_s": (setup_s, "s"),
    }
    info["window_s"] = window_s
    info["p50_ms"] = float(np.percentile(np.array(lat) * 1e3, 50))
    info["lat_ms"] = [round(x * 1e3, 2) for x in lat]
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        rec = tracer.record()
        metrics = {}
        for m in per_layer_of(spec, workload):
            value = metric_reader(m["name"], bench_dir)(rec)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = sum(e - s_ for s_, e in tr.busy_intervals(rec)) * 1e-6
        span = (rec["calls"][-1][1] - rec["calls"][0][0]) * 1e-6 if rec["calls"] else 0.0
        result["metrics"] = metrics
        result["device"] = _device(on_gpu, peak, busy_s=busy, window_s=span)
        result["breakdown"] = tr.breakdown(rec)
        info["traced_calls"] = len(rec["calls"])
    else:
        wanted = {m["name"]: m for m in end_to_end_of(spec, workload)}
        result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in e2e.items() if k in wanted}
        result["device"] = _device(on_gpu, peak)
    info["e2e"] = {k: v for k, (v, _) in e2e.items()}
    if on_gpu:
        info.update(_card_info())
    result["checks"] = checks
    result["_info"] = info
    return result


def _device(on_gpu: bool, peak: int, **extra) -> dict:
    import torch

    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    return {"platform": "gpu" if on_gpu else "cpu", "kind": kind, "count": 1,
            "memory_peak_bytes": int(peak), **extra}


def _launch_counts() -> dict:
    from fast_plaid_tpu_torch import native
    from fast_plaid_tpu_torch.ops import estimate_kernel, rerank_dedup, rerank_kernel

    fns = {"segmented_estimate": estimate_kernel.segmented_estimate,
           "maxsim_q4_gather_scores": rerank_kernel.maxsim_q4_gather_scores,
           "maxsim_gather_scores": rerank_kernel.maxsim_gather_scores,
           "maxsim_gather_scores_dedup": rerank_dedup.maxsim_gather_scores_dedup}
    out = {k: int(getattr(f, "launches", 0)) for k, f in fns.items()}
    out["gather_windows_u8"] = int(getattr(native.gather_windows_u8, "calls", 0))
    return out


def _diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b}


def _index_info(fp) -> dict:
    loaded = next(iter(fp.indices.values()))
    dev = loaded.dev
    return {
        "n_partitions": loaded.ispec.n_partitions, "doc_cap": loaded.ispec.doc_cap,
        "n_docs": loaded.ispec.n_docs, "low_memory": loaded.low_memory,
        "cache": "bf16" if dev.emb_cache is not None else ("q4" if dev.emb_q4 is not None else "none"),
        "buckets": list(loaded.ispec.bucket_caps),
    }


def result_line(result: dict) -> str:
    """The contract's last line: ``checks`` (each number compared beside its
    limit) comes last."""
    keys = ["correct", "attempted", "failed", "metrics", "device", "breakdown"]
    out = {k: result[k] for k in keys if k in result}
    out["checks"] = result["checks"]
    return json.dumps(out)

