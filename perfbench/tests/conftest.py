"""A tiny copy of the benchmark's tree, for runs of the harness on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = ROOT / "perfbench"
SEED = 4_000_000_123  # more than 32 signed bits, as a run's --seed may be


def tiny_config(route: str) -> dict:
    cfg = json.loads((BENCH / "configs" / "fiqa.json").read_text())
    cfg.update(name=f"tiny_{route}", n_docs=1500, mean_len=24, doc_maxlen=40, n_hubs=8,
               stage6_route=route, instance={"low_memory": route == "q4"})
    return cfg


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    """(spec, bench_dir) of a benchmark with one cell a stage-6 route, at a
    size a CPU runs in seconds; every metric reader is the real one."""
    root = tmp_path_factory.mktemp("bench")
    pb = root / "perfbench"
    shutil.copytree(BENCH / "metrics", pb / "metrics")
    (pb / "configs").mkdir()
    (pb / "mixes").mkdir()
    mix = json.loads((BENCH / "mixes" / "batch.json").read_text())
    mix.update(queries_per_call=16, query_pool=64, warmup_calls=1, judged_calls=2,
               traced_from=0, traced_calls=2)
    mix["search"]["n_full_scores"] = 256
    (pb / "mixes" / "batch.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, cells = [], []
    for route in ("q4", "bf16_cache"):
        cfg = tiny_config(route)
        (pb / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        configs.append(dict(spec["configs"][0], name=cfg["name"], file=f"perfbench/configs/{cfg['name']}.json"))
        cells.append(dict(spec["workloads"][0], name=f"{cfg['name']}.batch", config=cfg["name"]))
    spec["configs"], spec["workloads"] = configs, cells
    for m in spec["per_layer"] + spec["end_to_end"]:
        m["workloads"] = [c["name"] for c in cells]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, pb


# On the CPU the q4 route is the resident q4 tier (low_memory is a GPU
# deployment): a cache budget between the q4 and the bf16 cache's size.
CPU_CTOR = {
    "tiny_q4.batch": {"device": "cpu", "emb_cache_budget_bytes": 10_000_000},
    "tiny_bf16_cache.batch": {"device": "cpu", "emb_cache_budget_bytes": 100_000_000},
}


def run_tiny(tree, workload: str, *, trace: bool = False, break_path=None) -> dict:
    import time

    from perfbench import harness

    spec, pb = tree
    return harness.run_cell(workload, SEED, 0.5, trace, t_start=time.perf_counter(), device="cpu",
                            ctor_overrides=CPU_CTOR[workload], spec=spec, bench_dir=pb,
                            break_path=break_path)
