"""The harness's steps on the CPU with the port's plain paths, and how it
finds configurations, mixes and metrics by name."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch
from conftest import ROOT, SEED, run_tiny

from perfbench import harness

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def test_new_files_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as new files, with entries
    in BENCHMARK.json, are found with no other file edited."""
    pb = tmp_path / "perfbench"
    for sub in ("configs", "mixes", "metrics"):
        (pb / sub).mkdir(parents=True)
    (pb / "configs" / "newcfg.json").write_text(json.dumps({"name": "newcfg", "n_docs": 7}))
    (pb / "mixes" / "newmix.json").write_text(json.dumps({"name": "newmix", "queries_per_call": 1}))
    (pb / "metrics" / "calls_seen.newmix.py").write_text(textwrap.dedent('''
        def read(rec):
            return float(len(rec["calls"])) or None
    '''))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "newcfg", "source": "s", "file": "perfbench/configs/newcfg.json",
                            "reduced": [], "why": "w"})
    spec["workloads"].append({"name": "newcfg.newmix", "config": "newcfg", "traffic": "newmix",
                              "chips": 1, "why": "w"})
    spec["per_layer"].append({"name": "calls_seen.newmix", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "API and host driver",
                              "moves": "qps", "workloads": ["newcfg.newmix"]})
    cell, entry, cfg, mix = harness.cell_files(spec, "newcfg.newmix", pb)
    assert cfg["n_docs"] == 7 and mix["queries_per_call"] == 1 and entry["name"] == "newcfg"
    names = [m["name"] for m in harness.per_layer_of(spec, "newcfg.newmix")]
    assert names == ["calls_seen.newmix"]
    assert harness.metric_reader("calls_seen.newmix", pb)({"calls": [(0, 1), (2, 3)]}) == 2.0
    assert [m["name"] for m in harness.end_to_end_of(spec, "newcfg.newmix")] == [
        "qps", "peak_gb", "setup_s"]  # p95_ms lists its cells


def test_cells_of_the_benchmark_have_their_files():
    spec = harness.load_spec(ROOT)
    for cell in spec["workloads"]:
        harness.cell_files(spec, cell["name"])
        for m in harness.per_layer_of(spec, cell["name"]):
            assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("workload", ["tiny_q4.batch", "tiny_bf16_cache.batch"])
def test_tiny_run_agrees_with_reference(tiny_tree, workload):
    res = run_tiny(tiny_tree, workload)
    line = json.loads(harness.result_line(res))
    assert list(line) == [*CONTRACT, "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    checks = line["checks"]
    assert checks["index_mismatch"]["value"] == 0
    assert checks["score_err"]["value"] <= 1e-4
    assert checks["miss_share"]["value"] == 0
    assert set(line["metrics"]) == {"qps", "p95_ms", "peak_gb", "setup_s"}
    cache = res["_info"]["cache"]
    assert cache == ("q4" if workload == "tiny_q4.batch" else "bf16")


def test_tiny_traced_run(tiny_tree):
    line = json.loads(harness.result_line(run_tiny(tiny_tree, "tiny_q4.batch", trace=True)))
    assert list(line) == [*CONTRACT, "breakdown", "checks"]
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", "fiqa.batch",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "fiqa.batch", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tiny_run_on_the_card(tiny_tree, card):
    """The same tiny cells through the card's kernels, low_memory included."""
    import time

    spec, pb = tiny_tree
    for workload in ("tiny_q4.batch", "tiny_bf16_cache.batch"):
        res = harness.run_cell(workload, SEED, 1.0, True, t_start=time.perf_counter(), spec=spec,
                               bench_dir=pb)
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
