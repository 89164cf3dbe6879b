"""The ``trec-covid`` deployment on the CPU: its configuration through the
harness at a tiny size (D 96, doc_cap 304) with stage 6 on the dedup
wrapper's plain path, its four readers and the six ``.batch`` metrics it
shares with quora and fiqa, and the ``batch320`` mix of the
``quora.batch320`` cell."""

import json
import shutil
import time

import pytest
from conftest import BENCH, ROOT, SEED

from perfbench import harness

N_DOCS = 48
COVID = ["rerank_ms.covid", "roofline.rerank.covid", "probe_ms.covid", "idle.covid"]
SHARED = ["api_ms.batch", "torch_ms.batch", "roofline.estimate.batch", "prep_ms.batch",
          "emit_ms.batch", "cands_ms.batch"]


@pytest.fixture(scope="module")
def covid_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_covid")
    pb = root / "perfbench"
    shutil.copytree(BENCH / "metrics", pb / "metrics")
    (pb / "configs").mkdir()
    (pb / "mixes").mkdir()
    cfg = json.loads((BENCH / "configs" / "trec-covid.json").read_text())
    cfg.update(n_docs=N_DOCS)
    (pb / "configs" / "trec-covid.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "mixes" / "batch.json").read_text())
    mix.update(queries_per_call=16, query_pool=32, warmup_calls=1, judged_calls=2,
               traced_from=0, traced_calls=2)
    mix["search"]["n_full_scores"] = 32
    (pb / "mixes" / "batch.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, pb


def test_covid_cell_is_correct_on_the_dedup_route(covid_tree, monkeypatch):
    """The plain path stands in for kernel #4 at D 96 (``kernel_flags`` says
    rerank kernels, the CPU takes their plain versions): the reference
    agrees, the route is the bf16 cache at D 96 and doc_cap 304, the
    cell's per-layer metrics are the four covid ones and six shared with
    quora, and every one of them runs on the traced record (each covid
    reader through the sibling whose reading it shares)."""
    from fast_plaid_tpu_torch.ops import rerank_dedup
    from fast_plaid_tpu_torch.search import searcher

    spec, pb = covid_tree
    plain, widths = rerank_dedup.maxsim_gather_scores_dedup_plain, []
    monkeypatch.setattr(searcher, "kernel_flags", lambda dev: (False, dev.emb_cache is not None))
    monkeypatch.setattr(rerank_dedup, "maxsim_gather_scores_dedup_plain",
                        lambda emb, *a, **k: widths.append(emb.shape[2]) or plain(emb, *a, **k))
    read = []
    real_reader = harness.metric_reader
    monkeypatch.setattr(harness, "metric_reader",
                        lambda name, *a: read.append(name) or real_reader(name, *a))
    res = harness.run_cell("trec-covid.batch", SEED, 0.5, True, t_start=time.perf_counter(),
                           device="cpu",
                           ctor_overrides={"device": "cpu", "emb_cache_budget_bytes": 100_000_000},
                           spec=spec, bench_dir=pb)
    line = json.loads(harness.result_line(res))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["index_mismatch"]["value"] == 0
    info = res["_info"]
    assert info["cache"] == "bf16" and info["doc_cap"] == 304 and info["buckets"] == []
    assert widths and set(widths) == {96}
    names = [m["name"] for m in harness.per_layer_of(spec, "trec-covid.batch")]
    assert names == SHARED + COVID
    assert [n for n in read if n in names] == names
    assert set(line["metrics"]) <= set(names)


def _record() -> dict:
    """One call: the probe kernel inside ``engine.probe``, then a sort inside
    ``rerank.group`` and the dedup kernel inside ``engine.rerank``, with the
    work of one rerank launch whose bound is 1 ms."""
    host = [("engine.probe", 95.0, 5.0), ("cudaLaunchKernel", 96.0, 1.0),
            ("engine.rerank", 100.0, 50.0), ("rerank.group", 102.0, 10.0),
            ("cudaLaunchKernel", 105.0, 1.0), ("cudaLaunchKernel", 120.0, 1.0)]
    device = [("probe_topk_kernel", 150.0, 40.0, "kernel"), ("sort_kernel", 200.0, 300.0, "kernel"),
              ("maxsim_dedup_kernel", 500.0, 2000.0, "kernel")]
    return {"calls": [(90.0, 2600.0)], "host_ops": host, "device_ops": device,
            "launches": {"estimate": [], "q4": [], "rerank": [{"bound_ms": 1.0}]},
            "kernels": {"estimate": ("estimate_kernel",), "q4": ("maxsim_q4_gather_kernel",),
                        "rerank": ("maxsim_dedup_kernel", "maxsim_gather_kernel")}}


@pytest.mark.parametrize("name,want", [
    ("rerank_ms.covid", 2.3),
    ("roofline.rerank.covid", 50.0),
    ("probe_ms.covid", 0.04),
    ("idle.covid", 100.0 * (1.0 - 2340.0 / 2510.0)),
])
def test_covid_readers(name, want):
    assert harness.metric_reader(name)(_record()) == pytest.approx(want)


def test_batch320_mix_and_cell():
    """``batch320`` is ``batch`` with calls of 320 queries; its cell runs the
    quora deployment and reports ``qps``, ``peak_gb`` and ``setup_s``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, entry, cfg, mix = harness.cell_files(spec, "quora.batch320")
    base = json.loads((BENCH / "mixes" / "batch.json").read_text())
    assert mix["queries_per_call"] == 320
    assert {k: v for k, v in mix.items() if k not in ("name", "queries_per_call", "why")} == {
        k: v for k, v in base.items() if k not in ("name", "queries_per_call", "why")}
    assert cell["chips"] == 1 and entry["name"] == cfg["name"] == "quora"
    names = [m["name"] for m in harness.end_to_end_of(spec, "quora.batch320")]
    assert names == ["qps", "peak_gb", "setup_s"]
    assert harness.per_layer_of(spec, "quora.batch320") == harness.per_layer_of(spec, "quora.batch")
