"""The ``pages`` deployment on the CPU: its configuration through the harness
at a tiny size, with stage 6 on the dedup wrapper's plain path, and the
readers of its stage-6 metrics on records with and without the program's
span ``rerank.group``."""

import json
import shutil
import time

import pytest
from conftest import BENCH, ROOT, SEED

from perfbench import harness
from perfbench.group_span import ALIAS, aliased

N_PAGES = 24


@pytest.fixture(scope="module")
def pages_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_pages")
    pb = root / "perfbench"
    shutil.copytree(BENCH / "metrics", pb / "metrics")
    (pb / "configs").mkdir()
    (pb / "mixes").mkdir()
    cfg = json.loads((BENCH / "configs" / "pages.json").read_text())
    cfg.update(n_docs=N_PAGES)
    (pb / "configs" / "pages.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "mixes" / "batch.json").read_text())
    mix.update(queries_per_call=16, query_pool=32, warmup_calls=1, judged_calls=2,
               traced_from=0, traced_calls=2)
    mix["search"]["n_full_scores"] = 32
    (pb / "mixes" / "batch.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, pb


def test_pages_cell_is_correct_on_the_dedup_route(pages_tree, monkeypatch):
    """The plain path stands in for kernel #4 (``kernel_flags`` says rerank
    kernels, the CPU takes their plain versions): the reference agrees and
    every pages metric reader runs."""
    from fast_plaid_tpu_torch.ops import rerank_dedup
    from fast_plaid_tpu_torch.search import searcher

    spec, pb = pages_tree
    plain, used = rerank_dedup.maxsim_gather_scores_dedup_plain, []
    monkeypatch.setattr(searcher, "kernel_flags", lambda dev: (False, dev.emb_cache is not None))
    monkeypatch.setattr(rerank_dedup, "maxsim_gather_scores_dedup_plain",
                        lambda *a, **k: used.append(1) or plain(*a, **k))
    res = harness.run_cell("pages.batch", SEED, 0.5, True, t_start=time.perf_counter(), device="cpu",
                           ctor_overrides={"device": "cpu", "emb_cache_budget_bytes": 100_000_000},
                           spec=spec, bench_dir=pb)
    line = json.loads(harness.result_line(res))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["kmeans_gap"]["limit"] == 0.15
    assert line["checks"]["index_mismatch"]["value"] == 0
    assert used and res["_info"]["cache"] == "bf16"
    names = [m["name"] for m in harness.per_layer_of(spec, "pages.batch")]
    assert names == ["rerank_ms.pages", "group_ms.pages", "roofline.dedup.pages", "idle.pages"]


def _record(with_group: bool) -> dict:
    """One call: ``engine.rerank`` launches a sort inside ``rerank.group``
    (where the program has it), then the dedup kernel."""
    host = [("engine.rerank", 100.0, 50.0), ("cudaLaunchKernel", 105.0, 1.0), ("cudaLaunchKernel", 120.0, 1.0)]
    if with_group:
        host.append(("rerank.group", 102.0, 10.0))
    device = [("sort_kernel", 200.0, 300.0, "kernel"), ("maxsim_dedup_kernel", 500.0, 2000.0, "kernel")]
    return {"calls": [(90.0, 2600.0)], "host_ops": host, "device_ops": device}


def _read(name, rec):
    return harness.metric_reader(name)(rec)


def test_group_reader_with_and_without_the_span():
    assert _read("group_ms.pages", _record(True)) == pytest.approx(0.3)
    assert _read("rerank_ms.pages", _record(True)) == pytest.approx(2.3)
    assert _read("group_ms.pages", _record(False)) is None
    assert _read("rerank_ms.pages", _record(False)) == pytest.approx(2.3)


def test_alias_renames_the_recorders_launch_spans():
    rec = dict(_record(True), launch_span=[(0, 0, 300.0, "kernel", "rerank.group"),
                                           (0, 0, 2000.0, "kernel", "engine.rerank")])
    out = aliased(rec)
    assert [e[4] for e in out["launch_span"]] == [ALIAS, "engine.rerank"]
    assert rec["launch_span"][0][4] == "rerank.group"  # the record itself is left as it was
    assert _read("group_ms.pages", rec) == pytest.approx(0.3)
