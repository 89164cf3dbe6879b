"""``correct`` can come out false: the precision control fails a number, and
so does a run whose timed path is broken underneath."""

import importlib

import numpy as np
import pytest
from conftest import SEED, run_tiny

from perfbench import control


@pytest.mark.parametrize("workload", ["tiny_q4.batch", "tiny_bf16_cache.batch"])
def test_precision_control_fails(tiny_tree, workload):
    spec, pb = tiny_tree
    stated = control.run_control(workload, SEED, "bfloat16", device="cpu", spec=spec, bench_dir=pb)
    assert stated["fails"] == []
    lower = control.run_control(workload, SEED, "float8_e4m3fn", device="cpu", spec=spec, bench_dir=pb)
    assert lower["fails"], lower


def altered_answer(search):
    """A document id altered where the answer is produced."""
    def broken(queries, **kw):
        out = search(queries, **kw)
        return [[(pid + 1, s) if k == 0 else (pid, s) for k, (pid, s) in enumerate(r)] for r in out]
    return broken


def half_batch(search):
    """Half of the batch left out: the rest's answers stand in for it."""
    def broken(queries, **kw):
        half = len(queries) // 2
        out = search(queries[:half], **kw)
        return out + out[: len(queries) - half]
    return broken


@pytest.mark.parametrize("fault", [altered_answer, half_batch])
def test_broken_timed_path_is_not_correct(tiny_tree, fault):
    res = run_tiny(tiny_tree, "tiny_bf16_cache.batch", break_path=fault)
    assert res["correct"] is False
    assert res["checks"]["score_err"]["value"] > res["checks"]["score_err"]["limit"]


def wrong_code(real):
    """A code written wrong by the build."""
    def shifted(emb, cent, block=2048):
        codes = real(emb, cent, block)
        codes[::97] = (codes[::97] + 1) % cent.shape[0]
        return codes
    return shifted


def reseeded_centroids(real):
    """k-means gone wrong on a minority of its centroids (1 in 20 re-seeded
    elsewhere), with the codes and residuals built from them."""
    def reseeded(*args, **kw):
        cent = np.array(real(*args, **kw))
        cent[::20] = np.roll(cent, 1, axis=0)[::20]
        return cent
    return reseeded


@pytest.mark.parametrize(("module", "name", "fault", "number"), [
    ("fast_plaid_tpu_torch.ops.codec", "assign_codes", wrong_code, "index_mismatch"),
    ("fast_plaid_tpu_torch.search.fast_plaid", "compute_kmeans", reseeded_centroids, "kmeans_gap"),
])
def test_index_fault_is_not_correct(tiny_tree, monkeypatch, module, name, fault, number):
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = run_tiny(tiny_tree, "tiny_bf16_cache.batch")
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
