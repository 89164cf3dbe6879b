"""The port's profiling helpers on the CPU: ``trace`` / ``annotate``
(torch.profiler) and the memory printers."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fast_plaid_tpu_torch.utils.memory import device_memory_summary, print_array_memory
from fast_plaid_tpu_torch.utils.tracing import annotate, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_annotate_nests_inside_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        with annotate("outer_stage"):
            with annotate("inner_stage"):
                torch.arange(10).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"outer_stage", "inner_stage"} <= keys
    with open(os.path.join(log_dir, os.listdir(log_dir)[0])) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"] if "ts" in e and "dur" in e}
    outer, inner = events["outer_stage"], events["inner_stage"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    with annotate("outside_any_trace"):  # harmless without a profiler
        pass


def test_memory_printers(capsys):
    print_array_memory("np", np.zeros((4, 8), np.float32))
    print_array_memory("torch", torch.zeros((2, 3, 4), dtype=torch.bfloat16))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[memory] np: shape=(4, 8) dtype=float32 size=128.00 B"
    assert lines[1] == ("[memory] torch: shape=(2, 3, 4) dtype=torch.bfloat16 "
                        "device=cpu size=48.00 B")
    summary = device_memory_summary()  # no CUDA device here: no lines, no error
    if not torch.cuda.is_available():
        assert summary == ""
    else:
        assert summary.count("\n") == torch.cuda.device_count() - 1
