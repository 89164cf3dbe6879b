"""The PyTorch port imports with jax unavailable, and never imports it."""

from __future__ import annotations

import os
import subprocess
import sys

_SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import fast_plaid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    fast_plaid_tpu_torch.__path__, "fast_plaid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("ops.q4cache", "ops.rerank_dedup", "ops.rerank_kernel", "ops.probe_kernel",
             "search.load",
             "filtering", "filtering.filtering", "index.appender", "index.deleter",
             "search.update", "evaluation.evaluation", "evaluation.synthetic",
             "serving.batcher", "serving.server", "serving.__main__", "utils.tracing",
             "utils.memory", "parallel", "parallel.mesh", "parallel.sharded",
             "parallel.mesh2d", "parallel.lm_sharded", "parallel.api", "native", "models",
             "models.encoder", "models.torch_encoder", "utils.devices"):
    assert "fast_plaid_tpu_torch." + name in names, name
spec = importlib.util.spec_from_file_location("qp", "tools/quality_parity_torch.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
tool.make_corpus(8, 1, 8, 0, "colbert_proxy_graded")
bad = [m for m in sys.modules if m == "fast_plaid_tpu" or m.startswith("fast_plaid_tpu.")]
assert not bad, bad
assert "transformers" not in sys.modules  # the encoders import it at first use only
print(len(names))
"""


def test_port_imports_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True,
        text=True,
        cwd=root,
        env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the slices: ops (q4cache and rerank_dedup among them),
    # index (appender, deleter), search (update), filtering, utils,
    # evaluation, serving, parallel, native, models; and the port's quality tool
    assert int(out.stdout.strip().splitlines()[-1]) >= 46
