"""No JAX in the benchmark's process: top-level module names compared whole."""

import subprocess
import sys

from conftest import ROOT

from perfbench import harness


def test_forbidden_names_compared_whole():
    loaded = ["fast_plaid_tpu_torch", "fast_plaid_tpu_torch.search", "jaxtyping", "flaxen",
              "numpy", "jax.numpy", "fast_plaid_tpu.ops", "jaxlib", "flax"]
    assert harness.forbidden_modules(loaded) == ["fast_plaid_tpu.ops", "flax", "jax.numpy", "jaxlib"]
    assert harness.forbidden_modules(["fast_plaid_tpu_torch.ops.codec"]) == []


def test_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import perfbench.harness as h, perfbench.control, perfbench.judge, perfbench.tracing;"
        "import fast_plaid_tpu_torch.search, fast_plaid_tpu_torch.native;"
        "[h.metric_reader(p.stem) for p in (h.HERE / 'metrics').glob('*.py')];"
        "print(h.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_check_sees_a_loaded_jax():
    code = (
        "import sys, types; sys.path.insert(0, sys.argv[1]);"
        "sys.modules['jax'] = types.ModuleType('jax');"
        "import perfbench.harness as h; print(h.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "['jax']"
