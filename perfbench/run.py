"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Measures only on a CUDA card: without one, or with fewer cards than the
cell asks for, it exits 2 and prints no result. The last line of standard
output is the result; the numbers compared for ``correct`` are also the
last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from perfbench import harness

    spec = harness.load_spec(ROOT)
    cell, _, _, _ = harness.cell_files(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"needs {cell['chips']} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: not measured")
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, spec=spec)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"forbidden modules loaded in this process: {found}")
        return 3
    print(json.dumps({"info": result.pop("_info")}), flush=True)
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    harness.log(f"correct: {result['correct']}")
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
