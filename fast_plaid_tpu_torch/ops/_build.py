"""Build and load the CUDA kernels of this package.

The ``.cu`` sources under ``fast_plaid_tpu_torch/csrc/`` are compiled with
nvcc for ``sm_90a``, one nvcc process per source, all started together, and
linked (with libcuda, for TMA tensor maps) into one shared library with a
plain C interface, loaded through ctypes. The build happens at first use,
from the sources in the checkout only, into ``build/fast_plaid_tpu_torch/<hash>/`` beside the
package (``FASTPLAID_TORCH_BUILD_DIR`` overrides the root). The directory
is keyed by a hash of the sources and the flags, and a file lock keeps
parallel processes from building the same library twice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from fast_plaid_tpu_torch.utils import tracing
from fast_plaid_tpu_torch.utils.locking import FileLock

__all__ = ["load_library", "build_info", "build_root", "count_launch"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]
_LIB_NAME = "libfast_plaid_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: dict = {}
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (pid, own, table, out, B, W, C, Q, stream)
    "fp_segmented_estimate": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "fp_segmented_estimate_max_q": ([], _I),
    # (emb, n_rows, doc_cap, D, pids, lens, queries, B, R, Q, out, stream)
    "fp_maxsim_gather": ([_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "fp_maxsim_gather_smem_bytes": ([_I, _I], ctypes.c_longlong),  # (D, Q)
    # (emb_q4, scale, n_docs, caph, D, pids, lens, queries, B, R, Q, out, stream)
    "fp_maxsim_q4_gather": ([_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "fp_maxsim_q4_gather_smem_bytes": ([_I, _I], ctypes.c_longlong),  # (D, Q)
    # (emb, n_rows, doc_cap, D, pids, lens, order, bounds, n_entries, E, B, R,
    #  queries, Q, out, stream)
    "fp_maxsim_dedup": (
        [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P],
        _I,
    ),
    "fp_maxsim_dedup_smem_bytes": ([_I, _I], ctypes.c_longlong),  # (D, Q)
    # (queries, N, D, centroids, Kp, k_real, k, scratch, scores, cells, stream)
    "fp_probe_topk": ([_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    "fp_probe_scratch_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),  # (N, D, k_real, k)
}


def build_root() -> Path:
    """Where the package's native builds go: ``build/fast_plaid_tpu_torch`` beside
    the package, or ``FASTPLAID_TORCH_BUILD_DIR``."""
    env = os.environ.get("FASTPLAID_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _CSRC.parent.parent / "build" / "fast_plaid_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    msg = "nvcc not found: the CUDA kernels need the CUDA toolkit to build"
    raise RuntimeError(msg)


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _compile(sources: list[Path], out_dir: Path, lib_path: Path, log_path: Path) -> None:
    """One ``nvcc -c`` per ``.cu``, run in parallel, then one link."""
    nvcc = _nvcc()
    cus = [s for s in sources if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{os.getpid()}.o" for s in cus]
    cmds = [
        [nvcc, *_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(cus, objs)
    ]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}.tmp"
    # -lcuda: libcuda's tensor-map encoder (cuTensorMapEncodeTiled) for TMA.
    link = [nvcc, *_FLAGS, "-shared", "-o", str(tmp), *[str(o) for o in objs], "-lcuda"]
    failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            failed = [(link, proc.stdout + proc.stderr)]
    log_path.write_text(
        "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs)) + " ".join(link) + "\n"
    )
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        cmd, out = failed[0]
        msg = f"nvcc failed: {' '.join(cmd)}\n{out}"
        raise RuntimeError(msg)
    os.replace(tmp, lib_path)


def build_info() -> dict:
    """The loaded library's path and the compiler output of its build."""
    return dict(_info)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    with tracing.span("kernels.load"), _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        digest = hashlib.sha256(" ".join(_FLAGS).encode())
        for src in sources:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        out_dir = build_root() / digest.hexdigest()[:16]
        lib_path = out_dir / _LIB_NAME
        log_path = out_dir / "nvcc.log"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            with FileLock(str(out_dir / "build.lock")):
                if not lib_path.exists():
                    _compile(sources, out_dir, lib_path, log_path)
                    tracing.count("kernels.built", 1)
        lib = ctypes.CDLL(str(lib_path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _info.update(
            path=str(lib_path),
            log=log_path.read_text() if log_path.exists() else "",
        )
        _lib = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        msg = f"{what} launch failed with CUDA error code {status}"
        raise RuntimeError(msg)


def count_launch(fn) -> None:
    """Add one to a kernel wrapper's ``launches`` count, under a lock: the
    shards of one device search from several threads at once."""
    with _count_lock:
        fn.launches += 1
