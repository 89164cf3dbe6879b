"""Native (C++) host kernels: the IVF build and the low_memory row gather.

The port's counterpart of ``fast_plaid_tpu/native``, with the same entry
points and semantics (clamping, zero fill, the two-call IVF protocol).
``fastplaid_native.cpp`` is built at first use with g++ into
``build/fast_plaid_tpu_torch/native/<hash>/`` (the hash covers the source,
the flags and the host CPU that ``-march=native`` targets), under a file
lock so that parallel processes build it once. A
host without g++, or a failed build, prints why to stderr and leaves
``AVAILABLE`` False: every entry point then returns None and its caller
takes its numpy / torch path.

Unlike the JAX package's, ``gather_windows_u8`` can write into a
preallocated CPU tensor, so the low_memory path gathers straight into its
pinned buffer, and can pack the windows back to back (``out_rows``). Each
entry point counts its native calls in ``.calls``.
"""

from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from fast_plaid_tpu_torch.ops._build import build_root
from fast_plaid_tpu_torch.utils import tracing
from fast_plaid_tpu_torch.utils.locking import FileLock

__all__ = ["AVAILABLE", "build_ivf_native", "gather_windows_u8"]

_SRC = Path(__file__).resolve().parent / "fastplaid_native.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LIB_NAME = "libfastplaid_native.so"
_P, _I64 = ctypes.c_void_p, ctypes.c_int64

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False
AVAILABLE = False


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep)))


def _compile(lib_path: Path) -> None:
    tmp = lib_path.with_name(f".{_LIB_NAME}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    tmp.replace(lib_path)


def _load() -> ctypes.CDLL | None:
    """Build (once per source and flags) and load the library; None where
    that fails, which is reported once."""
    global _lib, _failed, AVAILABLE
    if _lib is not None or _failed:
        return _lib
    with tracing.span("kernels.load"), _lock:
        if _lib is not None or _failed:
            return _lib
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes() + _host_cpu())
        out_dir = build_root() / "native" / digest.hexdigest()[:16]
        lib_path = out_dir / _LIB_NAME
        try:
            if not lib_path.exists():
                out_dir.mkdir(parents=True, exist_ok=True)
                with FileLock(str(out_dir / "build.lock")):
                    if not lib_path.exists():
                        _compile(lib_path)
                        tracing.count("native.built", 1)
            lib = ctypes.CDLL(str(lib_path))
        except (OSError, subprocess.SubprocessError) as exc:
            print(f"fastplaid_native: build skipped ({exc})", file=sys.stderr)
            _failed = True
            return None
        lib.fp_build_ivf.restype = _I64
        lib.fp_build_ivf.argtypes = [_P, _I64, _P, _I64, _I64, _P, _P]
        lib.fp_gather_windows_u8.restype = None
        lib.fp_gather_windows_u8.argtypes = [_P, _I64, _I64, _P, _P, _I64, _I64, _P]
        lib.fp_gather_windows_packed_u8.restype = None
        lib.fp_gather_windows_packed_u8.argtypes = [
            _P, _I64, _I64, _P, _P, _P, _I64, _I64, _P,
        ]
        _lib = lib
        AVAILABLE = True
        return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _count(fn) -> None:
    with _count_lock:  # the shards of load_sharded_lm gather from several threads
        fn.calls += 1


def build_ivf_native(
    codes: np.ndarray, doc_lengths: np.ndarray, n_partitions: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """C++ IVF build: (ivf [I] int32 pids grouped by cell, pid-ascending,
    each (cell, pid) pair once; ivf_lengths [K] int64), or None when the
    native library is unavailable. A count and a scatter over the tokens in
    document order, no sort; raises ValueError for a code outside [0, K)."""
    lib = _load()
    if lib is None:
        return None
    _count(build_ivf_native)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    doc_lengths = np.ascontiguousarray(doc_lengths, dtype=np.int64)
    n_docs = int(len(doc_lengths))
    t = int(codes.shape[0])
    k = int(n_partitions)
    n_pairs = lib.fp_build_ivf(_ptr(codes), t, _ptr(doc_lengths), n_docs, k, None, None)
    if n_pairs < 0:
        msg = f"a code lies outside [0, {k})"
        raise ValueError(msg)
    ivf = np.empty(int(n_pairs), dtype=np.int32)
    ivf_lengths = np.empty(k, dtype=np.int64)
    lib.fp_build_ivf(
        _ptr(codes), t, _ptr(doc_lengths), n_docs, k, _ptr(ivf), _ptr(ivf_lengths)
    )
    return ivf, ivf_lengths


build_ivf_native.calls = 0


def gather_windows_u8(
    src: np.ndarray,
    indices: np.ndarray,
    lengths: np.ndarray,
    doc_cap: int,
    out: torch.Tensor | None = None,
    out_rows: np.ndarray | None = None,
):
    """Threaded jagged window gather from ``src`` [T, row_bytes].

    Window w is rows [indices[w], indices[w] + lengths[w]) of ``src`` (any
    dtype, viewed as bytes a row), the start clamped to [0, T), the length
    to [0, doc_cap] and to the end of ``src``; rows past it are zero.

    Without ``out_rows`` the windows are padded: [W, doc_cap, row_bytes],
    zero past each window's rows. With ``out_rows`` ([W] int64) they are
    packed: window w's rows (its clamped length, zeros past the end of
    ``src`` included) go to rows [out_rows[w], out_rows[w] + length) of the
    output, byte for byte the first rows of its padded window, and no other
    row is written. Into ``out`` when given (a contiguous CPU tensor, of any
    shape and dtype, of exactly W * doc_cap rows padded, of at least every
    window's last row packed), which is returned; else into a new uint8
    array ([rows, row_bytes] packed, zero where no window writes). None when
    the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    row_bytes = src.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    src = src.view(np.uint8).reshape(src.shape[0], row_bytes)
    indices = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32).reshape(-1)
    w = int(indices.shape[0])
    if lengths.shape[0] != w:
        msg = f"{w} window starts but {lengths.shape[0]} lengths"
        raise ValueError(msg)
    if out_rows is None:
        n_rows = w * int(doc_cap)
    else:
        out_rows = np.ascontiguousarray(out_rows, dtype=np.int64).reshape(-1)
        if out_rows.shape[0] != w:
            msg = f"{w} window starts but {out_rows.shape[0]} output rows"
            raise ValueError(msg)
        if w and out_rows.min() < 0:
            msg = "an output row is negative"
            raise ValueError(msg)
        ends = out_rows + np.clip(lengths, 0, int(doc_cap))
        n_rows = int(ends.max()) if w else 0
    nbytes = n_rows * row_bytes
    if out is None:
        if out_rows is None:
            result = np.empty((w, int(doc_cap), row_bytes), dtype=np.uint8)
        else:
            result = np.zeros((n_rows, row_bytes), dtype=np.uint8)
        dst = _ptr(result)
    else:
        if out.device.type != "cpu" or not out.is_contiguous():
            msg = "out must be a contiguous CPU tensor"
            raise ValueError(msg)
        held = out.numel() * out.element_size()
        if held < nbytes or (out_rows is None and held != nbytes):
            msg = f"out holds {held} bytes, the gather writes {nbytes}"
            raise ValueError(msg)
        result = out
        dst = ctypes.c_void_p(out.data_ptr())
    _count(gather_windows_u8)
    if out_rows is None:
        lib.fp_gather_windows_u8(
            _ptr(src), int(src.shape[0]), row_bytes, _ptr(indices), _ptr(lengths), w,
            int(doc_cap), dst,
        )
    else:
        lib.fp_gather_windows_packed_u8(
            _ptr(src), int(src.shape[0]), row_bytes, _ptr(indices), _ptr(lengths),
            _ptr(out_rows), w, int(doc_cap), dst,
        )
    return result


gather_windows_u8.calls = 0
