"""ctypes bridge to the native (C + OpenMP) batch assembler.

Counterpart of ``bubbleformer_tpu/data/native.py``.  Compiles the port's own
``bubbleformer_tpu_torch/native/batch_assembler.c`` at first use into
``build/bubbleformer_tpu_torch/`` at the root of the checkout (as
``_build.py`` builds the CUDA kernels), under a name that carries a hash of
the source and the flags, and exposes:

* :func:`assemble_windows` — batched sliding-window gather + downsample +
  normalize into the ``(B, T, C, H', W')`` training layout, bit for bit the
  dataset's numpy path;
* :func:`field_stats` — one-pass sum / sum of squares / min / max.

Where no compiler builds it, :func:`available` is False and
:func:`unavailable_reason` says why, for the caller to print: the switch to
the numpy path is never silent.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from bubbleformer_tpu_torch._lock import build_lock

# The kernels' build directory (``_build.py:BUILD_DIR``), named here so that
# the data path imports numpy alone.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bubbleformer_tpu_torch"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "batch_assembler.c"
CFLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
COMPILERS = ("cc", "gcc", "clang")

def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbatch_assembler_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the assembler unless this exact build exists; returns its path.
    Processes that build at once take turns (``_lock.py``).  Raises
    ``RuntimeError`` with each compiler's failure when none builds it."""
    so = library_path()
    if so.exists():
        return so
    with build_lock(so):
        if not so.exists():
            _compile(so)
    return so


def _compile(so: Path) -> None:
    failures = []
    for cc in COMPILERS:
        fd, tmp = tempfile.mkstemp(prefix=so.name + ".", suffix=".tmp", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([cc, *CFLAGS, str(SOURCE), "-o", tmp], capture_output=True,
                                 text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired) as exc:
            failures.append(f"{cc}: {exc}")
            os.unlink(tmp)
            continue
        if res.returncode == 0:
            os.replace(tmp, so)  # atomic: a half-written library is never loaded
            return
        os.unlink(tmp)
        failures.append(f"{cc} (exit {res.returncode}): {res.stderr.strip()[-500:]}")
    raise RuntimeError("no C compiler built the batch assembler with "
                       f"{' '.join(CFLAGS)}: " + "; ".join(failures))


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """The loaded library and None, or None and why it is unavailable
    (built at the first call of the process)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as exc:
        return None, str(exc)
    lib.assemble_windows.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # field_ptrs
        ctypes.c_int64,  # num_fields
        ctypes.c_int64,  # traj_h
        ctypes.c_int64,  # traj_w
        ctypes.POINTER(ctypes.c_int64),  # starts
        ctypes.c_int64,  # batch
        ctypes.c_int64,  # tw
        ctypes.c_int64,  # factor
        ctypes.POINTER(ctypes.c_float),  # diff
        ctypes.POINTER(ctypes.c_float),  # div
        ctypes.POINTER(ctypes.c_float),  # out
        ctypes.c_int64,  # num_threads
    ]
    lib.assemble_windows.restype = None
    lib.field_stats.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_double)]
    lib.field_stats.restype = None
    return lib, None


def available() -> bool:
    """Whether the assembler is built and loaded (building it if need be)."""
    return _load()[0] is not None


def unavailable_reason() -> Optional[str]:
    """Why the assembler is unavailable; None where it is available."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, reason = _load()
    if lib is None:
        raise RuntimeError(f"the native batch assembler is unavailable: {reason}")
    return lib


def assemble_windows(fields: Sequence[np.ndarray], starts: np.ndarray, time_window: int,
                     factor: int, diff: np.ndarray, div: np.ndarray,
                     out: Optional[np.ndarray] = None, threads: int = 0) -> np.ndarray:
    """``(B, T, C, H/factor, W/factor)`` batch from ``(T, H, W)`` field buffers:
    sample ``b`` holds frames ``[starts[b], starts[b] + time_window)``.  It is
    written into ``out`` where given (C-contiguous float32 of that shape, for
    instance a slice of a larger batch), else into a new array, by an OpenMP
    team of ``threads`` threads (0: OpenMP's default, every CPU)."""
    lib = _lib()
    num_fields = len(fields)
    t, h, w = fields[0].shape
    for f in fields:
        if f.dtype != np.float32 or not f.flags["C_CONTIGUOUS"] or f.shape != (t, h, w):
            raise ValueError("every field must be a C-contiguous float32 array of one shape, "
                             f"got {f.dtype} {f.shape} (first {(t, h, w)})")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if starts.size and (starts.min() < 0 or starts.max() + time_window > t):
        raise ValueError(f"windows [{starts.min()}, {starts.max() + time_window}) "
                         f"outside a trajectory of {t} frames")
    diff = np.ascontiguousarray(diff, dtype=np.float32)
    div = np.ascontiguousarray(div, dtype=np.float32)
    shape = (starts.shape[0], time_window, num_fields, h // factor, w // factor)
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]
          or not out.flags["WRITEABLE"]):
        raise ValueError(f"out must be a writeable C-contiguous float32 array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    ptrs = (ctypes.c_void_p * num_fields)(*[f.ctypes.data_as(ctypes.c_void_p) for f in fields])
    lib.assemble_windows(
        ptrs, num_fields, h, w, starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), shape[0],
        time_window, factor, diff.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        div.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads,
    )
    return out


def field_stats(data: np.ndarray) -> dict:
    """One-pass mean/std/min/max of a float32 array (native, OpenMP)."""
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.float32)
    out = np.zeros(4, np.float64)
    lib.field_stats(data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    n = data.size
    mean = out[0] / n
    var = max(out[1] / n - mean * mean, 0.0)
    return {"mean": mean, "std": float(np.sqrt(var)), "min": out[2], "max": out[3]}
