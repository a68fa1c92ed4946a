"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one process per
source, all started together — and links the objects into one shared
library with a plain C interface, under ``build/bubbleformer_tpu_torch/`` at
the root of the checkout.  The library's name carries a hash of the sources and the
flags, so an edit to a kernel builds anew and an unchanged tree reuses its
build.  It is built at first use — the first CUDA call of a kernel wrapper —
and loaded with ``ctypes``; every C entry returns the ``cudaError_t`` of its
launches, which the wrappers raise on.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "bubbleformer_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C entries (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dtype, x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout, bout, bias,
    # scale, stats1, qkv, ao, stats2, out, B, T, N, C, heads, stream
    "bf_temporal_block_fwd": [_I] + [_P] * 17 + [_I] * 5 + [_P],
    # dtype, x, do, qkv, in1_w, in1_b, wqkv_t, ln, in2_w, in2_b, wout_t, bias,
    # scale, stats1, ao, stats2, work, sums, dqkv, dx, din1, dwqkv, dbqkv, dln,
    # din2, dwout, dbout, dbias, dscale, B, T, N, C, heads, stream
    "bf_temporal_block_bwd": [_I] + [_P] * 28 + [_I] * 5 + [_P],
    # dtype, xn, wqkv, bqkv, ln, bias, scale, qkv (or null), ao, B, T, N, C,
    # heads, stream
    "bf_core_temporal_fwd": [_I] + [_P] * 8 + [_I] * 5 + [_P],
    # dtype, xn, dao, qkv, wqkv_t, ln, bias, scale, dqkv, dx, dwqkv, dbqkv,
    # dln, dbias, dscale, B, T, N, C, heads, stream
    "bf_core_temporal_bwd": [_I] + [_P] * 14 + [_I] * 5 + [_P],
    # dtype, qkv, ln, bias_x, bias_y, scale, row_out, out, BT, H, W, C, heads,
    # stream
    "bf_axial_attention_fwd": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    # dtype, qkv, do, ln, bias_x, bias_y, scale, dqkv, dln, dbias_x, dbias_y,
    # dscale, BT, H, W, C, heads, stream
    "bf_axial_attention_bwd": [_I] + [_P] * 11 + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
            "the CUDA kernels of bubbleformer_tpu_torch build only where the CUDA "
            "toolkit is installed"
        )
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbubbleformer_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{cu.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)]
            jobs.append((cu.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for name, _, proc in jobs:  # waits for every compiler, failed or not
            out, err = proc.communicate()
            log.append(f"== {name} (exit {proc.returncode})\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"{name}:\n{err[-6000:]}")
        tmp_so = Path(tmp) / so.name
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in jobs)],
                capture_output=True, text=True,
            )
            log.append(f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link:\n{link.stderr[-6000:]}")
        so.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed building {so.name}:\n" + "\n".join(failed))
        os.replace(tmp_so, so)  # atomic: a half-written library is never loaded
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with its C
    signatures declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bf_error_string.argtypes = [ctypes.c_int]
    lib.bf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.bf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_shapes(what: str, **tensors) -> None:
    """Raise unless each ``name=(tensor, shape)`` has exactly that shape: the
    kernels index their arguments by the shapes they are told."""
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream
