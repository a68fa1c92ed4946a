"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one process per
source, all started together (the shared kernels live in ``csrc/*.cuh``
headers that each source includes) — and links the objects into one shared
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

from bubbleformer_tpu_torch._lock import build_lock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "bubbleformer_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C entries (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)  # a host array of int64 (shapes, strides)
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of int32 (split-K token bounds)
_FP = ctypes.POINTER(ctypes.c_float)  # a host array of float32 (per-launch milliseconds)
_SIGNATURES = {
    # dtype, head_dim, x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout,
    # bout, bias, scale, stats1, qkv, ao, ao_r, stats2, out, xs, launch_ms, B,
    # T, N, C, heads, Cin, partial, stream
    "bf_temporal_block_fwd": [_I] * 2 + [_P] * 19 + [_FP] + [_I] * 7 + [_P],
    # dtype, head_dim, x, do, qkv, in1_w, in1_b, wqkv_t, ln, in2_w, in2_b,
    # wout_t, bias, scale, stats1, ao_r, stats2, work, sums, dqkv, dx, din1,
    # dwqkv, dbqkv, dln, din2, dwout, dbout, dbias, dscale, xs, part, plan_out,
    # splits_out, plan_qkv, splits_qkv, launch_ms, B, T, N, C, heads, Cin, stream
    "bf_temporal_block_bwd": [_I] * 2 + [_P] * 30 + [_IP, _I, _IP, _I, _FP] + [_I] * 6 + [_P],
    # layout, epilogue, a, b, out, bias, part, M, N, K, bounds, splits, stream
    "bf_hopper_gemm": [_I] * 2 + [_P] * 5 + [_I] * 3 + [_IP, _I, _P],
    # dtype, head_dim, xn, wqkv, bqkv, ln, bias, scale, qkv, ao, launch_ms, B,
    # T, N, C, heads, Cin, stream
    "bf_core_temporal_fwd": [_I] * 2 + [_P] * 8 + [_FP] + [_I] * 6 + [_P],
    # dtype, head_dim, xn, dao, wqkv, bqkv, wqkv_t, ln, bias, scale, qkv,
    # dqkv, dx, dwqkv, dbqkv, dln, dbias, dscale, part, plan, splits,
    # launch_ms, B, T, N, C, heads, Cin, stream
    "bf_core_temporal_bwd": [_I] * 2 + [_P] * 17 + [_IP, _I, _FP] + [_I] * 6 + [_P],
    # dtype, head_dim, fused, qkv, ln, bias_x, bias_y, scale, row_out, out,
    # BT, H, W, C, heads, stream
    "bf_axial_attention_fwd": [_I] * 3 + [_P] * 7 + [_I] * 5 + [_P],
    # dtype, head_dim, fused, qkv, do, ln, bias_x, bias_y, scale, dqkv, dacc,
    # stats, dln, dbias_x, dbias_y, dscale, part, groups_r, per_r, groups_c,
    # per_c, BT, H, W, C, heads, stream
    "bf_axial_attention_bwd": [_I] * 3 + [_P] * 14 + [_I] * 9 + [_P],
    # head_dim, qkv, ln, bias_x, bias_y, scale, row_out, out, BT, H, W, C,
    # heads, stream
    "bf_lane_hopper_fwd": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    # head_dim, qkv, dout, ln, bias_x, bias_y, scale, dqkv, lane_part, dln,
    # dbias_x, dbias_y, dscale, BT, H, W, C, heads, groups_r, per_r, groups_c,
    # per_c, stream
    "bf_lane_hopper_bwd": [_I] + [_P] * 12 + [_I] * 9 + [_P],
    # mode, head_dim, L, blocks (int out)
    "bf_lane_bwd_resident": [_I, _I, _I, _IP],
    # dtype, head_dim, packed, qkv3, bias_x, bias_y, scale, row_out, out, BT,
    # H, W, C, heads, stream
    "bf_axial_fused_fwd": [_I] * 3 + [_P] * 6 + [_I] * 5 + [_P],
    # dtype, head_dim, packed, qkv3, do, bias_x, bias_y, scale, dqkv3, dacc,
    # stats, dbias_x, dbias_y, dscale, part, groups_r, per_r, groups_c, per_c,
    # BT, H, W, C, heads, stream
    "bf_axial_fused_bwd": [_I] * 3 + [_P] * 12 + [_I] * 9 + [_P],
    # dtype, head_dim, qkv3, bias, scale, out, M, n, heads, stream
    "bf_axial_flash_fwd": [_I] * 2 + [_P] * 4 + [_I] * 3 + [_P],
    # dtype, head_dim, qkv3, dout, bias, scale, dqkv3, stats, dbias, dscale,
    # part, groups, per, M, n, heads, stream
    "bf_axial_flash_bwd": [_I] * 2 + [_P] * 9 + [_I] * 5 + [_P],
    # head_dim, q, k, v, bias, scale, out, M, n, heads, stream (bf16)
    "bf_flash_hopper_fwd": [_I] + [_P] * 6 + [_I] * 3 + [_P],
    # head_dim, q, k, v, dout, bias, scale, dq, dk, dv, part, dbias, dscale,
    # groups, per, M, n, heads, stream (bf16)
    "bf_flash_hopper_bwd": [_I] + [_P] * 12 + [_I] * 5 + [_P],
    # head_dim, n, blocks (int out)
    "bf_flash_hopper_resident": [_I, _I, _IP],
    # head_dim, qkv, ln, bias_x, bias_y, scale, half, out, BT, H, W, C, heads,
    # stream (bf16)
    "bf_fused_block_hopper_fwd": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    # head_dim, qkv, dout, ln, bias_x, bias_y, scale, dqkv, dacc, lane_part,
    # dln, dbias_x, dbias_y, dscale, BT, H, W, C, heads, groups_r, per_r,
    # groups_c, per_c, stream (bf16)
    "bf_fused_block_hopper_bwd": [_I] + [_P] * 13 + [_I] * 9 + [_P],
    # head_dim, q, k, v, strides, bias_x, bias_y, scale, half, out, BT, H, W,
    # C, heads, stream (bf16)
    "bf_fused_packed_hopper_fwd": [_I] + [_P] * 3 + [_LP] + [_P] * 5 + [_I] * 5 + [_P],
    # head_dim, q, k, v, dout, strides, bias_x, bias_y, scale, dq, dk, dv,
    # dacc, lane_part, dbias_x, dbias_y, dscale, BT, H, W, C, heads, groups_r,
    # per_r, groups_c, per_c, stream (bf16)
    "bf_fused_packed_hopper_bwd": [_I] + [_P] * 4 + [_LP] + [_P] * 11 + [_I] * 9 + [_P],
    # head_dim, q, k, v, strides, bias_x, bias_y, scale, half, out, BT, H, W,
    # C, heads, stream (bf16)
    "bf_fused_hopper_fwd": [_I] + [_P] * 3 + [_LP] + [_P] * 5 + [_I] * 5 + [_P],
    # head_dim, q, k, v, dout, strides, bias_x, bias_y, scale, dq, dk, dv,
    # part, dbias_x, dbias_y, dscale, BT, H, W, C, heads, groups_r, per_r,
    # groups_c, per_c, stream (bf16)
    "bf_fused_hopper_bwd": [_I] + [_P] * 4 + [_LP] + [_P] * 10 + [_I] * 9 + [_P],
    # head_dim, n, blocks (int out)
    "bf_fused_hopper_resident": [_I, _I, _IP],
    # n
    "bf_lp_norm_splits": [_I],
    # p_dtype, t_dtype, pred, tgt, partial, out, m, n, stream
    "bf_lp_norms_fwd": [_I] * 2 + [_P] * 4 + [_I] * 2 + [_P],
    # p_dtype, t_dtype, pred, tgt, coef, dpred, m, n, stream
    "bf_lp_norms_bwd": [_I] * 2 + [_P] * 4 + [_I] * 2 + [_P],
    # head_dim, x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout, bout,
    # bias_x, bias_y, scale, stats1, qkv, ao, ao_r, stats2, out, BT, H, W, C,
    # heads, stream (float32)
    "bf_axial_block_mega_fwd": [_I] + [_P] * 19 + [_I] * 5 + [_P],
    # head_dim, x, do, qkv, in1_w, in1_b, wqkv_t, ln, in2_w, in2_b, wout_t,
    # bias_x, bias_y, scale, stats1, ao_r, stats2, work, sums, dao, dqkv, dacc,
    # lstats, part, groups_r, per_r, groups_c, per_c, dx, din1, dwqkv, dbqkv,
    # dln, din2, dwout, dbout, dbias_x, dbias_y, dscale, BT, H, W, C, heads,
    # stream (float32)
    "bf_axial_block_mega_bwd": [_I] + [_P] * 23 + [_I] * 4 + [_P] * 11 + [_I] * 5 + [_P],
    # head_dim, x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout, bout,
    # bias_x, bias_y, scale, stats1, qkv, ao, ao_r, stats2, xs, out, BT, H, W,
    # C, heads, stream (bf16)
    "bf_mega_hopper_fwd": [_I] + [_P] * 20 + [_I] * 5 + [_P],
    # head_dim, x, do, qkv, in1_w, in1_b, wqkv_t, ln, in2_w, in2_b, wout_t,
    # bias_x, bias_y, scale, stats1, ao_r, stats2, work, sums, dao, dqkv, dacc,
    # xs, part_w, bounds_out, splits_out, bounds_qkv, splits_qkv, lane_part,
    # groups_r, per_r, groups_c, per_c, dx, din1, dwqkv, dbqkv, dln, din2,
    # dwout, dbout, dbias_x, dbias_y, dscale, BT, H, W, C, heads, stream (bf16)
    "bf_mega_hopper_bwd": [_I] + [_P] * 23 + [_IP, _I, _IP, _I, _P] + [_I] * 4 + [_P] * 11
    + [_I] * 5 + [_P],
    # head_dim, x, wqkv, bqkv, ln, bias_x, bias_y, scale, qkv, row_out, out,
    # BT, H, W, C, heads, stream (float32)
    "bf_axial_lane_px_fwd": [_I] + [_P] * 10 + [_I] * 5 + [_P],
    # head_dim, x, dout, wqkv, wqkv_t, bqkv, ln, bias_x, bias_y, scale, qkv,
    # dqkv, stats, part, groups_r, per_r, groups_c, per_c, dx, dwqkv, dbqkv,
    # dln, dbias_x, dbias_y, dscale, BT, H, W, C, heads, stream (float32)
    "bf_axial_lane_px_bwd": [_I] + [_P] * 13 + [_I] * 4 + [_P] * 7 + [_I] * 5 + [_P],
    # head_dim, x, wqkv, bqkv, ln, bias_x, bias_y, scale, qkv, row_out, out,
    # BT, H, W, C, heads, stream (bf16)
    "bf_lane_px_hopper_fwd": [_I] + [_P] * 10 + [_I] * 5 + [_P],
    # head_dim, x, dout, wqkv, wqkv_t, bqkv, ln, bias_x, bias_y, scale, qkv,
    # dqkv2, sums, part_w, bounds, splits, lane_part, groups_r, per_r,
    # groups_c, per_c, dx, dwqkv, dbqkv, dln, dbias_x, dbias_y, dscale, BT, H,
    # W, C, heads, stream (bf16)
    "bf_lane_px_hopper_bwd": [_I] + [_P] * 13 + [_IP, _I, _P] + [_I] * 4 + [_P] * 7 + [_I] * 5
    + [_P],
    # The probes' kernels (probes/, csrc/probe_*.cu).
    # desc (a packed RollDesc), x, out, stream
    "bf_probe_within_roll": [_P] * 4,
    # q, kv, bx, by, sc, row_out, out, BT, H, W, C, heads, scaling, stream
    # (float32)
    "bf_probe_lane_core": [_P] * 7 + [_I] * 5 + [_F, _P],
    # head_dim, q, kv, bx, by, sc, row_out, out, BT, H, W, C, heads, stream
    # (bf16)
    "bf_probe_lane_core_hopper": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, q_fs, kv_fs, ld, bias, mblk, sc, sc_col, scaling, s_out, out,
    # out_bf16, out_fs, out_ld, frames, heads, d, nchunks, ch, stream
    "bf_probe_chunk_attention": [_P] * 3 + [_L] * 2 + [_I] + [_P] * 3 + [_I, _F] + [_P] * 2
    + [_I, _L] + [_I] * 6 + [_P],
    # x, p, transpose_p, addend, out, rows, n, stream
    "bf_probe_perm_product": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 2 + [_P],
    # (none): the most input channels the stage takes
    "bf_probe_stage_max_channels": [],
    # y, mean, inv, k, out, partial, mu, var, bt, H, W, C, F, bx, by, stream
    "bf_probe_stage": [_P] * 8 + [_I] * 7 + [_P],
    # desc (a packed CopyDesc), src, dst, stream
    "bf_probe_view_copy": [_P] * 4,
    # dtype, a, rows, cols, row_stride, col_stride, vec, out, stream
    "bf_probe_gram": [_I, _P, _I, _I, _L, _L, _I, _P, _P],
    # dtype, a, shape, stride, ndim, out, stream
    "bf_probe_gram_view": [_I, _P, _LP, _LP, _I, _P, _P],
    # x, out, shape, stride, axis, chunk, accumulate, stream (float32)
    "bf_probe_chunk_gram": [_P, _P, _LP, _LP] + [_I] * 3 + [_P],
    # head_dim, x, out, shape, stride, axis, chunk, accumulate, stream (bf16)
    "bf_probe_chunk_gram_hopper": [_I, _P, _P, _LP, _LP] + [_I] * 3 + [_P],
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
    Processes that build at once take turns (``_lock.py``): the first
    builds, the others find its library.

    The compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    with build_lock(so):
        if not so.exists():
            _compile(so)
    return so


def _compile(so: Path) -> None:
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


def check_tma(what: str, **tensors) -> None:
    """Raise unless each named tensor can be a source of the Hopper GEMM's
    TMA loads (or of the 16-byte vector loads beside them): contiguous, its
    base 16-byte aligned and its rows a multiple of 16 bytes."""
    for name, t in tensors.items():
        if t.is_contiguous() and not t.data_ptr() % 16 and not t.shape[-1] * t.element_size() % 16:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} of shape {tuple(t.shape)} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} starts at {t.data_ptr():#x}, which is not "
                             "16-byte aligned (TMA needs it)")
        raise ValueError(f"{what}: {name} has rows of {t.shape[-1] * t.element_size()} "
                         "bytes, not a multiple of 16 (TMA needs it)")


def in_place_strides(what: str, **tensors) -> list:
    """Raise unless each named ``(BT, H, W, heads, d)`` tensor can be read in
    place by 16-byte loads, as the bf16 kernels of K6 and K7 read q, k, v
    and the output gradient: its last dim contiguous, its base 16-byte
    aligned, its tokens one fixed stride apart over (BT, H, W), and its
    token and head strides multiples of 16 bytes.  Returns each tensor's
    ``(token stride, head stride)`` in elements, in the order given, as one
    list."""
    out = []
    for name, t in tensors.items():
        bt, h, w, heads, d = t.shape
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} of shape {tuple(t.shape)} and strides {t.stride()} "
                             "is not contiguous in its last dim")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} starts at {t.data_ptr():#x}, which is not "
                             "16-byte aligned (its 16-byte loads need it)")
        try:
            flat = t.view(bt * h * w, heads, d)
        except RuntimeError:
            raise ValueError(f"{what}: {name} of shape {tuple(t.shape)} and strides {t.stride()} "
                             "has no one token stride over (BT, H, W)") from None
        strides = [flat.stride(0), flat.stride(1)]
        if any(s < 0 or s * t.element_size() % 16 for s in strides):
            raise ValueError(f"{what}: {name}'s token and head strides {tuple(strides)} (elements) "
                             "are not multiples of 16 bytes (its 16-byte loads need them)")
        out += strides
    return out


def int32_array(values) -> ctypes.Array:
    """A host array of int32, as the C entries take split-K token bounds."""
    values = list(values)
    return (ctypes.c_int * len(values))(*values)


def int64_array(values) -> ctypes.Array:
    """A host array of int64, as the C entries take shapes and strides."""
    values = list(values)
    return (ctypes.c_longlong * len(values))(*values)


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C entries take it
    (read without making a ``torch.cuda.Stream``, as Triton's launcher
    reads it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
