"""The Hopper GEMM of K1's and K3's products (``csrc/hopper_gemm.cuh``), on
its own.

K1 and K3 (:mod:`bubbleformer_tpu_torch.ops.temporal_block_mega`) launch the
GEMM from their C entries; this module exposes it to the tests and
measurements, and holds the split-K plan of their weight gradients, which
the wrappers compute on the host and hand to the kernel:

* :func:`gemm_nt`: ``a (M, K) @ b (N, K)^T`` in bf16 with a float32
  accumulator, stored in float32 or rounded to bf16, with or without a
  float32 bias added first;
* :func:`gemm_tn`: ``d (R, M)^T @ s (R, N)`` over R tokens in float32, split
  over token ranges (:func:`split_k_plan`) whose partial products are added
  in range order, so the sum repeats bit for bit.

On CPU tensors both take their plain versions (:func:`gemm_nt_plain`,
:func:`gemm_tn_plain`); on CUDA tensors they launch the kernel, count
``gemm_nt.launches`` / ``gemm_tn.launches``, and raise on what the kernel
does not take (16-byte alignment of every base and row, N a multiple of 8).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from bubbleformer_tpu_torch import _build

BLOCK_K = 64  # tokens per pipeline stage (csrc/hopper_gemm.cuh: kBK)
TILE = 128  # output tile rows and columns (kBM, kBN)
MAX_SPLITS = 64  # kMaxSplits
# Blocks to aim a split-K product at: two blocks of the GEMM fit one SM, and
# an H100 SXM has 132.
TARGET_BLOCKS = 2 * 132


def split_k_plan(tokens: int, m: int, n: int, target: int = TARGET_BLOCKS) -> List[int]:
    """Token bounds ``[0, b1, ..., tokens]`` of a split-K weight gradient of
    ``(m, n)`` over ``tokens``: enough ranges that ``ceil(m/128) *
    ceil(n/128)`` output tiles times the ranges come near ``target`` blocks,
    at most :data:`MAX_SPLITS`; every inner bound a multiple of
    :data:`BLOCK_K`, no range empty."""
    if tokens < 1:
        raise ValueError(f"split_k_plan: {tokens} tokens")
    tiles = -(-m // TILE) * -(-n // TILE)
    blocks = -(-tokens // BLOCK_K)
    splits = max(1, min(MAX_SPLITS, blocks, round(target / tiles)))
    per = -(-blocks // splits)  # stages per range
    splits = -(-blocks // per)
    return [min(tokens, z * per * BLOCK_K) for z in range(splits + 1)]


def gemm_nt_plain(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b^T`` of bf16 values accumulated in float32, plus ``bias``, in
    ``out_dtype``."""
    out = a.float() @ b.float().t()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def gemm_tn_plain(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``d^T @ s`` of bf16 values in float32."""
    return d.float().t() @ s.float()


def _check(what, **tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or t.dim() != 2:
            raise ValueError(f"{what}: {name} must be a 2-D bfloat16 CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _build.check_tma(what, **tensors)


def gemm_nt(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a (M, K) @ b (N, K)^T``: float32 (``out_dtype`` float32, no bias),
    or ``bf16(sum + bias)`` (``out_dtype`` bfloat16, a float32 ``bias`` of
    N) or ``bf16(sum)`` (``out_dtype`` bfloat16, no bias: K3's dx)."""
    if a.device.type == "cpu":
        return gemm_nt_plain(a, b, bias, out_dtype)
    _check("gemm_nt", a=a, b=b)
    (m, k), n = a.shape, b.shape[0]
    if b.shape[1] != k or n % 8:
        raise ValueError(f"gemm_nt: a {tuple(a.shape)} and b {tuple(b.shape)} (N a multiple "
                         "of 8)")
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            out_dtype == torch.float32 and bias is not None):
        raise ValueError("gemm_nt: a bfloat16 output with or without a bias, or float32 "
                         "without one")
    bias = None if bias is None else bias.detach().float().contiguous()
    out = torch.empty(m, n, device=a.device, dtype=out_dtype)
    # csrc/hopper_gemm.cuh's epilogues: kBiasRound, kStoreF32, kRound.
    epilogue = 1 if out_dtype == torch.float32 else 0 if bias is not None else 3
    lib = _build.library()
    err = lib.bf_hopper_gemm(0, epilogue, a.data_ptr(), b.data_ptr(),
                             out.data_ptr(), None if bias is None else bias.data_ptr(), None,
                             m, n, k, None, 1, _build.stream_handle(a.device))
    _build.check(lib, err, "bf_hopper_gemm (NT)")
    gemm_nt.launches += 1
    return out


def gemm_tn(d: torch.Tensor, s: torch.Tensor, bounds: Optional[List[int]] = None) -> torch.Tensor:
    """``d (R, M)^T @ s (R, N)`` in float32, split at the token ``bounds``
    (default :func:`split_k_plan`)."""
    if d.device.type == "cpu":
        return gemm_tn_plain(d, s)
    _check("gemm_tn", d=d, s=s)
    (r, m), n = d.shape, s.shape[1]
    if s.shape[0] != r or m % 8 or n % 8:
        raise ValueError(f"gemm_tn: d {tuple(d.shape)} and s {tuple(s.shape)} (M and N "
                         "multiples of 8)")
    bounds = split_k_plan(r, m, n) if bounds is None else list(bounds)
    part = torch.empty(len(bounds) - 1, m, n, device=d.device)
    out = torch.empty(m, n, device=d.device)
    lib = _build.library()
    err = lib.bf_hopper_gemm(1, 2, d.data_ptr(), s.data_ptr(), out.data_ptr(), None,
                             part.data_ptr(), m, n, r, _build.int32_array(bounds),
                             len(bounds) - 1, _build.stream_handle(d.device))
    _build.check(lib, err, "bf_hopper_gemm (TN)")
    gemm_tn.launches += 1
    return out


gemm_nt.launches = 0
gemm_tn.launches = 0
