"""K10: the training criterion's plane norms, forward and backward.

Counterpart of ``bubbleformer_tpu/ops/lp_loss.py``: the reference training
criterion ``LpLoss(d=2, p=2, reduce_dims=[0, 1, 2], reductions=["mean",
"mean", "sum"])`` on ``(B, T, C, H, W)`` tensors, computed from the per-plane
sums ``(sum (p - t)^2, sum t^2)`` over ``(H, W)`` of each of the ``B*T*C``
planes, in float32 (``_norms_kernel :31``); the relative L2
``sqrt(d2) / max(sqrt(t2), 1e-30)`` and the mean/mean/sum reductions stay
plain PyTorch, as they stayed XLA (``:133-147``).  The backward of the sums
is ``dpred = dtype(2 g_d2 (p - t))`` (``_dpred_kernel :44``); the target
gets no gradient.

:func:`plane_norms` is a ``torch.autograd.Function``.  On CUDA tensors its
forward and backward launch ``csrc/lp_loss.cu`` (the partial sums of each
plane added in a fixed order, so the loss repeats bit for bit); on CPU
tensors :func:`plane_norms_plain` and :func:`plane_norms_bwd_plain`; on any
other device they raise.  ``training/module.py`` takes this path under
``BUBBLEFORMER_LOSS_KERNEL=1`` for predictions on the card, as the JAX module
takes its kernel on a TPU.
"""
from __future__ import annotations

import torch

from bubbleformer_tpu_torch import _build

MAX_PLANES = 65535  # B*T*C planes a launch takes (one grid row each)


def plane_norms_plain(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10's forward: ``(m, 2)`` float32 =
    ``(sum (p - t)^2, sum t^2)`` over each row of ``(m, n)`` pred and
    target."""
    t = tgt.float()
    d = pred.float() - t
    return torch.stack([(d * d).sum(dim=-1), (t * t).sum(dim=-1)], dim=-1)


def plane_norms_bwd_plain(pred: torch.Tensor, tgt: torch.Tensor,
                          coef: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10's backward: ``dtype(coef (p - t))`` per
    row, ``coef`` ``(m,)`` float32 (``2 g_d2``)."""
    return (coef[:, None] * (pred.float() - tgt.float())).to(pred.dtype)


def _check(what, pred, tgt):
    m = pred.shape[0]
    _build.check_shapes(what, tgt=(tgt, pred.shape))
    if pred.dtype not in _build.DTYPE_CODES or tgt.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not {pred.dtype}, {tgt.dtype}")
    if m > MAX_PLANES or pred.shape[1] >= 2**31:
        raise ValueError(f"{what} kernel takes at most {MAX_PLANES} planes of fewer than 2^31 "
                         f"values; got {tuple(pred.shape)}")


def plane_norms_fwd_cuda(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/lp_loss.cu``'s forward on ``(m, n)`` pred and target."""
    what = "plane_norms"
    _check(what, pred, tgt)
    m, n = pred.shape
    dev = pred.device
    pred, tgt = pred.contiguous(), tgt.contiguous()
    lib = _build.library()
    partial = torch.empty(m, lib.bf_lp_norm_splits(n), 2, device=dev)
    out = torch.empty(m, 2, device=dev)
    err = lib.bf_lp_norms_fwd(_build.DTYPE_CODES[pred.dtype], _build.DTYPE_CODES[tgt.dtype],
                              pred.data_ptr(), tgt.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), m, n, _build.stream_handle(dev))
    _build.check(lib, err, f"{what} (bf_lp_norms_fwd)")
    return out


def plane_norms_bwd_cuda(pred: torch.Tensor, tgt: torch.Tensor,
                         coef: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/lp_loss.cu``'s backward: ``dtype(coef (p - t))``."""
    what = "plane_norms_bwd"
    _check(what, pred, tgt)
    m, n = pred.shape
    dev = pred.device
    pred, tgt = pred.contiguous(), tgt.contiguous()
    coef = coef.to(device=dev, dtype=torch.float32).contiguous()
    _build.check_shapes(what, coef=(coef, (m,)))
    dpred = torch.empty_like(pred)
    lib = _build.library()
    err = lib.bf_lp_norms_bwd(_build.DTYPE_CODES[pred.dtype], _build.DTYPE_CODES[tgt.dtype],
                              pred.data_ptr(), tgt.data_ptr(), coef.data_ptr(),
                              dpred.data_ptr(), m, n, _build.stream_handle(dev))
    _build.check(lib, err, f"{what} (bf_lp_norms_bwd)")
    return dpred


def plane_norms_bwd(pred: torch.Tensor, tgt: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """K10's backward, ``dtype(coef (p - t))``: CPU tensors take
    :func:`plane_norms_bwd_plain`; CUDA tensors launch ``csrc/lp_loss.cu``
    and count ``plane_norms_bwd.launches``."""
    if pred.device.type == "cpu":
        return plane_norms_bwd_plain(pred, tgt, coef)
    if pred.device.type != "cuda":
        raise ValueError(f"plane_norms_bwd: unsupported device {pred.device}")
    dpred = plane_norms_bwd_cuda(pred, tgt, coef)
    plane_norms_bwd.launches += 1
    return dpred


class _PlaneNorms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, tgt):
        ctx.save_for_backward(pred, tgt)
        if pred.device.type == "cpu":
            return plane_norms_plain(pred, tgt)
        if pred.device.type != "cuda":
            raise ValueError(f"plane_norms: unsupported device {pred.device}")
        out = plane_norms_fwd_cuda(pred, tgt)
        plane_norms.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        pred, tgt = ctx.saved_tensors
        # The epilogue differentiates the (d2, t2) rows: dp = 2 g_d2 (p - t).
        return plane_norms_bwd(pred, tgt, 2.0 * g[:, 0].float()), None


def plane_norms(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``(m, 2)`` float32 ``(sum (p - t)^2, sum t^2)`` per row of ``(m, n)``
    pred and target (float32 or bfloat16), differentiable in ``pred``.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels
    (``plane_norms.launches`` and ``plane_norms_bwd.launches`` count them)."""
    return _PlaneNorms.apply(pred, tgt)


plane_norms.launches = 0
plane_norms_bwd.launches = 0


def relative_l2_planes(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Per-(B, T, C) relative L2 over (H, W): ``(B, T, C)`` float32, from
    ``(B, T, C, H, W)`` pred and target: ``sqrt(sum (p - t)^2) / max(sqrt(sum
    t^2), 1e-30)`` (``bubbleformer_tpu/ops/lp_loss.py:98``)."""
    b, t, c, h, w = pred.shape
    out = plane_norms(pred.reshape(b * t * c, h * w), tgt.reshape(b * t * c, h * w))
    rel = torch.sqrt(out[:, 0]) / torch.clamp(torch.sqrt(out[:, 1]), min=1e-30)
    return rel.reshape(b, t, c)


def training_lp_loss(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """The training criterion on ``(B, T, C, H, W)`` tensors through K10:
    ``LpLoss(d=2, p=2, reduce_dims=[0, 1, 2], reductions=[mean, mean,
    sum])`` (``bubbleformer_tpu/ops/lp_loss.py:142``)."""
    return relative_l2_planes(pred, tgt).mean(dim=(0, 1)).sum()
