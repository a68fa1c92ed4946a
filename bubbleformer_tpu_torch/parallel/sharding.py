"""Tensor parallelism over the mesh's ``model`` axis (``mesh_cfg=dp_tp``).

Counterpart of ``bubbleformer_tpu/parallel/sharding.py``: Megatron-style
head and width sharding of the attention blocks and the MLPs, by module
name.

* Column-parallel (:data:`COLUMN_PARALLEL`, ``input_head`` and ``fc1``): the
  output features are split across the model ranks.  In torch's ``(out,
  in[, 1, 1])`` layout that is dim 0 of the weight, and the bias with it.
  The QKV features are laid out heads-major, ``(heads, 3, d)``
  (``layers/attention.py``), so a rank's rows of ``input_head`` are whole
  heads: ``heads / m`` of them.
* Row-parallel (:data:`ROW_PARALLEL`, ``output_head`` and ``fc2``): the
  input features are split, dim 1 of the weight; the bias is not sharded.
  Each rank computes a float32 partial product; the bias enters on model
  rank 0 alone (:func:`rank0_bias`), before :func:`reduce_from_model` sums
  the partials; the sum is cast once to the activation dtype.
* Everything else is replicated, held whole on every rank.  The JAX
  package's suffix rule would also shard the continuous bias's
  ``cpb_mlp`` (its flax ``fc1``/``fc2``); the port keeps that MLP
  replicated and slices its output's heads: a placement that differs, the
  same numbers.

Every rank builds the full model from the seed (or loads whole weights),
then keeps its slices (:func:`shard_model`), so a shard equals the one
process's slice bit for bit and flax's init distributions carry over.

The two differentiable operators over the model group, the Megatron pair:
:func:`copy_to_model` (identity forward, all-reduce of the gradient
backward) on each branch's input after any norm kept outside the kernel,
and :func:`reduce_from_model` (all-reduce forward, identity backward) after
each row-parallel product; both reduce in float32.  Under remat ``"dots"``
the reduce's output goes on the tape (``layers/remat.py:reuse``), so a
block's rerun issues no collective; under ``"full"`` the rerun issues the
same collectives in the same order on every rank.

Classes of replicated parameters, by where a block uses them:

* **Full gradient**: used only on replicated activations (FiLM, the
  embed/debed pyramid, ``norm1`` outside the kernel, ``mlp_norm``,
  ``gamma_att``, ``gamma_mlp``, the feat-scale scalars; ``gamma`` on the
  temporal ``core`` route).  Every model rank computes the same gradient;
  it is never summed over the model group.
* **Partial gradient** (:func:`partial_gradient_parameters`): used inside
  the sharded region, so each rank holds its heads' share of the gradient,
  to be **summed over the model group** (one bucketed all-reduce after the
  backward, ``training/module.py``): K1's fused ``norm1``, ``qnorm`` and
  ``knorm`` (one LayerNorm over ``d`` shared by all heads), the bias module
  (the T5 embedding's head columns, or the continuous MLP), the
  ``attn_scale_factor*`` scalars, ``norm2`` (held whole, sliced per rank),
  the row-parallel biases (rank 0's alone), and ``gamma`` of the temporal
  ``mega`` route, which K1 folds into the sharded ``wout`` and into the
  bias.

Checkpoints are whole: :func:`gather_full_state` and :func:`shard_state`
move a state dict between the one-process format and a rank's slices, on
CPU copies over the gloo twin of the model group (gloo's CUDA support is
sure only for broadcast and all-reduce).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from bubbleformer_tpu_torch.layers import remat
from bubbleformer_tpu_torch.layers.linear import linear
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype

COLUMN_PARALLEL = ("input_head", "fc1")
ROW_PARALLEL = ("output_head", "fc2")


@dataclass(frozen=True)
class ModelShard:
    """A rank's place in its model group: ``rank`` of ``size``, and
    ``all_reduce``, which sums a tensor in place over the group.  Tests that
    run the ranks of a group in one process pass their own ``all_reduce``;
    :func:`model_shard` makes one over a mesh's ``model_group``.
    ``host_group``: the group's gloo twin (checkpoint gathers)."""

    rank: int
    size: int
    all_reduce: Callable[[torch.Tensor], None]
    host_group: Any = None

    def part(self, n: int) -> slice:
        """The rank's run of ``n`` features split ``size`` ways."""
        if n % self.size:
            raise ValueError(f"mesh_cfg: {n} features do not split over model={self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def model_shard(mesh) -> Optional[ModelShard]:
    """The :class:`ModelShard` of a mesh with ``model > 1``; None for one
    model rank."""
    if mesh.model == 1:
        return None
    group = mesh.model_group

    def all_reduce(t: torch.Tensor) -> None:
        dist.all_reduce(t, group=group)

    return ModelShard(mesh.model_rank, mesh.model, all_reduce, mesh.model_host_group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group
    (each rank's heads give its share of the gradient of a replicated
    input) in float32 (float64 for float64), rounded once to the gradient's
    dtype."""

    @staticmethod
    def forward(ctx, shard, x):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.to(accumulation_dtype(grad.dtype)).contiguous().clone()
        ctx.shard.all_reduce(out)
        return None, out.to(grad.dtype)


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the ranks' partials forward; the identity backward."""

    @staticmethod
    def forward(ctx, shard, x):
        def run():
            out = x.contiguous().clone()
            shard.all_reduce(out)
            return out

        return remat.reuse(run, site=_ReduceFromModel)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x``, whose gradient is summed over the model group."""
    return _CopyToModel.apply(shard, x)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` summed over the model group; the gradient passes through."""
    return _ReduceFromModel.apply(shard, x)


def rank0_bias(bias: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A row-parallel bias as it enters a rank's partial: whole on model rank
    0, zero elsewhere (multiplied by 0, so that every rank's graph reaches
    it and DDP sees a gradient, zero, on every rank)."""
    return bias * (1.0 if shard.rank == 0 else 0.0)


def row_parallel_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                       dtype: Optional[torch.dtype], shard: ModelShard) -> torch.Tensor:
    """The row-parallel counterpart of ``layers/linear.py:dense``: ``x``
    ``(..., I / m)`` by the rank's ``weight`` ``(O, I / m)``, both rounded to
    the compute dtype, accumulated in float32 (float64 for float64), the
    bias added on model rank 0, the partials summed over the model group,
    and the sum cast once to the compute dtype."""
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    acc = accumulation_dtype(dt)
    part = linear(x.to(dt).to(acc), weight.to(dt).to(acc), None)
    if bias is not None:
        part = part + rank0_bias(bias.to(dt).to(acc), shard)
    return reduce_from_model(part, shard).to(dt)


def shard_dim(name: str) -> Optional[int]:
    """The dim of a parameter (by its state-dict name) that tensor
    parallelism splits: 0 for a column-parallel weight or bias, 1 for a
    row-parallel weight, None for anything replicated."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in COLUMN_PARALLEL:
        return 0
    if module in ROW_PARALLEL and leaf == "weight":
        return 1
    return None


def shard_parameters(module: torch.nn.Module, shard: ModelShard) -> None:
    """Replace the parameters of ``module``'s children named in
    :data:`COLUMN_PARALLEL` and :data:`ROW_PARALLEL` by the rank's slices."""
    for child_name in COLUMN_PARALLEL + ROW_PARALLEL:
        child = getattr(module, child_name, None)
        if child is None:
            continue
        for leaf, p in list(child.named_parameters(recurse=False)):
            dim = shard_dim(f"{child_name}.{leaf}")
            if dim is not None:
                kept = p.detach().narrow(dim, shard.part(p.shape[dim]).start,
                                         p.shape[dim] // shard.size)
                setattr(child, leaf, torch.nn.Parameter(kept.clone(),
                                                        requires_grad=p.requires_grad))


def sharded_modules(model: torch.nn.Module) -> List[torch.nn.Module]:
    """The modules that tensor parallelism shards (those with a
    ``model_shard`` attribute: the attention blocks and ``GeluMLP``)."""
    return [m for m in model.modules() if hasattr(m, "model_shard")]


def shard_model(model: torch.nn.Module, shard: ModelShard) -> torch.nn.Module:
    """Keep the rank's slices of every column- and row-parallel layer of
    ``model`` and hand each sharded module its :class:`ModelShard`; an
    attention block whose heads do not split raises ``ValueError`` naming
    ``mesh_cfg``.  A model without such modules (the U-Nets) is left whole:
    its model ranks compute the same step.  Returns ``model``."""
    for m in sharded_modules(model):
        heads = getattr(m, "num_heads", None)
        if heads is not None and heads % shard.size:
            raise ValueError(f"mesh_cfg: num_heads={heads} does not split over "
                             f"model={shard.size}")
    for m in sharded_modules(model):
        shard_parameters(m, shard)
        m.model_shard = shard
    return model


def partial_gradient_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The partial-gradient class of a sharded ``model`` (module docstring),
    each once, in module order: what each sharded module's last forward
    used inside its sharded region (``partial_gradient_parameters()`` of the
    blocks and the MLP)."""
    seen, out = set(), []
    for m in sharded_modules(model):
        if m.model_shard is None:
            continue
        for p in m.partial_gradient_parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def all_reduce_partial_gradients(model: torch.nn.Module, shard: ModelShard) -> int:
    """Sum the partial-gradient class's gradients over the model group in
    one bucket (a parameter without a gradient contributes zeros); returns
    the number of elements reduced."""
    params = partial_gradient_parameters(model)
    if not params:
        return 0
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).to(accumulation_dtype(g.dtype)) for g in grads])
    shard.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n
    return offset


def shard_state(state: Dict[str, torch.Tensor], shard: ModelShard) -> Dict[str, torch.Tensor]:
    """A whole (one-process) state dict's slices for ``shard``'s rank."""
    out = {}
    for k, v in state.items():
        dim = shard_dim(k)
        out[k] = v if dim is None else v.narrow(dim, shard.part(v.shape[dim]).start,
                                                v.shape[dim] // shard.size).clone()
    return out


def _gather(t: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.host_group)
    return torch.cat(parts, dim=dim)


def gather_full_state(state: Dict[str, torch.Tensor],
                      shard: ModelShard) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's slices (``state`` this rank's):
    the sharded entries gathered over the model group's gloo twin, on CPU
    copies, in rank order.  Every model rank calls it; all get the result."""
    return {k: (v.detach().cpu() if shard_dim(k) is None
                else _gather(v.detach().cpu(), shard_dim(k), shard)) for k, v in state.items()}


def _map_optimizer_state(optimizer_state: dict, names: List[str], fn) -> dict:
    """``optimizer_state`` with each per-parameter tensor of a sharded
    parameter (one of the parameter's own rank, such as Lion's ``exp_avg``
    or AdamW's moments) replaced by ``fn(tensor, dim)``; ``names`` are the
    parameters' in the order of ``model.named_parameters()``, which the
    optimizer's indices follow."""
    index = [i for group in optimizer_state["param_groups"] for i in group["params"]]
    by_index = dict(zip(index, names))
    state = {}
    for i, entry in optimizer_state["state"].items():
        dim = shard_dim(by_index[i])
        state[i] = {k: (fn(v, dim) if dim is not None and torch.is_tensor(v) and v.ndim > dim
                        else v) for k, v in entry.items()}
    return {"state": state, "param_groups": optimizer_state["param_groups"]}


def gather_optimizer_state(optimizer_state: dict, names: List[str],
                           shard: ModelShard) -> dict:
    """The one-process optimizer state dict from every rank's (``names``:
    the model's parameter names in order); every model rank calls it."""
    return _map_optimizer_state(
        optimizer_state, names,
        lambda v, dim: _gather(v.detach().cpu(), dim, shard))


def shard_optimizer_state(optimizer_state: dict, names: List[str],
                          shard: ModelShard) -> dict:
    """A one-process optimizer state dict's slices for ``shard``'s rank."""
    return _map_optimizer_state(
        optimizer_state, names,
        lambda v, dim: v.narrow(dim, shard.part(v.shape[dim]).start,
                                v.shape[dim] // shard.size).clone())
