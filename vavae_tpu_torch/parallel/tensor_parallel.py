"""Tensor parallelism of the DiT blocks (the JAX trainer's placement rules,
``vavae_tpu/train/dit_trainer.py:132-146``, written out by hand).

Megatron's split: the fan-out projections are column-parallel (``qkv``,
``w12``, ``fc1``: each rank holds some output rows) and the fan-in ones
row-parallel (``proj``, ``w3``, ``fc2``: the matching input columns, their
partial products summed over the tensor group before the bias). A
column-parallel layer's input gradient and a row-parallel layer's output
are sums over the group, so one block costs two all-reduces forward and two
backward. Each rank's part of such a sum is computed in fp32 from the
compute dtype's values and the sum rounded once: bf16 parts, each rounded,
put the losses of a 1p6B/1-width DiT at depth 2 1.3e-4 from one process's
on an H100 (``chip_smoke.py`` phase 33 (c); the limit is 5e-5).

GSPMD splits ``qkv`` and ``w12`` by plain columns and relayouts silently.
Here the split must follow the port's layouts: ``qkv``'s 3·C outputs are
(3, H, D), so a rank holds q, k and v of its heads and runs the attention
kernels on them as an ordinary (B, N, 3, local heads, D) tensor with
``num_heads`` the local count; ``w12``'s 2·F outputs are (gate, up), so a
rank holds the matching rows of each. The QK-norm weights are shared by
all heads: each rank's gradient covers its own heads, and is summed over
the tensor group (``TensorSplit.partial``).

Any tensor size T splits, as the JAX trainer trains any: heads are cut whole
and MLP rows one by one into contiguous pieces whose sizes differ by at
most one, the first ``size % T`` ranks holding one more (1p6B/1's 28 heads
and 4,778 rows at T = 4: 7 heads a rank, rows 1,195, 1,195, 1,194, 1,194).
GSPMD instead replicates a leaf whose dim does not divide T, so the layouts
differ; the arithmetic does not. A rank left with no heads (T above the
head count) runs no attention and adds a zero partial product to ``proj``'s
all-reduce, which it enters as every rank does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vavae_tpu_torch.models.layers import Linear


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.flatten(0, -2)


class _ColumnParallel(torch.autograd.Function):
    """``F.linear(x, weight, bias)`` on this rank's output rows; backward,
    each rank's part of the input's gradient in fp32 (the compute dtype's
    values multiplied exactly, summed in fp32), summed over the group, then
    rounded once: as one card rounds the whole sum once."""

    @staticmethod
    def forward(ctx, x, weight, bias, group):
        ctx.save_for_backward(x, weight)
        ctx.group, ctx.bias = group, bias is not None
        return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = torch.matmul(g.float(), weight.float())
        dist.all_reduce(dx, group=ctx.group)
        dw = _flat(g).t().mm(_flat(x))
        db = _flat(g).sum(0) if ctx.bias else None
        return dx.to(x.dtype), dw, db, None


class _RowParallel(torch.autograd.Function):
    """``F.linear(x, weight)`` on this rank's input columns in fp32 (the
    compute dtype's values multiplied exactly, summed in fp32), summed over
    the group: returned in fp32, for the caller to add the bias and round
    once, as one card's matmul does. The backward is one card's: the input's
    and the weight's gradients in the compute dtype."""

    @staticmethod
    def forward(ctx, x, weight, group):
        ctx.save_for_backward(x, weight)
        # a copy: remat keeps matmul outputs, which the all-reduce must not change
        y = F.linear(x.float(), weight.float()).clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype)
        return g.matmul(weight), _flat(g).t().mm(_flat(x)), None


class ColumnParallelLinear(Linear):
    """A ``Linear`` holding some output rows; its input is the replicated
    activation."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return _ColumnParallel.apply(x.to(d), self.weight.to(d), bias, self.tp_group)


class RowParallelLinear(Linear):
    """A ``Linear`` holding some input columns: the partial products summed
    over the tensor group in fp32, the (replicated) bias added to the sum,
    and the result rounded to the compute dtype once."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        y = _RowParallel.apply(x.to(d), self.weight.to(d), self.tp_group)
        return (y if self.bias is None else y + self.bias.float()).to(d)


@dataclasses.dataclass
class TensorSplit:
    """How one parameter is split over the tensor group: rank r holds
    ``full.index_select(dim, index[r])``. ``partial``: a replicated
    parameter whose gradient each rank sees only in part (summed over the
    group)."""

    dim: int = 0
    index: Optional[list[torch.Tensor]] = None
    partial: bool = False

    @property
    def sharded(self) -> bool:
        return self.index is not None


def pieces(size: int, parts: int) -> list[tuple[int, int]]:
    """[start, stop) of each of ``parts`` contiguous pieces of ``size``
    units: sizes differ by at most one, the first ``size % parts`` pieces
    hold one more."""
    q, r = divmod(size, parts)
    starts = [i * q + min(i, r) for i in range(parts + 1)]
    return list(zip(starts[:-1], starts[1:]))


def _blocks(n: int, size: int, parts: int, unit: int = 1) -> list[torch.Tensor]:
    """Rank r's indices when ``n`` segments of ``size`` units of ``unit``
    elements (heads of D columns, or single rows) are each cut into
    ``parts`` pieces of whole units (``pieces``)."""
    seg = size * unit
    return [torch.cat([s * seg + torch.arange(a * unit, b * unit) for s in range(n)])
            for a, b in pieces(size, parts)]


def _swap(module: nn.Module, cls: type, group, dim: int, idx: torch.Tensor) -> None:
    module.__class__ = cls
    module.tp_group = group
    with torch.no_grad():
        module.weight = nn.Parameter(module.weight.index_select(dim, idx.to(module.weight.device)))
        if cls is ColumnParallelLinear and module.bias is not None:
            module.bias = nn.Parameter(module.bias.index_select(0, idx.to(module.bias.device)))


def parallelize_dit(model: nn.Module, group, tensor: int, rank: int) -> dict[str, TensorSplit]:
    """Split every block of ``model`` (a ``LightningDiT``) over a tensor
    group of ``tensor`` ranks, in place, keeping each parameter's name;
    this process is ``rank`` in the group. Returns the split of every
    parameter that is not plainly replicated, by name."""
    splits: dict[str, TensorSplit] = {}
    for bi, block in enumerate(model.blocks):
        pre = f"blocks.{bi}."
        attn = block.attn
        H, D = attn.num_heads, attn.head_dim
        qkv_idx = _blocks(3, H, tensor, D)    # q, k, v of each rank's heads
        col_idx = _blocks(1, H, tensor, D)
        splits[pre + "attn.qkv.weight"] = TensorSplit(0, qkv_idx)
        splits[pre + "attn.qkv.bias"] = TensorSplit(0, qkv_idx)
        splits[pre + "attn.proj.weight"] = TensorSplit(1, col_idx)
        _swap(attn.qkv, ColumnParallelLinear, group, 0, qkv_idx[rank])
        _swap(attn.proj, RowParallelLinear, group, 1, col_idx[rank])
        start, stop = pieces(H, tensor)[rank]
        attn.num_heads = stop - start
        if attn.qk_norm:
            for norm in ("q_norm", "k_norm"):
                for name, _ in getattr(attn, norm).named_parameters():
                    splits[f"{pre}attn.{norm}.{name}"] = TensorSplit(partial=True)
        mlp = block.mlp
        if hasattr(mlp, "w12"):
            fan_out, fan_in, n_seg = mlp.w12, mlp.w3, 2   # (gate, up) rows
            names = ("mlp.w12", "mlp.w3")
        else:
            fan_out, fan_in, n_seg = mlp.fc1, mlp.fc2, 1
            names = ("mlp.fc1", "mlp.fc2")
        hidden = fan_in.in_features
        out_idx = _blocks(n_seg, hidden, tensor)
        in_idx = _blocks(1, hidden, tensor)
        splits[f"{pre}{names[0]}.weight"] = TensorSplit(0, out_idx)
        splits[f"{pre}{names[0]}.bias"] = TensorSplit(0, out_idx)
        splits[f"{pre}{names[1]}.weight"] = TensorSplit(1, in_idx)
        _swap(fan_out, ColumnParallelLinear, group, 0, out_idx[rank])
        _swap(fan_in, RowParallelLinear, group, 1, in_idx[rank])
    return splits
