"""Tensor parallelism of the DiT blocks (the JAX trainer's placement rules,
``vavae_tpu/train/dit_trainer.py:132-146``, written out by hand).

Megatron's split: the fan-out projections are column-parallel (``qkv``,
``w12``, ``fc1``: each rank holds some output rows) and the fan-in ones
row-parallel (``proj``, ``w3``, ``fc2``: the matching input columns, their
partial products summed over the tensor group before the bias). A
column-parallel layer's input passes ``copy_to_tensor_group`` (the
identity forward, the gradient summed backward); a row-parallel layer's
output passes ``reduce_from_tensor_group`` (the sum forward, the identity
backward). So one block costs two all-reduces forward and two backward.

GSPMD splits ``qkv`` and ``w12`` by plain columns and relayouts silently.
Here the split must follow the port's layouts: ``qkv``'s 3·C outputs are
(3, H, D), so a rank holds q, k and v of its H/T heads and runs the
attention kernels on them as an ordinary (B, N, 3, H/T, D) tensor with
``num_heads`` the local count; ``w12``'s 2·F outputs are (gate, up), so a
rank holds the matching F/T rows of each. The QK-norm weights are shared by
all heads: each rank's gradient covers its own heads, and is summed over
the tensor group (``TensorSplit.partial``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vavae_tpu_torch.models.layers import Linear


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.float().contiguous().clone()  # summed in fp32
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_tensor_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class ColumnParallelLinear(Linear):
    """A ``Linear`` holding some output rows; its input is the replicated
    activation."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(copy_to_tensor_group(x, self.tp_group))


class RowParallelLinear(Linear):
    """A ``Linear`` holding some input columns: the partial products are
    summed over the tensor group, then the (replicated) bias is added."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        y = reduce_from_tensor_group(F.linear(x.to(d), self.weight.to(d)), self.tp_group)
        return y if self.bias is None else y + self.bias.to(d)


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


def _blocks(n: int, size: int, parts: int) -> list[torch.Tensor]:
    """Rank r's indices when ``n`` segments of ``size`` are each cut into
    ``parts`` contiguous pieces."""
    step = size // parts
    return [torch.cat([s * size + torch.arange(r * step, (r + 1) * step) for s in range(n)])
            for r in range(parts)]


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
        if H % tensor:
            raise ValueError(f"{H} heads do not split over tensor={tensor}")
        C = H * D
        qkv_idx = _blocks(3, C, tensor)       # q, k, v of each rank's heads
        col_idx = _blocks(1, C, tensor)
        splits[pre + "attn.qkv.weight"] = TensorSplit(0, qkv_idx)
        splits[pre + "attn.qkv.bias"] = TensorSplit(0, qkv_idx)
        splits[pre + "attn.proj.weight"] = TensorSplit(1, col_idx)
        _swap(attn.qkv, ColumnParallelLinear, group, 0, qkv_idx[rank])
        _swap(attn.proj, RowParallelLinear, group, 1, col_idx[rank])
        attn.num_heads = H // tensor
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
        if hidden % tensor:
            raise ValueError(f"MLP width {hidden} does not split over tensor={tensor}")
        out_idx = _blocks(n_seg, hidden, tensor)
        in_idx = _blocks(1, hidden, tensor)
        splits[f"{pre}{names[0]}.weight"] = TensorSplit(0, out_idx)
        splits[f"{pre}{names[0]}.bias"] = TensorSplit(0, out_idx)
        splits[f"{pre}{names[1]}.weight"] = TensorSplit(1, in_idx)
        _swap(fan_out, ColumnParallelLinear, group, 0, out_idx[rank])
        _swap(fan_in, RowParallelLinear, group, 1, in_idx[rank])
    return splits
