"""LoRA finetuning of the DiT (port of ``vavae_tpu/train/lora_trainer.py``).

Only the adapters train; the base weights are the model's own parameters,
frozen (``requires_grad`` off) and never written. Every step merges
``W + (α/r)·A·B`` into the targeted weights and runs the model on the
merged weights (``swapped_weights``: a functional call whose swap also
spans the backward, where remat runs the blocks' forward again), so the
forward is the DiT's own (both attention kernels on the card) and the
gradients reach A and B through the merged weights, as the JAX step
differentiates through ``merge_lora`` inside its loss.

The optimizer is the JAX package's ``optax.multi_transform``: ``alpha``
rides in the adapter tree frozen, so ``clip_by_global_norm`` (when
``max_grad_norm`` is set) and AdamW (b1 0.9, b2 0.999, eps 1e-8, the
trainer's ``weight_decay``) see A and B only; the fp32 EMA at
``ema_decay`` runs over the whole tree, ``alpha`` included. Each step draws
t, x0 and the label dropout from a generator seeded from
``(global_seed, step)``, at the global batch's shape.

Data-parallel (``mesh``): each rank steps on its rows of the global batch
and takes its rows of the draws; the adapters' gradients and the losses
are averaged over the ranks (one flat fp32 all-reduce) before the norm,
so clipping reads the global gradient, as the JAX step on its sharded
batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vavae_tpu_torch.models.dit import LightningDiT
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.parallel.mesh import DP, Mesh
from vavae_tpu_torch.train.dit_trainer import (
    AdamState,
    adam_init,
    adamw_update,
    clip_by_global_norm,
    global_draws,
    global_norm,
    rank_rows,
    step_seed,
)
from vavae_tpu_torch.train.ema import update_ema
from vavae_tpu_torch.train.lora import (
    DEFAULT_TARGETS,
    Adapters,
    init_lora,
    merge_lora,
    swapped_weights,
)
from vavae_tpu_torch.transport.transport import Transport

ADAM_B2 = 0.999  # optax.adamw's default, which the JAX trainer keeps


@dataclasses.dataclass
class LoRAState:
    step: int
    lora: Adapters       # updated in place
    ema_lora: Adapters   # fp32
    opt: AdamState       # over ``trainable(lora)``


def trainable(lora: Adapters) -> list[torch.Tensor]:
    """The leaves the optimizer moves: A and B of each adapter, in order."""
    return [ad[k] for ad in lora.values() for k in ("a", "b")]


def leaves(lora: Adapters) -> list[torch.Tensor]:
    return [ad[k] for ad in lora.values() for k in ("a", "b", "alpha")]


@dataclasses.dataclass
class LoRATrainer:
    model: LightningDiT
    transport: Transport
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = DEFAULT_TARGETS
    lr: float = 1e-4
    weight_decay: float = 0.0
    ema_decay: float = 0.999
    max_grad_norm: Optional[float] = None
    global_seed: int = 0
    # data-parallel processes (parallel/mesh.py); None: one process
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mesh is not None and self.mesh.size(DP) != self.mesh.world:
            raise ValueError(f"LoRA finetuning is data-parallel only, got mesh {self.mesh.shape}")
        self.model.requires_grad_(False)  # the base weights never change
        self.device = next(self.model.parameters()).device

    def base_params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self, generator: Optional[torch.Generator] = None) -> LoRAState:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.global_seed)
        lora = init_lora(self.base_params(), self.rank, self.alpha, self.targets, generator)
        ema = {n: {k: v.clone() for k, v in ad.items()} for n, ad in lora.items()}
        return LoRAState(step=0, lora=lora, ema_lora=ema, opt=adam_init(trainable(lora)))

    @torch.no_grad()
    def merged_params(self, state: LoRAState, ema: bool = True) -> dict[str, torch.Tensor]:
        """Export: the model's full state with the (EMA) adapters folded in."""
        sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        sd.update(merge_lora(sd, state.ema_lora if ema else state.lora, self.rank))
        return sd

    def loss_and_grads(self, lora: Adapters, x, y, t, x0, drop, generator=None) -> tuple:
        """(total loss, velocity MSE, gradients of the total for
        ``trainable(lora)``) at the given draws: the model's loss on the
        merged weights, forward and backward under the same swap."""
        params = trainable(lora)
        for p in params:
            p.requires_grad_(True)
        try:
            merged = merge_lora(self.base_params(), lora, self.rank)
            with swapped_weights(self.model, merged):
                terms = self.transport.losses_at(
                    lambda xt, tt: self.model(xt, tt, y, train=True, force_drop_ids=drop,
                                              generator=generator),
                    t, x0.to(x.dtype), x)
                mse = terms["loss"].mean()
                total = mse + terms["cos_loss"].mean() if "cos_loss" in terms else mse
                grads = list(torch.autograd.grad(total, params))
        finally:
            for p in params:
                p.requires_grad_(False)
        return total.detach(), mse.detach(), grads

    def train_step(self, state: LoRAState, batch, draws=None) -> dict:
        """One step on ``batch`` = (x NHWC, y labels), this data rank's rows
        of the global batch, updating ``state`` in place. ``draws`` = (t, x0,
        drop_mask or None) at the global batch's shape replaces the step's
        own draws (tests hand in the JAX draws). Returns {"loss",
        "total_loss", "grad_norm"} of the global batch, as tensors."""
        x, y = (torch.as_tensor(a, device=self.device) for a in batch)
        y = y.long()
        n_dp, i_dp = (self.mesh.size(DP), self.mesh.index(DP)) if self.mesh else (1, 0)
        b = x.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(
            step_seed(self.global_seed, state.step))
        if draws is None:
            draws = global_draws(self.model, self.transport, b * n_dp, x.shape[1:], gen)
        t, x0, drop = rank_rows(draws, i_dp, b, self.device)
        params = trainable(state.lora)
        total, mse, grads = self.loss_and_grads(state.lora, x, y, t, x0, drop, gen)
        if self.mesh is not None and self.mesh.distributed:
            total, mse = total.clone(), mse.clone()
            mesh_lib.all_reduce_mean_(grads + [total, mse], self.mesh.group(DP))
        grad_norm = global_norm(grads)
        if self.max_grad_norm:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        adamw_update(params, grads, state.opt, self.lr, ADAM_B2, self.weight_decay)
        update_ema(leaves(state.ema_lora), leaves(state.lora), self.ema_decay)
        state.step += 1
        return {"loss": mse, "total_loss": total, "grad_norm": grad_norm}
