"""DiT training on one device (port of ``vavae_tpu/train/dit_trainer.py``).

One ``train_step``: the transport's velocity MSE (+ cosine loss) of the
model under label dropout, its gradient through the model's forward and
backward (both attention kernels on the card, per-block remat as the config
asks), then the optax chain of the JAX package written out as plain
functions over the parameter list: ``clip_by_global_norm`` → AdamW (b1 0.9,
eps 1e-8, decoupled weight decay, optax's bias correction, optional bf16
first moment) with a constant or warmup-cosine learning rate, under
``MultiSteps`` gradient accumulation; then the fp32 EMA every
``ema_every``-th optimizer step with decay^ema_every.

The JAX step donates its state and returns a new one; here the state is
updated in place (the parameters are the model's own), which holds one copy
of the ~13.5 GB XL/1 train state instead of two.

Randomness: every step draws from a ``torch.Generator`` seeded from
``(global_seed, step)`` (the JAX ``fold_in(rng, step)``), so a resumed run
draws what an unbroken one would. Multi-device data parallelism is not
ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.models.dit import LightningDiT
from vavae_tpu_torch.train.ema import update_ema
from vavae_tpu_torch.transport.transport import Transport

B1, EPS = 0.9, 1e-8  # optax.adamw defaults the JAX trainer keeps


# -- optimizer functions (optax, op for op) -----------------------------------


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (``optax.global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.stack(norms).square().sum())


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``g`` where the global norm is below ``max_norm``, else ``g / norm ·
    max_norm`` (``optax.clip_by_global_norm``; ``clip_grad_norm_`` adds 1e-6)."""
    norm = global_norm(grads)
    if norm.item() < max_norm:
        return grads
    out = torch._foreach_div(grads, norm)
    torch._foreach_mul_(out, max_norm)
    return out


def warmup_cosine_decay(count: int, peak: float, warmup_steps: int, decay_steps: int,
                        end_value: float) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps,
    end_value)`` at ``count``: linear from 0 over the warmup, then a cosine
    down to ``end_value`` at ``decay_steps``."""
    if count < warmup_steps:
        return peak * count / warmup_steps
    alpha = 0.0 if peak == 0.0 else end_value / peak
    span = decay_steps - warmup_steps
    c = min(count - warmup_steps, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
    return peak * ((1.0 - alpha) * cosine + alpha)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]  # first moment, fp32 or the mu dtype
    nu: list[torch.Tensor]  # second moment, fp32


def adam_init(params: list[torch.Tensor], mu_dtype: Optional[torch.dtype] = None) -> AdamState:
    return AdamState(
        count=0,
        mu=[torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


@torch.no_grad()
def adamw_update(params: list[torch.Tensor], grads: list[torch.Tensor], state: AdamState,
                 lr: float, b2: float, weight_decay: float = 0.0, b1: float = B1) -> None:
    """One ``optax.adamw`` step, in place: moments in fp32 (a bf16 first
    moment is widened for the update and stored back), bias correction
    ``1 − b^count`` in fp32, ``u = m̂ / (√v̂ + eps) + wd·p``, ``p += −lr·u``.
    With ``weight_decay`` 0 it is ``optax.adam``."""
    state.count += 1
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(state.count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(state.count))
    widened = state.mu[0].dtype != torch.float32
    if widened:
        # optax's b1·mu stays in mu's dtype, with b1 itself rounded to it
        # (0.9 → 0.8984375 in bf16); the sum with (1 − b1)·g is fp32
        b1_mu = torch.tensor(b1, dtype=state.mu[0].dtype).item()
        mu = [(m * b1_mu).float() for m in state.mu]
    else:
        mu = state.mu
        torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr)
    if widened:
        torch._foreach_copy_(state.mu, mu)


@torch.no_grad()
def accumulate_mean(acc: list[torch.Tensor], grads: list[torch.Tensor], n: int) -> None:
    """``optax.MultiSteps``' running mean: acc += (g − acc) / (n + 1)."""
    diff = torch._foreach_sub(grads, acc)
    torch._foreach_div_(diff, float(n + 1))
    torch._foreach_add_(acc, diff)


# -- trainer ---------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    step: int
    names: list[str]                # the model's parameter names, in order
    params: list[torch.Tensor]      # the model's parameters, updated in place
    ema_params: list[torch.Tensor]  # fp32
    opt: AdamState
    acc_grads: Optional[list[torch.Tensor]] = None  # MultiSteps accumulator
    mini_step: int = 0


def step_seed(global_seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a function of both, as
    ``fold_in(rng, step)``."""
    return int(np.random.SeedSequence([global_seed, step]).generate_state(1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class DiTTrainer:
    model: LightningDiT
    transport: Transport
    lr: float = 2e-4
    beta2: float = 0.95
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None
    ema_decay: float = 0.9999
    # EMA every k optimizer steps with decay**k (config train.ema_every)
    ema_every: int = 1
    # dtype of Adam's first moment: None = fp32, "bfloat16" halves it
    adam_mu_dtype: Optional[str] = None
    # "cosine": warmup-cosine schedule; None: constant
    lr_schedule: Optional[str] = None
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr: float = 0.0
    grad_accum: int = 1
    global_seed: int = 0

    def __post_init__(self):
        if self.ema_every < 1:
            raise ValueError(f"ema_every must be >= 1, got {self.ema_every}")
        self.device = next(self.model.parameters()).device

    def init_state(self) -> TrainState:
        names, params = zip(*self.model.named_parameters())
        params = list(params)
        mu_dtype = getattr(torch, self.adam_mu_dtype) if self.adam_mu_dtype else None
        return TrainState(
            step=0,
            names=list(names),
            params=params,
            ema_params=[p.detach().float().clone() for p in params],
            opt=adam_init(params, mu_dtype),
            acc_grads=[torch.zeros_like(p) for p in params] if self.grad_accum > 1 else None,
        )

    def learning_rate(self, count: int) -> float:
        if self.lr_schedule != "cosine":
            return self.lr
        warmup = max(self.warmup_steps, 1)
        return warmup_cosine_decay(count, self.lr, warmup,
                                   max(self.total_steps, warmup + 1), self.min_lr)

    def generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(step_seed(self.global_seed, step))

    def _update(self, state: TrainState, grads: list[torch.Tensor]) -> None:
        if self.max_grad_norm:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.learning_rate(state.opt.count)
        adamw_update(state.params, grads, state.opt, lr, self.beta2, self.weight_decay)

    def apply_gradients(self, state: TrainState, grads: list[torch.Tensor]) -> None:
        """The optimizer chain on one micro-step's gradients, in place: with
        ``grad_accum`` k > 1 the running mean is kept and applied on every
        k-th call (``optax.MultiSteps``); otherwise applied at once."""
        if self.grad_accum > 1:
            accumulate_mean(state.acc_grads, grads, state.mini_step)
            if state.mini_step == self.grad_accum - 1:
                self._update(state, state.acc_grads)
                torch._foreach_zero_(state.acc_grads)
            state.mini_step = (state.mini_step + 1) % self.grad_accum
        else:
            self._update(state, list(grads))

    def train_step(self, state: TrainState, batch, draws=None) -> dict:
        """One step on ``batch`` = (x NHWC, y labels), updating ``state`` in
        place. ``draws`` = (t, x0, drop_mask or None) replaces the step's own
        draws of t, x0 and the label dropout (tests hand in the JAX draws).
        Returns {"loss": velocity MSE, "total_loss", "grad_norm"} as tensors."""
        x, y = (torch.as_tensor(a, device=self.device) for a in batch)
        y = y.long()
        gen = self.generator(state.step)
        if draws is None:
            t = self.transport.sample_t(x.shape[0], gen, device=self.device)
            x0 = torch.randn(x.shape, generator=gen, device=self.device, dtype=torch.float32)
            drop = None
        else:
            t, x0, drop = (None if a is None else torch.as_tensor(a, device=self.device)
                           for a in draws)

        def model_fn(xt, tt):
            return self.model(xt, tt, y, train=True, force_drop_ids=drop, generator=gen)

        terms = self.transport.losses_at(model_fn, t, x0.to(x.dtype), x)
        mse = terms["loss"].mean()
        loss = mse + terms["cos_loss"].mean() if "cos_loss" in terms else mse
        grads = torch.autograd.grad(loss, state.params)
        grad_norm = global_norm(grads)

        self.apply_gradients(state, grads)
        period = self.ema_every * self.grad_accum  # counts optimizer steps
        if period == 1 or (state.step + 1) % period == 0:
            update_ema(state.ema_params, state.params, self.ema_decay ** self.ema_every)
        state.step += 1
        return {"loss": mse.detach(), "total_loss": loss.detach(), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator: torch.Generator,
                  sp=(0.0, 1.0)) -> dict:
        """Validation loss on ``batch`` with t uniform on ``sp`` (no label
        dropout), drawn from ``generator``."""
        x, y = (torch.as_tensor(a, device=self.device) for a in batch)
        terms = self.transport.training_losses(
            lambda xt, tt: self.model(xt, tt, y.long()), x, generator, sp_timesteps=tuple(sp))
        return {"val_loss": terms["loss"].mean()}
