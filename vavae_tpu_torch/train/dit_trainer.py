"""DiT training, on one card or over a (data, fsdp, tensor) mesh of
processes (port of ``vavae_tpu/train/dit_trainer.py``).

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
draws what an unbroken one would. t, x0 and the label-drop mask are drawn
at the global batch's shape and each data rank takes its rows, as JAX's
global-shape ``jax.random`` draws are sharded: a world of N takes the step
a world of 1 takes on the global batch.

Across processes (``mesh``, from ``parallel/mesh.py``; ``distribute``
places the state after any restore):
  - data: the batch rows split over data × fsdp; the gradients and the
    step's losses averaged over those ranks in one flat fp32 all-reduce
    before ``clip_by_global_norm``, so clipping and ``grad_norm`` read the
    global gradient. With equal shards the mean of the ranks' mean losses
    is the global mean loss;
  - fsdp > 1: FSDP2 ``fully_shard`` on every block and on the root (the
    parameters, sharded on dim 0 over fsdp, replicated over data); the EMA
    and both Adam moments are sharded alike, as the JAX trainer shards
    every state leaf. The gradient reaches ``.grad`` through FSDP2's
    reduce-scatter, which is why the step takes ``loss.backward()``;
  - tensor > 1: the blocks split by heads and MLP columns
    (``parallel/tensor_parallel.py``).
Norms over sharded tensors sum the ranks' squares over the groups that
hold different parts (``StateLayout.global_norm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vavae_tpu_torch.models.dit import LightningDiT
from vavae_tpu_torch.parallel import mesh as mesh_lib
from vavae_tpu_torch.parallel.mesh import DATA_AXIS, DP, FSDP_AXIS, TENSOR_AXIS, Mesh
from vavae_tpu_torch.parallel.tensor_parallel import TensorSplit, parallelize_dit
from vavae_tpu_torch.train.ema import update_ema
from vavae_tpu_torch.transport.transport import Transport

B1, EPS = 0.9, 1e-8  # optax.adamw defaults the JAX trainer keeps


# -- optimizer functions (optax, op for op) -----------------------------------


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (``optax.global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.stack(norms).square().sum())


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
    """``g`` where the global norm is below ``max_norm``, else ``g / norm ·
    max_norm`` (``optax.clip_by_global_norm``; ``clip_grad_norm_`` adds 1e-6).
    ``norm``: the norm when the caller has it (of a sharded gradient)."""
    if norm is None:
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


# -- the state's layout over the mesh ------------------------------------------


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t``: the local shard of an FSDP2 ``DTensor``
    (a view, so in-place updates reach the parameter), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _chunk(t: torch.Tensor, parts: int, i: int) -> torch.Tensor:
    """Chunk ``i`` of ``torch.chunk(t, parts)``, empty where ``torch.chunk``
    returns fewer chunks: FSDP2's dim-0 sharding."""
    chunks = torch.chunk(t, parts, dim=0)
    if i < len(chunks):
        return chunks[i]
    return t.new_empty((0,) + tuple(t.shape[1:]))


@dataclasses.dataclass
class StateLayout:
    """How each state tensor (by parameter index) is split over the mesh:
    its tensor-parallel split, then FSDP's dim-0 chunk over fsdp."""

    mesh: Mesh
    splits: list[Optional[TensorSplit]]
    shapes: list[torch.Size]  # full shapes

    @property
    def fsdp(self) -> int:
        return self.mesh.size(FSDP_AXIS)

    def fsdp_sharded(self, i: int) -> bool:
        """Whether FSDP shards parameter ``i``: every one but a tensor piece
        with no elements (on a rank with no heads), which FSDP2 cannot
        reduce-scatter, so ``DiTTrainer.distribute`` leaves it whole."""
        shape = list(self.shapes[i])
        split = self.splits[i]
        if split is not None and split.sharded:
            shape[split.dim] = len(split.index[self.mesh.index(TENSOR_AXIS)])
        return self.fsdp > 1 and math.prod(shape) > 0

    def local(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """Rank's part of parameter ``i``'s full tensor ``full``."""
        x = full
        split = self.splits[i]
        if split is not None and split.sharded:
            r = self.mesh.index(TENSOR_AXIS)
            x = x.index_select(split.dim, split.index[r].to(x.device))
        if self.fsdp_sharded(i):
            x = _chunk(x, self.fsdp, self.mesh.index(FSDP_AXIS))
        return x.clone()

    def gather(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s full tensor from every rank's part (collective)."""
        x = local_tensor(local).detach()
        if self.fsdp_sharded(i):
            x = torch.cat(mesh_lib.all_gather_rows(x.contiguous(), self.mesh.group(FSDP_AXIS)))
        split = self.splits[i]
        if split is not None and split.sharded:
            parts = mesh_lib.all_gather_rows(x.movedim(split.dim, 0).contiguous(),
                                             self.mesh.group(TENSOR_AXIS))
            full = x.new_empty(self.shapes[i]).movedim(split.dim, 0)
            for idx, part in zip(split.index, parts):
                full[idx.to(x.device)] = part
            x = full.movedim(0, split.dim)
        return x.reshape(self.shapes[i])

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """``optax.global_norm`` of the whole gradient from the ranks' parts:
        the squares summed over fsdp, those of tensor-split parameters also
        over tensor."""
        sq = torch.stack(torch._foreach_norm([g.float() for g in grads])).square()
        split = torch.tensor([s is not None and s.sharded for s in self.splits], device=sq.device)
        v = torch.stack([sq[split].sum(), sq[~split].sum()])
        if self.fsdp > 1:
            mesh_lib.all_reduce_sum_([v], self.mesh.group(FSDP_AXIS))
        if self.mesh.size(TENSOR_AXIS) > 1:
            head = v[:1].clone()
            mesh_lib.all_reduce_sum_([head], self.mesh.group(TENSOR_AXIS))
            v = torch.cat([head, v[1:]])
        return torch.sqrt(v.sum())


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
    # set by DiTTrainer.distribute when the tensors are this rank's parts
    layout: Optional[StateLayout] = None

    def full(self, tensors: Optional[list[torch.Tensor]]) -> Optional[list[torch.Tensor]]:
        """``tensors``, one of this state's per-parameter lists, at full size
        (collective when sharded: every rank calls it)."""
        if self.layout is None or tensors is None:
            return tensors
        return [self.layout.gather(i, t) for i, t in enumerate(tensors)]

    def gathered(self) -> "TrainState":
        """The state with full tensors (collective when sharded: every rank
        calls it); the state itself when it is not sharded."""
        if self.layout is None:
            return self
        full = self.full
        return TrainState(step=self.step, names=self.names, params=full(self.params),
                          ema_params=full(self.ema_params),
                          opt=AdamState(self.opt.count, full(self.opt.mu), full(self.opt.nu)),
                          acc_grads=full(self.acc_grads), mini_step=self.mini_step)


def global_draws(model: LightningDiT, transport: Transport, n: int, shape: tuple,
                 gen: torch.Generator) -> tuple:
    """t, x0 and the label-drop mask (None without label dropout) of a
    global batch of ``n`` latents of ``shape``, in the order a single
    process draws them (the model's own dropout draw comes last)."""
    device = gen.device
    t = transport.sample_t(n, gen, device=device)
    x0 = torch.randn((n,) + tuple(shape), generator=gen, device=device, dtype=torch.float32)
    p = model.y_embedder.dropout_prob
    drop = None
    if p > 0:
        drop = (torch.rand((n,), generator=gen, device=device) < p).to(torch.int32)
    return t, x0, drop


def rank_rows(draws, index: int, rows: int, device) -> tuple:
    """Data rank ``index``'s ``rows`` rows of each global draw (None stays
    None)."""
    return tuple(None if a is None else torch.as_tensor(a, device=device)[index * rows:(index + 1) * rows]
                 for a in draws)


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
    # the process mesh (parallel/mesh.py); None: one process
    mesh: Optional[Mesh] = None

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

    def distribute(self, state: TrainState) -> TrainState:
        """Place a full ``state`` (this trainer's model's) on the mesh: split
        the blocks over tensor, FSDP2-shard the model over fsdp, and cut
        the EMA, the Adam moments and the accumulator to match. Returns the
        new state; the model's parameters are replaced. Call it once, after
        any restore, on every rank."""
        mesh = self.mesh
        if mesh is None:
            return state
        tensor, fsdp = mesh.size(TENSOR_AXIS), mesh.size(FSDP_AXIS)
        if tensor == 1 and fsdp == 1:
            return state
        shapes = [p.shape for p in state.params]
        splits = {}
        if tensor > 1:
            splits = parallelize_dit(self.model, mesh.group(TENSOR_AXIS), tensor,
                                     mesh.index(TENSOR_AXIS))
        if fsdp > 1:
            from torch.distributed.fsdp import fully_shard

            axes = (DATA_AXIS, FSDP_AXIS) if mesh.size(DATA_AXIS) > 1 else (FSDP_AXIS,)
            dmesh = mesh.device_mesh(axes, self.device.type)
            # FSDP2 cannot reduce-scatter an empty gradient: the tensor
            # pieces of a rank with no heads stay whole (StateLayout.fsdp_sharded)
            empty = {p for p in self.model.parameters() if not p.numel()} or None
            for block in self.model.blocks:
                fully_shard(block, mesh=dmesh, ignored_params=empty)
            fully_shard(self.model, mesh=dmesh, ignored_params=empty)
        names, params = zip(*self.model.named_parameters())
        if list(names) != state.names:
            raise RuntimeError("distributing changed the model's parameter names")
        layout = StateLayout(mesh, [splits.get(n) for n in names], shapes)

        def local(ts):
            return None if ts is None else [layout.local(i, t) for i, t in enumerate(ts)]

        ema = local(state.ema_params)
        for name, p, e in zip(names, params, ema):
            if local_tensor(p).shape != e.shape:
                raise RuntimeError(f"{name}: the sharded parameter {tuple(local_tensor(p).shape)} "
                                   f"and its state {tuple(e.shape)} differ")
        return TrainState(step=state.step, names=list(names), params=list(params),
                          ema_params=ema,
                          opt=AdamState(state.opt.count, local(state.opt.mu), local(state.opt.nu)),
                          acc_grads=local(state.acc_grads), mini_step=state.mini_step,
                          layout=layout)

    def learning_rate(self, count: int) -> float:
        if self.lr_schedule != "cosine":
            return self.lr
        warmup = max(self.warmup_steps, 1)
        return warmup_cosine_decay(count, self.lr, warmup,
                                   max(self.total_steps, warmup + 1), self.min_lr)

    def generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(step_seed(self.global_seed, step))

    def _norm(self, state: TrainState, grads: list[torch.Tensor]) -> torch.Tensor:
        return global_norm(grads) if state.layout is None else state.layout.global_norm(grads)

    def _update(self, state: TrainState, grads: list[torch.Tensor]) -> None:
        if self.max_grad_norm:
            grads = clip_by_global_norm(grads, self.max_grad_norm, self._norm(state, grads))
        lr = self.learning_rate(state.opt.count)
        adamw_update([local_tensor(p) for p in state.params], grads, state.opt, lr,
                     self.beta2, self.weight_decay)

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
        """One step on ``batch`` = (x NHWC, y labels), this data rank's rows
        of the global batch, updating ``state`` in place. ``draws`` = (t, x0,
        drop_mask or None) at the global batch's shape replaces the step's
        own draws (tests hand in the JAX draws). Returns {"loss": velocity
        MSE, "total_loss", "grad_norm"} of the global batch, as tensors."""
        x, y = (torch.as_tensor(a, device=self.device) for a in batch)
        y = y.long()
        mesh = self.mesh
        n_dp, i_dp = (mesh.size(DP), mesh.index(DP)) if mesh is not None else (1, 0)
        b = x.shape[0]
        gen = self.generator(state.step)
        if draws is None:
            draws = global_draws(self.model, self.transport, b * n_dp, x.shape[1:], gen)
        t, x0, drop = rank_rows(draws, i_dp, b, self.device)

        def model_fn(xt, tt):
            return self.model(xt, tt, y, train=True, force_drop_ids=drop, generator=gen)

        terms = self.transport.losses_at(model_fn, t, x0.to(x.dtype), x)
        mse = terms["loss"].mean()
        loss = mse + terms["cos_loss"].mean() if "cos_loss" in terms else mse
        for p in state.params:
            p.grad = None
        loss.backward()
        # a parameter this rank's forward never reached (the QK-norm of a
        # tensor-parallel rank with no heads) has a zero gradient here
        grads = [torch.zeros_like(local_tensor(p)) if p.grad is None else local_tensor(p.grad)
                 for p in state.params]
        for p in state.params:
            p.grad = None
        mse, loss = mse.detach().clone(), loss.detach().clone()
        if mesh is not None and mesh.distributed:
            sharded = mesh.size(FSDP_AXIS) > 1  # FSDP2 reduced the gradients already
            mesh_lib.all_reduce_mean_(([] if sharded else grads) + [mse, loss], mesh.group(DP))
            if state.layout is not None:
                partial = [g for g, s in zip(grads, state.layout.splits) if s is not None and s.partial]
                mesh_lib.all_reduce_sum_(partial, mesh.group(TENSOR_AXIS))
        grad_norm = self._norm(state, grads)

        self.apply_gradients(state, grads)
        period = self.ema_every * self.grad_accum  # counts optimizer steps
        if period == 1 or (state.step + 1) % period == 0:
            update_ema(state.ema_params, [local_tensor(p) for p in state.params],
                       self.ema_decay ** self.ema_every)
        state.step += 1
        return {"loss": mse, "total_loss": loss, "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, generator: torch.Generator,
                  sp=(0.0, 1.0)) -> dict:
        """Validation loss on ``batch`` with t uniform on ``sp`` (no label
        dropout), drawn from ``generator``."""
        x, y = (torch.as_tensor(a, device=self.device) for a in batch)
        terms = self.transport.training_losses(
            lambda xt, tt: self.model(xt, tt, y.long()), x, generator, sp_timesteps=tuple(sp))
        return {"val_loss": terms["loss"].mean()}
