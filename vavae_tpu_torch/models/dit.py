"""LightningDiT (port of ``vavae_tpu/models/dit.py``).

NHWC latents in and out, as the JAX package. The JAX block stack runs under
``nn.scan`` over stacked parameters; here it is a plain loop over
``blocks``, a ``ModuleList`` (the weight bridge unstacks the depth axis).

Activation checkpointing per block (``use_checkpoint``) maps the JAX remat
policies onto ``torch.utils.checkpoint``: ``"nothing"`` recomputes the whole
block in the backward; ``"dots"`` saves the outputs of the Linear layers'
matrix products (``aten.mm``/``aten.addmm``, as
``dots_with_no_batch_dims_saveable`` saves dots) and recomputes the rest,
the attention kernel included.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import checkpoint

from vavae_tpu_torch.models.layers import (
    Attention,
    LabelEmbedder,
    LayerNormNoAffine,
    Linear,
    Mlp,
    RMSNorm,
    SwiGLUFFN,
    TimestepEmbedder,
    modulate,
)
from vavae_tpu_torch.models.posembed import get_2d_sincos_pos_embed, rope_2d_freqs


class PatchEmbed(nn.Module):
    """Non-overlapping patchify + linear projection, (p, p, C) flatten order."""

    def __init__(self, patch_size: int, in_chans: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Linear(patch_size * patch_size * in_chans, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        h, w = H // p, W // p
        x = x.reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(B, h * w, p * p * C))


def _save_matmuls(ctx, op, *args, **kwargs) -> checkpoint.CheckpointPolicy:
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


# torch.utils.checkpoint context_fn per JAX remat policy name
_REMAT_POLICIES = {
    "nothing": checkpoint.noop_context_fn,
    "dots": functools.partial(checkpoint.create_selective_checkpoint_contexts, _save_matmuls),
}


def _norm(use_rmsnorm: bool, hidden_size: int, dtype: torch.dtype) -> nn.Module:
    return RMSNorm(hidden_size, dtype=dtype) if use_rmsnorm else LayerNormNoAffine(dtype=dtype)


class DiTBlock(nn.Module):
    """Pre-norm attention + FFN with 6-way (or 4-way ``wo_shift``) adaLN gating."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_qknorm: bool = False, use_swiglu: bool = False,
                 use_rmsnorm: bool = False, wo_shift: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.wo_shift = wo_shift
        self.norm1 = _norm(use_rmsnorm, hidden_size, dtype)
        self.attn = Attention(hidden_size, num_heads, qk_norm=use_qknorm,
                              use_rmsnorm=use_rmsnorm, dtype=dtype)
        self.norm2 = _norm(use_rmsnorm, hidden_size, dtype)
        mlp_hidden = int(hidden_size * mlp_ratio)
        if use_swiglu:
            self.mlp = SwiGLUFFN(hidden_size, int(2 / 3 * mlp_hidden), hidden_size, dtype=dtype)
        else:
            self.mlp = Mlp(hidden_size, mlp_hidden, hidden_size, dtype=dtype)
        n_mod = 4 if wo_shift else 6
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, n_mod * hidden_size, dtype=dtype)
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor, rope=None) -> torch.Tensor:
        mod = self.adaLN_modulation(c)
        if self.wo_shift:
            scale_msa, gate_msa, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)
            shift_msa = shift_mlp = None
        else:
            shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        x = x + gate_msa[:, None, :] * self.attn(
            modulate(self.norm1(x), shift_msa, scale_msa), rope=rope
        )
        return x + gate_mlp[:, None, :] * self.mlp(
            modulate(self.norm2(x), shift_mlp, scale_mlp)
        )


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 use_rmsnorm: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_final = _norm(use_rmsnorm, hidden_size, dtype)
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels, dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 2 * hidden_size, dtype=dtype)
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(self.norm_final(x), shift, scale))


class LightningDiT(nn.Module):
    """Diffusion transformer over NHWC latents.

    forward(x, t, y): x (B, H, W, C), t (B,) in [0, 1], y (B,) int labels →
    velocity (B, H, W, C)."""

    def __init__(self, input_size: int = 32, patch_size: int = 2, in_channels: int = 32,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, class_dropout_prob: float = 0.1,
                 num_classes: int = 1000, learn_sigma: bool = False,
                 use_qknorm: bool = False, use_swiglu: bool = False, use_rope: bool = False,
                 use_rmsnorm: bool = False, wo_shift: bool = False,
                 use_checkpoint: bool = False, checkpoint_policy: str = "nothing",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_checkpoint and checkpoint_policy not in _REMAT_POLICIES:
            raise ValueError(f"checkpoint_policy={checkpoint_policy!r}: expected one of "
                             f"{sorted(_REMAT_POLICIES)}")
        self.use_checkpoint = use_checkpoint
        self.checkpoint_policy = checkpoint_policy
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.learn_sigma = learn_sigma
        self.depth = depth
        self.num_heads = num_heads
        self.use_swiglu = use_swiglu
        self.use_rmsnorm = use_rmsnorm
        self.use_rope = use_rope
        self.dtype = dtype
        grid = input_size // patch_size

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype=dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob, dtype=dtype)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio, use_qknorm, use_swiglu,
                     use_rmsnorm, wo_shift, dtype=dtype)
            for _ in range(depth)
        )
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels,
                                      use_rmsnorm=use_rmsnorm, dtype=dtype)
        # frozen tables, rebuilt from the config rather than stored
        pos = torch.as_tensor(get_2d_sincos_pos_embed(hidden_size, grid))
        self.register_buffer("pos_embed", pos, persistent=False)
        if use_rope:
            cos, sin = rope_2d_freqs(hidden_size // num_heads, grid)
            self.register_buffer("rope_cos", torch.as_tensor(cos), persistent=False)
            self.register_buffer("rope_sin", torch.as_tensor(sin), persistent=False)
        self.initialize_weights()

    @torch.no_grad()
    def initialize_weights(self) -> None:
        """The JAX package's init: lecun-normal Dense kernels with zero bias,
        xavier patch embedding, N(0, 0.02) timestep MLP and label table, and
        zero adaLN and final projections (so a fresh model outputs 0)."""
        for m in self.modules():
            if isinstance(m, Linear):
                fan_in = m.weight.shape[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
                nn.init.zeros_(m.bias)
        nn.init.xavier_uniform_(self.x_embedder.proj.weight)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            nn.init.normal_(lin.weight, std=0.02)
        nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02)
        zero = [b.adaLN_modulation[1] for b in self.blocks]
        zero += [self.final_layer.adaLN_modulation[1], self.final_layer.linear]
        for lin in zero:
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def rope(self):
        return (self.rope_cos, self.rope_sin) if self.use_rope else None

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                train: bool = False, force_drop_ids: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train`` turns on label dropout, drawn from ``generator``."""
        x = self.x_embedder(x)
        x = x + self.pos_embed[None].to(x.dtype)
        c = self.t_embedder(t) + self.y_embedder(y, train, force_drop_ids, generator)
        rope = self.rope()
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint.checkpoint(block, x, c, rope, use_reentrant=False,
                                          context_fn=_REMAT_POLICIES[self.checkpoint_policy])
            else:
                x = block(x, c, rope)
        x = self._unpatchify(self.final_layer(x, c))
        if self.learn_sigma:
            x = x[..., : self.in_channels]
        return x

    def _unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens (B, N, p²·c) → NHWC (B, H, W, c)."""
        B, N, _ = x.shape
        p = self.patch_size
        c = self.out_channels
        h = w = int(N**0.5)
        x = x.reshape(B, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, h * p, w * p, c)

    def forward_with_cfg(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                         cfg_scale: float, cfg_interval: bool = False,
                         cfg_interval_start: float = 0.0,
                         cfg_channels: int | None = None) -> torch.Tensor:
        """Batched CFG forward: ``x`` holds [cond | uncond] halves with the same
        latents, ``y`` holds [labels | null]. ``cfg_channels`` limits guidance
        to the first k channels (the reference's 3-channel quirk); None guides
        all channels."""
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half], dim=0), t, y)
        k = cfg_channels if cfg_channels is not None else out.shape[-1]
        eps, rest = out[..., :k], out[..., k:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        guided = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        if cfg_interval:
            # below the interval start, the conditional output stands
            guided = torch.where(t[0] < cfg_interval_start, cond_eps, guided)
        eps = torch.cat([guided, guided], dim=0)
        return torch.cat([eps, rest], dim=-1)


# -- registry -----------------------------------------------------------------

_VARIANTS = {
    "S": dict(depth=12, hidden_size=384, num_heads=6),
    "B": dict(depth=12, hidden_size=768, num_heads=12),
    "L": dict(depth=24, hidden_size=1024, num_heads=16),
    "XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "1p0B": dict(depth=24, hidden_size=1536, num_heads=24),
    "1p6B": dict(depth=28, hidden_size=1792, num_heads=28),
}


def _make_ctor(size: str, patch: int) -> Callable[..., LightningDiT]:
    def ctor(**kw: Any) -> LightningDiT:
        return LightningDiT(patch_size=patch, **_VARIANTS[size], **kw)

    return ctor


LightningDiT_models = {
    f"LightningDiT-{size}/{patch}": _make_ctor(size, patch)
    for size in _VARIANTS
    for patch in (1, 2)
    if not (size == "L" and patch == 1)  # the reference registry has no L/1
}


def create_dit(model_cfg: Any, latent_size: int, num_classes: int,
               device: str | torch.device | None = None) -> LightningDiT:
    """Build a DiT from a reference-format ``model:`` config block, on
    ``device`` (default: torch's current default device). ``bf16: true`` means
    bf16 compute over fp32-stored weights."""
    g = model_cfg.get
    with torch.device(device) if device is not None else contextlib.nullcontext():
        return LightningDiT_models[model_cfg["model_type"]](
            input_size=latent_size,
            num_classes=num_classes,
            use_qknorm=g("use_qknorm", False),
            use_swiglu=g("use_swiglu", False),
            use_rope=g("use_rope", False),
            use_rmsnorm=g("use_rmsnorm", False),
            wo_shift=g("wo_shift", False),
            in_channels=g("in_chans", 4),
            class_dropout_prob=g("class_dropout_prob", 0.1),
            use_checkpoint=g("use_checkpoint", False),
            checkpoint_policy=g("checkpoint_policy", "nothing"),
            dtype=torch.bfloat16 if g("bf16", False) else torch.float32,
        )

