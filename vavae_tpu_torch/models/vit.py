"""Frozen ViT-L foundation models (DINOv2 / MAE) for VF alignment (port of
``vavae_tpu/models/vit.py``).

timm's ``vit_large_patch14_dinov2.lvd142m`` (LayerScale, patch 14, a 37×37
pretraining grid) and ``vit_large_patch16_224.mae`` (patch 16, 14×14),
used frozen: DINOv2 first resizes the input to 224 (``F.interpolate``
bilinear, ``align_corners=False``, no antialias), then ``forward_features``;
the cls token is dropped and the patch tokens are reshaped by the net's
true patch grid to an NHWC feature map (B, h, w, 1024). The pos-embed is
resampled to another grid as timm's ``resample_abs_pos_embed`` does
(bicubic, antialias). The JAX package rebuilds both resizes as weight
matrices (``vavae_tpu/utils/interp.py``); the port calls ``F.interpolate``.

The parameters carry timm's key names (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``blocks.{i}.ls1.gamma``, ``norm``), so a timm
state dict loads as it is. Attention is a plain matmul and softmax, as the
JAX module computes it outside Pallas; GELU is exact. No download:
``load`` reads ``VAVAE_DINOV2_WEIGHTS`` / ``VAVAE_MAE_WEIGHTS``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vavae_tpu_torch.utils.device import resolve_device
from vavae_tpu_torch.utils.weights import lecun_normal_


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.unbind(dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (C // self.num_heads) ** -0.5
        probs = torch.softmax(logits, dim=-1)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_layerscale: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls1 = LayerScale(dim) if use_layerscale else nn.Identity()
        self.ls2 = LayerScale(dim) if use_layerscale else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int, in_channels: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)


def resample_pos_embed(pos: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """(1, g·g, D) patch pos-embed → (1, gh·gw, D): timm's
    ``resample_abs_pos_embed``, bicubic with antialias, in fp32."""
    g = int(round(pos.shape[1] ** 0.5))
    x = pos.float().reshape(1, g, g, -1).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=grid, mode="bicubic", antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1).reshape(1, grid[0] * grid[1], -1).to(pos.dtype)


class TimmViT(nn.Module):
    """timm-layout ViT encoder: NHWC images → normed tokens (B, 1+N, D)."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0, use_layerscale: bool = True,
                 pretrain_grid: int = 37):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pretrain_grid = pretrain_grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pretrain_grid**2, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, use_layerscale) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (self.pretrain_grid, self.pretrain_grid):
            pos_patch = resample_pos_embed(pos_patch, (gh, gw))
        x = x + pos_patch
        x = torch.cat([(self.cls_token + pos_cls).expand(B, -1, -1), x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


def _kind_config(kind: str) -> dict:
    """TimmViT arguments of a foundation kind; ``<kind>-tiny`` keeps the
    patch and grid conventions at width 64, depth 2 (the weight-free testbed
    of CPU runs)."""
    base, _, variant = kind.partition("-")
    if variant not in ("", "tiny"):
        raise ValueError(kind)
    tiny = dict(embed_dim=64, depth=2, num_heads=2) if variant == "tiny" else {}
    if base == "dinov2":
        return dict(patch_size=14, use_layerscale=True, pretrain_grid=37, **tiny)
    if base == "mae":
        return dict(patch_size=16, use_layerscale=False, pretrain_grid=14, **tiny)
    raise ValueError(kind)


class FoundationModel(nn.Module):
    """The reference's ``aux_foundation_model``: images (B, H, W, 3) in
    [-1, 1] → frozen feature map (B, h, w, feature_dim), computed under
    ``no_grad``. Built on ``device`` (the card unless told otherwise) with
    zero weights: call ``load`` or ``init_random``."""

    def __init__(self, kind: str = "dinov2", device: str | torch.device = "cuda"):
        super().__init__()
        self.kind = kind
        self.model = TimmViT(**_kind_config(kind))
        self.feature_dim = self.model.embed_dim
        self.model.requires_grad_(False)
        self.to(resolve_device(device)).eval()

    def load(self, weights_path: Optional[str] = None) -> "FoundationModel":
        """timm ViT-L weights from ``weights_path`` or the kind's variable
        (``VAVAE_DINOV2_WEIGHTS`` / ``VAVAE_MAE_WEIGHTS``): a state dict, or
        one under ``model`` / ``state_dict``. Keys the model lacks (a head)
        are dropped; every model key must be present."""
        env = "VAVAE_DINOV2_WEIGHTS" if self.kind.startswith("dinov2") else "VAVAE_MAE_WEIGHTS"
        if self.kind.endswith("-tiny"):
            raise FileNotFoundError(
                f"{self.kind} is the weight-free smoke testbed: there are no pretrained "
                "weights to load; use init_random() / --allow_random_foundation")
        weights_path = weights_path or os.environ.get(env)
        if not (weights_path and os.path.exists(weights_path)):
            raise FileNotFoundError(f"{self.kind} ViT-L weights not found; set {env}=/path/to/ckpt")
        sd = torch.load(weights_path, map_location="cpu", weights_only=False)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
        own = self.model.state_dict()
        self.model.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=True)
        return self

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "FoundationModel":
        """Seeded random weights (runs without weights): the JAX init's
        rules, lecun-normal kernels, zero biases, unit norms, pos-embed
        N(0, 0.02²), zero cls token, LayerScale 1e-5."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(1e-5)
        self.model.pos_embed.copy_(0.02 * torch.randn(self.model.pos_embed.shape, generator=gen))
        self.model.cls_token.zero_()
        return self

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if self.kind.startswith("dinov2"):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(224, 224), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        # the true token grid: the reference reshapes by input/16, which
        # coincides with it at 256 px only
        gh, gw = x.shape[1] // self.model.patch_size, x.shape[2] // self.model.patch_size
        return self.model(x)[:, 1:].reshape(B, gh, gw, -1)
