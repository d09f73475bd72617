"""Convolutional VAE tokenizer (port of ``vavae_tpu/models/vae.py``).

The public functions take and return NHWC, as the JAX package; inside, the
convolutions run NCHW. Module names follow the reference LDM AutoencoderKL
(``encoder.down.{i}.block.{j}``, ``decoder.up.{i}.upsample``,
``mid.attn_1``), so a reference state dict loads with no renaming.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def GroupNorm32(channels: int, eps: float = 1e-6) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = _conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = _conv(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = _conv(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the (H·W) grid, fp32 logits."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = _conv(channels, channels, 1)
        self.k = _conv(channels, channels, 1)
        self.v = _conv(channels, channels, 1)
        self.proj_out = _conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, C, H * W)
        k = self.k(h).reshape(B, C, H * W)
        v = self.v(h).reshape(B, C, H * W)
        logits = torch.einsum("bcq,bck->bqk", q.float(), k.float())
        probs = torch.softmax(logits * (C ** -0.5), dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bck->bcq", probs, v).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 conv with the LDM asymmetric (right/bottom) zero pad."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest ×2 upsample + 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution level: res blocks, optional attention after each,
    optional resampling at the end (reference ``down[i]`` / ``up[i]``)."""

    def __init__(self, cin: int, cout: int, n_blocks: int, attn: bool,
                 resample: str | None):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout) for j in range(n_blocks)
        )
        self.attn = nn.ModuleList(AttnBlock(cout) for _ in range(n_blocks) if attn)
        if resample == "down":
            self.downsample = Downsample(cout)
        elif resample == "up":
            self.upsample = Upsample(cout)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for j, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[j](h)
        if hasattr(self, "downsample"):
            h = self.downsample(h)
        if hasattr(self, "upsample"):
            h = self.upsample(h)
        return h


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, in_channels: int = 3, z_channels: int = 16,
                 double_z: bool = True):
        super().__init__()
        self.conv_in = _conv(in_channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        curr_res = resolution
        levels = []
        for i, mult in enumerate(ch_mult):
            last = i == len(ch_mult) - 1
            levels.append(_Level(ch * in_mult[i], ch * mult, num_res_blocks,
                                 curr_res in attn_resolutions, None if last else "down"))
            if not last:
                curr_res //= 2
        self.down = nn.ModuleList(levels)
        block_in = ch * ch_mult[-1]
        self.mid = _Mid(block_in)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv(block_in, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 256, z_channels: int = 16):
        super().__init__()
        n = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (n - 1)
        self.conv_in = _conv(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels: list[_Level | None] = [None] * n
        for i in reversed(range(n)):
            block_out = ch * ch_mult[i]
            levels[i] = _Level(block_in, block_out, num_res_blocks + 1,
                               curr_res in attn_resolutions, "up" if i != 0 else None)
            block_in = block_out
            if i != 0:
                curr_res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv(block_in, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(swish(self.norm_out(h)))


@dataclasses.dataclass
class DiagonalGaussian:
    """Posterior N(mean, exp(logvar)) with channel-last (NHWC) moments."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean, logvar.clamp(-30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator | None = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                            device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(self.mean.pow(2) + var - 1.0 - self.logvar, dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + (sample - self.mean).pow(2) / var,
            dim=(1, 2, 3),
        )


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):
    """f16 conv VAE: encode → DiagonalGaussian over z; decode z → image.

    With ``attn_resolutions=None`` the decoder attention follows
    ``model_type`` ('marvae' drops it), as in the JAX package."""

    def __init__(self, embed_dim: int = 32, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 1, 2, 2, 4), resolution: int = 256,
                 use_variational: bool = True, model_type: str = "vavae",
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] | None = None,
                 z_channels: int | None = None, out_ch: int = 3, double_z: bool = True):
        super().__init__()
        z_ch = embed_dim if z_channels is None else z_channels
        enc_attn = (16,) if attn_resolutions is None else tuple(attn_resolutions)
        if attn_resolutions is None:
            dec_attn = (16,) if model_type == "vavae" else ()
        else:
            dec_attn = () if model_type == "marvae" else tuple(attn_resolutions)
        self.use_variational = use_variational
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               attn_resolutions=enc_attn, resolution=resolution,
                               z_channels=z_ch, double_z=double_z)
        self.decoder = Decoder(ch=ch, out_ch=out_ch, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks, attn_resolutions=dec_attn,
                               resolution=resolution, z_channels=z_ch)
        mult = 2 if use_variational else 1
        self.quant_conv = _conv(2 * z_ch if double_z else z_ch, mult * embed_dim, 1)
        self.post_quant_conv = _conv(embed_dim, z_ch, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x: (B, H, W, 3) → posterior over (B, h, w, embed_dim), moments fp32."""
        moments = _nhwc(self.quant_conv(self.encoder(_nchw(x)))).float()
        if not self.use_variational:
            moments = torch.cat([moments, torch.ones_like(moments)], dim=-1)
        return DiagonalGaussian.from_moments(moments)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, h, w, embed_dim) → (B, H, W, out_ch)."""
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(z))))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                sample: bool = True):
        posterior = self.encode(x)
        z = posterior.sample(generator) if sample else posterior.mode()
        return self.decode(z), posterior, z


def vae_from_ddconfig(embed_dim: int, ddconfig: Any, *,
                      model_type: str = "vavae") -> AutoencoderKL:
    """An AutoencoderKL honouring the full ddconfig."""
    get = ddconfig.get if hasattr(ddconfig, "get") else lambda k, d=None: getattr(ddconfig, k, d)
    attn = get("attn_resolutions")
    return AutoencoderKL(
        embed_dim=embed_dim,
        ch=get("ch", 128),
        ch_mult=tuple(get("ch_mult", (1, 1, 2, 2, 4))),
        resolution=get("resolution", 256),
        num_res_blocks=get("num_res_blocks", 2),
        attn_resolutions=None if attn is None else tuple(attn),
        z_channels=get("z_channels"),
        out_ch=get("out_ch", 3),
        double_z=bool(get("double_z", True)),
        model_type=model_type,
    )
