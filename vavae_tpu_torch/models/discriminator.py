"""PatchGAN discriminator (port of ``vavae_tpu/models/discriminator.py``).

taming's NLayerDiscriminator: Conv(4×4, s2) + LeakyReLU(0.2), ``n_layers``
of Conv + BatchNorm + LeakyReLU with the channels doubling (capped at 8×),
stride 1 on the last, a final one-channel conv. Takes NHWC, computes NCHW,
returns NHWC logits. Modules carry the JAX names (``conv0``, ``conv{n}``,
``bn{n}``, ``conv_out``), so the weight bridge is a transpose per kernel.

The batch norm is flax's, not ``nn.BatchNorm2d``: in train mode it
normalises by the batch's own mean and biased variance (E[x²] − E[x]²,
clipped at 0) and moves the running stats by hand, ``r = 0.9·r + 0.1·b``,
storing the biased variance, so a checkpoint's ``batch_stats`` equal the
JAX package's. In eval mode it normalises by the running stats.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM, EPS = 0.9, 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))   # flax "scale"
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_(mean.detach(), alpha=1.0 - MOMENTUM)
                self.running_var.mul_(MOMENTUM).add_(var.detach(), alpha=1.0 - MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2**n, 8)
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv{n}", nn.Conv2d(cin, cout, 4, stride=stride, padding=1, bias=False))
            setattr(self, f"bn{n}", BatchNorm(cout))
            cin = cout
        self.conv_out = nn.Conv2d(cin, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (B, H, W, C) → patch logits (B, h, w, 1). ``train`` normalises
        by the batch and moves the running stats."""
        h = F.leaky_relu(self.conv0(x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(h), train)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


@torch.no_grad()
def init_discriminator_weights(model: NLayerDiscriminator, generator: torch.Generator) -> None:
    """taming's ``weights_init``: convs N(0, 0.02²) with zero biases, batch
    norm scales N(1, 0.02²) with zero biases; running stats 0 and 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(0.02 * torch.randn(m.weight.shape, generator=generator,
                                              device=generator.device))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator,
                                                    device=generator.device))
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))
