"""LPIPS perceptual metric with a VGG16 backbone (port of
``vavae_tpu/models/lpips.py``).

The taming-transformers LPIPS: scaling layer, VGG16 feature taps relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3, channel-unit-normalised squared
differences, 1×1 linear heads, spatial mean, sum over the taps. ``LPIPS``
takes NHWC in [-1, 1], as the JAX module, computes NCHW inside and returns
(B,). Its convolutions run in fp32 with TF32 off, as the JAX module pins
``Precision.HIGHEST``; a module cast to bf16 (the VA-VAE trainer's frozen
nets) computes in bf16. Its forward stays differentiable in its inputs:
it is the trainer's perceptual loss.

The modules are laid out as the taming module (``net.slice{1..5}.{N}`` at
torchvision's ``features.N`` indices, ``lin{i}.model.1``), so a full LPIPS
dump loads as it is. The genuine taming ``vgg.pth`` holds only the lin
heads; ``lpips_state_from_torch`` takes the convolutions from a torchvision
``vgg16`` state dict (``features.N``) then. No download: ``load_lpips``
reads ``VAVAE_LPIPS_WEIGHTS`` and ``VAVAE_VGG16_WEIGHTS``.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from vavae_tpu_torch.utils.device import full_fp32, resolve_device

# VGG16 'features' conv layout: channels per conv, 'M' = maxpool
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# the taming slices over torchvision's features indices: each ends at a tap
_SLICE_BOUNDS = [(0, 4), (4, 9), (9, 16), (16, 23), (23, 30)]
_TAP_CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _features_layers() -> list[nn.Module]:
    """torchvision's vgg16 ``features`` up to relu5_3 (indices 0-29)."""
    layers: list[nn.Module] = []
    cin = 3
    for item in _VGG16_CFG:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
            cin = item
    return layers


def conv_slices() -> list[tuple[int, int]]:
    """(taming slice 1-5, torchvision ``features`` index) of each of the 13
    convolutions."""
    idx = [i for i, m in enumerate(_features_layers()) if isinstance(m, nn.Conv2d)]
    return [(next(s + 1 for s, (lo, hi) in enumerate(_SLICE_BOUNDS) if lo <= i < hi), i)
            for i in idx]


class VGG16Features(nn.Module):
    """The five taps of VGG16, NCHW."""

    def __init__(self):
        super().__init__()
        layers = _features_layers()
        for s, (lo, hi) in enumerate(_SLICE_BOUNDS):
            part = nn.Sequential()
            for i in range(lo, hi):
                part.add_module(str(i), layers[i])
            setattr(self, f"slice{s + 1}", part)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for s in range(len(_SLICE_BOUNDS)):
            x = getattr(self, f"slice{s + 1}")(x)
            taps.append(x)
        return taps


class _NetLin(nn.Module):
    """taming's NetLinLayer: dropout (identity in eval) + 1×1 conv to one channel."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(cin, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """lpips(a, b): (B, H, W, 3) in [-1, 1] → (B,) distances."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)
        self.net = VGG16Features()
        for i, c in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{i}", _NetLin(c))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dtype = self.lin0.model[1].weight.dtype  # fp32, or bf16 for a cast module
        a = (a.to(dtype).permute(0, 3, 1, 2) - self.shift) / self.scale
        b = (b.to(dtype).permute(0, 3, 1, 2) - self.shift) / self.scale
        with full_fp32():
            fa, fb = self.net(a), self.net(b)
            total = 0.0
            for i, (xa, xb) in enumerate(zip(fa, fb)):
                d = torch.square(_unit_normalize(xa) - _unit_normalize(xb))
                total = total + torch.mean(getattr(self, f"lin{i}")(d), dim=(1, 2, 3))
        return total


def lpips_state_from_torch(sd: Mapping, vgg_sd: Optional[Mapping] = None) -> dict:
    """The ``LPIPS`` state dict from torch weights: ``sd`` the taming
    ``vgg.pth`` (lin heads; a full-module dump also bundles the VGG convs),
    ``vgg_sd`` a torchvision vgg16 state dict (``features.N.*``) consulted
    for any convolution ``sd`` lacks. The key search of the JAX package's
    ``lpips_params_from_torch``."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    vgg_sd = {k: torch.as_tensor(np.asarray(v)) for k, v in (vgg_sd or {}).items()}

    def find(names):
        for n in names:
            if n in sd:
                return sd[n]
        for n in names:
            if n in vgg_sd:
                return vgg_sd[n]
        return None

    out: dict[str, torch.Tensor] = {}
    for ci, (si, ti) in enumerate(conv_slices()):
        within = ti - _SLICE_BOUNDS[si - 1][0]
        w = find([f"net.slice{si}.{ti}.weight", f"net.slice{si}.{within}.weight",
                  f"features.{ti}.weight", f"net.features.{ti}.weight"])
        bvec = find([f"net.slice{si}.{ti}.bias", f"net.slice{si}.{within}.bias",
                     f"features.{ti}.bias", f"net.features.{ti}.bias"])
        if w is None:
            raise KeyError(
                f"VGG conv {ci} (torch idx {ti}) not found. The genuine taming "
                "vgg.pth contains only the lin heads — also provide the "
                "torchvision vgg16 state dict (features.N.weight layout) via "
                "VAVAE_VGG16_WEIGHTS / the vgg16_path argument."
            )
        out[f"net.slice{si}.{ti}.weight"] = w.float()
        out[f"net.slice{si}.{ti}.bias"] = bvec.float()
    for i in range(len(_TAP_CHANNELS)):
        w = find([f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"])
        if w is None:
            raise KeyError(f"lin{i} weights not found")
        out[f"lin{i}.model.1.weight"] = w.float()
    return out


@torch.no_grad()
def init_lpips_weights(model: LPIPS, generator: torch.Generator) -> None:
    """Random weights for smoke runs: He-normal convolutions (the features
    keep their scale through the depth), zero biases, non-negative lin heads
    (as trained LPIPS heads are)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = (2.0 / m.weight[0].numel()) ** 0.5
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    for i in range(len(_TAP_CHANNELS)):
        getattr(model, f"lin{i}").model[1].weight.abs_()


def load_lpips(weights_path: str | None = None, vgg16_path: str | None = None,
               device: str | torch.device = "cuda") -> LPIPS:
    """The LPIPS module in eval mode on ``device``, from ``weights_path`` (or
    ``VAVAE_LPIPS_WEIGHTS``) and, for the convolutions a genuine ``vgg.pth``
    lacks, ``vgg16_path`` (or ``VAVAE_VGG16_WEIGHTS``). Raises
    ``FileNotFoundError`` naming both variables without weights."""
    dev = resolve_device(device)
    weights_path = weights_path or os.environ.get("VAVAE_LPIPS_WEIGHTS")
    vgg16_path = vgg16_path or os.environ.get("VAVAE_VGG16_WEIGHTS")
    if not (weights_path and os.path.exists(weights_path)):
        raise FileNotFoundError(
            "LPIPS VGG weights not found. Provide the taming 'vgg.pth' via "
            "VAVAE_LPIPS_WEIGHTS=/path/to/vgg.pth — and, since that file holds "
            "only the lin heads, the torchvision vgg16 state dict via "
            "VAVAE_VGG16_WEIGHTS=/path/to/vgg16.pth"
        )
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    vgg_sd = None
    if vgg16_path and os.path.exists(vgg16_path):
        vgg_sd = torch.load(vgg16_path, map_location="cpu", weights_only=False)
        if hasattr(vgg_sd, "state_dict"):  # a pickled module, not a dict
            vgg_sd = vgg_sd.state_dict()
    model = LPIPS()
    model.load_state_dict(lpips_state_from_torch(sd, vgg_sd), strict=True)
    return model.to(dev).eval()
