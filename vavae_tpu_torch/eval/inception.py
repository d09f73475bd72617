"""FID InceptionV3 feature extractor (port of ``vavae_tpu/eval/inception.py``).

pytorch-fid's InceptionV3: torchvision's ``inception_v3`` with the FID
changes (3×3 average pools that do not count the padding in the A, C and E
blocks, a max pool in the last E block). The modules carry pytorch-fid's
names, so its checkpoint (``pt_inception-2015-12-05``) loads by name,
strictly, once its classifier (``fc.*``) is dropped. There is no download:
the weights come from ``weights_path`` or ``VAVAE_FID_WEIGHTS``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vavae_tpu_torch.utils.device import resolve_device

FID_DIMS = 2048


def _pad(k) -> tuple[int, int]:
    k = (k, k) if isinstance(k, int) else k
    return (k[0] // 2, k[1] // 2)


class BasicConv2d(nn.Module):
    """Conv (no bias) → BatchNorm (eps 1e-3, running statistics) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 average pool, pad 1, padding not counted (the FID quirk)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=_pad(5))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=_pad(3))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=_pad(3))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=_pad(3))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=_pad((1, 7)))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=_pad((7, 1)))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=_pad((7, 1)))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=_pad((1, 7)))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=_pad((7, 1)))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=_pad((1, 7)))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=_pad((1, 7)))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=_pad((7, 1)))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool`` "avg" (Mixed_7b) or "max" (Mixed_7c, pytorch-fid's change)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=_pad((1, 3)))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=_pad((3, 1)))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=_pad(3))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=_pad((1, 3)))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=_pad((3, 1)))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = avg_pool_3x3(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3FID(nn.Module):
    """Pool3 (2048-d) features of (B, H, W, 3) float images in [0, 1]:
    resized to 299² (``F.interpolate`` bilinear, ``align_corners=False``,
    no antialias, as pytorch-fid) and mapped to [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=_pad(3))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=False)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))  # adaptive average pool → (B, 2048)


@torch.no_grad()
def init_inception_weights(model: InceptionV3FID, generator: torch.Generator) -> None:
    """Random weights for smoke runs: He-normal convs (so the activations
    keep their scale through the depth), identity batch norms."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = (2.0 / m.weight[0].numel()) ** 0.5
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            nn.init.zeros_(m.running_mean)
            nn.init.ones_(m.running_var)


def load_inception(weights_path: Optional[str] = None, allow_random: bool = False,
                   device: str | torch.device = "cuda") -> InceptionV3FID:
    """The extractor in eval mode on ``device`` (the card unless ``"cpu"`` is
    asked for; without CUDA that raises). Without weights it raises,
    unless ``allow_random`` (or ``VAVAE_FID_ALLOW_RANDOM=1``): random
    weights still compare two sets (FID(a, a) ≈ 0), but their values mean
    nothing against published ones."""
    device = resolve_device(device)
    model = InceptionV3FID()
    weights_path = weights_path or os.environ.get("VAVAE_FID_WEIGHTS")
    allow_random = allow_random or os.environ.get("VAVAE_FID_ALLOW_RANDOM") == "1"
    if weights_path and os.path.exists(weights_path):
        sd = torch.load(weights_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        # without the classifier (and the auxiliary head torchvision's files carry)
        model.load_state_dict({k: v for k, v in sd.items()
                               if not k.startswith(("fc.", "AuxLogits."))}, strict=True)
    elif allow_random:
        init_inception_weights(model, torch.Generator().manual_seed(0))
    else:
        raise FileNotFoundError(
            "FID Inception weights not found. Download pt_inception-2015-12-05"
            " (pytorch-fid) and set VAVAE_FID_WEIGHTS=/path/to/weights.pth"
            " (or set VAVAE_FID_ALLOW_RANDOM=1 for smoke runs)"
        )
    return model.to(device).eval()
