"""ResNet-18 classifiers (port of ``vavae_tpu/models/resnet.py``).

Takes NHWC images, computes NCHW. Modules carry the JAX package's names
(``conv1``, ``bn1``, ``layer{s}_{b}`` with ``conv1``/``bn1``/``conv2``/
``bn2``/``down_conv``/``down_bn``, ``head_fc``, ``fc``, ``proj``; and
``backbone``, ``proj_fc``, ``proj_bn``, ``cls_fc1``, ``cls_bn``,
``cls_fc2`` in ``DomainAdaptiveClassifier``), so the weight bridge
(``utils/weights.py``: ``resnet_state_from_jax``/``resnet_state_to_jax``) is
a transpose per kernel. The batch norms are flax's (``BatchNorm`` of
``models/discriminator.py``: biased variance, running stats ``0.9·r +
0.1·batch``), the stem's max pool pads with −∞ by (1, 1), and the
domain-adaptive backbone is a ``ResNet18`` without heads, as the JAX
backbone called with ``features=True`` never creates its ``fc``.

Dropout (the domain-adaptive heads) draws its keep masks from the
``generator`` passed to ``forward``, or takes ``dropout_masks`` (a list of
two 0/1 masks, tests hand in fixed ones); kept units are scaled by
1/(1 − rate), as flax's ``nn.Dropout``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vavae_tpu_torch.models.discriminator import BatchNorm
from vavae_tpu_torch.utils.weights import lecun_normal_


def _bn1d(bn: BatchNorm, x: torch.Tensor, train: bool) -> torch.Tensor:
    """flax BatchNorm over the features of (B, F)."""
    return bn(x[:, :, None, None], train)[:, :, 0, 0]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, padding=1, bias=False)
        self.bn2 = BatchNorm(filters)
        if stride != 1 or cin != filters:
            self.down_conv = nn.Conv2d(cin, filters, 1, stride, bias=False)
            self.down_bn = BatchNorm(filters)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x), train)
        return F.relu(residual + y)


class ResNet18(nn.Module):
    """Backbone + optional heads. ``forward`` returns logits; ``features=True``
    the 512-d pooled embedding; ``return_all=True`` (logits, features,
    L2-normalised projection or None). ``heads=False`` builds the backbone
    alone (the domain-adaptive classifier's)."""

    def __init__(self, num_classes: int = 31, head_dim: int = 0, proj_dim: int = 0,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), heads: bool = True):
        super().__init__()
        self.head_dim, self.proj_dim = head_dim, proj_dim
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin, filters = 64, 64
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, BasicBlock(cin, filters, stride))
                self.block_names.append(name)
                cin = filters
            filters *= 2
        self.heads = heads
        if heads:
            if head_dim:
                self.head_fc = nn.Linear(cin, head_dim)
            self.fc = nn.Linear(head_dim or cin, num_classes)
            if proj_dim:
                self.proj = nn.Linear(cin, proj_dim)
        init_flax_(self)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                return_all: bool = False):
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)), train))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        feat = h.mean(dim=(2, 3))
        if features and not return_all:
            return feat
        if self.head_dim:
            logits = self.fc(F.relu(self.head_fc(feat)))
        else:
            logits = self.fc(feat)
        if self.proj_dim and (return_all or train):
            p = self.proj(feat)
            p = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-12)
            if return_all:
                return logits, feat, p
        if return_all:
            return logits, feat, None
        return logits


class DomainAdaptiveClassifier(nn.Module):
    """ResNet18 backbone + BN-regularised projector and classifier heads.
    ``forward`` returns (logits, features); ``features=True`` the projected
    features only; ``return_all=True`` (logits, features, their L2
    normalisation)."""

    def __init__(self, num_classes: int = 31, feature_dim: int = 512,
                 dropout_rate: float = 0.3):
        super().__init__()
        self.feature_dim, self.dropout_rate = feature_dim, dropout_rate
        self.backbone = ResNet18(heads=False)
        self.proj_fc = nn.Linear(512, feature_dim)
        self.proj_bn = BatchNorm(feature_dim)
        self.cls_fc1 = nn.Linear(feature_dim, 256)
        self.cls_bn = BatchNorm(256)
        self.cls_fc2 = nn.Linear(256, num_classes)
        init_flax_(self)

    def _dropout(self, x, train, generator, mask):
        if not train or self.dropout_rate == 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        if mask is None:
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                return_all: bool = False, generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[list] = None):
        masks = dropout_masks or [None, None]
        feat512 = self.backbone(x, train, features=True)
        h = F.relu(_bn1d(self.proj_bn, self.proj_fc(feat512), train))
        feat = self._dropout(h, train, generator, masks[0])
        if features and not return_all:
            return feat
        c = F.relu(_bn1d(self.cls_bn, self.cls_fc1(feat), train))
        c = self._dropout(c, train, generator, masks[1])
        logits = self.cls_fc2(c)
        if return_all:
            norm = torch.clamp(torch.linalg.vector_norm(feat, dim=-1, keepdim=True), min=1e-12)
            return logits, feat, feat / norm
        return logits, feat


@torch.no_grad()
def init_flax_(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default init: lecun-normal conv and Dense kernels, zero biases;
    batch-norm scale 1, bias 0, running stats 0 and 1."""
    generator = generator or torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()


@torch.no_grad()
def update_feature_bank(bank: torch.Tensor, features: torch.Tensor, labels: torch.Tensor,
                        momentum: float = 0.95) -> torch.Tensor:
    """EMA class prototypes, in place: bank[l] = m·bank[l] + (1 − m)·f for
    each sample in batch order (duplicates of a class fold in one after
    another)."""
    for f, label in zip(features.detach(), labels.tolist()):
        bank[label] = bank[label] * momentum + f * (1.0 - momentum)
    return bank


def feature_similarity(bank: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of features against the class prototypes."""
    f = features / torch.clamp(torch.linalg.vector_norm(features, dim=-1, keepdim=True), min=1e-12)
    p = bank / torch.clamp(torch.linalg.vector_norm(bank, dim=-1, keepdim=True), min=1e-12)
    return f @ p.T
