"""Training regularisation for the classifiers (port of
``vavae_tpu/apps/regularization.py``): label smoothing, focal loss, mixup,
cutmix, label noise, a dropout schedule, the supervised and inter-user
contrastive losses, the class memory bank with its global-negative loss,
the expected calibration error and the warmup-cosine schedule.

Random draws come from an explicit ``torch.Generator``; each drawing
function also takes its draws as arguments (``lam``, ``perm``, the box
centre, the flip mask…), so tests hand the port the JAX package's draws.
Beta draws (mixup and cutmix λ) are made on the host by numpy, seeded
from the generator.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vavae_tpu_torch.train.dit_trainer import warmup_cosine_decay


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _beta(alpha: float, generator: Optional[torch.Generator]) -> float:
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device if generator is not None else "cpu"))
    return float(np.float32(np.random.default_rng(seed).beta(alpha, alpha)))


def smooth_labels(labels: torch.Tensor, num_classes: int, smoothing: float = 0.1) -> torch.Tensor:
    """(1 − ε)·onehot + ε/K."""
    onehot = F.one_hot(labels.long(), num_classes).float()
    return onehot * (1.0 - smoothing) + smoothing / num_classes


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float = 0.1) -> torch.Tensor:
    targets = smooth_labels(labels, logits.shape[-1], smoothing)
    return -torch.mean(torch.sum(targets * F.log_softmax(logits, dim=-1), dim=-1))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    idx = labels.long()[:, None]
    p_t = torch.gather(torch.exp(logp), -1, idx)[:, 0]
    logp_t = torch.gather(logp, -1, idx)[:, 0]
    return -torch.mean(alpha * (1.0 - p_t) ** gamma * logp_t)


def mixup(x: torch.Tensor, labels: torch.Tensor, num_classes: int, alpha: float = 0.2,
          generator: Optional[torch.Generator] = None, lam: Optional[float] = None,
          perm: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Beta(α, α) convex mix of the batch with a shuffled copy."""
    if lam is None:
        lam = _beta(alpha, generator)
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    lam = torch.tensor(lam, dtype=torch.float32, device=x.device)
    x_mix = lam * x + (1.0 - lam) * x[perm]
    y = F.one_hot(labels.long(), num_classes).float()
    return x_mix, lam * y + (1.0 - lam) * y[perm]


def cutmix(x: torch.Tensor, labels: torch.Tensor, num_classes: int, alpha: float = 1.0,
           generator: Optional[torch.Generator] = None, lam: Optional[float] = None,
           perm: Optional[torch.Tensor] = None, cy: Optional[int] = None,
           cx: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """CutMix with a Beta-sampled box centred at (cy, cx); label weights by
    the box's actual area."""
    B, H, W, _ = x.shape
    if lam is None:
        lam = _beta(alpha, generator)
    if perm is None:
        perm = torch.randperm(B, generator=generator, device=x.device)
    dev = generator.device if generator is not None else "cpu"
    if cy is None:
        cy = int(torch.randint(0, H, (1,), generator=generator, device=dev))
    if cx is None:
        cx = int(torch.randint(0, W, (1,), generator=generator, device=dev))
    cut = np.sqrt(np.float32(1.0) - np.float32(lam))
    ch, cw = int(cut * np.float32(H)), int(cut * np.float32(W))
    y0, y1 = np.clip(cy - ch // 2, 0, H), np.clip(cy + ch // 2, 0, H)
    x0, x1 = np.clip(cx - cw // 2, 0, W), np.clip(cx + cw // 2, 0, W)
    rows = torch.arange(H, device=x.device)[None, :, None, None]
    cols = torch.arange(W, device=x.device)[None, None, :, None]
    box = ((rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)).to(x.dtype)
    x_mix = x * (1.0 - box) + x[perm] * box
    area = float(np.float32((y1 - y0) * (x1 - x0)) / np.float32(H * W))
    y = F.one_hot(labels.long(), num_classes).float()
    return x_mix, (1.0 - area) * y + area * y[perm]


def add_label_noise(labels: torch.Tensor, num_classes: int, noise_prob: float = 0.05,
                    generator: Optional[torch.Generator] = None,
                    flip: Optional[torch.Tensor] = None,
                    random_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    if flip is None:
        flip = torch.rand(labels.shape, generator=generator, device=labels.device) < noise_prob
    if random_labels is None:
        random_labels = torch.randint(0, num_classes, labels.shape, generator=generator,
                                      device=labels.device)
    return torch.where(flip.bool(), random_labels.to(labels.dtype), labels)


def dropout_schedule(step: int, total_steps: int, start: float = 0.3, end: float = 0.1) -> float:
    """Linearly decaying dropout rate."""
    frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
    return start + (end - start) * frac


def supcon_loss(features: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss over L2-normalised features."""
    sim = features @ features.T / temperature
    B = features.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=features.device)
    sim = torch.where(eye, torch.full_like(sim, -1e9), sim)
    logp = F.log_softmax(sim, dim=-1)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    pos_count = torch.clamp(pos.sum(dim=-1), min=1)
    return -torch.mean(torch.sum(torch.where(pos, logp, torch.zeros_like(logp)), dim=-1)
                       / pos_count)


def interuser_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                               temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over the batch: −log(Σ_pos e^s / (Σ_pos e^s + Σ_neg e^s)),
    averaged over the anchors that have a positive."""
    B = features.shape[0]
    f = _normalize(features)
    sim = f @ f.T / temperature
    eye = torch.eye(B, dtype=torch.bool, device=features.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    neg = labels[:, None] != labels[None, :]
    sim = sim - torch.max(sim, dim=1, keepdim=True).values.detach()
    e = torch.exp(sim)
    zero = torch.zeros_like(e)
    pos_sum = torch.clamp(torch.sum(torch.where(pos, e, zero), dim=1), min=1e-8)
    neg_sum = torch.sum(torch.where(neg, e, zero), dim=1)
    loss = -torch.log(pos_sum / (pos_sum + neg_sum + 1e-8))
    has_pos = pos.any(dim=1)
    denom = torch.clamp(has_pos.sum(), min=1)
    return torch.sum(torch.where(has_pos, loss, torch.zeros_like(loss))) / denom


def init_memory_bank(num_classes: int, dim: int = 64, memory_size: int = 200,
                     generator: Optional[torch.Generator] = None,
                     device: str | torch.device = "cpu") -> dict:
    """Per-class feature ring buffer: L2-normalised normal draws (on the
    generator's device, then moved to ``device``) and a write pointer per
    class."""
    bank = torch.randn((num_classes, memory_size, dim), generator=generator,
                       device=generator.device if generator is not None else device).to(device)
    bank = bank / torch.linalg.vector_norm(bank, dim=-1, keepdim=True)
    return {"bank": bank, "ptr": torch.zeros((num_classes,), dtype=torch.int32, device=device)}


@torch.no_grad()
def update_memory_bank(memory: dict, features: torch.Tensor, labels: torch.Tensor) -> dict:
    """Ring-buffer write, as one scatter: sample i of class c lands at slot
    (ptr[c] + rank of i within c) % memory_size; where a class occurs more
    than memory_size times, only its last memory_size samples are written
    (the sequential loop's last-write-wins). Returns a new memory."""
    bank, ptr = memory["bank"].clone(), memory["ptr"]
    C, M = bank.shape[:2]
    f = _normalize(features.detach())
    labels = labels.long()
    B = labels.shape[0]
    same = labels[:, None] == labels[None, :]
    earlier = torch.tril(torch.ones((B, B), dtype=torch.bool, device=labels.device), diagonal=-1)
    occ = (same & earlier).sum(dim=1)
    slots = (ptr.long()[labels] + occ) % M
    counts = torch.bincount(labels, minlength=C)
    keep = occ >= counts[labels] - M
    bank[labels[keep], slots[keep]] = f[keep].to(bank.dtype)
    return {"bank": bank, "ptr": ((ptr.long() + counts) % M).to(ptr.dtype)}


def global_negative_contrastive(features: torch.Tensor, labels: torch.Tensor, memory: dict,
                                temperature: float = 0.07, margin: float = 0.5,
                                bank_pos: int = 50, bank_neg: int = 20) -> torch.Tensor:
    """Global-negative contrastive loss with the class memory bank: per
    anchor, positives are the other same-class batch samples and the first
    ``bank_pos`` entries of its class (−mean of sim/T); negatives the first
    ``bank_neg`` entries of every other class, the mean over the hard ones
    (sim/T > margin) when any, else over all."""
    bank = memory["bank"]
    C = bank.shape[0]
    B = features.shape[0]
    labels = labels.long()
    f = _normalize(features)
    batch_sim = f @ f.T / temperature
    eye = torch.eye(B, dtype=torch.bool, device=f.device)
    pos_mask = (labels[:, None] == labels[None, :]) & ~eye
    own_bank = bank[labels, :bank_pos]
    bank_sim = torch.einsum("bd,bpd->bp", f, own_bank) / temperature
    pos_sum = (torch.sum(torch.where(pos_mask, batch_sim, torch.zeros_like(batch_sim)), dim=1)
               + torch.sum(bank_sim, dim=1))
    pos_cnt = pos_mask.sum(dim=1) + bank_sim.shape[1]
    pos_loss = -pos_sum / pos_cnt

    neg_sim = torch.einsum("bd,cnd->bcn", f, bank[:, :bank_neg]) / temperature
    valid = (torch.arange(C, device=f.device)[None, :] != labels[:, None])[..., None].expand(
        neg_sim.shape)
    zero = torch.zeros_like(neg_sim)
    hard = (neg_sim > margin) & valid
    hard_cnt = hard.sum(dim=(1, 2))
    hard_mean = torch.sum(torch.where(hard, neg_sim, zero), dim=(1, 2)) / torch.clamp(hard_cnt, min=1)
    all_cnt = torch.clamp(valid.sum(dim=(1, 2)), min=1)
    all_mean = torch.sum(torch.where(valid, neg_sim, zero), dim=(1, 2)) / all_cnt
    neg_loss = torch.where(hard_cnt > 0, hard_mean, all_mean)
    return torch.mean(pos_loss + neg_loss)


def expected_calibration_error(probs: torch.Tensor, labels: torch.Tensor,
                               n_bins: int = 15) -> torch.Tensor:
    conf = torch.max(probs, dim=-1).values
    pred = torch.argmax(probs, dim=-1)
    correct = (pred == labels.long()).float()
    bins = torch.clamp((conf * n_bins).to(torch.int32), 0, n_bins - 1)
    ece = torch.zeros((), device=probs.device)
    for b in range(n_bins):
        mask = (bins == b).float()
        count = torch.clamp(mask.sum(), min=1.0)
        avg_conf = torch.sum(conf * mask) / count
        avg_acc = torch.sum(correct * mask) / count
        ece = ece + (mask.sum() / conf.shape[0]) * torch.abs(avg_conf - avg_acc)
    return ece


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_lr: float = 0.0):
    """count → learning rate: linear warmup from 0, then a cosine to
    ``min_lr`` (``optax.warmup_cosine_decay_schedule``)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1)
    return lambda count: warmup_cosine_decay(count, base_lr, warmup, decay, min_lr)
