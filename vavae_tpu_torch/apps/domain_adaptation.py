"""Few-shot domain adaptation: LCCS batch-norm statistic fusion and PNC
prototype fusion (port of ``vavae_tpu/apps/domain_adaptation.py``).

  - LCCS: the source classifier's batch-norm running statistics are fused
    with the support set's (target-domain) statistics,
    μ ← (1−α)·μ_src + α·μ_tgt, σ² ← (1−α)·σ²_src + α·σ²_tgt; or folded in
    progressively with a small momentum; or only the means shifted.
  - PNC: norm-weighted (or strategy-built) class prototypes from the
    support features, a temperature softmax over the prototype cosines
    fused with the classifier's probabilities.
  - The support split, the support-selection strategies, nearest-centroid
    classification, ensembles, the paired t-test and the grid drivers.

Model calls go through the port's ``models/resnet.py`` by
``torch.func.functional_call`` with explicit parameters and batch-norm
statistics (``{buffer name: tensor}``, e.g. ``bn1.running_mean``), in fp32
with TF32 off; everything else is numpy, as in the JAX package. The
train-mode passes read each batch norm's moments directly
(``BatchNorm.batch_moments``) where the JAX package recovers them from
flax's running-average update, ``(new − 0.9·old)/0.1``; both pool them the
same way (means weighted by chunk size, variances through E[x²], flax's
biased variance, in float64). The domain-adaptive classifier keeps its
dropout on in these passes, as the JAX package does, drawing the masks
from a generator seeded like its dropout key. k-means is
``utils/kmeans.py``. ``python -m vavae_tpu_torch.apps.domain_adaptation``
runs on the card unless ``--device cpu`` is passed.

    python -m vavae_tpu_torch.apps.domain_adaptation --classifier_ckpt clf.safetensors \\
        --target_split_file target.json --support_per_class 5 --ncc
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vavae_tpu_torch.models.discriminator import BatchNorm
from vavae_tpu_torch.utils.device import full_fp32
from vavae_tpu_torch.utils.kmeans import KMeans

Stats = Dict[str, torch.Tensor]


# -- model calls with explicit parameters and statistics -----------------------------


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _call(model, params, stats: Stats, images, train: bool = False, features: bool = False,
          seed: int = 0):
    """One forward of ``model`` on ``images`` (NHWC numpy in [-1, 1]) with
    ``params`` (None: the model's own) and ``stats``; in train mode the
    statistics are copies (the pass moves running stats in place) and the
    domain-adaptive classifier's dropout draws from a generator seeded with
    ``seed``."""
    dev = _device(model)
    x = torch.as_tensor(np.asarray(images), device=dev).float()
    tensors = dict(params if params is not None else model.named_parameters())
    tensors.update({k: v.clone() for k, v in stats.items()} if train else stats)
    kwargs = {"train": train, "features": features}
    if hasattr(model, "dropout_rate"):
        kwargs["generator"] = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad(), full_fp32():
        return torch.func.functional_call(model, tensors, (x,), kwargs)


def _batch_norms(model) -> Dict[str, BatchNorm]:
    return {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm)}


def _train_mode_moments(model, params, stats: Stats, batch, seed: int = 0
                        ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """One train-mode pass: each batch norm's batch (mean, biased variance)
    as float64, by module name. Models with dropout keep it on, as the
    JAX package's pass does."""
    bns = _batch_norms(model)
    for bn in bns.values():
        bn.batch_moments = None
    _call(model, params, stats, batch, train=True, seed=seed)
    return {name: (bn.batch_moments[0].double().cpu().numpy(),
                   bn.batch_moments[1].double().cpu().numpy())
            for name, bn in bns.items() if bn.batch_moments is not None}


def _moment_key(key: str) -> Tuple[str, str]:
    """``layer1_0.bn1.running_mean`` → (``layer1_0.bn1``, ``mean``)."""
    mod, leaf = key.rsplit(".", 1)
    return mod, leaf[len("running_"):]


def _stats_like(source: Stats, values: Dict[str, np.ndarray]) -> Stats:
    return {k: torch.as_tensor(np.asarray(values[k], np.float32), device=source[k].device)
            for k in source}


def model_stats(model) -> Stats:
    """A copy of ``model``'s batch-norm running statistics."""
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


# -- LCCS: linear combination of channel statistics ---------------------------------


def compute_target_bn_stats(
    model,
    params: Any,
    source_stats: Stats,
    support_images: np.ndarray,
    batch_size: int = 32,
) -> Stats:
    """PURE target-domain batch-norm statistics of the support set: each
    chunk's batch moments pooled over the chunks (means weighted by chunk
    size, variances through E[x²]); no source statistic leaks in."""
    n_total = 0
    acc_mean: dict = {}
    acc_e2: dict = {}
    for s in range(0, len(support_images), batch_size):
        batch = support_images[s : s + batch_size]
        n = len(batch)
        for name, (m, v) in _train_mode_moments(model, params, source_stats, batch,
                                                seed=s).items():
            acc_mean[name] = acc_mean.get(name, 0.0) + n * m
            acc_e2[name] = acc_e2.get(name, 0.0) + n * (v + m**2)
        n_total += n
    out = {}
    for key in source_stats:
        mod, leaf = _moment_key(key)
        mean = acc_mean[mod] / n_total
        out[key] = mean if leaf == "mean" else acc_e2[mod] / n_total - mean**2
    return _stats_like(source_stats, out)


def lccs_fuse_stats(source_stats: Stats, target_stats: Stats, alpha: float) -> Stats:
    """(1−α)·source + α·target, leafwise."""
    return {k: (1.0 - alpha) * s + alpha * target_stats[k] for k, s in source_stats.items()}


@dataclasses.dataclass
class LCCSAdapter:
    """Save/fuse/restore batch-norm statistics."""

    model: Any
    params: Any
    source_stats: Stats

    def adapt(self, support_images: np.ndarray, alpha: float = 0.3) -> Stats:
        target = compute_target_bn_stats(
            self.model, self.params, self.source_stats, support_images
        )
        return lccs_fuse_stats(self.source_stats, target, alpha)

    def restore(self) -> Stats:
        return self.source_stats


# -- LCCS v2: progressive small-momentum BN update ------------------------------


def lccs_progressive(
    model,
    params: Any,
    source_stats: Stats,
    support_images: np.ndarray,
    momentum: float = 0.01,
    iterations: int = 5,
    batch_size: int = 32,
) -> Stats:
    """Progressive update: the support set forwarded ``iterations`` times in
    train mode, each batch's statistics B folded in as S ← (1−m)·S + m·B."""
    stats = dict(source_stats)
    for it in range(iterations):
        for s in range(0, len(support_images), batch_size):
            batch = support_images[s : s + batch_size]
            moments = _train_mode_moments(model, params, stats, batch, seed=it * 1000 + s)
            new = {}
            for k, S in stats.items():
                mod, leaf = _moment_key(k)
                B = moments[mod][0 if leaf == "mean" else 1]
                new[k] = (1.0 - momentum) * S + momentum * torch.as_tensor(
                    B.astype(np.float32), device=S.device)
            stats = new
    return stats


def lccs_mean_shift(
    model,
    params: Any,
    source_stats: Stats,
    support_images: np.ndarray,
    shift: float = 0.3,
    batch_size: int = 32,
) -> Stats:
    """Mean-shift-only adaptation: μ ← μ + shift·(μ_target − μ), variances
    untouched; the target means are the chunks' batch means, averaged over
    the chunks."""
    batches = []
    for s in range(0, len(support_images), batch_size):
        batch = support_images[s : s + batch_size]
        batches.append(_train_mode_moments(model, params, source_stats, batch, seed=s))
    fused = {}
    for k, v in source_stats.items():
        mod, leaf = _moment_key(k)
        if leaf == "mean":
            target = torch.as_tensor(np.mean(np.stack(
                [b[mod][0].astype(np.float32) for b in batches]), 0), device=v.device)
            fused[k] = v + shift * (target - v)
        else:
            fused[k] = v
    return fused


# -- PNC: prototype-based classification fusion --------------------------------


def build_prototypes(
    features: np.ndarray, labels: np.ndarray, num_classes: int,
    norm_weighted: bool = True,
) -> np.ndarray:
    """Norm-weighted class prototypes (improved_pnc.py:33-68): features with
    larger norms (more confident embeddings) contribute more."""
    protos = np.zeros((num_classes, features.shape[-1]), np.float32)
    for c in range(num_classes):
        f = features[labels == c]
        if len(f) == 0:
            continue
        if norm_weighted:
            # reference-exact (improved_pnc.py:48-66): features are
            # L2-NORMALIZED first — the softmax over their (unit) norms is
            # then uniform — and the prototype is re-normalized. Weighting
            # RAW features by raw-norm fractions would hand an outlier with
            # 10× the norm ~10× the weight.
            fn = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
            w = np.exp(np.linalg.norm(fn, axis=-1))
            w = w / max(w.sum(), 1e-12)
            proto = (fn * w[:, None]).sum(axis=0)
            protos[c] = proto / max(np.linalg.norm(proto), 1e-12)
        else:
            protos[c] = f.mean(axis=0)
    return protos


def pnc_probs(
    features: np.ndarray,
    classifier_probs: np.ndarray,
    prototypes: np.ndarray,
    temperature: float = 0.1,
    fusion_weight: float = 0.5,
    confidence_adaptive: bool = True,
) -> np.ndarray:
    """Fuse prototype-similarity softmax with classifier probabilities
    (improved_pnc.py:70-108 adaptive_fusion_predict). With
    confidence_adaptive, each side is weighted by its NORMALIZED confidence
    (proto_conf/(proto_conf+class_conf) — the reference ignores alpha_base
    on this path); otherwise fusion_weight·proto + (1−fusion_weight)·class."""
    f = features / np.maximum(np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
    p = prototypes / np.maximum(np.linalg.norm(prototypes, axis=-1, keepdims=True), 1e-12)
    sim = f @ p.T  # cosine similarities
    ex = np.exp(sim / temperature - (sim / temperature).max(axis=-1, keepdims=True))
    proto_probs = ex / ex.sum(axis=-1, keepdims=True)

    if confidence_adaptive:
        proto_conf = proto_probs.max(axis=-1, keepdims=True)
        class_conf = classifier_probs.max(axis=-1, keepdims=True)
        total = proto_conf + class_conf + 1e-8
        return proto_probs * (proto_conf / total) + classifier_probs * (
            class_conf / total
        )
    return fusion_weight * proto_probs + (1.0 - fusion_weight) * classifier_probs


# -- combined evaluation --------------------------------------------------------


@dataclasses.dataclass
class DAResult:
    accuracy: float
    per_class_acc: Dict[int, float]
    config: Dict


def _apply_logits(model, params, stats: Stats, images) -> torch.Tensor:
    out = _call(model, params, stats, images)
    if isinstance(out, tuple):  # DomainAdaptiveClassifier returns (logits, feat)
        out = out[0]
    return out


def _softmax_probs(model, params, stats: Stats, images) -> np.ndarray:
    return torch.softmax(_apply_logits(model, params, stats, images), dim=-1).cpu().numpy()


def _features(model, params, stats: Stats, images) -> np.ndarray:
    return _call(model, params, stats, images, features=True).cpu().numpy()


def evaluate_adaptation(
    model,
    params: Any,
    batch_stats: Stats,
    test_images: np.ndarray,
    test_labels: np.ndarray,
    prototypes: Optional[np.ndarray] = None,
    pnc_cfg: Optional[dict] = None,
    batch_size: int = 64,
) -> DAResult:
    """Accuracy (+ per class) on the target test set with the given
    statistics and optional PNC fusion; the PNC features come from the same
    ``batch_stats`` as the logits."""
    preds = []
    for s in range(0, len(test_images), batch_size):
        x = test_images[s : s + batch_size]
        probs = _softmax_probs(model, params, batch_stats, x)
        if prototypes is not None:
            feats = _features(model, params, batch_stats, x)
            probs = pnc_probs(feats, probs, prototypes, **(pnc_cfg or {}))
        preds.append(probs.argmax(axis=-1))
    preds = np.concatenate(preds)
    acc = float((preds == test_labels).mean())
    per_class = {
        int(c): float((preds[test_labels == c] == c).mean())
        for c in np.unique(test_labels)
    }
    return DAResult(acc, per_class, {})


def _jax_stat_path(key: str) -> str:
    """``layer1_0.bn1.running_mean`` → ``layer1_0/bn1/mean``: the JAX
    package's flattened batch-stats key, which layer names match."""
    mod, leaf = _moment_key(key)
    return f"{mod.replace('.', '/')}/{leaf}"


def lccs_fuse_stats_per_layer(
    source_stats: Stats, target_stats: Stats, alphas: Dict[str, float],
    default_alpha: float = 0.3,
) -> Stats:
    """A fusion weight per batch-norm layer: the first name in ``alphas``
    that is a substring of the layer's JAX key (``layer1_0/bn1/mean``) sets
    its α, else ``default_alpha``."""
    fused = {}
    for key, s in source_stats.items():
        path = _jax_stat_path(key)
        alpha = default_alpha
        for name, a in alphas.items():
            if name in path:
                alpha = a
                break
        fused[key] = (1.0 - alpha) * s + alpha * target_stats[key]
    return fused


# -- support-set construction ---------------------------------------------------


def strategic_split(
    labels: np.ndarray,
    support_per_class: int,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """Support/test-DISJOINT index split of a target-domain set
    (strategic_dataset.py:15): per class, the first ``support_per_class``
    shuffled samples become the support set, the rest the test set."""
    rng = np.random.default_rng(seed)
    support, test = [], []
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        support.extend(idx[:support_per_class])
        test.extend(idx[support_per_class:])
    return np.asarray(sorted(support)), np.asarray(sorted(test))


def select_support(
    features: np.ndarray,
    labels: np.ndarray,
    probs: np.ndarray,
    support_size: int,
    strategy: str = "random",
    seed: int = 42,
) -> np.ndarray:
    """Support-sample selection strategies (sample_selection_pnc.py
    SampleSelector:24-160) — pick ``support_size`` indices from the
    candidate pool for PNC adaptation:

      - random: uniform without replacement (baseline, :31)
      - confidence: highest classifier max-softmax (:36)
      - diversity: k-means into ``support_size`` clusters, sample nearest
        each centroid (:60)
      - uncertainty: highest predictive entropy (:95)
      - balanced: 0.7·min-max-normalized confidence + 0.3·normalized mean
        pairwise feature distance (:120)

    The reference selects globally (not per class) — classes that end up
    unrepresented get zero prototypes downstream, matching its behavior."""
    n = len(labels)
    support_size = min(support_size, n)
    rng = np.random.default_rng(seed)
    if strategy == "random":
        return np.sort(rng.choice(n, support_size, replace=False))
    conf = probs.max(axis=-1)
    if strategy == "confidence":
        return np.sort(np.argsort(-conf)[:support_size])
    if strategy == "uncertainty":
        ent = -(probs * np.log(probs + 1e-8)).sum(axis=-1)
        return np.sort(np.argsort(-ent)[:support_size])
    if strategy == "diversity":
        if n <= support_size:
            return np.arange(n)
        km = KMeans(n_clusters=support_size, random_state=42, n_init=10)
        km.fit(features)
        picked = [
            int(np.argmin(np.linalg.norm(features - c, axis=1)))
            for c in km.cluster_centers_
        ]
        return np.sort(np.asarray(picked))
    if strategy == "balanced":
        span = conf.max() - conf.min()
        nc = (conf - conf.min()) / (span + 1e-8)
        d = np.linalg.norm(features[:, None] - features[None], axis=-1)
        dv = d.mean(axis=1)
        nd = (dv - dv.min()) / (dv.max() - dv.min() + 1e-8)
        return np.sort(np.argsort(0.7 * nc + 0.3 * nd)[-support_size:])
    raise ValueError(f"unknown support-selection strategy {strategy!r}")


def smart_select_support(
    features: np.ndarray,
    labels: np.ndarray,
    probs: np.ndarray,
    per_class: int,
    diversity_weight: float = 0.5,
) -> np.ndarray:
    """smart_sample_selector equivalent: greedy per-class pick balancing
    classifier confidence and feature diversity (max-min distance to the
    already-picked set)."""
    fn = features / np.maximum(np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
    picked: List[int] = []
    conf = probs.max(axis=-1)
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        chosen: List[int] = []
        for _ in range(min(per_class, len(idx))):
            best, best_score = None, -np.inf
            for i in idx:
                if i in chosen:
                    continue
                if chosen:
                    d = 1.0 - (fn[i] @ fn[chosen].T).max()
                else:
                    d = 1.0
                score = (1 - diversity_weight) * conf[i] + diversity_weight * d
                if score > best_score:
                    best, best_score = i, score
            chosen.append(best)
        picked.extend(chosen)
    return np.asarray(sorted(picked))


# -- statistical comparison -------------------------------------------------------


def paired_t_test(acc_a: Sequence[float], acc_b: Sequence[float]) -> Dict[str, float]:
    """Paired t-test over per-seed/per-episode accuracies
    (cross_domain_evaluator.py:88 uses paired t-tests to compare methods)."""
    from scipy import stats

    a, b = np.asarray(acc_a, np.float64), np.asarray(acc_b, np.float64)
    t, p = stats.ttest_rel(a, b)
    return {
        "t_statistic": float(t),
        "p_value": float(p),
        "mean_diff": float((a - b).mean()),
        "significant_05": bool(p < 0.05),
    }


def adapted_ensemble_probs(prob_list: Sequence[np.ndarray]) -> np.ndarray:
    """Average the softmax outputs of several adapted variants
    (different α / per-layer settings)."""
    return np.mean(np.stack(prob_list), axis=0)


def ensemble_predict_probs(
    orig_probs: np.ndarray,
    adapt_probs: np.ndarray,
    method: str = "confidence_weighted",
) -> np.ndarray:
    """LCCSEnsemble fusion of original vs LCCS-adapted model predictions
    (lccs_ensemble.py:38-78): per-sample confidence weighting, max-confidence
    selection, plain average, or the adapted model alone."""
    if method == "confidence_weighted":
        oc = orig_probs.max(axis=-1, keepdims=True)
        ac = adapt_probs.max(axis=-1, keepdims=True)
        total = oc + ac + 1e-8
        return orig_probs * (oc / total) + adapt_probs * (ac / total)
    if method == "max_confidence":
        mask = adapt_probs.max(-1, keepdims=True) > orig_probs.max(-1, keepdims=True)
        return np.where(mask, adapt_probs, orig_probs)
    if method == "average":
        return (orig_probs + adapt_probs) / 2.0
    if method == "lccs_only":
        return adapt_probs
    raise ValueError(f"unknown ensemble method {method!r}")


# -- prototype strategies (enhanced_prototype_methods.py + eval_utils.py) -------


def build_prototypes_strategy(
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    strategy: str = "simple_mean",
    probs: Optional[np.ndarray] = None,
    temperature: float = 0.1,
    augment_factor: float = 0.1,
    num_select: Optional[int] = None,
    seed: int = 42,
) -> np.ndarray:
    """Class prototypes under the reference's strategy space
    (eval_config.py PROTOTYPE_STRATEGIES + enhanced_prototype_methods.py):

      - simple_mean: mean → L2 normalize (eval_utils.py:161)
      - weighted_mean: classifier-confidence weights when ``probs`` given,
        else feature-norm softmax (enhanced v2, :44-75; eval_utils :192)
      - augmented: base mean averaged with 3 noise-perturbed copies
        (enhanced v3, :77-102)
      - adaptive: soft-nearest-neighbor reweighting within the class at
        ``temperature`` (enhanced v4, :104-126)
      - diversity: k-means picks ``num_select`` spread-out samples, mean of
        those (eval_utils :255)
      - uncertainty: top-half highest-entropy samples, needs ``probs``
        (eval_utils :305)

    Empty classes get zero prototypes (reference behavior)."""
    D = features.shape[-1]
    rng = np.random.default_rng(seed)
    protos = np.zeros((num_classes, D), np.float32)

    def _norm(v):
        n = np.linalg.norm(v)
        return v / n if n > 1e-12 else v

    for c in range(num_classes):
        mask = labels == c
        f = features[mask]
        if len(f) == 0:
            continue
        if strategy == "simple_mean":
            p = f.mean(axis=0)
        elif strategy == "weighted_mean":
            if probs is not None:
                w = probs[mask].max(axis=-1)
                w = w / max(w.sum(), 1e-12)
            else:
                n = np.linalg.norm(f, axis=-1)
                e = np.exp(n - n.max())
                w = e / e.sum()
            p = (f * w[:, None]).sum(axis=0)
        elif strategy == "augmented":
            base = f.mean(axis=0)
            noisy = [base + rng.standard_normal(D).astype(np.float32) * augment_factor
                     for _ in range(3)]
            p = np.stack([base] + noisy).mean(axis=0)
        elif strategy == "adaptive":
            sim = (f @ f.T) / temperature
            sim = sim - sim.max(axis=1, keepdims=True)
            w = np.exp(sim)
            w = w / w.sum(axis=1, keepdims=True)
            p = (w @ f).mean(axis=0)
        elif strategy == "diversity":
            k = num_select if num_select is not None else len(f)
            if len(f) <= k:
                sel = f
            else:
                km = KMeans(n_clusters=k, random_state=42, n_init=10).fit(f)
                idx = [
                    int(np.argmin(np.linalg.norm(f - cen, axis=1)))
                    for cen in km.cluster_centers_
                ]
                sel = f[idx]
            p = sel.mean(axis=0)
        elif strategy == "uncertainty":
            assert probs is not None, "uncertainty strategy needs classifier probs"
            pr = probs[mask]
            ent = -(pr * np.log(pr + 1e-8)).sum(axis=-1)
            order = np.argsort(-ent)
            top_k = min(len(f), max(1, len(f) // 2))
            p = f[order[:top_k]].mean(axis=0)
        else:
            raise ValueError(f"unknown prototype strategy {strategy!r}")
        protos[c] = _norm(p)
    return protos


def ncc_classify(
    features: np.ndarray,
    prototypes: np.ndarray,
    metric: str = "cosine",
    temperature: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Nearest-centroid classification (lccs_adapter.py:215-273, soft form
    enhanced_prototype_methods.py:143-152): returns (preds, confidences,
    probs). metric ∈ {cosine, euclidean} (NCC_CONFIG distance_metrics);
    scores are temperature-softmaxed."""
    if metric == "cosine":
        f = features / np.maximum(np.linalg.norm(features, axis=-1, keepdims=True), 1e-12)
        p = prototypes / np.maximum(np.linalg.norm(prototypes, axis=-1, keepdims=True), 1e-12)
        scores = f @ p.T
    elif metric == "euclidean":
        d = np.linalg.norm(features[:, None, :] - prototypes[None, :, :], axis=-1)
        scores = -d
    else:
        raise ValueError(f"unknown NCC metric {metric!r}")
    z = scores / temperature
    z = z - z.max(axis=-1, keepdims=True)
    probs = np.exp(z)
    probs /= probs.sum(axis=-1, keepdims=True)
    preds = probs.argmax(axis=-1)
    return preds, probs.max(axis=-1), probs


def lccs_pnc_combined(
    model,
    params: Any,
    source_stats: Stats,
    support_images: np.ndarray,
    support_labels: np.ndarray,
    num_classes: int,
    alpha: float = 0.3,
    pnc_cfg: Optional[dict] = None,
    lccs_method: str = "weighted",
    lccs_params: Optional[dict] = None,
    prototype_strategy: Optional[str] = None,
    prototype_kwargs: Optional[dict] = None,
):
    """LCCS-adapt the statistics on the support set, then build prototypes
    from features computed WITH the adapted statistics. Returns (stats,
    prototypes, predict_fn(images) -> fused probs).

    lccs_method ∈ {weighted, progressive, mean_shift}; prototype_strategy
    selects a builder of build_prototypes_strategy (None: the norm-weighted
    build_prototypes)."""
    if lccs_method == "weighted":
        stats = LCCSAdapter(model, params, source_stats).adapt(
            support_images, alpha=alpha
        )
    elif lccs_method == "progressive":
        stats = lccs_progressive(
            model, params, source_stats, support_images, **(lccs_params or {})
        )
    elif lccs_method == "mean_shift":
        stats = lccs_mean_shift(
            model, params, source_stats, support_images, **(lccs_params or {})
        )
    else:
        raise ValueError(f"unknown lccs_method {lccs_method!r}")

    def adapted_features(images) -> np.ndarray:
        return _features(model, params, stats, images)

    feats = adapted_features(support_images)
    if prototype_strategy is None:
        protos = build_prototypes(feats, support_labels, num_classes)
    else:
        sup_probs = _softmax_probs(model, params, stats, support_images)
        pk = dict(prototype_kwargs or {})
        if prototype_strategy == "diversity" and "num_select" not in pk:
            # half the smallest class's support, as the JAX package defaults
            # it, so k-means selects
            counts = np.bincount(support_labels, minlength=num_classes)
            pk["num_select"] = max(1, int(counts[counts > 0].min()) // 2)
        protos = build_prototypes_strategy(
            feats, support_labels, num_classes, strategy=prototype_strategy,
            probs=sup_probs, **pk,
        )

    def predict(images: np.ndarray) -> np.ndarray:
        probs = _softmax_probs(model, params, stats, images)
        return pnc_probs(adapted_features(images), probs, protos, **(pnc_cfg or {}))

    return stats, protos, predict


def hyperparameter_search(
    eval_fn: Callable[[Dict], float],
    grid: Dict[str, Iterable],
) -> Tuple[Dict, float, List[Tuple[Dict, float]]]:
    """Exhaustive grid search (run_full_hyperparameter_search.py driver).

    eval_fn(config) -> accuracy. Returns (best_config, best_acc, all)."""
    keys = list(grid)
    results: List[Tuple[Dict, float]] = []
    best, best_acc = None, -1.0
    for combo in itertools.product(*(grid[k] for k in keys)):
        cfg = dict(zip(keys, combo))
        acc = eval_fn(cfg)
        results.append((cfg, acc))
        if acc > best_acc:
            best, best_acc = cfg, acc
    return best, best_acc, results


DEFAULT_SEARCH_SPACE = {
    # compact everyday grid (the full reference space is EVAL_CONFIG below)
    "lccs_alpha": [0.1, 0.2, 0.3, 0.5],
    "pnc_temperature": [0.05, 0.1, 0.2],
    "pnc_fusion_weight": [0.3, 0.5, 0.7],
    "confidence_adaptive": [True, False],
}

# the reference's complete search space, dimension for dimension
# (domain_adaptation_experiment/eval_config.py:8-56)
EVAL_CONFIG = {
    "data": {
        "support_sizes": [3, 5, 10],
        "random_seeds": [42, 123, 456],
    },
    "pnc": {
        "fusion_alphas": [0.3, 0.4, 0.5, 0.6, 0.7, 0.8],
        "similarity_taus": [0.005, 0.01, 0.02, 0.05, 0.1],
        "use_adaptive_fusion": [True, False],
    },
    "lccs": {
        "methods": ["progressive", "weighted"],
        "progressive": {
            "momentums": [0.001, 0.005, 0.01, 0.02],
            "iterations": [3, 5, 10],
        },
        "weighted": {"alphas": [0.1, 0.2, 0.3, 0.4, 0.5]},
    },
    "ncc": {
        "temperatures": [0.005, 0.01, 0.02, 0.05],
        "distance_metrics": ["cosine", "euclidean"],
    },
    "prototype_strategies": [
        "simple_mean", "weighted_mean", "diversity", "uncertainty",
    ],
    "quick_test": {"support_sizes": [3], "random_seeds": [42]},
}


def full_method_grid(eval_config: Dict = EVAL_CONFIG) -> List[Dict]:
    """Enumerate every method combination the reference drivers search
    (run_full/optimized_hyperparameter_search.py over eval_config.py):
    each LCCS variant (progressive momentum×iterations + weighted alphas)
    crossed with the PNC grid and each prototype strategy. Returns a list
    of config dicts consumable by the CLI's eval function."""
    lccs_variants: List[Dict] = []
    prog = eval_config["lccs"]["progressive"]
    for m in prog["momentums"]:
        for it in prog["iterations"]:
            lccs_variants.append({
                "lccs_method": "progressive",
                "lccs_params": {"momentum": m, "iterations": it},
            })
    for a in eval_config["lccs"]["weighted"]["alphas"]:
        lccs_variants.append({"lccs_method": "weighted", "lccs_alpha": a})

    combos: List[Dict] = []
    pnc = eval_config["pnc"]
    for lv in lccs_variants:
        for fa in pnc["fusion_alphas"]:
            for tau in pnc["similarity_taus"]:
                for adaptive in pnc["use_adaptive_fusion"]:
                    for strat in eval_config["prototype_strategies"]:
                        combos.append({
                            **lv,
                            "pnc_fusion_weight": fa,
                            "pnc_temperature": tau,
                            "confidence_adaptive": adaptive,
                            "prototype_strategy": strat,
                        })
    return combos


def main(argv=None) -> Dict:
    """Load a source classifier, split a target-domain dataset into disjoint
    support and test sets, run the LCCS+PNC grid search, and report the
    baseline against the best adapted accuracy; returns the report (the
    ``--out`` JSON, with the ensemble accuracy when asked)."""
    import argparse
    import json

    from vavae_tpu_torch.apps.train_classifier import ClassifierTrainer, restore_classifier
    from vavae_tpu_torch.data.image_folder import SplitFileDataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--classifier_ckpt", required=True)
    ap.add_argument("--target_split_file", required=True,
                    help="target-domain split file (its 'val' side is used)")
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "improved", "calibrated", "domain_adaptive"])
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--support_per_class", type=int, default=5)
    ap.add_argument("--support_selection", default=None,
                    choices=["random", "confidence", "diversity",
                             "uncertainty", "balanced", "smart"],
                    help="subselect HALF the support pool with a "
                         "sample_selection_pnc.py strategy before adapting "
                         "(smart = smart_sample_selector greedy per-class)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--full_grid", action="store_true",
                    help="search DEFAULT_SEARCH_SPACE (default: a 2x2 sub-grid)")
    ap.add_argument("--reference_grid", action="store_true",
                    help="search the reference's COMPLETE method space "
                         "(eval_config.py: every LCCS variant × PNC grid × "
                         "prototype strategy — thousands of combos)")
    ap.add_argument("--limit", type=int, default=None,
                    help="cap the number of combos evaluated (sampled evenly)")
    ap.add_argument("--combo", default=None,
                    help="evaluate exactly ONE configuration, given as a JSON "
                         "dict of grid keys (run_best_config_only.py "
                         "equivalent), e.g. '{\"lccs_alpha\": 0.3, "
                         "\"pnc_temperature\": 0.1, \"pnc_fusion_weight\": "
                         "0.5, \"confidence_adaptive\": true}'")
    ap.add_argument("--ncc", action="store_true",
                    help="NCC supplement (run_ncc_supplement.py): after the "
                         "search, nearest-centroid-classify the best-adapted "
                         "feature space over the reference NCC grid "
                         "(temperatures x distance metrics)")
    ap.add_argument("--ensemble", default=None,
                    choices=["confidence_weighted", "max_confidence",
                             "average", "lccs_only"],
                    help="also fuse the best adapted model with the original "
                         "(lccs_ensemble.py) and report the ensemble accuracy")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = ClassifierTrainer(num_classes=args.num_classes, mode=args.mode,
                                device=args.device)
    restore_classifier(args.classifier_ckpt, trainer, trainer.init_state(0))
    model = trainer.model.eval()
    params = {k: v.detach() for k, v in model.named_parameters()}
    source_stats = model_stats(model)

    ds = SplitFileDataset(args.target_split_file, args.split, image_size=args.image_size)
    pairs = [ds[i] for i in range(len(ds))]
    images = np.stack([p[0] for p in pairs])
    labels = np.asarray([p[1] for p in pairs], np.int64)
    sup_idx, test_idx = strategic_split(labels, args.support_per_class, seed=args.seed)
    sup_x, sup_y = images[sup_idx], labels[sup_idx]
    test_x, test_y = images[test_idx], labels[test_idx]
    print(f"target: {len(sup_x)} support / {len(test_x)} test")

    def feature_fn(x):
        return _features(model, params, source_stats, x)

    if args.support_selection:
        # strategy comparison protocol (sample_selection_pnc.py): select a
        # smaller support subset from the disjoint support pool, keep the
        # test set untouched
        feats = feature_fn(sup_x)
        sprobs = _softmax_probs(model, params, source_stats, sup_x)
        keep = max(1, len(sup_x) // 2)
        if args.support_selection == "smart":
            sel = smart_select_support(
                feats, sup_y, sprobs,
                per_class=max(1, args.support_per_class // 2),
            )
        else:
            sel = select_support(
                feats, sup_y, sprobs, keep, args.support_selection,
                seed=args.seed,
            )
        sup_x, sup_y = sup_x[sel], sup_y[sel]
        print(f"support after {args.support_selection} selection: {len(sup_x)}")

    baseline = evaluate_adaptation(model, params, source_stats, test_x, test_y)
    print(f"baseline (no adaptation): {baseline.accuracy:.4f}")

    grid = DEFAULT_SEARCH_SPACE if args.full_grid else {
        "lccs_alpha": [0.2, 0.5],
        "pnc_temperature": [0.1],
        "pnc_fusion_weight": [0.3, 0.7],
        "confidence_adaptive": [True],
    }

    def adapt_cfg(cfg):
        return lccs_pnc_combined(
            model, params, source_stats, sup_x, sup_y, args.num_classes,
            alpha=cfg.get("lccs_alpha", 0.3),
            lccs_method=cfg.get("lccs_method", "weighted"),
            lccs_params=cfg.get("lccs_params"),
            prototype_strategy=cfg.get("prototype_strategy"),
            pnc_cfg=dict(
                temperature=cfg["pnc_temperature"],
                fusion_weight=cfg["pnc_fusion_weight"],
                confidence_adaptive=cfg["confidence_adaptive"],
            ),
        )

    # The expensive work (BN-stat adaptation, support/test forwards,
    # prototype build) depends ONLY on the lccs/prototype sub-config; the
    # PNC fusion knobs (temperature/weight/adaptive) are cheap numpy over
    # cached test probs+features. The reference grid sweeps ~240 fusion
    # combos per LCCS variant — without this cache every one re-ran the
    # full model over support+test sets.
    adapt_cache: dict = {}

    def _adapt_key(cfg):
        return json.dumps(
            {k: cfg.get(k) for k in
             ("lccs_alpha", "lccs_method", "lccs_params", "prototype_strategy")},
            sort_keys=True,
        )

    def eval_cfg(cfg):
        key = _adapt_key(cfg)
        if key not in adapt_cache:
            stats, protos, _ = adapt_cfg(cfg)
            probs_l, feats_l = [], []
            for s in range(0, len(test_x), 64):
                xb = test_x[s : s + 64]
                probs_l.append(_softmax_probs(model, params, stats, xb))
                feats_l.append(_features(model, params, stats, xb))
            adapt_cache[key] = (
                np.concatenate(probs_l), np.concatenate(feats_l), protos
            )
        probs, feats, protos = adapt_cache[key]
        fused = pnc_probs(
            feats, probs, protos,
            temperature=cfg["pnc_temperature"],
            fusion_weight=cfg["pnc_fusion_weight"],
            confidence_adaptive=cfg["confidence_adaptive"],
        )
        return float((fused.argmax(-1) == test_y).mean())

    if args.combo:
        cfg = json.loads(args.combo)
        cfg.setdefault("pnc_temperature", 0.1)
        cfg.setdefault("pnc_fusion_weight", 0.5)
        cfg.setdefault("confidence_adaptive", True)
        best_cfg, best_acc = cfg, eval_cfg(cfg)
        results = [(cfg, best_acc)]
    elif args.reference_grid:
        combos = full_method_grid()
        if args.limit and args.limit < len(combos):
            idx = np.linspace(0, len(combos) - 1, args.limit).astype(int)
            combos = [combos[i] for i in idx]
        print(f"reference grid: {len(combos)} method combinations")
        results = [(c, eval_cfg(c)) for c in combos]
        best_cfg, best_acc = max(results, key=lambda r: r[1])
    else:
        best_cfg, best_acc, results = hyperparameter_search(eval_cfg, grid)
    print(f"best adapted: {best_acc:.4f} with {best_cfg} "
          f"(delta {best_acc - baseline.accuracy:+.4f})")

    ncc_results: Dict[str, float] = {}
    if args.ncc:
        # the best config's adapted test features + prototypes are already
        # cached from its eval — the NCC sweep is pure numpy on top
        _, feats, protos = adapt_cache[_adapt_key(best_cfg)]
        for metric in EVAL_CONFIG["ncc"]["distance_metrics"]:
            for tau in EVAL_CONFIG["ncc"]["temperatures"]:
                preds, _, _ = ncc_classify(feats, protos, metric=metric,
                                           temperature=tau)
                ncc_results[f"{metric}@{tau}"] = float((preds == test_y).mean())
        best_ncc = max(ncc_results, key=ncc_results.get)
        print(f"ncc supplement: best {best_ncc} = {ncc_results[best_ncc]:.4f} "
              f"(vs adapted {best_acc:.4f})")

    ens_acc = None
    if args.ensemble:
        stats, _, predict = adapt_cfg(best_cfg)
        fused_preds = []
        for s in range(0, len(test_x), 64):
            xb = test_x[s : s + 64]
            orig = _softmax_probs(model, params, source_stats, xb)
            fused_preds.append(
                ensemble_predict_probs(orig, predict(xb), args.ensemble).argmax(-1)
            )
        ens_acc = float((np.concatenate(fused_preds) == test_y).mean())
        print(f"ensemble ({args.ensemble}): {ens_acc:.4f}")
    report = {
        "baseline_accuracy": baseline.accuracy,
        "best_accuracy": best_acc,
        "best_config": best_cfg,
        "grid_results": [(c, a) for c, a in results],
        **({"ncc_results": ncc_results} if ncc_results else {}),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"written to {args.out}")
    if ens_acc is not None:
        report["ensemble_accuracy"] = ens_acc
    return report


if __name__ == "__main__":
    main()
