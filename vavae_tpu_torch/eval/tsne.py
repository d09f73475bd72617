"""The port's t-SNE: what scikit-learn's ``TSNE(n_components=2,
perplexity=30, random_state=seed, init="pca")`` computes, without
scikit-learn, on the card unless asked for the CPU.

The schedule is scikit-learn 1.9's (``sklearn/manifold/_t_sne.py``):
- k = min(N - 1, floor(3 * perplexity + 1)) nearest neighbours on squared
  Euclidean distances (summed over the features in order, in float64), the
  squared distances rounded to float32 as scikit-learn rounds them before
  its search;
- per point, the binary search for the precision whose conditional
  distribution over those neighbours has the wanted perplexity
  (``_utils._binary_search_perplexity``: 100 steps at most, tolerance 1e-5
  on the entropy), then P = (P + P^T) / sum;
- the PCA init of ``PCA(n_components=2, random_state=seed)`` with its
  ``auto`` solver (``covariance_eigh`` for tall inputs, ``full`` for small
  ones, ``randomized`` drawing from ``RandomState(seed)``) and ``svd_flip``
  signs, computed in the input's dtype on the host as scikit-learn computes
  it, scaled to a first-column std of 1e-4;
- learning rate max(N / 12 / 4, 50); 250 iterations with P exaggerated 12
  times and momentum 0.5, then up to ``max_iter`` with momentum 0.8; gains
  +0.2 / x0.8 floored at 0.01; every 50 iterations the KL divergence and
  the gradient norm are checked (300 iterations without progress, or a
  gradient norm of 1e-7, end a stage).

The attractive term runs over the sparse P, as scikit-learn's does. The
repulsive term is exact, over all N^2 pairs in row chunks on the device,
where scikit-learn approximates it with a Barnes-Hut tree at angle 0.5; the
distances, P, the positions and the sums are float64 (scikit-learn keeps
the positions in float32). The card and the host agree to rounding for
the first tens of iterations, but the iterations are chaotic: rounding alone
(the card against the host, or the card's unordered ``index_add_`` from
one run to the next) ends in another layout. Twelve host runs of 1,000
latent pixels whose inits differ by 1e-14 to 1e-13 relative end with their
KL within 2.1% of each other, normalised entropy within 0.0076 and Gini
within 0.022; ``chip_smoke.py``'s ``TSNE_TOL`` holds the card to the host
within 8%, 0.02 and 0.05.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from vavae_tpu_torch.utils.device import resolve_device

MACHINE_EPSILON = float(np.finfo(np.double).eps)
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
CHECK_EVERY = 50


def _svd_flip_rows(u: Optional[np.ndarray], vt: np.ndarray):
    """``svd_flip(u, vt, u_based_decision=False)``: each row of ``vt`` made
    to have its largest entry (in magnitude) positive."""
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    if u is not None:
        u *= signs[np.newaxis, :]
    vt *= signs[:, np.newaxis]
    return u, vt


def _randomized_svd(m: np.ndarray, n_components: int, rs: np.random.RandomState):
    """scikit-learn's ``_randomized_svd`` as PCA calls it (10 oversamples,
    ``auto`` power iterations with LU normalisation, no sign flip)."""
    n_random = n_components + 10
    n_iter = 7 if n_components < 0.1 * min(m.shape) else 4
    transpose = m.shape[0] < m.shape[1]
    if transpose:
        m = m.T
    q = rs.normal(size=(m.shape[1], n_random))
    if m.dtype == np.float32:
        q = q.astype(np.float32, copy=False)
    for _ in range(n_iter):
        q, _ = linalg.lu(m @ q, permute_l=True, check_finite=False)
        q, _ = linalg.lu(m.T @ q, permute_l=True, check_finite=False)
    q, _ = linalg.qr(m @ q, mode="economic", check_finite=False)
    uhat, s, vt = linalg.svd(q.T @ m, full_matrices=False, lapack_driver="gesdd")
    u = q @ uhat
    if transpose:
        return vt[:n_components, :].T, s[:n_components], u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def pca_solver(n_samples: int, n_features: int, n_components: int = 2) -> str:
    """The solver PCA's ``auto`` picks for a dense (n_samples, n_features)
    input."""
    if n_features <= 1_000 and n_samples >= 10 * n_features:
        return "covariance_eigh"
    if max(n_samples, n_features) <= 500:
        return "full"
    if 1 <= n_components < 0.8 * min(n_samples, n_features):
        return "randomized"
    return "full"


def pca_init(x: np.ndarray, seed: int = 0, n_components: int = 2) -> np.ndarray:
    """t-SNE's PCA init: ``PCA(n_components, random_state=seed)
    .fit_transform(x)`` as float32, scaled to a first-column std of 1e-4."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    n, _ = x.shape
    mean = np.mean(x, axis=0)
    solver = pca_solver(*x.shape, n_components)
    if solver == "covariance_eigh":
        c = x.T @ x
        c -= n * np.reshape(mean, (-1, 1)) * np.reshape(mean, (1, -1))
        c /= n - 1
        _, vecs = np.linalg.eigh(c)
        vt = np.flip(vecs, axis=1).T
        _, vt = _svd_flip_rows(None, vt)
        comps = np.asarray(vt[:n_components], copy=True)
        emb = x @ comps.T
        emb -= np.reshape(mean, (1, -1)) @ comps.T
    elif solver == "full":
        u, s, vt = linalg.svd(x - mean, full_matrices=False)
        u, vt = _svd_flip_rows(u, vt)
        emb = u[:, :n_components] * s[:n_components]
    else:
        u, s, vt = _randomized_svd(x - mean, n_components, np.random.RandomState(seed))
        u, vt = _svd_flip_rows(u, vt)
        emb = u[:, :n_components] * s[:n_components]
    emb = emb.astype(np.float32, copy=False)
    return emb / np.std(emb[:, 0]) * 1e-4


def _row_chunk(n: int, device: torch.device) -> int:
    """Rows a chunk of an (rows, n) float64 temporary: about 128 MiB on the
    card, 8 MiB on the host."""
    budget = 1 << 24 if device.type == "cuda" else 1 << 20
    return max(1, min(n, budget // max(n, 1)))


def nearest_neighbours(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances, indices), each (N, k) sorted nearest first, of
    each row's k nearest other rows; the squared distances summed over the
    features in order, in float64."""
    n = x.shape[0]
    x = x.to(torch.float64)
    dists, idx = [], []
    step = _row_chunk(n, x.device)
    for s in range(0, n, step):
        xr = x[s:s + step]
        d2 = torch.zeros(xr.shape[0], n, dtype=torch.float64, device=x.device)
        for c in range(x.shape[1]):
            d2 += (xr[:, c:c + 1] - x[None, :, c]) ** 2
        d2[torch.arange(xr.shape[0], device=x.device), torch.arange(s, s + xr.shape[0], device=x.device)] = math.inf
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dists.append(d)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def binary_search_perplexity(sqdist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Conditional P (N, k) from each row's squared distances to its
    neighbours: scikit-learn's per-row search, run on all rows at once, each
    row frozen at the step where it converges."""
    n = sqdist.shape[0]
    dev = sqdist.device
    desired_entropy = math.log(perplexity)
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    p = torch.zeros_like(sqdist)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(100):
        pa = torch.exp(-sqdist * beta[:, None])
        sum_p = pa.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, torch.full_like(sum_p, 1e-8), sum_p)
        pa = pa / sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (sqdist * pa).sum(dim=1)
        diff = entropy - desired_entropy
        p = torch.where(active[:, None], pa, p)
        done = diff.abs() <= 1e-5
        up = active & ~done & (diff > 0.0)
        down = active & ~done & (diff <= 0.0)
        new_beta = torch.where(
            up, torch.where(torch.isinf(beta_max), beta * 2.0, (beta + beta_max) / 2.0),
            torch.where(down, torch.where(torch.isinf(beta_min), beta / 2.0,
                                          (beta + beta_min) / 2.0), beta))
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = new_beta
        active = active & ~done
        if not bool(active.any()):
            break
    return p


def joint_probabilities(x: torch.Tensor, perplexity: float = 30.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric joint P over the kNN graph (``_joint_probabilities_nn``):
    (rows, cols, values) of its entries, ordered by row then column, the
    values float64 and summing to 1."""
    n = x.shape[0]
    if not 0 < perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must be positive and below the "
                         f"number of samples ({n})")
    k = min(n - 1, int(3.0 * perplexity + 1))
    d2, idx = nearest_neighbours(x, k)
    # scikit-learn orders each row's neighbours by index before its search
    idx, order = torch.sort(idx, dim=1)
    d2 = torch.gather(d2, 1, order).to(torch.float32).to(torch.float64)
    cond = binary_search_perplexity(d2, perplexity).reshape(-1)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    # P + P^T: the entries of both, summed where they meet
    keys, inverse = torch.unique(torch.cat([rows * n + cols, cols * n + rows]),
                                 sorted=True, return_inverse=True)
    vals = torch.zeros(keys.shape[0], dtype=torch.float64, device=x.device)
    vals.index_add_(0, inverse, torch.cat([cond, cond]))
    vals /= max(float(vals.sum()), MACHINE_EPSILON)
    return keys // n, keys % n, vals


def kl_gradient(y: torch.Tensor, p: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                compute_error: bool = True) -> Tuple[float, torch.Tensor]:
    """(KL(P || Q), dKL/dy) for positions y (N, 2) float64 and P's entries
    (``joint_probabilities``): the attractive term over P's entries, the
    repulsive one exact over all pairs, in row chunks (squared distances
    as |a|^2 + |b|^2 - 2 a.b in float64). The KL is NaN unless
    ``compute_error``."""
    n = y.shape[0]
    i, j, pv = p
    diff = y[i] - y[j]
    w = 1.0 / (1.0 + (diff * diff).sum(dim=1))
    grad = torch.zeros_like(y).index_add_(0, i, (pv * w)[:, None] * diff)
    neg = torch.empty_like(y)
    sq = (y * y).sum(dim=1)
    z = y.new_zeros(())
    step = _row_chunk(n, y.device)
    for s in range(0, n, step):
        yr = y[s:s + step]
        q = sq[s:s + step, None] + sq[None, :]
        q.addmm_(yr, y.t(), alpha=-2.0).add_(1.0).reciprocal_()
        z += q.sum() - yr.shape[0]  # less the diagonal's ones
        q.mul_(q)
        neg[s:s + step] = q.sum(dim=1, keepdim=True) * yr - q @ y
    grad.sub_(neg / z).mul_(4.0)
    error = math.nan
    if compute_error:
        qij = w / z
        error = float((pv * torch.log(pv.clamp_min(FLOAT32_TINY)
                                      / qij.clamp_min(FLOAT32_TINY))).sum())
    return error, grad


def _gradient_descent(y: torch.Tensor, p: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], it: int, max_iter: int,
                      momentum: float, learning_rate: float, n_iter_without_progress: int,
                      min_grad_norm: float = 1e-7) -> Tuple[torch.Tensor, float, int]:
    """scikit-learn's ``_gradient_descent`` on float64 positions."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        error, grad = kl_gradient(y, p, compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(0.01)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return y, error, i


def tsne(features: np.ndarray, perplexity: float = 30.0, seed: int = 0, max_iter: int = 1000,
         device: str | torch.device = "cuda", n_iter_without_progress: int = 300
         ) -> Tuple[np.ndarray, float]:
    """(N, 2) float64 embedding of ``features`` (N, C) and its final KL
    divergence, on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    x = np.asarray(features)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float32)
    n = x.shape[0]
    p = joint_probabilities(torch.as_tensor(x, device=dev), perplexity)
    y = torch.as_tensor(pca_init(x, seed).astype(np.float64), device=dev)
    learning_rate = max(n / EARLY_EXAGGERATION / 4, 50.0)
    exaggerated = (p[0], p[1], p[2] * EARLY_EXAGGERATION)
    y, error, it = _gradient_descent(y, exaggerated, 0, EXPLORATION_ITERS, 0.5, learning_rate,
                                     EXPLORATION_ITERS)
    if it < EXPLORATION_ITERS or max_iter - EXPLORATION_ITERS > 0:
        y, error, it = _gradient_descent(y, p, it + 1, max_iter, 0.8, learning_rate,
                                         n_iter_without_progress)
    return y.cpu().numpy(), error
