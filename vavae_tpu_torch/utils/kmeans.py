"""k-means in numpy: the port's stand-in for ``sklearn.cluster.KMeans(
n_clusters=k, random_state=42, n_init=10)``, which the JAX package's
domain adaptation calls (``vavae_tpu/apps/domain_adaptation.py:388, 557``)
and the card's machine does not have.

The algorithm is scikit-learn's dense Lloyd k-means (1.x):
  - the data centred on its mean; the tolerance ``tol`` times the mean of
    the per-feature variances;
  - greedy k-means++ seeding: the first centre drawn with
    ``RandomState.choice``, then ``2 + int(log k)`` candidates a centre
    drawn in proportion to the squared distance to the nearest centre, the
    one that lowers the potential most kept;
  - Lloyd's iterations until the labels repeat or the squared centre shift
    falls to the tolerance (then one more assignment), an empty cluster
    taking the point farthest from its centre;
  - the best of ``n_init`` runs by inertia, all drawn from one
    ``np.random.RandomState(random_state)`` stream.
It computes in float64 where scikit-learn keeps float32 data in float32,
so the two agree where the clustering is unique (well-separated data) and
may part at near-ties elsewhere (``tests/test_torch_domain_adaptation.py``
measures the inertia gap).
"""
from __future__ import annotations

import numpy as np


def _sq_dists(a: np.ndarray, b: np.ndarray, b_sq: np.ndarray) -> np.ndarray:
    """Squared euclidean distances (len(a), len(b)), clipped at 0."""
    d = (a * a).sum(-1)[:, None] - 2.0 * (a @ b.T) + b_sq[None, :]
    return np.maximum(d, 0.0)


def kmeans_plusplus(X: np.ndarray, k: int, x_sq: np.ndarray,
                    rs: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ initial centres (k, D) of the centred X."""
    n = len(X)
    trials = 2 + int(np.log(k))
    weights = np.ones(n)
    first = rs.choice(n, p=weights / weights.sum())
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[first]
    closest = _sq_dists(X[first][None], X, x_sq)[0]
    pot = closest.sum()
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(closest), rand_vals)
        np.clip(cand, None, n - 1, out=cand)
        d = np.minimum(closest, _sq_dists(X[cand], X, x_sq))
        pots = d.sum(-1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], d[best]
        centers[c] = X[cand[best]]
    return centers


def _assign(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest centre of each point (the lowest index on a tie)."""
    d = (centers * centers).sum(-1)[None, :] - 2.0 * (X @ centers.T)
    return np.argmin(d, axis=1)


def _update(X: np.ndarray, labels: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Means of the clusters; an empty one takes the point farthest from
    its centre, which leaves its old cluster."""
    k = len(centers)
    sums = np.zeros_like(centers)
    np.add.at(sums, labels, X)
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    empty = np.where(counts == 0)[0]
    if len(empty):
        dist = ((X - centers[labels]) ** 2).sum(-1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        for new, idx in zip(empty, far):
            old = labels[idx]
            sums[old] -= X[idx]
            counts[old] -= 1.0
            sums[new] = X[idx]
            counts[new] = 1.0
    return sums / np.maximum(counts, 1.0)[:, None]


def lloyd(X: np.ndarray, centers: np.ndarray, max_iter: int, tol: float
          ) -> tuple[np.ndarray, float, np.ndarray, int]:
    """(labels, inertia, centres, iterations) of one Lloyd run."""
    labels_old = np.full(len(X), -1)
    strict = False
    for i in range(max_iter):
        labels = _assign(X, centers)
        new = _update(X, labels, centers)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers, i + 1


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """True when two labelings are the same partition up to renaming."""
    mapping = np.full(k, -1)
    for x, y in zip(a, b):
        if mapping[x] == -1:
            mapping[x] = y
        elif mapping[x] != y:
            return False
    return True


class KMeans:
    """``fit(X)`` sets ``cluster_centers_``, ``labels_``, ``inertia_`` and
    ``n_iter_``, as scikit-learn's estimator does."""

    def __init__(self, n_clusters: int = 8, random_state: int = 0, n_init: int = 10,
                 max_iter: int = 300, tol: float = 1e-4):
        self.n_clusters, self.random_state = n_clusters, random_state
        self.n_init, self.max_iter, self.tol = n_init, max_iter, tol

    def fit(self, X) -> "KMeans":
        X = np.asarray(X, np.float64)
        k = self.n_clusters
        if not 1 <= k <= len(X):
            raise ValueError(f"n_samples={len(X)} should be >= n_clusters={k}")
        rs = np.random.RandomState(self.random_state)
        tol = float(np.mean(np.var(X, axis=0)) * self.tol)
        mean = X.mean(axis=0)
        Xc = X - mean
        x_sq = (Xc * Xc).sum(-1)
        best = None
        for _ in range(self.n_init):
            run = lloyd(Xc, kmeans_plusplus(Xc, k, x_sq, rs), self.max_iter, tol)
            if best is None or (run[1] < best[1] and not _same_clustering(run[0], best[0], k)):
                best = run
        labels, inertia, centers, n_iter = best
        self.cluster_centers_ = centers + mean
        self.labels_, self.inertia_, self.n_iter_ = labels, inertia, n_iter
        return self
