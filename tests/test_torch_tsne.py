"""The port's t-SNE (``eval/tsne.py``) and scatter plot
(``eval/latent_vis.py:render_scatter``) against scikit-learn 1.9 and
matplotlib, on the CPU:
- the joint probabilities P against ``_joint_probabilities_nn`` within 1e-6
  relative, entry by entry: whole (neighbour search included) where
  scikit-learn searches a KD-tree (up to 15 features); at 32 and 64
  features, where it takes the brute route through float32 GEMM distances
  (``EuclideanArgKmin32``) whose rounding moves P by up to 6e-5 relative,
  fed the port's exact neighbour distances;
- the PCA init against ``PCA(n_components=2, random_state=seed)`` scaled as
  ``_t_sne.py:1012`` scales it, within 1e-6, for each solver its ``auto``
  rule picks (``covariance_eigh``, ``full``, ``randomized``);
- one gradient against ``_kl_divergence_bh`` at ``angle=0.0`` (no cell
  summarised) within 1e-5 relative, and the KL within 1e-5;
- the scatter plot of one embedding against matplotlib's figure: the frame
  within 1 level, the axes' pixels within 6 levels.
"""
import io

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_common import one_thread  # noqa: F401
from vavae_tpu_torch.eval import latent_vis as tvis
from vavae_tpu_torch.eval import tsne as T
from vavae_tpu_torch.utils.png import read_png

pytestmark = pytest.mark.usefixtures("one_thread")


def _sklearn_p(x: np.ndarray, perplexity: float = 30.0, sqdist=None):
    """scikit-learn's P for ``x`` (its own neighbour search), or from
    ``sqdist``, a CSR matrix of squared neighbour distances."""
    from sklearn.manifold import _t_sne
    from sklearn.neighbors import NearestNeighbors

    if sqdist is None:
        k = min(len(x) - 1, int(3.0 * perplexity + 1))
        sqdist = NearestNeighbors(algorithm="auto", n_neighbors=k).fit(x).kneighbors_graph(
            mode="distance")
        sqdist.data **= 2
    return _t_sne._joint_probabilities_nn(sqdist, perplexity, 0)


def _dense(n, rows, cols, vals):
    out = np.zeros((n, n))
    out[rows, cols] = vals
    return out


def _data(n: int, c: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, c)).astype(np.float32)
    x[:, : max(1, c // 4)] *= 3  # a few dominant directions
    return x


@pytest.mark.parametrize("n,c", [(300, 4), (250, 8), (400, 15), (240, 32), (200, 64)])
def test_joint_probabilities_match_sklearn(n, c):
    x = _data(n, c, n + c)
    rows, cols, vals = (t.numpy() for t in T.joint_probabilities(torch.as_tensor(x)))
    got = _dense(n, rows, cols, vals)
    assert abs(vals.sum() - 1.0) < 1e-12
    np.testing.assert_array_equal(got, got.T)
    if c <= 15:
        want = _sklearn_p(x).toarray()
    else:
        from scipy.sparse import csr_array

        k = min(n - 1, 91)
        d2, idx = T.nearest_neighbours(torch.as_tensor(x), k)
        sq = csr_array((d2.numpy().ravel(), idx.numpy().ravel(), np.arange(0, n * k + 1, k)),
                       shape=(n, n))
        want = _sklearn_p(x, sqdist=sq).toarray()
        whole = _sklearn_p(x).toarray()
        assert np.array_equal(whole > 0, got > 0)  # the same neighbour sets
        assert np.max(np.abs(whole - got)[got > 0] / got[got > 0]) < 1e-4
    assert np.array_equal(want > 0, got > 0)
    rel = np.abs(want - got)[want > 0] / want[want > 0]
    assert rel.max() < 1e-6, rel.max()


@pytest.mark.parametrize("n,c,solver", [(400, 8, "covariance_eigh"), (200, 32, "full"),
                                        (600, 100, "randomized")])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_init_matches_sklearn(n, c, solver, dtype):
    from sklearn.decomposition import PCA

    x = _data(n, c, 3).astype(dtype)
    assert T.pca_solver(n, c) == solver
    seed = 7
    pca = PCA(n_components=2, random_state=np.random.RandomState(seed))
    want = pca.fit_transform(x).astype(np.float32, copy=False)
    assert pca._fit_svd_solver == solver
    want = want / np.std(want[:, 0]) * 1e-4
    got = T.pca_init(x, seed)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n,c", [(300, 8), (240, 32)])
def test_gradient_matches_barnes_hut_at_angle_0(n, c):
    """One gradient and KL at spread-out positions, on scikit-learn's P."""
    from sklearn.manifold import _t_sne

    x = _data(n, c, 11)
    p = _sklearn_p(x).tocoo()
    order = np.lexsort((p.col, p.row))
    entries = tuple(torch.as_tensor(a[order]) for a in (p.row.astype(np.int64),
                                                        p.col.astype(np.int64), p.data))
    y = np.random.default_rng(2).standard_normal((n, 2)) * 5
    err, grad = _t_sne._kl_divergence_bh(y.ravel().astype(np.float32), _sklearn_p(x), 1, n, 2,
                                         angle=0.0, compute_error=True)
    got_err, got = T.kl_gradient(torch.as_tensor(y), entries)
    got = got.numpy()
    assert np.abs(grad.reshape(n, 2) - got).max() / np.abs(got).max() < 1e-5
    assert abs(got_err - err) / abs(err) < 1e-5


def test_repulsion_chunks_give_the_same_gradient(monkeypatch):
    """The row chunking of the exact repulsion does not change the result
    beyond rounding."""
    x = _data(150, 6, 4)
    p = T.joint_probabilities(torch.as_tensor(x))
    y = torch.as_tensor(np.random.default_rng(3).standard_normal((150, 2)))
    e1, g1 = T.kl_gradient(y, p)
    monkeypatch.setattr(T, "_row_chunk", lambda n, device: 7)
    e2, g2 = T.kl_gradient(y, p)
    torch.testing.assert_close(g2, g1, rtol=1e-12, atol=1e-15)
    assert abs(e1 - e2) < 1e-12


def test_tsne_refuses_what_sklearn_refuses_and_runs_on_the_card(monkeypatch):
    """Perplexity at or above N raises; without CUDA the entry points raise
    unless given ``device="cpu"``."""
    x = _data(20, 3, 1)
    with pytest.raises(ValueError, match="perplexity"):
        T.tsne(x, perplexity=30.0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.tsne(x, perplexity=5.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.plot_tsne_visualization(x.reshape(1, 4, 5, 3), None, num_samples=20)
    emb, kl = T.tsne(x, perplexity=5.0, device="cpu", max_iter=300)
    assert emb.shape == (20, 2) and np.isfinite(emb).all() and np.isfinite(kl)


def _matplotlib_png(emb: np.ndarray, title: str) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(emb[:, 0], emb[:, 1], s=1, alpha=0.3)
    ax.set_title(title)
    b = io.BytesIO()
    fig.savefig(b, dpi=150)
    plt.close(fig)
    return np.asarray(Image.open(b).convert("RGB"))


@pytest.mark.parametrize("n", [7, 400, 4000])
def test_scatter_matches_matplotlib(n, tmp_path):
    """The port's drawing of an embedding against matplotlib's figure of it
    (the JAX package's code): same size, the frame's pixels within 1 level
    (but where matplotlib's tick marks, which the port does not draw, cross
    it), the
    axes' pixels within 6 levels, the same pixels inked; the title inked
    above the axes. The PNG reads back through the port's reader."""
    emb = np.random.default_rng(n).standard_normal((n, 2)) * [3.0, 0.7] + [10.0, -2.0]
    title = "entropy=0.675 gini=0.922"
    want = _matplotlib_png(emb, title).astype(int)
    got = tvis.render_scatter(emb, title).astype(int)
    assert got.shape == want.shape == (900, 900, 3)
    # the frame, but where matplotlib's tick marks (3.5 pt, outward, not
    # drawn by the port) cross it
    ticked_cols = (want[803:808, :, 0] < 255).any(0)
    ticked_rows = (want[:, 105:110, 0] < 255).any(1)
    cols = [c for c in range(105, 818) if not ticked_cols[c]]
    rows = [r for r in range(100, 809) if not ticked_rows[r]]
    assert len(cols) > 650 and len(rows) > 650
    for r in (105, 106, 107, 108, 109, 798, 799, 800, 801, 802):
        assert np.abs(got[r, cols] - want[r, cols]).max() <= 1, r
    for c in (110, 111, 112, 113, 114, 807, 808, 809, 810, 811):
        assert np.abs(got[rows, c] - want[rows, c]).max() <= 1, c
    inner = (slice(110, 799), slice(115, 808))
    assert np.abs(got[inner] - want[inner]).max() <= 6
    np.testing.assert_array_equal((got[inner] < 255).any(-1), (want[inner] < 255).any(-1))
    assert (got[70:106, 112:811] < 128).any() and not (got[:60] < 255).any()
    path = tmp_path / "t.png"
    path.write_bytes(tvis.encode_png(got.astype(np.uint8)))
    np.testing.assert_array_equal(read_png(str(path)), got)
