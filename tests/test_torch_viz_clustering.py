"""The port's vector tools: PCA, t-SNE (exact and Barnes-Hut), k-means and
the search trees, the plotter and the render endpoint. The reference's
assertions (tests/test_viz_clustering.py, the PCA and t-SNE cases of
tests/test_gapfill.py) re-run on the port, and the port held against the
JAX package: PCA up to each component's sign (LAPACK and the port's SVD
may choose either), the first t-SNE iterations from the same start, one
Lloyd step and whole k-means fits.

Tolerances: ``PCA_RTOL`` of the largest projection; ``LLOYD_ATOL`` for
centroids. t-SNE is chaotic: last-bit differences grow about 2x an
iteration in early exaggeration, and the gains read ``sign(grad)``. On
these blobs one ulp in y0 moves the reference's own map by 4.2e-5 of its
largest coordinate at iteration 10, and the port (its sums round in other
orders at every step) lies 2.5e-4 from the reference's there, past the
1e-4 the first iterations hold. So the map after each of the first
``TSNE_ITERS`` iterations holds within ``TSNE_RTOL`` of its largest
coordinate, or within ``TSNE_ULPS_X`` times the reference's own one-ulp
movement at that iteration, whichever is larger.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.clustering import KDTree, KMeans, QuadTree, VPTree
from deeplearning4j_tpu_torch.clustering import kmeans as pk
from deeplearning4j_tpu_torch.ops.pca import pca, pca_factor
from deeplearning4j_tpu_torch.plot import tsne as pt
from deeplearning4j_tpu_torch.plot.barnes_hut import BarnesHutTsne
from deeplearning4j_tpu_torch.plot.tsne import Tsne

torch.set_num_threads(1)

PCA_RTOL = 1e-4
TSNE_RTOL = 1e-4
TSNE_ULPS_X = 10
TSNE_ITERS = 10
LLOYD_ATOL = 1e-5


@pytest.fixture
def ref():
    jax = pytest.importorskip("jax")
    from types import SimpleNamespace

    from deeplearning4j_tpu.clustering import kmeans
    from deeplearning4j_tpu.ops import pca as jpca
    from deeplearning4j_tpu.plot import tsne

    return SimpleNamespace(jnp=jax.numpy, jax=jax, kmeans=kmeans, pca=jpca,
                           tsne=tsne)


def _three_blobs(n_per=30, seed=0, d=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5, (3, d))
    pts = np.concatenate([c + rng.normal(0, 0.3, (n_per, d))
                          for c in centers])
    labels = np.repeat(np.arange(3), n_per)
    return pts.astype(np.float32), labels


def _cluster_quality(y, labels):
    """Mean intra-cluster distance / mean inter-cluster distance."""
    d = np.linalg.norm(y[:, None] - y[None], axis=-1)
    iu = np.triu_indices(len(y), 1)
    same = (labels[:, None] == labels[None])[iu]
    return d[iu][same].mean() / d[iu][~same].mean()


# -- PCA ---------------------------------------------------------------------

def test_pca_recovers_dominant_directions():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(500, 2)) * np.array([10.0, 3.0])
    mix = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, -0.5]])
    x = base @ mix + 0.01 * rng.normal(size=(500, 3))
    proj = pca(x, 2, device="cpu")
    assert proj.shape == (500, 2)
    total = np.var(x - x.mean(0), axis=0).sum()
    assert np.var(proj, axis=0).sum() / total > 0.99
    proj2, comps = pca_factor(x, 2, device="cpu")
    assert comps.shape == (2, 3)
    np.testing.assert_allclose(proj, proj2, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(comps @ comps.T, np.eye(2), atol=1e-4)


def test_pca_normalize_and_dim_clip():
    x = np.random.default_rng(1).normal(size=(20, 4))
    assert pca(x, 10, normalize=True, device="cpu").shape == (20, 4)


@pytest.mark.parametrize("normalize", [False, True])
def test_pca_matches_reference_up_to_sign(ref, normalize):
    """Each component equals the reference's or its negation, and so does
    its projection; a constant column (zero std) divides by 1."""
    g = np.random.default_rng(2)
    x = (g.normal(size=(120, 12)) @ g.normal(size=(12, 12))).astype(
        np.float32)
    x[:, 3] = 1.5
    got, comps = pca_factor(x, 5, normalize, device="cpu")
    want, rcomps = ref.pca.pca_factor(x, 5, normalize)
    sign = np.sign((comps * rcomps).sum(1))
    assert (np.abs(sign) == 1).all()
    np.testing.assert_allclose(comps * sign[:, None], rcomps, rtol=0,
                               atol=PCA_RTOL)
    np.testing.assert_allclose(got * sign, want, rtol=0,
                               atol=PCA_RTOL * np.abs(want).max())


# -- t-SNE -------------------------------------------------------------------

def test_p_affinities_match_reference(ref):
    x, _ = _three_blobs(10)
    np.testing.assert_array_equal(pt.p_affinities(x, 8.0),
                                  ref.tsne.p_affinities(x, 8.0))


def _tsne_case():
    x, _ = _three_blobs(40, d=5)
    p = pt.p_affinities(x, 20.0).astype(np.float32)
    y0 = (1e-4 * np.random.default_rng(0).normal(size=(120, 2))).astype(
        np.float32)
    return p, y0


def _assert_tsne_close(got, want, want_ulp, it):
    """``got`` within TSNE_RTOL of the map's largest coordinate, or within
    TSNE_ULPS_X times what one ulp in y0 moves the reference run itself
    (``want_ulp``), whichever is larger."""
    noise = np.abs(want_ulp - want).max()
    bar = max(TSNE_RTOL * np.abs(want).max(), TSNE_ULPS_X * noise)
    err = np.abs(got - want).max()
    assert err <= bar, (it, err, bar, noise)


def test_tsne_first_iterations_match_reference(ref):
    """From the same P and y0: the map after each of the first TSNE_ITERS
    iterations against the reference's."""
    p, y0 = _tsne_case()
    y0_ulp = np.nextafter(y0, np.float32(1))

    def reference(y, it):
        return np.asarray(ref.tsne._tsne_loop(
            ref.jnp.asarray(p), ref.jnp.asarray(y), 200.0, 0.5, 0.8, it,
            100))

    for it in range(1, TSNE_ITERS + 1):
        got = pt._tsne_loop(torch.tensor(p), torch.tensor(y0), 200.0, 0.5,
                            0.8, it, 100).numpy()
        _assert_tsne_close(got, reference(y0, it), reference(y0_ulp, it), it)


def test_tsne_start_is_the_reference_draw(ref):
    """``prepare``'s P is the reference's affinities in f32 and its y0
    the reference's ``1e-4 * normal(key(seed))`` within a few ulps."""
    x, _ = _three_blobs(10)
    p, y0 = Tsne(perplexity=8.0, seed=3, device="cpu").prepare(x)
    np.testing.assert_array_equal(
        p.numpy(), ref.tsne.p_affinities(x, 8.0).astype(np.float32))
    want = 1e-4 * np.asarray(ref.jax.random.normal(ref.jax.random.key(3),
                                                   (30, 2)))
    np.testing.assert_allclose(y0.numpy(), want, rtol=1e-6, atol=0)


def test_tsne_separates_blobs():
    x, labels = _three_blobs()
    y = Tsne(perplexity=15.0, n_iter=300, seed=1, device="cpu").calculate(x)
    assert y.shape == (90, 2)
    assert np.isfinite(y).all()
    assert _cluster_quality(y, labels) < 0.5


def test_tsne_use_pca_path():
    x = np.random.default_rng(2).normal(size=(30, 10)).astype(np.float32)
    y = Tsne(n_iter=20, perplexity=5.0, use_pca=True, pca_dims=5,
             device="cpu").calculate(x)
    assert y.shape == (30, 2)
    assert np.isfinite(y).all()


def test_barnes_hut_tsne_separates_blobs():
    x, labels = _three_blobs(n_per=20)
    y = BarnesHutTsne(perplexity=10.0, n_iter=150, seed=1).fit_transform(x)
    assert y.shape == (60, 2)
    assert np.isfinite(y).all()
    assert _cluster_quality(y, labels) < 0.6


# -- k-means and the trees ------------------------------------------------------

def test_lloyd_step_matches_reference(ref):
    x, _ = _three_blobs()
    c0 = x[[0, 31, 62, 5]]
    got = pk._lloyd_step(torch.tensor(x), torch.tensor(c0), 4)
    want = ref.kmeans._lloyd_step(ref.jnp.asarray(x), ref.jnp.asarray(c0),
                                  k=4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=LLOYD_ATOL)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)


def test_lloyd_argmin_ties_go_to_the_lowest_centroid():
    x = torch.tensor([[0.0, 0.0], [2.0, 0.0]])
    c = torch.tensor([[1.0, 0.0], [1.0, 0.0], [5.0, 5.0]])
    new, assign, _ = pk._lloyd_step(x, c, 3)
    assert assign.tolist() == [0, 0]
    assert torch.equal(new[1], c[1])  # an empty cluster keeps its centroid


def test_kmeans_matches_reference(ref):
    x, _ = _three_blobs(seed=4)
    got = KMeans(k=4, seed=2, device="cpu").fit(x)
    want = ref.kmeans.KMeans(k=4, seed=2).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=0,
                               atol=LLOYD_ATOL)
    np.testing.assert_array_equal(got.predict(x[:7]), want.predict(x[:7]))


def test_kmeans_recovers_blobs():
    x, labels = _three_blobs()
    km = KMeans(k=3, seed=2, device="cpu").fit(x)
    assert km.centroids.shape == (3, x.shape[1])
    purity = 0
    for c in range(3):
        members = labels[km.labels_ == c]
        if len(members):
            purity += np.bincount(members).max()
    assert purity / len(labels) > 0.95


def test_kdtree_knn_matches_bruteforce():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 4))
    tree = KDTree(pts)
    q = rng.normal(size=4)
    got = [i for _, i in tree.nearest(q, k=5)]
    assert got == np.argsort(np.linalg.norm(pts - q, axis=1))[:5].tolist()
    hits = tree.range(np.full(4, -0.5), np.full(4, 0.5))
    brute = [i for i, p in enumerate(pts)
             if np.all(p >= -0.5) and np.all(p <= 0.5)]
    assert sorted(hits) == sorted(brute)


def test_vptree_knn_matches_bruteforce():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(150, 6))
    tree = VPTree(pts)
    q = rng.normal(size=6)
    got = [i for _, i in tree.nearest(q, k=4)]
    assert got == np.argsort(np.linalg.norm(pts - q, axis=1))[:4].tolist()


def test_quadtree_mass_and_forces():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 2))
    tree = QuadTree.build(pts)
    assert tree.mass == 50
    assert np.allclose(tree.com, pts.mean(0), atol=1e-9)
    f = np.zeros(2)
    s = tree.compute_non_edge_forces(pts[0], theta=0.5, neg_f=f)
    assert np.isfinite(f).all() and s > 0


# -- the plotter and the render endpoint ---------------------------------------

def test_plotter_outputs_files(tmp_path):
    pytest.importorskip("matplotlib")
    from deeplearning4j_tpu_torch.plot.plotter import NeuralNetPlotter

    p = NeuralNetPlotter(tmp_path)
    rng = np.random.default_rng(0)
    out1 = p.plot_weight_histograms({"W": rng.normal(size=(20, 10)),
                                     "b": rng.normal(size=10)})
    out2 = p.render_filters(rng.normal(size=(49, 9)))
    out3 = p.plot_activations(rng.random((16, 32)))
    for f in (out1, out2, out3):
        assert f.exists() and f.stat().st_size > 0


def test_tsne_render_endpoint():
    from deeplearning4j_tpu_torch.plot.plotter import serve_tsne

    port = serve_tsne(["a", "b"], np.array([[0.0, 1.0], [2.0, 3.0]]))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/coords") as r:
        data = json.loads(r.read())
    assert data[0]["word"] == "a" and data[1]["x"] == 2.0


@pytest.mark.cuda
def test_vector_tools_on_card_match_cpu():
    """PCA up to sign, the Lloyd assignment and the first t-SNE
    iterations on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, _ = _three_blobs()
    a, ca = pca_factor(x, 4, device="cpu")
    b, cb = pca_factor(x, 4, device="cuda")
    sign = np.sign((ca * cb).sum(1))
    np.testing.assert_allclose(b * sign, a, rtol=0,
                               atol=PCA_RTOL * np.abs(a).max())
    c0 = torch.tensor(x[[0, 31, 62]])
    cpu = pk._lloyd_step(torch.tensor(x), c0, 3)
    card = pk._lloyd_step(torch.tensor(x).cuda(), c0.cuda(), 3)
    assert torch.equal(cpu[1], card[1].cpu())
    p, y0 = (torch.tensor(a) for a in _tsne_case())
    y0_ulp = torch.tensor(np.nextafter(y0.numpy(), np.float32(1)))
    args = (200.0, 0.5, 0.8, TSNE_ITERS, 100)
    want = pt._tsne_loop(p, y0, *args).numpy()
    want_ulp = pt._tsne_loop(p, y0_ulp, *args).numpy()
    got = pt._tsne_loop(p.cuda(), y0.cuda(), *args).cpu().numpy()
    _assert_tsne_close(got, want, want_ulp, TSNE_ITERS)
