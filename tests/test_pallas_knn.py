"""Fused GPU kNN kernel: interpret-mode correctness on the CPU against the
XLA form (ops/knn.py) and a float64 NumPy brute force, the occupancy rule,
and the backend dispatch. The compiled kernel is checked on the card by
chip_smoke.py (tests/test_chip.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vil_fusion_tpu.ops import knn as knn_xla
from vil_fusion_tpu.ops.pallas import knn_pallas


def _brute(q, db, valid, k):
    d = ((np.asarray(q, np.float64)[:, None, :]
          - np.asarray(db, np.float64)[None]) ** 2).sum(-1)
    d = np.where(np.asarray(valid)[None], d, np.inf)
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, 1), i


def _check(d, i, q, db, valid, k, atol):
    d, i = np.asarray(d), np.asarray(i)
    d_ref, _ = _brute(q, db, valid, k)
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(d_ref))
    fin = np.isfinite(d_ref)
    np.testing.assert_allclose(d[fin], d_ref[fin], rtol=1e-5, atol=atol)
    # returned indices point at points with the returned distances
    got = ((np.asarray(q, np.float64)[:, None, :]
            - np.asarray(db, np.float64)[i]) ** 2).sum(-1)
    np.testing.assert_allclose(got[fin], d_ref[fin], rtol=1e-5, atol=atol)
    assert (i[~fin] == 0).all()


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("nq,nd", [(37, 700), (300, 3000)])
def test_fused_knn_matches_brute_force_and_xla(k, nq, nd):
    """Sizes off the (16, 512) block grid; ~10% invalid database slots."""
    rng = np.random.default_rng(k * 1000 + nq)
    q = rng.uniform(-20, 20, (nq, 3)).astype(np.float32)
    db = rng.uniform(-20, 20, (nd, 3)).astype(np.float32)
    valid = rng.random(nd) > 0.1
    d, i = knn_pallas.knn_fused(q, db, valid, k=k, interpret=True)
    _check(d, i, q, db, valid, k, atol=1e-4)
    d_x, _ = knn_xla.knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid),
                         k=k)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_x), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("n_split", [1, 4])
def test_fused_knn_split_merge(n_split):
    """The database split across blocks (occupancy for few-query shapes)
    merges to the same exact answer as one split."""
    rng = np.random.default_rng(7)
    q = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
    db = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    valid = rng.random(2000) > 0.3
    d, i = knn_pallas.knn_fused(q, db, valid, k=5, n_split=n_split,
                                interpret=True)
    _check(d, i, q, db, valid, 5, atol=1e-5)


def test_fused_knn_few_valid():
    q = np.zeros((8, 3), np.float32)
    db = np.ones((600, 3), np.float32)
    valid = np.zeros(600, bool)
    valid[[5, 17]] = True
    d, i = knn_pallas.knn_fused(q, db, valid, k=4, interpret=True)
    d, i = np.asarray(d), np.asarray(i)
    assert (np.isfinite(d).sum(1) == 2).all()
    assert set(i[0, :2].tolist()) == {5, 17}
    assert (i[:, 2:] == 0).all()


def test_fused_knn_all_invalid_db():
    q = np.zeros((70, 3), np.float32)
    db = np.ones((500, 3), np.float32)
    d, i = knn_pallas.knn_fused(q, db, np.zeros(500, bool), k=3,
                                interpret=True)
    assert not np.isfinite(np.asarray(d)).any()
    assert (np.asarray(i) == 0).all()


def test_fused_knn_unit_sphere_near_zero():
    """Depth association: rays and cloud on the unit sphere, neighbour
    distances ~1e-6..1e-4; the difference-square form keeps them to 1e-9."""
    rng = np.random.default_rng(3)
    cloud = rng.normal(size=(5000, 3)) * [1.0, 0.3, 0.1] + [0, 0, 1]
    cloud /= np.linalg.norm(cloud, axis=1, keepdims=True)
    rays = cloud[rng.choice(5000, 50, replace=False)] + rng.normal(
        0, 1e-3, (50, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    cloud, rays = cloud.astype(np.float32), rays.astype(np.float32)
    valid = np.ones(5000, bool)
    d, i = knn_pallas.knn_fused(rays, cloud, valid, k=3, interpret=True)
    d_ref, _ = _brute(rays, cloud, valid, 3)
    assert d_ref[:, 0].max() < 1e-4
    np.testing.assert_allclose(np.asarray(d), d_ref, rtol=0, atol=1e-9)


def test_fused_knn_under_vmap():
    """Batched (sequence-axis) odometry vmaps the dispatch."""
    rng = np.random.default_rng(5)
    q = rng.uniform(-5, 5, (2, 40, 3)).astype(np.float32)
    db = rng.uniform(-5, 5, (2, 500, 3)).astype(np.float32)
    valid = rng.random((2, 500)) > 0.2
    d, i = jax.vmap(lambda a, b, c: knn_pallas.knn_fused(
        a, b, c, k=3, interpret=True))(q, db, valid)
    for s in range(2):
        _check(d[s], i[s], q[s], db[s], valid[s], 3, atol=1e-5)


def test_split_rule_fills_the_card():
    """Main-path shapes: surf 8192x32768 needs no split, the 2048-query edge
    pass and the ~200-ray depth pass split the database."""
    bq, bd = knn_pallas._BQ, knn_pallas._BD
    splits = {name: knn_pallas._n_split(-(-nq // bq), -(-nd // bd))
              for name, (nq, nd) in dict(surf=(8192, 32768),
                                         edge=(2048, 16384),
                                         depth=(200, 115200)).items()}
    assert splits["surf"] == 1
    for name, (nq, nd) in dict(edge=(2048, 16384), depth=(200, 115200)).items():
        blocks = -(-nq // bq) * splits[name]
        assert blocks >= knn_pallas._TARGET_BLOCKS, (name, splits)
        assert -(-nd // bd) // splits[name] >= 4, (name, splits)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_dispatch_by_backend(monkeypatch, backend):
    """One decision: the compiled kernel (never interpret mode) on the GPU
    backend, the XLA form elsewhere."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(knn_pallas, "knn_fused",
                        lambda *a, **kw: calls.append(("fused", kw)) or "f")
    monkeypatch.setattr(knn_pallas.knn_xla, "knn",
                        lambda *a, **kw: calls.append(("xla", kw)) or "x")
    q = np.zeros((4, 3), np.float32)
    out = knn_pallas.knn(q, q, np.ones(4, bool), k=3)
    if backend == "gpu":
        assert out == "f" and calls[0][0] == "fused"
        assert not calls[0][1].get("interpret", False)
    else:
        assert out == "x" and calls[0][0] == "xla"
    assert calls[0][1]["k"] == 3 and len(calls) == 1
