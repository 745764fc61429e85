"""f32-conditioning adversarial test (SURVEY §7 "precision" hard part).

Ceres runs the reference's BA in f64; here BA solves in f32 with symmetric
Jacobi preconditioning + one round of iterative refinement (ba.schur_solve).
This test pits that claim against a deliberately ill-conditioned window —
motion along the optical axis (parallax-poor) with a 100:1 landmark depth
spread — and asserts the f32 step stays aligned with a golden f64 solve.
"""
import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as ge
from vil_fusion_tpu.models import ba, window


def _ill_conditioned_problem(dtype):
    """_example_problem geometry, feats replaced by a parallax-poor set:
    motion nearly along the optical axis, depths 3 m .. 300 m."""
    state, feats, pre, lidar, prior = ge._example_problem(f_cap=64, dtype=dtype)
    K = window.K
    rng = np.random.default_rng(3)
    F = 64
    n_act = 56
    # true 3-D points in frame-0 camera: half near (3-10 m), half far (100-300 m)
    z0 = np.where(np.arange(F) % 2 == 0,
                  rng.uniform(3.0, 10.0, F), rng.uniform(100.0, 300.0, F))
    xy0 = rng.uniform(-0.45, 0.45, (F, 2)) * z0[:, None]
    X = np.concatenate([xy0, z0[:, None]], -1)  # frame-0 cam coords
    p = np.asarray(state.p)  # window positions (identity orientations)
    # observations: project into each frame's camera (camera == body here)
    obs = np.zeros((F, K, 2), np.float32)
    for k in range(K):
        Xi = X - (p[k] - p[0])
        obs[:, k] = Xi[:, :2] / Xi[:, 2:3]
    act = np.arange(F) < n_act
    feats = feats._replace(
        active=jnp.asarray(act),
        obs=jnp.asarray(obs, dtype),
        obs_valid=jnp.tile(jnp.asarray(act)[:, None], (1, K)),
        inv_depth=jnp.asarray(np.where(act, (1.0 / z0) * 1.02, -1.0), dtype),
        feat_id=jnp.asarray(np.where(act, np.arange(F), -1), np.int32))
    # perturb the state so the GN step is non-trivial
    dp = rng.normal(0, 0.03, (K, 3)).astype(np.float32)
    state = state._replace(p=state.p + jnp.asarray(dp, dtype))
    return state, feats, pre, lidar, prior


def f32_vs_f64_step() -> dict:
    """f32 and f64 Schur steps and LM costs on the ill-conditioned window:
    direction cosine, norm ratio, median relative depth-update error, and
    both final costs (also run on the GPU by chip_smoke.py)."""
    with jax.enable_x64(True):
        cfg = ba.BAConfig(max_iters=8)
        lam = 1e-4

        @jax.jit
        def step(state, feats, pre, lidar, prior, lam):
            sys_ = ba.build_system(state, feats, pre, lidar, prior, cfg, 1.0)
            return ba.schur_solve(sys_, lam, cfg)

        deltas = {}
        for dtype in (jnp.float32, jnp.float64):
            state, feats, pre, lidar, prior = _ill_conditioned_problem(dtype)
            d, dd = step(state, feats, pre, lidar, prior,
                         jnp.asarray(lam, dtype))
            deltas[str(jnp.dtype(dtype))] = (np.asarray(d, np.float64),
                                             np.asarray(dd, np.float64))
        d32, dd32 = deltas["float32"]
        d64, dd64 = deltas["float64"]
        # depth back-substitution: compare where depths are meaningfully moved
        big = np.abs(dd64) > 1e-6
        rel = np.abs(dd32[big] - dd64[big]) / np.maximum(np.abs(dd64[big]), 1e-9)

        # full LM loop: f32 must reach the f64 cost basin
        costs = {}
        for dtype in (jnp.float32, jnp.float64):
            state, feats, pre, lidar, prior = _ill_conditioned_problem(dtype)
            _, _, cost = ba.optimize(state, feats, pre, lidar, prior, cfg)
            costs[str(jnp.dtype(dtype))] = float(cost)
    return dict(
        cos=float(d32 @ d64 / (np.linalg.norm(d32) * np.linalg.norm(d64))),
        ratio=float(np.linalg.norm(d32) / np.linalg.norm(d64)),
        n_depths=int(big.sum()),
        median_depth_rel=float(np.median(rel)) if big.any() else None,
        cost_f32=costs["float32"], cost_f64=costs["float64"])


def f32_vs_f64_failures(r: dict) -> list:
    """Names of the bounds `r` (from f32_vs_f64_step) breaks."""
    # vision blocks scale with FOCAL^2 ~ 2e5: a raw f32 normal-equation
    # solve loses the direction here; the preconditioned one must not
    bounds = {
        "cos > 0.999": r["cos"] > 0.999,
        "0.95 < ratio < 1.05": 0.95 < r["ratio"] < 1.05,
        "depths moved": r["n_depths"] > 0,
        "median depth rel < 0.05": r["n_depths"] > 0
        and r["median_depth_rel"] < 0.05,
        "f32 cost in the f64 basin":
            r["cost_f32"] < r["cost_f64"] * 1.05 + 1e-6,
    }
    return [name for name, ok in bounds.items() if not ok]


def test_f32_step_matches_f64_golden_on_ill_conditioned_window():
    r = f32_vs_f64_step()
    assert not f32_vs_f64_failures(r), r
