"""Sliding-window bundle adjustment: assembly, Schur complement, LM loop.

Rebuild of the reference's `Estimator::optimization` (estimator.cpp:689-1050)
and its Ceres DENSE_SCHUR/DOGLEG solve (:838-853), accelerator-first:

  * Per-factor residuals + Jacobians are vmapped pure functions (jacfwd over
    tangent deltas traces to the reference's hand-written analytic Jacobians).
  * The Gauss-Newton normal system over the D-dim pose state is assembled by
    batched scatter-add of dense factor blocks — one fused XLA computation,
    the analog of Ceres' block-sparse assembly plus the 4-pthread map-reduce
    in marginalization_factor.cpp:232-261.
  * Inverse depths couple through single-landmark factors only, so H_ll is
    diagonal and the Schur complement is two matmuls (DENSE_SCHUR analog).
  * Levenberg-Marquardt with fixed iteration budget (max 8, matching the
    reference's time-boxed solver, kitti_config.yaml max_num_iterations).
  * Gauge freedom handled like double2vector (estimator.cpp:549-638): after
    the solve the window is re-anchored to frame-0's pre-solve yaw/position.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.models import factors
from vil_fusion_tpu.models.window import (
    D, K, FeatureStore, LidarConstraints, StackedPreint, WindowState,
    local_diff, retract,
)
from vil_fusion_tpu.ops import lie

# MargPrior lives in factors.py; re-export for callers
MargPrior = factors.MargPrior


def empty_prior(state: WindowState) -> MargPrior:
    dtype = state.p.dtype
    return MargPrior(
        J=jnp.zeros((D, D), dtype),
        r0=jnp.zeros((D,), dtype),
        lin=state,
        valid=jnp.zeros((), bool),
    )


class BAConfig(NamedTuple):
    max_iters: int = 8
    lm_init: float = 1e-4
    gravity: tuple = (0.0, 0.0, 9.81)
    use_lidar: bool = True
    fix_lidar_depths: bool = True  # SetParameterBlockConstant (estimator.cpp:780-790)
    estimate_td: bool = False
    estimate_extrinsic: bool = False
    # inverse-depth floor: only guards against sign flips (behind-camera);
    # must be far below any real landmark's inverse depth. The reference
    # instead lets depth go negative and deletes the feature post-solve
    # (feature_manager removeFailures); we keep the slot alive but clamped.
    depth_min: float = 1e-4
    # run the LM loop with landmark factors sharded over the active device
    # mesh (parallel/sharded_ba.optimize_sharded; the reference's 4-pthread
    # Hessian map-reduce, marginalization_factor.cpp:232-261, scaled to
    # chips). Requires parallel.mesh.set_active_mesh() first.
    sharded: bool = False


class System(NamedTuple):
    H: jnp.ndarray  # (D, D)
    b: jnp.ndarray  # (D,)
    Hpd: jnp.ndarray  # (D, F)
    Hd: jnp.ndarray  # (F,)
    bd: jnp.ndarray  # (F,)
    cost: jnp.ndarray  # ()


def _gather_frame(state: WindowState, i):
    return dict(p=state.p[i], q=state.q[i], v=state.v[i], ba=state.ba[i], bg=state.bg[i])


# ---------------------------------------------------------------------------
# IMU factors (slots 1..K-1)
# ---------------------------------------------------------------------------

def _imu_res_delta(delta, pre_row, si, sj, g):
    qi, pi = lie.pose_retract((si["q"], si["p"]), delta[0:6])
    vi, bai, bgi = si["v"] + delta[6:9], si["ba"] + delta[9:12], si["bg"] + delta[12:15]
    qj, pj = lie.pose_retract((sj["q"], sj["p"]), delta[15:21])
    vj, baj, bgj = sj["v"] + delta[21:24], sj["ba"] + delta[24:27], sj["bg"] + delta[27:30]
    return factors.imu_residual(pre_row, pi, qi, vi, bai, bgi, pj, qj, vj, baj, bgj, g)


def _imu_blocks(state: WindowState, pre: StackedPreint, g, dtype):
    slots = jnp.arange(1, K)

    def one(s):
        pre_row = jax.tree.map(lambda a: a[s], pre._asdict())
        si = _gather_frame(state, s - 1)
        sj = _gather_frame(state, s)
        z = jnp.zeros(30, dtype)
        r = _imu_res_delta(z, pre_row, si, sj, g)
        J = jax.jacfwd(_imu_res_delta)(z, pre_row, si, sj, g)
        ix = jnp.concatenate([15 * (s - 1) + jnp.arange(15), 15 * s + jnp.arange(15)])
        return r, J, ix

    r, J, ix = jax.vmap(one)(slots)
    w = pre.valid[1:].astype(dtype)
    return r * w[:, None], J * w[:, None, None], ix


# ---------------------------------------------------------------------------
# Projection (td) factors over the (F, K) observation grid
# ---------------------------------------------------------------------------

def _proj_res_delta(delta, obs_i, obs_j, vel_i, vel_j, tsh_i, tsh_j,
                    inv_depth, si, sj, ext, depth_free):
    qi, pi = lie.pose_retract((si["q"], si["p"]), delta[0:6])
    qj, pj = lie.pose_retract((sj["q"], sj["p"]), delta[6:12])
    qic, tic = lie.pose_retract((ext["qic"], ext["tic"]), delta[12:18])
    td = ext["td"] + delta[18]
    lam = inv_depth + delta[19] * depth_free
    return factors.projection_td_residual(
        obs_i, obs_j, vel_i, vel_j, lam, pi, qi, pj, qj, tic, qic, td,
        tsh_i, tsh_j)


def _proj_blocks(state: WindowState, feats: FeatureStore, cfg: BAConfig, dtype,
                 cauchy_c=1.0):
    F = feats.active.shape[0]
    ext = dict(qic=state.qic, tic=state.tic, td=state.td)

    f_idx, j_idx = jnp.meshgrid(jnp.arange(F), jnp.arange(K), indexing="ij")
    f_idx = f_idx.reshape(-1)
    j_idx = j_idx.reshape(-1)
    s_idx = feats.start[f_idx]
    valid = (
        feats.active[f_idx]
        & feats.obs_valid[f_idx, s_idx]
        & feats.obs_valid[f_idx, j_idx]
        & (j_idx != s_idx)
        & (feats.inv_depth[f_idx] > 0)
    )
    depth_free = jnp.where(
        feats.lidar_flag[f_idx] & cfg.fix_lidar_depths, 0.0, 1.0
    ).astype(dtype)

    def one(f, s, j, dfree):
        si = _gather_frame(state, s)
        sj = _gather_frame(state, j)
        args = (feats.obs[f, s], feats.obs[f, j], feats.vel[f, s], feats.vel[f, j],
                feats.tshift[f, s], feats.tshift[f, j],
                feats.inv_depth[f], si, sj, ext, dfree)
        z = jnp.zeros(20, dtype)
        r = _proj_res_delta(z, *args)
        J = jax.jacfwd(_proj_res_delta)(z, *args)
        ar6 = jnp.arange(6)
        ix = jnp.concatenate([15 * s + ar6, 15 * j + ar6,
                              15 * K + jnp.arange(7)])  # (19,) pose-state dims
        return r, J, ix

    r, J, ix = jax.vmap(one)(f_idx, s_idx, j_idx, depth_free)
    # robust reweight (Cauchy, estimator.cpp:760) with annealable scale
    r2 = jnp.sum(r * r, axis=-1)
    vmask = valid.astype(dtype)
    w = factors.cauchy_weight(r2, cauchy_c) * vmask
    rho_cost = jnp.sum(factors.cauchy_rho(r2, cauchy_c) * vmask)
    if not cfg.estimate_extrinsic:
        J = J.at[:, :, 12:18].set(0.0)
    if not cfg.estimate_td:
        J = J.at[:, :, 18].set(0.0)
    r = r * w[:, None]
    J = J * w[:, None, None]
    Jp, Jd = J[:, :, :19], J[:, :, 19]
    return r, Jp, Jd, ix, f_idx, rho_cost


# ---------------------------------------------------------------------------
# LiDAR relative-pose factors (slots 1..K-1)
# ---------------------------------------------------------------------------

def _lidar_res_delta(delta, q_meas, p_meas, si, sj):
    qi, pi = lie.pose_retract((si["q"], si["p"]), delta[0:6])
    qj, pj = lie.pose_retract((sj["q"], sj["p"]), delta[6:12])
    return factors.lidar_rel_residual(q_meas, p_meas, pi, qi, pj, qj)


def _lidar_blocks(state: WindowState, lidar: LidarConstraints, dtype):
    slots = jnp.arange(1, K)

    def one(s):
        si = _gather_frame(state, s - 1)
        sj = _gather_frame(state, s)
        z = jnp.zeros(12, dtype)
        r = _lidar_res_delta(z, lidar.q_rel[s], lidar.p_rel[s], si, sj)
        J = jax.jacfwd(_lidar_res_delta)(z, lidar.q_rel[s], lidar.p_rel[s], si, sj)
        ar6 = jnp.arange(6)
        ix = jnp.concatenate([15 * (s - 1) + ar6, 15 * s + ar6])
        return r, J, ix

    r, J, ix = jax.vmap(one)(slots)
    w = lidar.valid[1:].astype(dtype)
    return r * w[:, None], J * w[:, None, None], ix


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def _scatter_quadratic(H, b, r, J, ix):
    """H += J^T J, b += -J^T r scattered at index array ix (N, d)."""
    JTJ = jnp.einsum("nrd,nre->nde", J, J)
    JTr = jnp.einsum("nrd,nr->nd", J, r)
    H = H.at[ix[:, :, None], ix[:, None, :]].add(JTJ)
    b = b.at[ix].add(-JTr)
    return H, b


def accumulate_proj_quadratic(H, b, Hpd, Hd, bd, r, Jp, Jd, ix, f_idx):
    """Projection-factor accumulation via one-hot matmuls.

    Thousands of 19x19 scatter-adds serialize on an accelerator; projecting each
    factor's Jacobian into the full D-dim tangent with a one-hot selection
    matrix turns the whole assembly into three dense einsums (the same trick
    the pthreaded map-reduce in marginalization_factor.cpp:232-261 is NOT).
    """
    N = r.shape[0]
    F = Hd.shape[0]
    dtype = H.dtype
    sel = (ix[:, :, None] == jnp.arange(D)[None, None, :]).astype(dtype)  # (N, 19, D)
    Jf = jnp.einsum("nrd,ndD->nrD", Jp, sel)  # (N, 2, D)
    H = H + jnp.einsum("nrD,nrE->DE", Jf, Jf)
    b = b - jnp.einsum("nrD,nr->D", Jf, r)
    self_f = (f_idx[:, None] == jnp.arange(F)[None, :]).astype(dtype)  # (N, F)
    JfTJd = jnp.einsum("nrD,nr->nD", Jf, Jd)  # (N, D)
    Hpd = Hpd + jnp.einsum("nD,nF->DF", JfTJd, self_f)
    Hd = Hd + self_f.T @ jnp.sum(Jd * Jd, axis=-1)
    bd = bd - self_f.T @ jnp.einsum("nr,nr->n", Jd, r)
    return H, b, Hpd, Hd, bd


def build_system(
    state: WindowState,
    feats: FeatureStore,
    pre: StackedPreint,
    lidar: LidarConstraints,
    prior: MargPrior,
    cfg: BAConfig,
    cauchy_c=1.0,
) -> System:
    dtype = state.p.dtype
    F = feats.active.shape[0]
    g = jnp.asarray(cfg.gravity, dtype)
    H = jnp.zeros((D, D), dtype)
    b = jnp.zeros((D,), dtype)
    cost = jnp.zeros((), dtype)

    # marginalization prior (linear factor)
    r_p = factors.marg_prior_residual(prior, state)
    Jp = jnp.where(prior.valid, 1.0, 0.0) * prior.J
    H = H + Jp.T @ Jp
    b = b - Jp.T @ r_p
    cost = cost + jnp.sum(r_p * r_p)

    # IMU
    r, J, ix = _imu_blocks(state, pre, g, dtype)
    H, b = _scatter_quadratic(H, b, r, J, ix)
    cost = cost + jnp.sum(r * r)

    # LiDAR inter-frame
    if cfg.use_lidar:
        r, J, ix = _lidar_blocks(state, lidar, dtype)
        H, b = _scatter_quadratic(H, b, r, J, ix)
        cost = cost + jnp.sum(r * r)

    # projection + depth coupling (one-hot matmul assembly)
    r, Jpse, Jd, ix, f_idx, rho_cost = _proj_blocks(state, feats, cfg, dtype, cauchy_c)
    cost = cost + rho_cost
    Hpd = jnp.zeros((D, F), dtype)
    Hd = jnp.zeros((F,), dtype)
    bd = jnp.zeros((F,), dtype)
    H, b, Hpd, Hd, bd = accumulate_proj_quadratic(
        H, b, Hpd, Hd, bd, r, Jpse, Jd, ix, f_idx)
    return System(H, b, Hpd, Hd, bd, cost)


def total_cost(state, feats, pre, lidar, prior, cfg, cauchy_c=1.0) -> jnp.ndarray:
    """Cost only (for LM accept/reject) — cheap subset of build_system."""
    dtype = state.p.dtype
    g = jnp.asarray(cfg.gravity, dtype)
    r_p = factors.marg_prior_residual(prior, state)
    cost = jnp.sum(r_p * r_p)
    r, _J, _ = _imu_blocks(state, pre, g, dtype)
    cost = cost + jnp.sum(r * r)
    if cfg.use_lidar:
        r, _J, _ = _lidar_blocks(state, lidar, dtype)
        cost = cost + jnp.sum(r * r)
    _r, _Jp, _Jd, _, _, rho_cost = _proj_blocks(state, feats, cfg, dtype, cauchy_c)
    return cost + rho_cost


# ---------------------------------------------------------------------------
# Schur solve + LM loop
# ---------------------------------------------------------------------------

def schur_solve(sys: System, lam: jnp.ndarray, cfg: BAConfig):
    """Eliminate diagonal depth block, solve damped pose system, back-substitute.

    f32-conditioning (SURVEY.md §7 "precision" hard part): the FOCAL^2-scaled
    vision blocks give H entries up to ~1e8, so a raw f32 solve of the normal
    equations loses the descent direction entirely. We symmetrically Jacobi-
    precondition (condition number drops to the geometry's intrinsic one) and
    apply one step of iterative refinement — equivalent in practice to the
    f64 solve Ceres uses, at f32 speed.
    """
    dtype = sys.H.dtype
    d_ok = sys.Hd > 1e-8
    Hd_safe = jnp.where(d_ok, sys.Hd, 1.0) + lam
    inv_Hd = jnp.where(d_ok, 1.0 / Hd_safe, 0.0)
    Hs = sys.H - (sys.Hpd * inv_Hd[None, :]) @ sys.Hpd.T
    bs = sys.b - sys.Hpd @ (sys.bd * inv_Hd)
    damp = lam * (jnp.diag(sys.H) + 1.0)
    Hs = Hs + jnp.diag(damp)
    s = 1.0 / jnp.sqrt(jnp.abs(jnp.diag(Hs)) + 1e-10)
    Hn = Hs * s[:, None] * s[None, :]
    bn = bs * s
    # damped+preconditioned Hn is SPD: one Cholesky factorization, reused by
    # the refinement step (jnp.linalg.solve would LU-factorize twice)
    L = jnp.linalg.cholesky(Hn)
    solve = lambda rhs: jax.scipy.linalg.cho_solve((L, True), rhs)
    y = solve(bn)
    y = y + solve(bn - Hn @ y)  # iterative refinement
    # Cholesky fails only if damping underflowed the f32 SPD margin; fall
    # back to the pivoted LU path for that iteration
    bad = ~jnp.isfinite(L[-1, -1])
    y = jnp.where(bad, jnp.linalg.solve(
        jnp.where(bad, Hn + jnp.eye(Hn.shape[0], dtype=dtype) * 1e-6, Hn),
        bn), y)
    delta = y * s
    delta_d = (sys.bd - sys.Hpd.T @ delta) * inv_Hd
    return delta, delta_d


def _apply(state: WindowState, feats: FeatureStore, delta, delta_d, cfg: BAConfig):
    new_state = retract(state, delta)
    new_depth = jnp.maximum(feats.inv_depth + delta_d, cfg.depth_min)
    new_depth = jnp.where(feats.inv_depth > 0, new_depth, feats.inv_depth)
    return new_state, feats._replace(inv_depth=new_depth)


@functools.partial(jax.jit, static_argnames=("cfg",))
def optimize(
    state: WindowState,
    feats: FeatureStore,
    pre: StackedPreint,
    lidar: LidarConstraints,
    prior: MargPrior,
    cfg: BAConfig = BAConfig(),
):
    """LM loop with re-anchoring; returns (state, feats, final_cost)."""
    anchor_p0 = state.p[0]
    anchor_ypr0 = lie.R2ypr(lie.q2R(state.q[0]))

    dtype = state.p.dtype
    # graduated non-convexity: anneal the Cauchy scale 16 -> 1 over the first
    # iterations so far-out (but inlier) residuals keep gradient early on.
    sched = jnp.maximum(
        jnp.ones((cfg.max_iters,), dtype),
        16.0 * 0.25 ** jnp.arange(cfg.max_iters, dtype=dtype))

    def step(carry, cauchy_c):
        st, ft, lam = carry
        sys = build_system(st, ft, pre, lidar, prior, cfg, cauchy_c)
        delta, delta_d = schur_solve(sys, lam, cfg)
        cand_st, cand_ft = _apply(st, ft, delta, delta_d, cfg)
        new_cost = total_cost(cand_st, cand_ft, pre, lidar, prior, cfg, cauchy_c)
        accept = (new_cost < sys.cost) & jnp.isfinite(new_cost)
        st = jax.tree.map(lambda a, b_: jnp.where(accept, b_, a), st, cand_st)
        ft = jax.tree.map(lambda a, b_: jnp.where(accept, b_, a), ft, cand_ft)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-7), lam * 8.0)
        cost = jnp.where(accept, new_cost, sys.cost)
        return (st, ft, lam), cost

    (state, feats, _), costs = jax.lax.scan(
        step, (state, feats, jnp.asarray(cfg.lm_init, dtype)), sched)
    cost = costs[-1]

    state = re_anchor(state, anchor_p0, anchor_ypr0)
    return state, feats, cost


def re_anchor(state: WindowState, anchor_p0, anchor_ypr0) -> WindowState:
    """Fix the 4-dof gauge like double2vector (estimator.cpp:549-638): restore
    frame-0 position and yaw to their pre-solve values."""
    ypr_new = lie.R2ypr(lie.q2R(state.q[0]))
    y_diff = anchor_ypr0[0] - ypr_new[0]
    rot = lie.ypr2R(jnp.stack([y_diff, jnp.zeros_like(y_diff), jnp.zeros_like(y_diff)]))
    q_rot = lie.R2q(rot)
    p_new = jnp.einsum("ij,kj->ki", rot, state.p - state.p[0]) + anchor_p0
    q_new = lie.qnormalize(lie.qmul(q_rot[None, :], state.q))
    v_new = jnp.einsum("ij,kj->ki", rot, state.v)
    return state._replace(p=p_new, q=q_new, v=v_new)
