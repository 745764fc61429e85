"""Multi-chip sliding-window BA: feature factors sharded over the mesh.

The BA Hessian assembly is a map-reduce over factors (the reference does the
same on 4 pthreads, marginalization_factor.cpp:232-261). Here each device
assembles the normal-equation contribution of its landmark shard and the
6-DoF-pose-state system is reduced with `psum` across devices — the direct
analog, scaled from 4 threads to N devices.

Landmark depths stay device-local (H_ll is diagonal and landmark-parallel:
the Schur complement's per-landmark elimination never crosses shards), so the
only communication is one psum of the (D, D) pose system per iteration.

`optimize_sharded` runs the FULL annealed LM loop of `ba.optimize` (graduated
Cauchy schedule, accept/reject, lambda annealing, gauge re-anchoring) under
shard_map: all scalar LM state is replicated (psum-reduced costs are
deterministic and identical on every device, so the accept branch never
diverges across the mesh).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from vil_fusion_tpu.models import ba, factors
from vil_fusion_tpu.models.window import D, FeatureStore, WindowState
from vil_fusion_tpu.parallel.mesh import AXIS, get_active_mesh


def build_system_sharded(state, feats_shard: FeatureStore, pre, lidar, prior,
                         cfg: ba.BAConfig, cauchy_c=1.0):
    """Per-device body (runs under shard_map): assemble local landmark blocks,
    psum the (pre-Schur) pose-state system; IMU/LiDAR/prior factors evaluated
    on every device at 1/N weight (cheap, avoids a broadcast branch).

    Returns (H, b, cost) replicated + (Hpd, Hd, bd) landmark-local — the
    sharded image of ba.System."""
    dtype = state.p.dtype
    g = jnp.asarray(cfg.gravity, dtype)
    n_dev = jax.lax.psum(jnp.ones((), dtype), AXIS)
    inv_n = 1.0 / n_dev

    H = jnp.zeros((D, D), dtype)
    b = jnp.zeros((D,), dtype)

    r_p = factors.marg_prior_residual(prior, state)
    Jp = jnp.where(prior.valid, 1.0, 0.0) * prior.J
    H = H + Jp.T @ Jp * inv_n
    b = b - Jp.T @ r_p * inv_n
    cost = jnp.sum(r_p * r_p) * inv_n

    r, J, ix = ba._imu_blocks(state, pre, g, dtype)
    JTJ = jnp.einsum("nrd,nre->nde", J, J) * inv_n
    JTr = jnp.einsum("nrd,nr->nd", J, r) * inv_n
    H = H.at[ix[:, :, None], ix[:, None, :]].add(JTJ)
    b = b.at[ix].add(-JTr)
    cost = cost + jnp.sum(r * r) * inv_n

    if cfg.use_lidar:
        r, J, ix = ba._lidar_blocks(state, lidar, dtype)
        JTJ = jnp.einsum("nrd,nre->nde", J, J) * inv_n
        JTr = jnp.einsum("nrd,nr->nd", J, r) * inv_n
        H = H.at[ix[:, :, None], ix[:, None, :]].add(JTJ)
        b = b.at[ix].add(-JTr)
        cost = cost + jnp.sum(r * r) * inv_n

    # local landmark shard (one-hot matmul assembly)
    r, Jpse, Jd, ixp, f_idx, rho_cost = ba._proj_blocks(
        state, feats_shard, cfg, dtype, cauchy_c)
    F_loc = feats_shard.active.shape[0]
    cost = cost + rho_cost
    Hpd = jnp.zeros((D, F_loc), dtype)
    Hd = jnp.zeros((F_loc,), dtype)
    bd = jnp.zeros((F_loc,), dtype)
    H, b, Hpd, Hd, bd = ba.accumulate_proj_quadratic(
        H, b, Hpd, Hd, bd, r, Jpse, Jd, ixp, f_idx)

    H = jax.lax.psum(H, AXIS)
    b = jax.lax.psum(b, AXIS)
    cost = jax.lax.psum(cost, AXIS)
    return H, b, cost, Hpd, Hd, bd


def schur_solve_sharded(H, b, Hpd, Hd, bd, lam, cfg: ba.BAConfig):
    """Sharded mirror of ba.schur_solve: per-landmark elimination is local,
    the Schur correction to the pose system is one psum, the damped solve is
    replicated (identical on every device)."""
    d_ok = Hd > 1e-8
    Hd_safe = jnp.where(d_ok, Hd, 1.0) + lam
    inv_Hd = jnp.where(d_ok, 1.0 / Hd_safe, 0.0)
    Hs = H - jax.lax.psum((Hpd * inv_Hd[None, :]) @ Hpd.T, AXIS)
    bs = b - jax.lax.psum(Hpd @ (bd * inv_Hd), AXIS)
    damp = lam * (jnp.diag(H) + 1.0)
    Hs = Hs + jnp.diag(damp)
    s = 1.0 / jnp.sqrt(jnp.abs(jnp.diag(Hs)) + 1e-10)
    Hn = Hs * s[:, None] * s[None, :]
    bn = bs * s
    y = jnp.linalg.solve(Hn, bn)
    y = y + jnp.linalg.solve(Hn, bn - Hn @ y)  # iterative refinement
    delta = y * s
    delta_d = (bd - Hpd.T @ delta) * inv_Hd  # local landmark back-subst
    return delta, delta_d


def total_cost_sharded(state, feats_shard, pre, lidar, prior, cfg, cauchy_c):
    dtype = state.p.dtype
    g = jnp.asarray(cfg.gravity, dtype)
    n_dev = jax.lax.psum(jnp.ones((), dtype), AXIS)
    inv_n = 1.0 / n_dev
    r_p = factors.marg_prior_residual(prior, state)
    cost = jnp.sum(r_p * r_p) * inv_n
    r, _J, _ = ba._imu_blocks(state, pre, g, dtype)
    cost = cost + jnp.sum(r * r) * inv_n
    if cfg.use_lidar:
        r, _J, _ = ba._lidar_blocks(state, lidar, dtype)
        cost = cost + jnp.sum(r * r) * inv_n
    _r, _Jp, _Jd, _, _, rho_cost = ba._proj_blocks(
        state, feats_shard, cfg, dtype, cauchy_c)
    return jax.lax.psum(cost + rho_cost, AXIS)


def _lm_loop_body(state, feats_shard, pre, lidar, prior, cfg: ba.BAConfig):
    """The full annealed LM loop of ba.optimize, per-device body."""
    anchor_p0 = state.p[0]
    from vil_fusion_tpu.ops import lie

    anchor_ypr0 = lie.R2ypr(lie.q2R(state.q[0]))
    dtype = state.p.dtype
    sched = jnp.maximum(
        jnp.ones((cfg.max_iters,), dtype),
        16.0 * 0.25 ** jnp.arange(cfg.max_iters, dtype=dtype))

    def step(carry, cauchy_c):
        st, ft, lam = carry
        H, b, cost0, Hpd, Hd, bd = build_system_sharded(
            st, ft, pre, lidar, prior, cfg, cauchy_c)
        delta, delta_d = schur_solve_sharded(H, b, Hpd, Hd, bd, lam, cfg)
        cand_st, cand_ft = ba._apply(st, ft, delta, delta_d, cfg)
        new_cost = total_cost_sharded(cand_st, cand_ft, pre, lidar, prior,
                                      cfg, cauchy_c)
        accept = (new_cost < cost0) & jnp.isfinite(new_cost)
        st = jax.tree.map(lambda a, b_: jnp.where(accept, b_, a), st, cand_st)
        ft = jax.tree.map(lambda a, b_: jnp.where(accept, b_, a), ft, cand_ft)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-7), lam * 8.0)
        cost = jnp.where(accept, new_cost, cost0)
        return (st, ft, lam), cost

    (state, feats_shard, _), costs = jax.lax.scan(
        step, (state, feats_shard, jnp.asarray(cfg.lm_init, dtype)), sched)
    state = ba.re_anchor(state, anchor_p0, anchor_ypr0)
    return state, feats_shard, costs[-1]


def _feats_specs(feats):
    return jax.tree.map(lambda _: P(AXIS), feats,
                        is_leaf=lambda x: x is None)


def optimize_sharded(mesh, state, feats, pre, lidar, prior,
                     cfg: ba.BAConfig):
    """Drop-in for ba.optimize with landmark factors sharded over `mesh`.
    `feats` arrays are (or become) sharded on the leading landmark axis; the
    window state is replicated. Returns (state, feats, cost)."""
    body = jax.shard_map(
        functools.partial(_lm_loop_body, cfg=cfg), mesh=mesh,
        in_specs=(P(), _feats_specs(feats), P(), P(), P()),
        out_specs=(P(), _feats_specs(feats), P()),
        check_vma=False)
    return body(state, feats, pre, lidar, prior)


def optimize_on_active_mesh(state, feats, pre, lidar, prior, cfg: ba.BAConfig):
    """ba.optimize replacement used inside jitted code (fused_full_step) when
    cfg.sharded is set: resolves the mesh from parallel.mesh at trace time."""
    return optimize_sharded(get_active_mesh(), state, feats, pre, lidar,
                            prior, cfg)


def optimize_step_sharded(mesh, state, feats, pre, lidar, prior,
                          cfg: ba.BAConfig, lam=1e-4):
    """One sharded GN step at fixed damping (kept for tests/benchmarks; the
    deployment path is optimize_sharded). Returns (state, feats, cost)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), _feats_specs(feats), P(), P(), P()),
        out_specs=(P(), _feats_specs(feats), P()),
        check_vma=False)
    def step(state, feats_shard, pre, lidar, prior):
        H, b, cost, Hpd, Hd, bd = build_system_sharded(
            state, feats_shard, pre, lidar, prior, cfg)
        lam_ = jnp.asarray(lam, state.p.dtype)
        delta, delta_d = schur_solve_sharded(H, b, Hpd, Hd, bd, lam_, cfg)
        new_state, new_feats = ba._apply(state, feats_shard, delta, delta_d, cfg)
        return new_state, new_feats, cost

    return step(state, feats, pre, lidar, prior)
