"""Marginalization (Schur prior) and window sliding.

Rebuild of the reference's marginalization machinery
(reference: src/visual_inertial_lidar/vins_estimator/factor/marginalization_factor.cpp:
preMarginalize :37-173, 4-pthread Hessian assembly :232-261, Schur complement
with eigendecomposition :267-297, prior replay :333-381) and `slideWindow`
(estimator.cpp:1052-1177, removeBackShiftDepth feature_manager.cpp:292-339).

Accelerator-first: the pthread map-reduce becomes the same batched scatter-add used by
ba.build_system; the Schur complement and the (J, r0) re-factorization are two
eigendecompositions of small dense matrices — one fused jit, no threads.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.models import ba, factors, imu as imu_mod
from vil_fusion_tpu.models.window import (
    D, K, FeatureStore, LidarConstraints, StackedPreint, WindowState,
)
from vil_fusion_tpu.ops import lie

MargPrior = factors.MargPrior
_EIG_EPS = 1e-8  # eigenvalue threshold (marginalization_factor.cpp:267-276)


def _quadratic_to_factor(Lam, g):
    """Express quadratic (Lam, g) as linear factor (J, r0) with J^T J = Lam,
    J^T r0 = g (marginalization_factor.cpp:288-297 semantics)."""
    Lam = 0.5 * (Lam + Lam.T)
    S, V = jnp.linalg.eigh(Lam)
    ok = S > _EIG_EPS
    S_sqrt = jnp.where(ok, jnp.sqrt(jnp.maximum(S, _EIG_EPS)), 0.0)
    S_inv_sqrt = jnp.where(ok, 1.0 / jnp.maximum(S_sqrt, _EIG_EPS), 0.0)
    J = S_sqrt[:, None] * V.T
    r0 = S_inv_sqrt * (V.T @ g)
    return J, r0


def _schur_eliminate(Lam, g, m_idx, r_idx):
    """Eliminate dims m_idx from (Lam, g) via eigendecomposed pseudo-inverse."""
    Lmm = Lam[jnp.ix_(m_idx, m_idx)]
    Lmm = 0.5 * (Lmm + Lmm.T)
    S, V = jnp.linalg.eigh(Lmm)
    S_inv = jnp.where(S > _EIG_EPS, 1.0 / jnp.maximum(S, _EIG_EPS), 0.0)
    Lmm_inv = (V * S_inv[None, :]) @ V.T
    Lrm = Lam[jnp.ix_(r_idx, m_idx)]
    Lrr = Lam[jnp.ix_(r_idx, r_idx)]
    Lam_new = Lrr - Lrm @ Lmm_inv @ Lrm.T
    g_new = g[r_idx] - Lrm @ (Lmm_inv @ g[m_idx])
    return Lam_new, g_new


def _shifted_state(state: WindowState) -> WindowState:
    """Window layout after MARGIN_OLD: slots 0..K-2 <- 1..K-1, slot K-1 dup."""
    sh = lambda a: jnp.concatenate([a[1:], a[-1:]], axis=0)
    return state._replace(p=sh(state.p), q=sh(state.q), v=sh(state.v),
                          ba=sh(state.ba), bg=sh(state.bg))


@functools.partial(jax.jit, static_argnames=("cfg",))
def marginalize_old(
    state: WindowState,
    feats: FeatureStore,
    pre: StackedPreint,
    lidar: LidarConstraints,
    prior: MargPrior,
    cfg: ba.BAConfig,
) -> MargPrior:
    """Marginalize frame 0: build the quadratic from every factor touching it
    (prior + IMU slot 1 + LiDAR slot 1 + projections anchored at frame 0),
    eliminate those features' depths then the 15 frame-0 dims, re-factorize,
    and re-index into the slid window (estimator.cpp:862-1046 semantics)."""
    dtype = state.p.dtype
    g_vec = jnp.asarray(cfg.gravity, dtype)
    F = feats.active.shape[0]
    Lam = jnp.zeros((D, D), dtype)
    g = jnp.zeros((D,), dtype)

    # prior factor (touches everything)
    Jp = jnp.where(prior.valid, 1.0, 0.0) * prior.J
    r_p = factors.marg_prior_residual(prior, state)
    Lam = Lam + Jp.T @ Jp
    g = g + Jp.T @ r_p

    # IMU slot 1 only
    r, J, ix = ba._imu_blocks(state, pre, g_vec, dtype)
    m = (jnp.arange(1, K) == 1).astype(dtype)
    r, J = r * m[:, None], J * m[:, None, None]
    Lam = Lam.at[ix[:, :, None], ix[:, None, :]].add(jnp.einsum("nrd,nre->nde", J, J))
    g = g.at[ix].add(jnp.einsum("nrd,nr->nd", J, r))

    # LiDAR slot 1 only
    if cfg.use_lidar:
        r, J, ix = ba._lidar_blocks(state, lidar, dtype)
        r, J = r * m[:, None], J * m[:, None, None]
        Lam = Lam.at[ix[:, :, None], ix[:, None, :]].add(jnp.einsum("nrd,nre->nde", J, J))
        g = g.at[ix].add(jnp.einsum("nrd,nr->nd", J, r))

    # projections anchored at frame 0 (depths eliminated on the fly);
    # one-hot matmul assembly like ba.accumulate_proj_quadratic (sign note:
    # that helper accumulates b -= J^T r while this function carries
    # g = +J^T r, so negate its b outputs)
    marg_feats = feats._replace(active=feats.active & (feats.start == 0))
    r, Jpse, Jd, ixp, f_idx, _rho = ba._proj_blocks(state, marg_feats, cfg, dtype, 1.0)
    bneg = jnp.zeros((D,), dtype)
    gd_neg = jnp.zeros((F,), dtype)
    Hpd = jnp.zeros((D, F), dtype)
    Hd = jnp.zeros((F,), dtype)
    Lam, bneg, Hpd, Hd, gd_neg = ba.accumulate_proj_quadratic(
        Lam, bneg, Hpd, Hd, gd_neg, r, Jpse, Jd, ixp, f_idx)
    g = g - bneg
    gd = -gd_neg
    inv_Hd = jnp.where(Hd > _EIG_EPS, 1.0 / jnp.maximum(Hd, _EIG_EPS), 0.0)
    Lam = Lam - (Hpd * inv_Hd[None, :]) @ Hpd.T
    g = g - Hpd @ (inv_Hd * gd)

    # eliminate frame-0 dims [0, 15)
    m_idx = jnp.arange(15)
    r_idx = jnp.arange(15, D)
    Lam_r, g_r = _schur_eliminate(Lam, g, m_idx, r_idx)

    J_new_small, r0_small = _quadratic_to_factor(Lam_r, g_r)  # (D-15, D-15)

    # re-index into the slid window: old dims 15..15K-1 -> new 0..15(K-1)-1,
    # ext/td dims keep their absolute position 15K..15K+6.
    n_f = 15 * (K - 1)  # frame dims remaining
    J_new = jnp.zeros((D, D), dtype)
    J_new = J_new.at[:D - 15, :n_f].set(J_new_small[:, :n_f])
    J_new = J_new.at[:D - 15, 15 * K:].set(J_new_small[:, n_f:])
    r0_new = jnp.zeros((D,), dtype).at[: D - 15].set(r0_small)

    return MargPrior(J=J_new, r0=r0_new, lin=_shifted_state(state),
                     valid=jnp.ones((), bool))


@jax.jit
def marginalize_second_new(prior: MargPrior, state_after_slide: WindowState) -> MargPrior:
    """Drop the second-newest frame from the prior only (the reference's
    MARGIN_SECOND_NEW path marginalizes just the prior blocks touching that
    frame — its visual observations are discarded, estimator.cpp:875-887)."""
    dtype = prior.J.dtype
    Jp = jnp.where(prior.valid, 1.0, 0.0) * prior.J
    Lam = Jp.T @ Jp
    g = Jp.T @ prior.r0
    drop0 = 15 * (K - 2)
    m_idx = jnp.arange(drop0, drop0 + 15)
    r_idx = jnp.concatenate([jnp.arange(0, drop0), jnp.arange(drop0 + 15, D)])
    Lam_r, g_r = _schur_eliminate(Lam, g, m_idx, r_idx)
    J_small, r0_small = _quadratic_to_factor(Lam_r, g_r)
    # col map: dims < drop0 identity; old frame K-1 dims -> slot K-2; ext/td same
    J_new = jnp.zeros((D, D), dtype)
    J_new = J_new.at[: D - 15, :drop0].set(J_small[:, :drop0])
    J_new = J_new.at[: D - 15, drop0 : drop0 + 15].set(J_small[:, drop0 : drop0 + 15])
    J_new = J_new.at[: D - 15, 15 * K :].set(J_small[:, drop0 + 15 :])
    r0_new = jnp.zeros((D,), dtype).at[: D - 15].set(r0_small)
    return MargPrior(J=J_new, r0=r0_new, lin=state_after_slide,
                     valid=prior.valid)


# ---------------------------------------------------------------------------
# Window sliding (array shifts + feature bookkeeping)
# ---------------------------------------------------------------------------

def _reset_row(tree_row_template, arr, i):
    return arr.at[i].set(tree_row_template)


@functools.partial(jax.jit, static_argnames=("imu_noise",))
def slide_old(
    state: WindowState,
    feats: FeatureStore,
    pre: StackedPreint,
    lidar: LidarConstraints,
    imu_noise: imu_mod.ImuNoise = imu_mod.ImuNoise(),
):
    """MARGIN_OLD slide (estimator.cpp:1055-1116 + removeBackShiftDepth)."""
    dtype = state.p.dtype
    old_q0, old_p0 = state.q[0], state.p[0]
    new_state = _shifted_state(state)

    sh = lambda a: jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)
    new_pre = StackedPreint(**{k: sh(v) for k, v in pre._asdict().items()})
    new_lidar = LidarConstraints(
        q_rel=jnp.concatenate([lidar.q_rel[1:],
                               jnp.array([[1.0, 0, 0, 0]], dtype)], axis=0),
        p_rel=sh(lidar.p_rel), valid=sh(lidar.valid))

    # ---- features: depth handover to the new anchor (frame 1's camera) ----
    # old anchor camera pose / new anchor camera pose in world
    qic, tic = state.qic, state.tic
    q_c0 = lie.qmul(old_q0, qic)
    p_c0 = lie.qrot(old_q0, tic) + old_p0
    q_c1 = lie.qmul(state.q[1], qic)
    p_c1 = lie.qrot(state.q[1], tic) + state.p[1]

    anchored0 = feats.active & (feats.start == 0)
    obs0 = feats.obs[:, 0]  # (F, 2) anchor observations
    depth0 = 1.0 / jnp.maximum(feats.inv_depth, 1e-6)
    pts_c0 = jnp.concatenate([obs0, jnp.ones_like(obs0[:, :1])], axis=-1) * depth0[:, None]
    pts_w = lie.qrot(q_c0[None, :], pts_c0) + p_c0[None, :]
    pts_c1 = lie.qrot(lie.qconj(q_c1)[None, :], pts_w - p_c1[None, :])
    new_depth = pts_c1[:, 2]
    handover_ok = anchored0 & (feats.inv_depth > 0) & (new_depth > 0.1)
    inv_depth_new = jnp.where(handover_ok, 1.0 / jnp.maximum(new_depth, 1e-6),
                              jnp.where(anchored0, -1.0, feats.inv_depth))
    lidar_flag_new = jnp.where(anchored0 & ~handover_ok, False, feats.lidar_flag)

    # shift observation grid left
    obs_new = jnp.concatenate([feats.obs[:, 1:], jnp.zeros_like(feats.obs[:, :1])], axis=1)
    ov_new = jnp.concatenate([feats.obs_valid[:, 1:],
                              jnp.zeros_like(feats.obs_valid[:, :1])], axis=1)
    vel_new = jnp.concatenate([feats.vel[:, 1:], jnp.zeros_like(feats.vel[:, :1])], axis=1)
    tsh_new = jnp.concatenate([feats.tshift[:, 1:],
                               jnp.zeros_like(feats.tshift[:, :1])], axis=1)
    start_new = jnp.maximum(feats.start - 1, 0)
    active_new = feats.active & jnp.any(ov_new, axis=1)
    feat_id_new = jnp.where(active_new, feats.feat_id, -1)

    new_feats = FeatureStore(
        active=active_new, start=start_new, obs=obs_new, obs_valid=ov_new,
        vel=vel_new, tshift=tsh_new,
        inv_depth=jnp.where(active_new, inv_depth_new, -1.0),
        lidar_flag=jnp.where(active_new, lidar_flag_new, False),
        feat_id=feat_id_new)
    return new_state, new_feats, new_pre, new_lidar


@functools.partial(jax.jit, static_argnames=("imu_noise", "imu_cap"))
def slide_new(
    state: WindowState,
    feats: FeatureStore,
    pre: StackedPreint,
    lidar: LidarConstraints,
    imu_noise: imu_mod.ImuNoise = imu_mod.ImuNoise(),
    imu_cap: int = 64,
):
    """MARGIN_SECOND_NEW slide: discard frame K-2, merge IMU segments and
    compose LiDAR constraints (estimator.cpp:1119-1162)."""
    dtype = state.p.dtype
    i, j = K - 2, K - 1  # merged into slot i

    # ---- IMU merge: samples of segment i + segment j (shared boundary) ----
    n1 = pre.n_samples[i]
    n2 = pre.n_samples[j]
    cap = pre.acc_buf.shape[1]

    # Fixed-capacity twist (the reference's vectors are unbounded,
    # estimator.cpp:1122-1133): if the merged buffer would overflow, decimate
    # segment i 2x first — every other sample kept, dt pairs summed, total
    # time exactly preserved (midpoint integration at half rate).
    def decimate(acc, gyr, dt, n):
        idx = jnp.arange(cap)
        src = jnp.clip(idx * 2, 0, cap - 1)
        acc_d = acc[src]
        gyr_d = gyr[src]
        dt_src0 = jnp.clip(idx * 2, 0, cap - 2)
        dt_src1 = jnp.clip(idx * 2 + 1, 0, cap - 2)
        dt_pad = dt  # (cap-1,)
        dt_d = jnp.where(
            idx[: cap - 1] * 2 + 1 < n - 1,
            dt_pad[dt_src0[: cap - 1]] + dt_pad[dt_src1[: cap - 1]],
            jnp.where(idx[: cap - 1] * 2 < n - 1, dt_pad[dt_src0[: cap - 1]], 0.0))
        n_d = (n + 1) // 2
        return acc_d, gyr_d, dt_d, n_d

    overflow = n1 + n2 - 1 > cap
    acc_i, gyr_i, dt_i, n1 = jax.tree.map(
        lambda a, b: jnp.where(overflow, a, b),
        decimate(pre.acc_buf[i], pre.gyr_buf[i], pre.dt_buf[i], n1),
        (pre.acc_buf[i], pre.gyr_buf[i], pre.dt_buf[i], n1))
    # a single 2x pass can still overflow (n1/2 + n2 - 1 > cap when n2 is
    # near cap); decimating segment j as well guarantees a fit since
    # ceil(n1/2) + ceil(n2/2) - 1 <= cap for n1, n2 <= cap
    overflow2 = n1 + n2 - 1 > cap
    acc_j, gyr_j, dt_j, n2 = jax.tree.map(
        lambda a, b: jnp.where(overflow2, a, b),
        decimate(pre.acc_buf[j], pre.gyr_buf[j], pre.dt_buf[j], n2),
        (pre.acc_buf[j], pre.gyr_buf[j], pre.dt_buf[j], n2))
    pre = pre._replace(
        acc_buf=pre.acc_buf.at[i].set(acc_i).at[j].set(acc_j),
        gyr_buf=pre.gyr_buf.at[i].set(gyr_i).at[j].set(gyr_j),
        dt_buf=pre.dt_buf.at[i].set(dt_i).at[j].set(dt_j),
        n_samples=pre.n_samples.at[i].set(n1).at[j].set(n2))

    def roll_append(buf_i, buf_j, n1):
        # place buf_j[1:] starting at position n1 in a fresh buffer
        cap = buf_i.shape[0]
        idx = jnp.arange(cap)
        src = jnp.clip(idx - n1 + 1, 0, cap - 1)
        tail = buf_j[src]
        return jnp.where((idx < n1)[:, None], buf_i, tail)

    acc_m = roll_append(pre.acc_buf[i], pre.acc_buf[j], n1)
    gyr_m = roll_append(pre.gyr_buf[i], pre.gyr_buf[j], n1)
    # dt buffer: first n1-1 from segment i, then n2-1 from segment j
    capd = pre.dt_buf.shape[1]
    idxd = jnp.arange(capd)
    srcd = jnp.clip(idxd - (n1 - 1), 0, capd - 1)
    dt_m = jnp.where(idxd < n1 - 1, pre.dt_buf[i],
                     jnp.where(idxd < n1 - 1 + n2 - 1, pre.dt_buf[j][srcd], 0.0))
    n_m = jnp.where(pre.valid[i], n1 + n2 - 1, n2)
    acc_m = jnp.where(pre.valid[i], acc_m, pre.acc_buf[j])
    gyr_m = jnp.where(pre.valid[i], gyr_m, pre.gyr_buf[j])
    dt_m = jnp.where(pre.valid[i], dt_m, pre.dt_buf[j])

    from vil_fusion_tpu.models.window import make_segment

    seg = make_segment(acc_m, gyr_m, dt_m, n_m, pre.ba[i], pre.bg[i], imu_noise, imu_cap)
    pre_d = pre._asdict()
    new_pre = StackedPreint(**{
        k: pre_d[k].at[i].set(seg[k]).at[j].set(jnp.zeros_like(pre_d[k][j]))
        for k in pre_d})
    new_pre = new_pre._replace(
        dq=new_pre.dq.at[j].set(jnp.array([1.0, 0, 0, 0], dtype)),
        jac=new_pre.jac.at[j].set(jnp.eye(15, dtype=dtype)),
        sqrt_info=new_pre.sqrt_info.at[j].set(jnp.eye(15, dtype=dtype)),
        valid=new_pre.valid.at[i].set(seg["valid"]).at[j].set(False))

    # ---- LiDAR constraint composition T_{i-1,j} = T_{i-1,i} * T_{i,j} ----
    q_c, p_c = lie.pose_compose(
        (lidar.q_rel[i], lidar.p_rel[i]), (lidar.q_rel[j], lidar.p_rel[j]))
    both = lidar.valid[i] & lidar.valid[j]
    new_lidar = LidarConstraints(
        q_rel=lidar.q_rel.at[i].set(jnp.where(both, q_c, lidar.q_rel[j]))
        .at[j].set(jnp.array([1.0, 0, 0, 0], dtype)),
        p_rel=lidar.p_rel.at[i].set(jnp.where(both, p_c, lidar.p_rel[j]))
        .at[j].set(jnp.zeros(3, dtype)),
        valid=lidar.valid.at[i].set(lidar.valid[j]).at[j].set(False))

    # ---- state: slot i <- slot j ----
    cp = lambda a: a.at[i].set(a[j])
    new_state = state._replace(p=cp(state.p), q=cp(state.q), v=cp(state.v),
                               ba=cp(state.ba), bg=cp(state.bg))

    # ---- features (removeFront): drop obs at frame i, move obs j -> i ----
    obs_new = feats.obs.at[:, i].set(feats.obs[:, j])
    obs_new = obs_new.at[:, j].set(0.0)
    ov_new = feats.obs_valid.at[:, i].set(feats.obs_valid[:, j])
    ov_new = ov_new.at[:, j].set(False)
    vel_new = feats.vel.at[:, i].set(feats.vel[:, j]).at[:, j].set(0.0)
    tsh_new = feats.tshift.at[:, i].set(feats.tshift[:, j]).at[:, j].set(0.0)
    start_new = jnp.where(feats.start == j, i, feats.start)
    active_new = feats.active & jnp.any(ov_new, axis=1)
    new_feats = feats._replace(
        obs=obs_new, obs_valid=ov_new, vel=vel_new, tshift=tsh_new,
        start=start_new,
        active=active_new, feat_id=jnp.where(active_new, feats.feat_id, -1),
        inv_depth=jnp.where(active_new, feats.inv_depth, -1.0),
        lidar_flag=jnp.where(active_new, feats.lidar_flag, False))
    return new_state, new_feats, new_pre, new_lidar
