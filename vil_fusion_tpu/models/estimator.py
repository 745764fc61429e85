"""Sliding-window visual-inertial-LiDAR estimator (orchestration).

Rebuild of the reference's `Estimator` (estimator.{h,cpp}: processIMU :103-137,
processImage :139-236, solveOdometry :492-503, slideWindow :1052-1177,
failureDetection :640-686) and the feature manager (feature_manager.cpp:
addFeatureCheckParallax :44-105, triangulate :218-270).

Host-side Python orchestrates; all per-frame heavy work (ingestion,
triangulation, BA, marginalization, sliding) is jitted with fixed shapes.
The ROS node's callback threads collapse into a single `process_frame` call
per synchronized (image, lidar, IMU-segment) bundle.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import ba, imu as imu_mod, initialization as init_mod, marginalization as marg
from vil_fusion_tpu.models.window import (
    D, K, FeatureStore, LidarConstraints, StackedPreint, WindowState,
    init_features, init_lidar_constraints, init_preint, init_window, make_segment,
)
from vil_fusion_tpu.ops import lie

MIN_PARALLAX = 10.0 / 460.0  # parameters.cpp MIN_PARALLAX / FOCAL_LENGTH


class EstimatorConfig(NamedTuple):
    ba: ba.BAConfig = ba.BAConfig()
    f_cap: int = 128  # feature slots (reference tracks MAX_CNT=200 / frame)
    imu_cap: int = 64  # IMU samples per inter-frame segment (merge headroom)
    obs_cap: int = 128  # per-frame feature observations
    imu_noise: imu_mod.ImuNoise = imu_mod.ImuNoise()
    min_parallax: float = MIN_PARALLAX
    min_track_for_nonkey: int = 20  # addFeatureCheckParallax :60
    tri_min_depth: float = 0.1


# ---------------------------------------------------------------------------
# jitted helpers
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=())
def propagate_from_segment(state: WindowState, seg_dp, seg_dq, seg_dv, seg_dt,
                           slot_prev, gravity):
    """IMU mechanization of the new frame's state from the preintegrated
    segment (estimator.cpp processIMU world-frame propagation :120-135)."""
    p_i = state.p[slot_prev]
    q_i = state.q[slot_prev]
    v_i = state.v[slot_prev]
    q_j = lie.qnormalize(lie.qmul(q_i, seg_dq))
    v_j = v_i - gravity * seg_dt + lie.qrot(q_i, seg_dv)
    p_j = p_i + v_i * seg_dt - 0.5 * gravity * seg_dt * seg_dt + lie.qrot(q_i, seg_dp)
    return p_j, q_j, v_j


@jax.jit
def ingest_features(
    feats: FeatureStore,
    ids: jnp.ndarray,  # (M,) int32, -1 = empty
    xy: jnp.ndarray,  # (M, 2)
    vel: jnp.ndarray,  # (M, 2)
    depth: jnp.ndarray,  # (M,) lidar depth, <= 0 if none
    fc: jnp.ndarray,  # scalar int32 current frame slot
    tshift=None,  # (M,) rolling-shutter/td-capture shift (seconds) or None
) -> FeatureStore:
    """Associate incoming per-frame observations with feature slots by id;
    allocate free slots for new tracks; inject LiDAR depth for new tracks
    (feature_manager addFeatureCheckParallax :44-79 rebuild)."""
    F = feats.active.shape[0]
    M = ids.shape[0]
    present = ids >= 0

    # --- match against existing slots ---
    eq = (feats.feat_id[:, None] == ids[None, :]) & feats.active[:, None] & present[None, :]
    has_match = jnp.any(eq, axis=0)  # (M,)
    match_slot = jnp.argmax(eq, axis=0)  # (M,)

    # --- allocate slots for new tracks (stable: free slots in order) ---
    is_new = present & ~has_match
    free = ~feats.active
    free_slots = jnp.argsort(~free, stable=True)  # free first
    n_free = jnp.sum(free)
    new_rank = jnp.cumsum(is_new) - 1  # (M,)
    can_alloc = is_new & (new_rank < n_free)
    alloc_slot = free_slots[jnp.clip(new_rank, 0, F - 1)]

    slot = jnp.where(has_match, match_slot, jnp.where(can_alloc, alloc_slot, F))
    # scatter with overflow row F
    pad = lambda a: jnp.concatenate([a, jnp.zeros_like(a[:1])], axis=0)
    obs = pad(feats.obs).at[slot, fc].set(xy)[:F]
    ov = pad(feats.obs_valid).at[slot, fc].set(present)[:F]
    velg = pad(feats.vel).at[slot, fc].set(vel)[:F]
    if tshift is None:
        tshift = jnp.zeros_like(xy[:, 0])
    tshg = pad(feats.tshift).at[slot, fc].set(tshift)[:F]

    active = pad(feats.active).at[slot].set(present)[:F]
    feat_id = pad(feats.feat_id).at[slot].set(jnp.where(present, ids, -1))[:F]
    start = pad(feats.start).at[slot].set(
        jnp.where(has_match, pad(feats.start)[slot], fc))[:F]
    # lidar depth injection for NEW tracks only (depth is anchored at start
    # frame; reference injects when measured at the track's start,
    # feature_manager.cpp:74-79). Sign convention from feature_depth:
    # positive = strong incidence -> constant-depth feature (lidar_flag,
    # the reference's SetParameterBlockConstant semantics); negative
    # (< -2 m) = grazing incidence -> the depth only INITIALIZES inv_depth
    # and BA refines it (bias-prone grazing depths must not lock in).
    mag = jnp.abs(depth)
    has_depth = mag >= 2.0
    new_depth_val = jnp.where(has_depth, 1.0 / jnp.maximum(mag, 1e-3), -1.0)
    inv_depth = pad(feats.inv_depth).at[slot].set(
        jnp.where(has_match, pad(feats.inv_depth)[slot], new_depth_val))[:F]
    lidar_flag = pad(feats.lidar_flag).at[slot].set(
        jnp.where(has_match, pad(feats.lidar_flag)[slot], depth > 0))[:F]
    return FeatureStore(active=active, start=start, obs=obs, obs_valid=ov,
                        vel=velg, tshift=tshg, inv_depth=inv_depth,
                        lidar_flag=lidar_flag, feat_id=feat_id)


@jax.jit
def keyframe_decision(feats: FeatureStore, fc: jnp.ndarray,
                      min_parallax: float = MIN_PARALLAX,
                      min_track: int = 20):
    """True if the SECOND-newest frame is a keyframe
    (addFeatureCheckParallax :44-105 + compensatedParallax2)."""
    f2 = jnp.maximum(fc - 2, 0)
    f1 = jnp.maximum(fc - 1, 0)
    both = feats.active & feats.obs_valid[:, f2] & feats.obs_valid[:, f1]
    dp = feats.obs[:, f2] - feats.obs[:, f1]
    par = jnp.linalg.norm(dp, axis=-1)
    n_both = jnp.sum(both)
    mean_par = jnp.sum(jnp.where(both, par, 0.0)) / jnp.maximum(n_both, 1)
    tracked = jnp.sum(feats.active & feats.obs_valid[:, fc]
                      & (feats.start < fc))
    return (fc < 2) | (tracked < min_track) | (n_both == 0) | (mean_par >= min_parallax)


@jax.jit
def triangulate(state: WindowState, feats: FeatureStore,
                min_depth: float = 0.1) -> FeatureStore:
    """Multi-view DLT triangulation for features without depth
    (feature_manager.cpp triangulate :218-270; skips lidar-depthed tracks).

    Anchor camera = camera at start frame; solve A X = 0 with A built from
    every observation's projective rows, via eigh of A^T A (batched 4x4)."""
    F = feats.active.shape[0]
    # camera poses per window slot
    q_c = lie.qmul(state.q, state.qic[None, :])  # (K, 4)
    p_c = lie.qrot(state.q, jnp.broadcast_to(state.tic, (K, 3))) + state.p

    def per_feature(start, obs, ov):
        # T_j<-anchor: x_j = R_cj^T (R_ca x_a + p_ca - p_cj)
        q_a = q_c[start]
        p_a = p_c[start]
        R_rel = lie.q2R(lie.qmul(lie.qconj(q_c), q_a[None, :]))
        t_rel = lie.qrot(lie.qconj(q_c), p_a[None, :] - p_c)
        P = jnp.concatenate([R_rel, t_rel[:, :, None]], axis=-1)  # (K, 3, 4)
        u = obs[:, 0]
        v = obs[:, 1]
        row_u = u[:, None] * P[:, 2] - P[:, 0]  # (K, 4)
        row_v = v[:, None] * P[:, 2] - P[:, 1]
        w = ov.astype(obs.dtype)
        A = jnp.concatenate([row_u * w[:, None], row_v * w[:, None]], axis=0)  # (2K, 4)
        AtA = A.T @ A
        return AtA, jnp.sum(ov)

    AtA, n_obs = jax.vmap(per_feature)(feats.start, feats.obs, feats.obs_valid)
    # homogeneous point = nullspace of the batched 4x4 normal matrices;
    # Cholesky inverse iteration instead of batched eigh (ops/linalg)
    from vil_fusion_tpu.ops.linalg import smallest_eigvec_inverse_iteration

    X = smallest_eigvec_inverse_iteration(AtA)
    depth = X[:, 2] / jnp.where(jnp.abs(X[:, 3]) > 1e-12, X[:, 3], 1e-12)

    need = feats.active & (feats.inv_depth <= 0) & (n_obs >= 2) & ~feats.lidar_flag
    ok = need & (depth > min_depth) & jnp.isfinite(depth)
    inv_depth = jnp.where(ok, 1.0 / jnp.maximum(depth, min_depth), feats.inv_depth)
    return feats._replace(inv_depth=inv_depth)


@jax.jit
def landmarks_world(state: WindowState, feats: FeatureStore, slot: jnp.ndarray):
    """World-frame 3D points of depth-resolved features observed at `slot`,
    plus their normalized obs there (pubKeyframe export, visualization.cpp
    :385-440: WINDOW-2 pose + 3D/2D/id channels).

    Returns (pts_w (F, 3), obs_xy (F, 2), ids (F,), valid (F,))."""
    F = feats.active.shape[0]
    rows = jnp.arange(F)
    q_c = lie.qmul(state.q, state.qic[None, :])
    p_c = lie.qrot(state.q, jnp.broadcast_to(state.tic, (K, 3))) + state.p
    s = feats.start
    anchor_obs = feats.obs[rows, s]
    depth = 1.0 / jnp.maximum(feats.inv_depth, 1e-6)
    pts_c = jnp.concatenate([anchor_obs, jnp.ones_like(anchor_obs[:, :1])],
                            axis=-1) * depth[:, None]
    pts_w = lie.qrot(q_c[s], pts_c) + p_c[s]
    valid = (feats.active & (feats.inv_depth > 0)
             & feats.obs_valid[rows, s] & feats.obs_valid[:, slot])
    obs_at = feats.obs[:, slot]
    observed = feats.active & feats.obs_valid[:, slot]
    return pts_w, obs_at, feats.feat_id, valid, observed


@jax.jit
def gauge_transform(window: WindowState, prior, R_d, t_d):
    """Re-anchor the whole window by a yaw+translation transform — the VIO
    gauge freedom (relocalization feedback, estimator.cpp setReloFrame
    :1188-1206 + relo factors :799-836 + drift_correct in double2vector
    :617-638; here the correction is applied to the window itself, so the
    VIO output re-converges after a loop instead of drifting forever).

    Exact for every factor: IMU preintegration, lidar relative constraints
    and camera-anchored inverse depths are invariant under a global yaw+t;
    the marginalization prior is kept bit-equivalent by transforming its
    linearization point and rotating the position/velocity Jacobian columns
    (local-orientation and bias columns are invariant because the pose
    parameterization uses right perturbations: q' = q_d q gives unchanged
    q_lin'^{-1} q'). yaw-only rotation keeps gravity fixed."""
    dtype = window.p.dtype
    R_d = jnp.asarray(R_d, dtype)
    t_d = jnp.asarray(t_d, dtype)
    q_d = lie.R2q(R_d)

    def move(st: WindowState) -> WindowState:
        return st._replace(
            p=st.p @ R_d.T + t_d[None, :],
            q=lie.qnormalize(lie.qmul(q_d[None, :], st.q)),
            v=st.v @ R_d.T)

    window = move(window)
    # rotate prior Jacobian columns for the p and v blocks of every frame
    G = jnp.eye(D, dtype=dtype)
    for i in range(K):
        G = G.at[15 * i:15 * i + 3, 15 * i:15 * i + 3].set(R_d.T)
        G = G.at[15 * i + 6:15 * i + 9, 15 * i + 6:15 * i + 9].set(R_d.T)
    prior = prior._replace(J=prior.J @ G, lin=move(prior.lin))
    return window, prior


# failure_detection bitmask layout (nonzero == failed); FAIL_NAMES decodes a
# host-fetched mask into the predicate names for restart-cause reporting
# (every restart's cause must be recorded, not just counted)
FAIL_NAMES = {1: "acc_bias_norm", 2: "gyr_bias_norm", 4: "position_jump",
              8: "z_jump", 16: "rotation_jump"}


def decode_failure(mask: int):
    return [name for bit, name in FAIL_NAMES.items() if int(mask) & bit]


@jax.jit
def failure_detection(state: WindowState, state_prev_p, state_prev_q) -> jnp.ndarray:
    """Divergence detector (estimator.cpp failureDetection :640-686):
    bias norms, translation/z jumps, rotation jump. Returns an int32
    BITMASK of fired predicates (0 == healthy) so the host can log which
    gate tripped; any nonzero value means failure."""
    big_ba = jnp.linalg.norm(state.ba[K - 1]) > 2.5
    big_bg = jnp.linalg.norm(state.bg[K - 1]) > 1.0
    dp = state.p[K - 1] - state_prev_p
    big_jump = jnp.linalg.norm(dp) > 5.0
    big_z = jnp.abs(dp[2]) > 1.0
    dq = lie.qmul(lie.qconj(state_prev_q), state.q[K - 1])
    big_rot = jnp.linalg.norm(lie.so3_log(dq)) > 0.87  # ~50 deg
    return (big_ba.astype(jnp.int32) | (big_bg.astype(jnp.int32) << 1)
            | (big_jump.astype(jnp.int32) << 2) | (big_z.astype(jnp.int32) << 3)
            | (big_rot.astype(jnp.int32) << 4))


# ---------------------------------------------------------------------------
# Fused full-window frame step (one device program per frame)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg",))
def fused_full_step(
    window: WindowState,
    feats: FeatureStore,
    pre: StackedPreint,
    lidar: LidarConstraints,
    prior,
    acc_b, gyr_b, dt_b, n_imu,  # padded IMU segment buffers + count
    ids_b, xy_b, vel_b, dep_b, tsh_b,  # padded feature observations
    lidar_q_rel, lidar_p_rel, lidar_valid,
    run_ba,  # bool scalar: initialized (BA + failure detection active)
    cfg: EstimatorConfig,
):
    """The entire full-window frame: IMU segment + propagate + lidar
    constraint + feature ingest + keyframe decision + triangulate + BA +
    marginalize + slide — one XLA program.

    The host-orchestrated version dispatches ~10 kernels plus dozens of small
    host<->device reads per frame; under dispatch latency that dominates
    wall clock. This is the 'frame-synchronous
    pipeline of jitted stages' the SURVEY design calls for.

    Returns (window, feats, pre, lidar, prior, outputs dict).
    """
    fc = K - 1
    gravity = jnp.asarray(cfg.ba.gravity, window.p.dtype)

    # --- IMU segment into slot K-1 + state propagation ---
    seg = make_segment(acc_b, gyr_b, dt_b, n_imu, window.ba[fc - 1],
                       window.bg[fc - 1], cfg.imu_noise, cfg.imu_cap)
    pre_d = pre._asdict()
    pre = StackedPreint(**{k: pre_d[k].at[fc].set(seg[k]) for k in pre_d})
    has_imu = n_imu > 0
    p_j, q_j, v_j = propagate_from_segment(
        window, seg["dp"], seg["dq"], seg["dv"], seg["dt_sum"],
        jnp.int32(fc - 1), gravity)
    window = window._replace(
        p=window.p.at[fc].set(jnp.where(has_imu, p_j, window.p[fc])),
        q=window.q.at[fc].set(jnp.where(has_imu, q_j, window.q[fc])),
        v=window.v.at[fc].set(jnp.where(has_imu, v_j, window.v[fc])),
        ba=window.ba.at[fc].set(window.ba[fc - 1]),
        bg=window.bg.at[fc].set(window.bg[fc - 1]))

    # --- lidar inter-frame constraint ---
    lidar = LidarConstraints(
        q_rel=lidar.q_rel.at[fc].set(jnp.where(lidar_valid, lidar_q_rel,
                                               lidar.q_rel[fc])),
        p_rel=lidar.p_rel.at[fc].set(jnp.where(lidar_valid, lidar_p_rel,
                                               lidar.p_rel[fc])),
        valid=lidar.valid.at[fc].set(lidar_valid))

    # --- features + keyframe decision ---
    feats = ingest_features(feats, ids_b, xy_b, vel_b, dep_b, jnp.int32(fc),
                            tsh_b)
    is_key = keyframe_decision(feats, jnp.int32(fc), cfg.min_parallax,
                               cfg.min_track_for_nonkey)

    # --- triangulate + BA (only when initialized) ---
    prev_p = window.p[K - 1]
    prev_q = window.q[K - 1]

    def do_ba(args):
        window, feats = args
        feats = triangulate(window, feats, cfg.tri_min_depth)
        if cfg.ba.sharded:
            # landmark factors sharded over the active mesh (the reference's
            # 4-pthread Hessian map-reduce scaled to chips)
            from vil_fusion_tpu.parallel import sharded_ba

            w2, f2, cost = sharded_ba.optimize_on_active_mesh(
                window, feats, pre, lidar, prior, cfg.ba)
        else:
            w2, f2, cost = ba.optimize(window, feats, pre, lidar, prior, cfg.ba)
        return w2, f2, cost

    def skip_ba(args):
        window, feats = args
        return window, feats, jnp.zeros((), window.p.dtype)

    window, feats, cost = jax.lax.cond(run_ba, do_ba, skip_ba, (window, feats))
    failed = jnp.where(run_ba, failure_detection(window, prev_p, prev_q),
                       jnp.int32(0))

    out_p = window.p[K - 1]
    out_q = window.q[K - 1]
    out_v = window.v[K - 1]

    # --- marginalize + slide (keyframe vs non-keyframe path) ---
    def key_path(args):
        window, feats, pre, lidar, prior = args
        new_prior = marg.marginalize_old(window, feats, pre, lidar, prior, cfg.ba)
        w, f, p_, l_ = marg.slide_old(window, feats, pre, lidar, cfg.imu_noise)
        return w, f, p_, l_, new_prior

    def nonkey_path(args):
        window, feats, pre, lidar, prior = args
        w, f, p_, l_ = marg.slide_new(window, feats, pre, lidar,
                                      cfg.imu_noise, cfg.imu_cap)
        new_prior = marg.marginalize_second_new(prior, w)
        return w, f, p_, l_, new_prior

    window, feats, pre, lidar, prior = jax.lax.cond(
        is_key, key_path, nonkey_path, (window, feats, pre, lidar, prior))

    outputs = dict(p=out_p, q=out_q, v=out_v, cost=cost, failed=failed,
                   is_key=is_key)
    return window, feats, pre, lidar, prior, outputs


# ---------------------------------------------------------------------------
# Host-side estimator
# ---------------------------------------------------------------------------

class VILEstimator:
    """Single-controller rebuild of the estimator node (estimator_node.cpp).

    Call `process_frame` once per synchronized bundle. During the filling
    phase (first K frames) states are propagated by IMU only; once the window
    is full, every frame runs triangulate -> BA -> marginalize -> slide.
    """

    def __init__(self, cfg: EstimatorConfig = EstimatorConfig(), dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.window = init_window(dtype)
        self.feats = init_features(cfg.f_cap, dtype)
        self.pre = init_preint(cfg.imu_cap, dtype)
        self.lidar = init_lidar_constraints(dtype)
        self.prior = ba.empty_prior(self.window)
        self.frame_count = 0  # host-side (mirrors Estimator::frame_count)
        self.initialized = False
        self.failed = False
        self.fail_mask = 0  # failure_detection bitmask of the failing frame
        self.gravity = jnp.asarray(cfg.ba.gravity, dtype)

    # -- bootstrap helpers ---------------------------------------------------
    def set_initial_state(self, p, q, v, ba_=None, bg=None):
        """Oracle/LiDAR bootstrap: set frame-0 state (init module provides the
        visual-inertial alignment path)."""
        z3 = jnp.zeros(3, self.dtype)
        self.window = self.window._replace(
            p=self.window.p.at[0].set(jnp.asarray(p, self.dtype)),
            q=self.window.q.at[0].set(jnp.asarray(q, self.dtype)),
            v=self.window.v.at[0].set(jnp.asarray(v, self.dtype)),
            ba=self.window.ba.at[0].set(z3 if ba_ is None else jnp.asarray(ba_, self.dtype)),
            bg=self.window.bg.at[0].set(z3 if bg is None else jnp.asarray(bg, self.dtype)),
        )
        self.initialized = True

    def apply_drift(self, R_d, t_d):
        """Relocalization feedback (setReloFrame/relo-factor pathway): move
        the window + marg prior into the loop-corrected frame. Safe between
        frames; a pure gauge transform (see gauge_transform)."""
        self.window, self.prior = gauge_transform(
            self.window, self.prior, jnp.asarray(R_d, self.dtype),
            jnp.asarray(t_d, self.dtype))

    def set_extrinsics(self, qic, tic, td=0.0):
        self.window = self.window._replace(
            qic=jnp.asarray(qic, self.dtype), tic=jnp.asarray(tic, self.dtype),
            td=jnp.asarray(td, self.dtype))

    # -- per-frame processing ------------------------------------------------
    def process_frame(self, imu_acc, imu_gyr, imu_dt, obs_ids, obs_xy,
                      obs_vel=None, obs_depth=None, lidar_q_rel=None,
                      lidar_p_rel=None, obs_tshift=None):
        """One synchronized frame bundle. Returns (p, q, v) of the newest frame.

        imu_acc/imu_gyr: (n, 3) samples since previous frame (empty for first).
        obs_ids/obs_xy: per-frame feature observations (normalized plane).
        lidar_*_rel: relative body pose from LiDAR odometry since prev frame.
        """
        cfg = self.cfg
        fc = min(self.frame_count, K - 1)
        M = cfg.obs_cap

        # --- pack fixed-capacity buffers (one host pass) ---
        ids_b = np.full((M,), -1, np.int32)
        xy_b = np.zeros((M, 2), np.float32)
        vel_b = np.zeros((M, 2), np.float32)
        dep_b = np.zeros((M,), np.float32)
        tsh_b = np.zeros((M,), np.float32)
        m = min(len(obs_ids), M)
        ids_b[:m] = obs_ids[:m]
        xy_b[:m] = obs_xy[:m]
        if obs_vel is not None:
            vel_b[:m] = obs_vel[:m]
        if obs_depth is not None:
            dep_b[:m] = obs_depth[:m]
        if obs_tshift is not None:
            tsh_b[:m] = obs_tshift[:m]
        acc_b, gyr_b, dt_b, n_imu = self._pack_imu(imu_acc, imu_gyr, imu_dt)
        has_lidar = lidar_q_rel is not None and fc > 0
        lqr = np.asarray(lidar_q_rel if has_lidar else [1.0, 0, 0, 0], np.float32)
        lpr = np.asarray(lidar_p_rel if has_lidar else [0.0, 0, 0], np.float32)

        # --- steady state: one fused device program per frame ---
        if self.frame_count >= K - 1 and self.initialized:
            (self.window, self.feats, self.pre, self.lidar, self.prior,
             out) = fused_full_step(
                self.window, self.feats, self.pre, self.lidar, self.prior,
                jnp.asarray(acc_b), jnp.asarray(gyr_b), jnp.asarray(dt_b),
                jnp.int32(n_imu), jnp.asarray(ids_b), jnp.asarray(xy_b),
                jnp.asarray(vel_b), jnp.asarray(dep_b), jnp.asarray(tsh_b),
                jnp.asarray(lqr), jnp.asarray(lpr), jnp.asarray(bool(has_lidar)),
                jnp.asarray(True), cfg)
            host = jax.device_get((out["p"], out["q"], out["v"], out["cost"],
                                   out["failed"]))
            self.absorb_result(host[3], host[4])
            return np.asarray(host[0]), np.asarray(host[1]), np.asarray(host[2])

        # --- filling phase / cold start: host-orchestrated path ---
        if fc > 0 and n_imu > 0:
            seg = self._store_segment(acc_b, gyr_b, dt_b, n_imu, fc)
            p_j, q_j, v_j = propagate_from_segment(
                self.window, seg["dp"], seg["dq"], seg["dv"], seg["dt_sum"],
                jnp.int32(fc - 1), self.gravity)
            self.window = self.window._replace(
                p=self.window.p.at[fc].set(p_j),
                q=self.window.q.at[fc].set(q_j),
                v=self.window.v.at[fc].set(v_j),
                ba=self.window.ba.at[fc].set(self.window.ba[fc - 1]),
                bg=self.window.bg.at[fc].set(self.window.bg[fc - 1]))
        if has_lidar:
            self.lidar = LidarConstraints(
                q_rel=self.lidar.q_rel.at[fc].set(jnp.asarray(lqr)),
                p_rel=self.lidar.p_rel.at[fc].set(jnp.asarray(lpr)),
                valid=self.lidar.valid.at[fc].set(True))
        self.feats = ingest_features(
            self.feats, jnp.asarray(ids_b), jnp.asarray(xy_b),
            jnp.asarray(vel_b), jnp.asarray(dep_b), jnp.int32(fc),
            jnp.asarray(tsh_b))

        if self.frame_count < K - 1:
            self.frame_count += 1
            return self._current_pose(fc)

        # --- cold start: visual-inertial initialization (initialStructure) ---
        if not self.initialized:
            self._try_initialize()
        if self.initialized:
            prev_p = self.window.p[K - 1]
            prev_q = self.window.q[K - 1]
            self.feats = triangulate(self.window, self.feats, cfg.tri_min_depth)
            if cfg.ba.sharded:
                from vil_fusion_tpu.parallel import sharded_ba

                self.window, self.feats, cost = sharded_ba.optimize_on_active_mesh(
                    self.window, self.feats, self.pre, self.lidar, self.prior,
                    cfg.ba)
            else:
                self.window, self.feats, cost = ba.optimize(
                    self.window, self.feats, self.pre, self.lidar, self.prior,
                    cfg.ba)
            self.last_cost = float(cost)
            mask = int(failure_detection(self.window, prev_p, prev_q))
            if mask:
                self.failed = True
                self.fail_mask = mask

        is_key = bool(keyframe_decision(
            self.feats, jnp.int32(fc), cfg.min_parallax, cfg.min_track_for_nonkey))
        if is_key:
            self.prior = marg.marginalize_old(
                self.window, self.feats, self.pre, self.lidar, self.prior, cfg.ba)
            self.window, self.feats, self.pre, self.lidar = marg.slide_old(
                self.window, self.feats, self.pre, self.lidar, cfg.imu_noise)
        else:
            self.window, self.feats, self.pre, self.lidar = marg.slide_new(
                self.window, self.feats, self.pre, self.lidar, cfg.imu_noise,
                cfg.imu_cap)
            self.prior = marg.marginalize_second_new(self.prior, self.window)

        return self._current_pose(K - 1)

    def process_frame_device(self, acc_b, gyr_b, dt_b, n_imu,
                             ids, xy, vel, dep,
                             lidar_q_rel=None, lidar_p_rel=None, tsh=None):
        """Device-to-device fast path for the steady state: all inputs are
        already fixed-capacity device arrays (tracker outputs flow straight
        into the fused step — no host round trip). Arrays must have
        obs_cap-length leading dims; ids == -1 marks empty slots.

        Falls back to the host path (packing + init) until initialized."""
        if not (self.frame_count >= K - 1 and self.initialized):
            val = np.asarray(ids) >= 0
            return self.process_frame(
                np.asarray(acc_b)[: int(n_imu)], np.asarray(gyr_b)[: int(n_imu)],
                np.asarray(dt_b), np.asarray(ids)[val], np.asarray(xy)[val],
                obs_vel=np.asarray(vel)[val], obs_depth=np.asarray(dep)[val],
                lidar_q_rel=None if lidar_q_rel is None else np.asarray(lidar_q_rel),
                lidar_p_rel=None if lidar_p_rel is None else np.asarray(lidar_p_rel),
                obs_tshift=None if tsh is None else np.asarray(tsh)[val])
        out = self.process_frame_device_async(
            acc_b, gyr_b, dt_b, n_imu, ids, xy, vel, dep,
            lidar_q_rel=lidar_q_rel, lidar_p_rel=lidar_p_rel, tsh=tsh)
        host = jax.device_get((out["p"], out["q"], out["v"], out["cost"],
                               out["failed"]))
        self.absorb_result(host[3], host[4])
        return np.asarray(host[0]), np.asarray(host[1]), np.asarray(host[2])

    def process_frame_device_async(self, acc_b, gyr_b, dt_b, n_imu,
                                   ids, xy, vel, dep,
                                   lidar_q_rel=None, lidar_p_rel=None,
                                   tsh=None) -> dict:
        """Steady-state fused step with NO host sync: enqueues the whole
        frame program and returns the raw device-ref output dict. The caller
        must later fetch out["cost"]/out["failed"] and pass them to
        `absorb_result` (deferred failure detection). This is the deployed
        pipeline's cross-frame-overlap path (the reference's 4-process stage
        overlap, launch/run_fusion.launch:13-36, reborn as bounded-depth
        asynchronous dispatch)."""
        assert self.frame_count >= K - 1 and self.initialized
        has_lidar = lidar_q_rel is not None
        lqr = lidar_q_rel if has_lidar else jnp.asarray([1.0, 0, 0, 0], self.dtype)
        lpr = lidar_p_rel if has_lidar else jnp.zeros(3, self.dtype)
        if tsh is None:
            tsh = jnp.zeros_like(dep)
        (self.window, self.feats, self.pre, self.lidar, self.prior,
         out) = fused_full_step(
            self.window, self.feats, self.pre, self.lidar, self.prior,
            acc_b, gyr_b, dt_b, jnp.int32(n_imu), ids, xy, vel, dep, tsh,
            lqr, lpr, jnp.asarray(bool(has_lidar)), jnp.asarray(True), self.cfg)
        return out

    def absorb_result(self, host_cost, host_failed):
        """Record a (possibly deferred) frame result fetched by the caller.
        host_failed is the failure_detection bitmask (nonzero == failed);
        the mask is kept on `fail_mask` for restart-cause logging."""
        self.last_cost = float(host_cost)
        if int(host_failed):
            self.failed = True
            self.fail_mask = int(host_failed)

    def _pack_imu(self, acc, gyr, dts):
        """Pad/decimate raw IMU arrays into fixed-capacity buffers."""
        cap = self.cfg.imu_cap
        n = len(acc)
        if n > cap:
            stride = -(-n // cap)  # ceil: decimate, preserving total time
            keep = np.arange(0, n, stride)
            cum = np.concatenate([[0.0], np.cumsum(dts[: n - 1])])
            acc = acc[keep]
            gyr = gyr[keep]
            dts = np.diff(np.concatenate([cum[keep], cum[-1:]]))
            n = len(acc)
        acc_b = np.zeros((cap, 3), np.float32)
        gyr_b = np.zeros((cap, 3), np.float32)
        dt_b = np.zeros((cap - 1,), np.float32)
        if n:
            acc_b[:n] = acc
            gyr_b[:n] = gyr
            acc_b[n:] = acc[-1]
            gyr_b[n:] = gyr[-1]
            dt_b[: n - 1] = dts[: n - 1]
        return acc_b, gyr_b, dt_b, n

    def _store_segment(self, acc_b, gyr_b, dt_b, n, slot):
        seg = make_segment(
            jnp.asarray(acc_b), jnp.asarray(gyr_b), jnp.asarray(dt_b),
            jnp.int32(n), self.window.ba[slot], self.window.bg[slot],
            self.cfg.imu_noise, self.cfg.imu_cap)
        pre_d = self.pre._asdict()
        self.pre = StackedPreint(**{k: pre_d[k].at[slot].set(seg[k]) for k in pre_d})
        return seg

    def _try_initialize(self) -> bool:
        """Cold-start init (estimator.cpp initialStructure :237-381 +
        visualInitialAlign :383-459): SfM over the window, gyro-bias solve,
        re-preintegration, linear alignment, gravity-frame alignment."""
        cfg = self.cfg
        import jax.random as jrandom

        # IMU excitation check (:244-263): enough acceleration variance
        dv_norm = np.asarray(jnp.linalg.norm(self.pre.dv, axis=-1))
        dt_sum = np.asarray(self.pre.dt_sum)
        valid_seg = np.asarray(self.pre.valid)
        mean_g = dv_norm[valid_seg] / np.maximum(dt_sum[valid_seg], 1e-6)
        if valid_seg.sum() < K - 1 or np.std(mean_g) < 0.15:
            return False

        sfm, pts_w, pts_ok = init_mod.global_sfm(
            self.feats.obs, self.feats.obs_valid & self.feats.active[:, None],
            jrandom.PRNGKey(self.frame_count))
        if not bool(sfm.ok):
            return False

        qic = self.window.qic
        tic = self.window.tic
        # body rotations in the SfM (cam-l) frame
        q_b = lie.qnormalize(lie.qmul(sfm.q, lie.qconj(qic)[None, :]))

        # gyro bias from rotation-only preintegration, then re-preintegrate
        dbg = init_mod.solve_gyro_bias(
            sfm.q, qic, self.pre.dq, self.pre.jac[:, 3:6, 12:15], self.pre.valid)
        if not np.all(np.isfinite(np.asarray(dbg))):
            return False
        # physical plausibility: MEMS gyro biases are < ~0.1 rad/s; a large
        # estimate means the SfM rotation chain is junk (degenerate RANSAC
        # draw / bad window geometry) and the whole alignment will silently
        # succeed with collapsed scale — observed exactly once per cold start
        # at full KITTI intrinsics before this gate existed
        if float(np.linalg.norm(np.asarray(dbg))) > 0.5:
            return False
        self._repropagate(jnp.zeros(3, self.dtype), dbg)

        # vil mode: pin the metric scale from the lidar odometry's relative
        # translations (novelty #2 used at init time — the joint [v, g, s]
        # solve is near-degenerate under sustained turning: gravity can
        # absorb the centripetal term and collapse s; with s known the
        # system is well-conditioned)
        s_lidar, n_lid = init_mod.lidar_scale_estimate(
            sfm.p, self.lidar.p_rel, self.lidar.valid)
        g_norm = float(jnp.linalg.norm(jnp.asarray(cfg.ba.gravity)))
        if s_lidar > 0:
            v_b, g_est = init_mod.linear_alignment_fixed_scale(
                q_b, sfm.p, self.pre.dp, self.pre.dv, self.pre.dt_sum,
                self.pre.valid, tic, jnp.asarray(s_lidar, self.dtype))
            s = s_lidar
        else:
            v_b, g_est, s = init_mod.linear_alignment(
                q_b, sfm.p, self.pre.dp, self.pre.dv, self.pre.dt_sum,
                self.pre.valid, tic)
        if abs(float(jnp.linalg.norm(g_est)) - g_norm) > 1.5 or float(s) < 0:
            return False
        g_ref, v_b, s = init_mod.refine_gravity(
            q_b, sfm.p, self.pre.dp, self.pre.dv, self.pre.dt_sum,
            self.pre.valid, tic, g_est, g_norm,
            s_fixed=(jnp.asarray(s_lidar, self.dtype) if s_lidar > 0 else None))
        s = float(s)
        if s <= 0:
            return False

        # ---- visualInitialAlign: rotate everything into the gravity frame ----
        R0 = lie.g2R(g_ref)  # cam-l frame -> gravity-aligned world
        ypr0 = lie.R2ypr(R0 @ lie.q2R(q_b[0]))
        R_fix = lie.ypr2R(jnp.stack([-ypr0[0], jnp.zeros_like(ypr0[0]),
                                     jnp.zeros_like(ypr0[0])]))
        R0 = R_fix @ R0
        q_R0 = lie.R2q(R0)

        p_b = s * sfm.p - lie.qrot(q_b, jnp.broadcast_to(tic, (K, 3)))
        p_new = lie.qrot(q_R0[None, :], p_b - p_b[0:1])
        q_new = lie.qnormalize(lie.qmul(q_R0[None, :], q_b))
        v_new = lie.qrot(q_new, v_b)  # body-frame vel -> world

        # vil-mode metric cross-check the reference cannot do: its lidar
        # odometry T_ij (novelty #2, lidar_factor.h) is metric, so the
        # recovered visual-inertial scale must agree with the accumulated
        # lidar translation over the same window. A silent scale collapse
        # here otherwise survives until the first BA fights the lidar
        # factors and failureDetection reboots the estimator.
        lid_ok = np.asarray(self.lidar.valid)
        if lid_ok.sum() >= 3:
            lid = float(np.linalg.norm(
                np.asarray(self.lidar.p_rel), axis=-1)[lid_ok].sum())
            seg = np.linalg.norm(np.diff(np.asarray(p_new), axis=0), axis=-1)
            vis = float(seg[lid_ok[1:]].sum())
            if lid > 1.0 and not (0.6 < vis / lid < 1.7):
                return False

        self.window = self.window._replace(
            p=p_new, q=q_new, v=v_new,
            ba=jnp.zeros((K, 3), self.dtype),
            bg=jnp.tile(jnp.asarray(dbg, self.dtype), (K, 1)))
        # reset depths (re-triangulated with metric poses); keep lidar depths
        self.feats = self.feats._replace(
            inv_depth=jnp.where(self.feats.lidar_flag, self.feats.inv_depth, -1.0))
        self.feats = triangulate(self.window, self.feats, cfg.tri_min_depth)
        self.prior = ba.empty_prior(self.window)
        self.initialized = True
        return True

    def _repropagate(self, ba_new, bg_new):
        """Re-preintegrate all segments with new biases (repropagate
        integration_base.h:130-145)."""
        pre_d = self.pre._asdict()
        rows = []
        for i in range(K):
            seg = make_segment(
                self.pre.acc_buf[i], self.pre.gyr_buf[i], self.pre.dt_buf[i],
                self.pre.n_samples[i], ba_new, bg_new, self.cfg.imu_noise,
                self.cfg.imu_cap)
            rows.append(seg)
        self.pre = StackedPreint(**{
            k: jnp.stack([jnp.asarray(r[k]) for r in rows]) for k in pre_d})
        self.pre = self.pre._replace(valid=self.pre.n_samples > 0)

    def _current_pose(self, slot):
        return (np.asarray(self.window.p[slot]), np.asarray(self.window.q[slot]),
                np.asarray(self.window.v[slot]))
