"""Sliding-window state layout for the visual-inertial-LiDAR estimator.

Rebuild of the reference's window arrays (estimator.h:29-147: Ps/Rs/Vs/Bas/Bgs
[WINDOW_SIZE+1], tic/ric, td, pre_integrations, lidarConstraints) as one
fixed-shape pytree. The tangent-space layout used by the BA solver packs all
non-landmark states into a single D-dim vector:

  frame i (i in [0, K)):  [15*i, 15*i+15) = [dp, dtheta, dv, dba, dbg]
  camera-IMU extrinsic:   [15*K, 15*K+6)  = [dt_ic, dtheta_ic]
  time offset td:         [15*K + 6]

Landmark inverse depths form a separate F-dim tangent handled by Schur
complement (they couple to poses only through single-landmark factors, so
H_ll is diagonal — the dense batched equivalent of Ceres DENSE_SCHUR).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.models import imu as imu_mod
from vil_fusion_tpu.ops import lie

WINDOW_SIZE = 10  # parameters.h:24
K = WINDOW_SIZE + 1


class WindowState(NamedTuple):
    p: jnp.ndarray  # (K, 3)
    q: jnp.ndarray  # (K, 4)
    v: jnp.ndarray  # (K, 3)
    ba: jnp.ndarray  # (K, 3)
    bg: jnp.ndarray  # (K, 3)
    tic: jnp.ndarray  # (3,)  camera-IMU translation
    qic: jnp.ndarray  # (4,)  camera-IMU rotation
    td: jnp.ndarray  # ()    camera-IMU time offset


class FeatureStore(NamedTuple):
    """Fixed-capacity feature tracks (feature_manager.h:57-115 rebuild)."""

    active: jnp.ndarray  # (F,) bool — slot in use
    start: jnp.ndarray  # (F,) int32 — window index of first observation
    obs: jnp.ndarray  # (F, K, 2) normalized-plane coords
    obs_valid: jnp.ndarray  # (F, K) bool
    vel: jnp.ndarray  # (F, K, 2) normalized-plane velocity (for td)
    # per-observation time shift in seconds: -td_at_capture + TR*row_norm
    # (rolling shutter, projection_td_factor.cpp:51-52 TR/ROW terms; zero
    # for global-shutter rigs with constant td)
    tshift: jnp.ndarray  # (F, K)
    inv_depth: jnp.ndarray  # (F,) inverse depth at start frame
    lidar_flag: jnp.ndarray  # (F,) bool — depth from LiDAR, held constant in BA
    feat_id: jnp.ndarray  # (F,) int32 — global track id (-1 = empty)


class StackedPreint(NamedTuple):
    """Preintegrated IMU per window slot i (segment frame i-1 -> i; slot 0 unused).

    Raw sample buffers are kept (fixed capacity) so segments can be merged and
    re-integrated on non-keyframe marginalization (estimator.cpp:1143-1177)."""

    dp: jnp.ndarray  # (K, 3)
    dq: jnp.ndarray  # (K, 4)
    dv: jnp.ndarray  # (K, 3)
    jac: jnp.ndarray  # (K, 15, 15)
    sqrt_info: jnp.ndarray  # (K, 15, 15)
    dt_sum: jnp.ndarray  # (K,)
    ba: jnp.ndarray  # (K, 3) linearization biases
    bg: jnp.ndarray  # (K, 3)
    acc_buf: jnp.ndarray  # (K, CAP, 3) raw samples
    gyr_buf: jnp.ndarray  # (K, CAP, 3)
    dt_buf: jnp.ndarray  # (K, CAP-1)
    n_samples: jnp.ndarray  # (K,) int32 — valid samples in buffer
    valid: jnp.ndarray  # (K,) bool — segment exists


class LidarConstraints(NamedTuple):
    """Per-slot relative body pose from LiDAR odometry (lidarConstraint_base.h:9-27):
    slot i holds the measured T_{i-1,i} in the IMU frame; composed on
    non-keyframe merge (estimator.cpp:1143-1145)."""

    q_rel: jnp.ndarray  # (K, 4)
    p_rel: jnp.ndarray  # (K, 3)
    valid: jnp.ndarray  # (K,) bool


def pose_dim(k: int = K) -> int:
    return 15 * k + 7


D = pose_dim()


def init_window(dtype=jnp.float32) -> WindowState:
    return WindowState(
        p=jnp.zeros((K, 3), dtype),
        q=jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (K, 1)),
        v=jnp.zeros((K, 3), dtype),
        ba=jnp.zeros((K, 3), dtype),
        bg=jnp.zeros((K, 3), dtype),
        tic=jnp.zeros(3, dtype),
        qic=jnp.array([1.0, 0, 0, 0], dtype),
        td=jnp.zeros((), dtype),
    )


def init_features(capacity: int, dtype=jnp.float32) -> FeatureStore:
    return FeatureStore(
        active=jnp.zeros(capacity, bool),
        start=jnp.zeros(capacity, jnp.int32),
        obs=jnp.zeros((capacity, K, 2), dtype),
        obs_valid=jnp.zeros((capacity, K), bool),
        vel=jnp.zeros((capacity, K, 2), dtype),
        tshift=jnp.zeros((capacity, K), dtype),
        inv_depth=jnp.full((capacity,), -1.0, dtype),
        lidar_flag=jnp.zeros(capacity, bool),
        feat_id=jnp.full((capacity,), -1, jnp.int32),
    )


def init_preint(imu_cap: int = 64, dtype=jnp.float32) -> StackedPreint:
    return StackedPreint(
        dp=jnp.zeros((K, 3), dtype),
        dq=jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (K, 1)),
        dv=jnp.zeros((K, 3), dtype),
        jac=jnp.tile(jnp.eye(15, dtype=dtype), (K, 1, 1)),
        sqrt_info=jnp.tile(jnp.eye(15, dtype=dtype), (K, 1, 1)),
        dt_sum=jnp.zeros((K,), dtype),
        ba=jnp.zeros((K, 3), dtype),
        bg=jnp.zeros((K, 3), dtype),
        acc_buf=jnp.zeros((K, imu_cap, 3), dtype),
        gyr_buf=jnp.zeros((K, imu_cap, 3), dtype),
        dt_buf=jnp.zeros((K, imu_cap - 1), dtype),
        n_samples=jnp.zeros((K,), jnp.int32),
        valid=jnp.zeros((K,), bool),
    )


def init_lidar_constraints(dtype=jnp.float32) -> LidarConstraints:
    return LidarConstraints(
        q_rel=jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (K, 1)),
        p_rel=jnp.zeros((K, 3), dtype),
        valid=jnp.zeros((K,), bool),
    )


def make_segment(acc, gyr, dt, n_samples, ba, bg, noise, imu_cap: int):
    """Build one StackedPreint row from (padded) raw buffers."""
    pre = imu_mod.preintegrate(acc, gyr, dt, ba, bg, noise)
    return dict(
        dp=pre.dp, dq=pre.dq, dv=pre.dv, jac=pre.jac,
        sqrt_info=imu_mod.sqrt_information(pre), dt_sum=pre.dt_sum,
        ba=ba, bg=bg, acc_buf=acc, gyr_buf=gyr, dt_buf=dt,
        n_samples=n_samples, valid=n_samples > 0,
    )


# ---------------------------------------------------------------------------
# Tangent retraction over the whole window
# ---------------------------------------------------------------------------

def retract(state: WindowState, delta: jnp.ndarray) -> WindowState:
    """Apply a D-dim tangent step (pose blocks use the reference's
    PoseLocalParameterization: p + dp, q * exp(dtheta))."""
    blocks = delta[: 15 * K].reshape(K, 15)
    q_new, p_new = lie.pose_retract((state.q, state.p), blocks[:, 0:6])  # [dp, dtheta]
    ext = delta[15 * K : 15 * K + 6]
    qic_new, tic_new = lie.pose_retract((state.qic, state.tic), ext)
    return WindowState(
        p=p_new,
        q=q_new,
        v=state.v + blocks[:, 6:9],
        ba=state.ba + blocks[:, 9:12],
        bg=state.bg + blocks[:, 12:15],
        tic=tic_new,
        qic=qic_new,
        td=state.td + delta[15 * K + 6],
    )


def local_diff(state: WindowState, ref: WindowState) -> jnp.ndarray:
    """D-dim tangent such that ref ⊞ delta ≈ state (for the marg prior)."""
    pose_d = lie.pose_local((ref.q, ref.p), (state.q, state.p))  # (K, 6)
    blocks = jnp.concatenate(
        [pose_d, state.v - ref.v, state.ba - ref.ba, state.bg - ref.bg], axis=-1
    )  # (K, 15)
    ext_d = lie.pose_local((ref.qic, ref.tic), (state.qic, state.tic))
    return jnp.concatenate([blocks.reshape(-1), ext_d, (state.td - ref.td)[None]])
