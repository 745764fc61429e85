"""Factor residuals for the sliding-window estimator.

Rebuild of the reference's factor library (C8):
  * IMU factor          — imu_factor.h:12-64 (15-dim, sqrt-info weighted)
  * projection-td       — projection_td_factor.{h,cpp} (2-dim reprojection
                          with time-offset velocity compensation)
  * LiDAR relative pose — lidar_factor.h:12-83 (6-dim between consecutive
                          window frames, fixed sqrt-info)
  * marginalization prior — marginalization_factor.cpp:333-381 (linear replay)

Accelerator-first design: every residual is a pure function of the window state; the
analytic Jacobians the reference hand-codes are produced by `jax.jacfwd` over
the tangent retraction — tracing yields the same closed-form expressions,
fused by XLA, with zero runtime autodiff cost. vmapped over factor batches.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.models import imu as imu_mod
from vil_fusion_tpu.models.window import K, WindowState
from vil_fusion_tpu.ops import lie

FOCAL_LENGTH = 460.0  # parameters.h:25
PROJ_SQRT_INFO = FOCAL_LENGTH / 1.5  # projection_factor.cpp sqrt_info

# lidar_factor.h fixed weights: translation 10, rotation 100.
# (numpy, not jnp: module import must not trigger device-backend init)
import numpy as _np

LIDAR_SQRT_INFO = _np.array([10.0, 10.0, 10.0, 100.0, 100.0, 100.0], dtype=_np.float32)


def imu_residual(pre_row, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity):
    """Weighted 15-dim preintegration residual for one window segment."""
    pre = imu_mod.Preintegrated(
        dp=pre_row["dp"], dq=pre_row["dq"], dv=pre_row["dv"], jac=pre_row["jac"],
        cov=jnp.eye(15, dtype=p_i.dtype),  # unused by residual
        dt_sum=pre_row["dt_sum"], ba=pre_row["ba"], bg=pre_row["bg"],
    )
    r = imu_mod.residual(pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity)
    return pre_row["sqrt_info"] @ r


def projection_td_residual(
    xy_i, xy_j, vel_i, vel_j, inv_depth,
    p_i, q_i, p_j, q_j, tic, qic, td,
    tshift_i=0.0, tshift_j=0.0,
):
    """2-dim reprojection residual with td + rolling-shutter compensation
    (projection_td_factor.cpp:51-52: pts_td = pts - (td - td_i +
    TR/ROW * row_i) * velocity). `tshift` carries the per-observation
    constant part (-td_at_capture + TR * row_norm); zero for global-shutter
    rigs with constant td.

    Observation i is the anchor (start) frame holding the inverse depth.
    """
    xy_i_td = xy_i - (td + tshift_i) * vel_i
    xy_j_td = xy_j - (td + tshift_j) * vel_j
    pts_i = jnp.concatenate([xy_i_td, jnp.ones_like(xy_i_td[..., :1])], axis=-1)
    depth = 1.0 / jnp.maximum(inv_depth, 1e-4)
    pts_cam_i = pts_i * depth
    pts_imu_i = lie.qrot(qic, pts_cam_i) + tic
    pts_w = lie.qrot(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.qrot(lie.qconj(q_j), pts_w - p_j)
    pts_cam_j = lie.qrot(lie.qconj(qic), pts_imu_j - tic)
    z_j = jnp.maximum(pts_cam_j[..., 2], 1e-4)
    r = pts_cam_j[..., :2] / z_j[..., None] - xy_j_td
    return PROJ_SQRT_INFO * r


def lidar_rel_residual(q_meas, p_meas, p_i, q_i, p_j, q_j):
    """6-dim relative-pose residual between consecutive window frames vs the
    LiDAR odometry measurement expressed in the IMU frame (lidar_factor.h:40-71).
    Order: [translation, rotation], weighted by LIDAR_SQRT_INFO."""
    q_ij = lie.qmul(lie.qconj(q_i), q_j)
    p_ij = lie.qrot(lie.qconj(q_i), p_j - p_i)
    r_t = p_ij - p_meas
    r_q = 2.0 * lie.qmul(lie.qconj(q_meas), q_ij)[..., 1:]
    return LIDAR_SQRT_INFO.astype(p_i.dtype) * jnp.concatenate([r_t, r_q], axis=-1)


class MargPrior(NamedTuple):
    """Linearized Gaussian prior left by marginalization
    (linearized_jacobians/residuals, marginalization_factor.cpp:267-297).

    r(x) = r0 + J @ local_diff(x, x_lin); rows beyond `rank` are zero.
    Pose-state part only (depths of marginalized features are eliminated)."""

    J: jnp.ndarray  # (D, D)
    r0: jnp.ndarray  # (D,)
    lin: WindowState  # linearization point
    valid: jnp.ndarray  # () bool — prior exists


def marg_prior_residual(prior: MargPrior, state: WindowState):
    from vil_fusion_tpu.models.window import local_diff

    dx = local_diff(state, prior.lin)
    r = prior.r0 + prior.J @ dx
    return jnp.where(prior.valid, r, jnp.zeros_like(r))


def cauchy_weight(r2, c=1.0):
    """Cauchy IRLS reweight sqrt(rho'(s)) (reference: ceres CauchyLoss(1.0)
    on projection factors, estimator.cpp:760)."""
    return 1.0 / jnp.sqrt(1.0 + r2 / (c * c))


def cauchy_rho(r2, c=1.0):
    """True Cauchy robust cost rho(s) = c^2 log(1 + s/c^2).

    Used for LM accept/reject: unlike the IRLS surrogate (w r)^2 = s/(1+s),
    rho stays sensitive for saturated residuals, so the solver can still
    rank steps when many residuals are far out (graduated non-convexity)."""
    return c * c * jnp.log1p(r2 / (c * c))
