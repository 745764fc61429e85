"""IMU preintegration (midpoint) with bias Jacobian + covariance propagation.

Rebuild of the reference's `IntegrationBase`
(reference: src/visual_inertial_lidar/vins_estimator/factor/integration_base.h:9-209):
`midPointIntegration` (:54-128) becomes one `lax.scan` step; `repropagate`
(:130-145) is a re-run of the scan with new linearization biases (cheap under
jit — the scan is compiled once); `evaluate` (:160-186) is `residual` below.

Design notes:
  * Fixed-capacity segments: steps are padded with dt == 0, which is exactly
    an identity update (F = I, V = 0), so no masks are needed.
  * The whole integrator is differentiable; the 15x15 first-order bias
    Jacobian is still propagated analytically (it is needed for fast bias
    correction inside the BA iteration without re-running the scan).
  * State tangent ordering [p, theta, v, ba, bg] = lie.O_P..O_BG.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.ops import lie


class ImuNoise(NamedTuple):
    """Continuous-time IMU noise densities (parameters.cpp ACC_N/GYR_N/ACC_W/GYR_W)."""

    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6


class Preintegrated(NamedTuple):
    """Result of preintegrating one IMU segment between two image frames."""

    dp: jnp.ndarray  # (..., 3) position delta in frame i
    dq: jnp.ndarray  # (..., 4) rotation delta
    dv: jnp.ndarray  # (..., 3) velocity delta
    jac: jnp.ndarray  # (..., 15, 15) d(state)/d(initial state + biases)
    cov: jnp.ndarray  # (..., 15, 15) covariance of the deltas
    dt_sum: jnp.ndarray  # (...,) total integration time
    ba: jnp.ndarray  # (..., 3) linearization accel bias
    bg: jnp.ndarray  # (..., 3) linearization gyro bias


def _noise_cov(noise: ImuNoise, dtype) -> jnp.ndarray:
    """18x18 discrete noise covariance (integration_base.h:39-46 semantics)."""
    d = jnp.array(
        [noise.acc_n**2] * 3
        + [noise.gyr_n**2] * 3
        + [noise.acc_n**2] * 3
        + [noise.gyr_n**2] * 3
        + [noise.acc_w**2] * 3
        + [noise.gyr_w**2] * 3,
        dtype=dtype,
    )
    return jnp.diag(d)


def _midpoint_step(carry, inputs, ba, bg, Q18):
    """One midpoint integration step; dt == 0 is exactly identity."""
    dp, dq, dv, jac, cov = carry
    acc0, gyr0, acc1, gyr1, dt = inputs
    dtype = dp.dtype
    eye3 = jnp.eye(3, dtype=dtype)

    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq_new = lie.qnormalize(lie.qmul(dq, lie.so3_exp(un_gyr * dt)))
    R0 = lie.q2R(dq)
    R1 = lie.q2R(dq_new)
    a0 = acc0 - ba
    a1 = acc1 - ba
    un_acc = 0.5 * (R0 @ a0 + R1 @ a1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt

    # --- discrete error-state transition F (15x15) and noise map V (15x18) ---
    a0h = lie.skew(a0)
    a1h = lie.skew(a1)
    wh = lie.skew(un_gyr)
    I_wdt = eye3 - wh * dt  # d(theta_{k+1})/d(theta_k)
    R1a1 = R1 @ a1h
    dt2 = dt * dt

    F = jnp.zeros((15, 15), dtype=dtype)
    F = F.at[0:3, 0:3].set(eye3)
    F = F.at[0:3, 3:6].set(-0.25 * (R0 @ a0h) * dt2 - 0.25 * R1a1 @ I_wdt * dt2)
    F = F.at[0:3, 6:9].set(eye3 * dt)
    F = F.at[0:3, 9:12].set(-0.25 * (R0 + R1) * dt2)
    F = F.at[0:3, 12:15].set(0.25 * R1a1 * dt2 * dt)
    F = F.at[3:6, 3:6].set(I_wdt)
    F = F.at[3:6, 12:15].set(-eye3 * dt)
    F = F.at[6:9, 3:6].set(-0.5 * (R0 @ a0h) * dt - 0.5 * R1a1 @ I_wdt * dt)
    F = F.at[6:9, 6:9].set(eye3)
    F = F.at[6:9, 9:12].set(-0.5 * (R0 + R1) * dt)
    F = F.at[6:9, 12:15].set(0.5 * R1a1 * dt * dt)
    F = F.at[9:12, 9:12].set(eye3)
    F = F.at[12:15, 12:15].set(eye3)

    V = jnp.zeros((15, 18), dtype=dtype)
    V = V.at[0:3, 0:3].set(0.25 * R0 * dt2)
    V = V.at[0:3, 3:6].set(-0.125 * R1a1 * dt2 * dt)
    V = V.at[0:3, 6:9].set(0.25 * R1 * dt2)
    V = V.at[0:3, 9:12].set(-0.125 * R1a1 * dt2 * dt)
    V = V.at[3:6, 3:6].set(0.5 * eye3 * dt)
    V = V.at[3:6, 9:12].set(0.5 * eye3 * dt)
    V = V.at[6:9, 0:3].set(0.5 * R0 * dt)
    V = V.at[6:9, 3:6].set(-0.25 * R1a1 * dt2)
    V = V.at[6:9, 6:9].set(0.5 * R1 * dt)
    V = V.at[6:9, 9:12].set(-0.25 * R1a1 * dt2)
    V = V.at[9:12, 12:15].set(eye3 * dt)
    V = V.at[12:15, 15:18].set(eye3 * dt)

    jac_new = F @ jac
    cov_new = F @ cov @ F.T + V @ Q18 @ V.T
    return (dp_new, dq_new, dv_new, jac_new, cov_new), None


def preintegrate(
    acc: jnp.ndarray,
    gyr: jnp.ndarray,
    dt: jnp.ndarray,
    ba: jnp.ndarray,
    bg: jnp.ndarray,
    noise: ImuNoise = ImuNoise(),
    parallel: bool = False,
) -> Preintegrated:
    """Preintegrate an IMU segment of N+1 samples (N steps).

    Args:
      acc: (N+1, 3) accelerometer samples (body frame, includes gravity).
      gyr: (N+1, 3) gyro samples.
      dt:  (N,) step durations; entries may be 0 (identity padding).
      ba, bg: (3,) linearization-point biases.
      parallel: log-depth associative-scan formulation (see
        preintegrate_parallel) vs the sequential lax.scan reference.

    Replaces IntegrationBase::propagate loop (integration_base.h:147-158);
    both paths are compiled once for the fixed capacity N and agree to f32
    rounding (test_imu.py::test_parallel_preintegration_matches_sequential).

    The SEQUENTIAL path is the deployed default despite its longer serial
    latency: the associative composition's different f32 summation
    order perturbs the 15x15 covariance at ~1e-4 relative, which the
    sqrt-information Cholesky amplifies on short low-noise segments into
    visibly different IMU factor weights — measured as 3 extra
    failure-detection restarts over the 1.26 km acceptance circuit
    (11 vs 8) and a flipped marginal frame in the toy e2e. Accuracy of the
    estimator outweighs the latency win; the parallel path remains for
    throughput-bound uses (batched replay scoring) and as the template for
    a future compensated-summation version.
    """
    if parallel:
        return preintegrate_parallel(acc, gyr, dt, ba, bg, noise)
    dtype = acc.dtype
    Q18 = _noise_cov(noise, dtype)
    init = (
        jnp.zeros(3, dtype),
        jnp.array([1.0, 0, 0, 0], dtype),
        jnp.zeros(3, dtype),
        jnp.eye(15, dtype=dtype),
        jnp.zeros((15, 15), dtype=dtype),
    )
    inputs = (acc[:-1], gyr[:-1], acc[1:], gyr[1:], dt)
    (dp, dq, dv, jac, cov), _ = jax.lax.scan(
        lambda c, x: _midpoint_step(c, x, ba, bg, Q18), init, inputs
    )
    return Preintegrated(dp, dq, dv, jac, cov, jnp.sum(dt), ba, bg)


def preintegrate_parallel(
    acc: jnp.ndarray,
    gyr: jnp.ndarray,
    dt: jnp.ndarray,
    ba: jnp.ndarray,
    bg: jnp.ndarray,
    noise: ImuNoise = ImuNoise(),
) -> Preintegrated:
    """Log-depth preintegration: the SAME midpoint math as _midpoint_step,
    restructured for an accelerator's latency profile. A 63-step lax.scan is 63
    serial dispatches of tiny 15x15 matmuls — pure latency. The recurrence
    decomposes into associative pieces:

      1. per-step rotation increments r_k = exp((w_mid_k - bg) dt_k)
         — independent, computed batched;
      2. prefix rotations dq_k = r_0 ⊗ ... ⊗ r_k — an associative_scan of
         quaternion products (depth log2 N);
      3. dv/dp are then plain (ex/in)clusive cumulative sums of
         un_acc_k dt_k terms (the midpoint update is affine given the
         rotations);
      4. the (jacobian, covariance) pair composes associatively:
         (J2,P2)∘(J1,P1) = (J2 J1, J2 P1 J2ᵀ + P2), with per-step leaves
         (F_k, V_k Q V_kᵀ) built batched — one associative_scan of 15x15
         matmuls (depth log2 N).

    dt == 0 padding steps contribute exact identities ((I, 0) leaves,
    identity quaternions), as in the sequential path.
    """
    dtype = acc.dtype
    Q18 = _noise_cov(noise, dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    a0 = acc[:-1] - ba  # (N, 3)
    a1 = acc[1:] - ba
    un_gyr = 0.5 * (gyr[:-1] + gyr[1:]) - bg  # (N, 3)
    N = a0.shape[0]

    # 1-2: prefix rotations
    r = lie.so3_exp(un_gyr * dt[:, None])  # (N, 4)
    dq_after = jax.lax.associative_scan(
        lambda x, y: lie.qnormalize(lie.qmul(x, y)), r)
    q_id = jnp.array([1.0, 0, 0, 0], dtype)
    dq_before = jnp.concatenate([q_id[None], dq_after[:-1]], axis=0)
    R0 = lie.q2R(dq_before)  # (N, 3, 3)
    R1 = lie.q2R(dq_after)

    # 3: dv / dp cumulative sums
    un_acc = 0.5 * (jnp.einsum("nij,nj->ni", R0, a0)
                    + jnp.einsum("nij,nj->ni", R1, a1))  # (N, 3)
    u = un_acc * dt[:, None]
    dv_before = jnp.cumsum(u, axis=0) - u  # exclusive prefix
    dv = jnp.sum(u, axis=0)
    dp = jnp.sum(dv_before * dt[:, None] + 0.5 * un_acc * dt[:, None] ** 2,
                 axis=0)

    # 4: batched F_k / V_k Q V_kᵀ leaves (same entries as _midpoint_step)
    a0h = lie.skew(a0)  # (N, 3, 3)
    a1h = lie.skew(a1)
    wh = lie.skew(un_gyr)
    dtc = dt[:, None, None]
    dt2 = dtc * dtc
    I_wdt = eye3[None] - wh * dtc
    R0a0 = R0 @ a0h
    R1a1 = R1 @ a1h
    eyeN = jnp.broadcast_to(eye3, (N, 3, 3))

    F = jnp.zeros((N, 15, 15), dtype=dtype)
    F = F.at[:, 0:3, 0:3].set(eyeN)
    F = F.at[:, 0:3, 3:6].set(-0.25 * R0a0 * dt2 - 0.25 * (R1a1 @ I_wdt) * dt2)
    F = F.at[:, 0:3, 6:9].set(eyeN * dtc)
    F = F.at[:, 0:3, 9:12].set(-0.25 * (R0 + R1) * dt2)
    F = F.at[:, 0:3, 12:15].set(0.25 * R1a1 * dt2 * dtc)
    F = F.at[:, 3:6, 3:6].set(I_wdt)
    F = F.at[:, 3:6, 12:15].set(-eyeN * dtc)
    F = F.at[:, 6:9, 3:6].set(-0.5 * R0a0 * dtc - 0.5 * (R1a1 @ I_wdt) * dtc)
    F = F.at[:, 6:9, 6:9].set(eyeN)
    F = F.at[:, 6:9, 9:12].set(-0.5 * (R0 + R1) * dtc)
    F = F.at[:, 6:9, 12:15].set(0.5 * R1a1 * dtc * dtc)
    F = F.at[:, 9:12, 9:12].set(eyeN)
    F = F.at[:, 12:15, 12:15].set(eyeN)

    V = jnp.zeros((N, 15, 18), dtype=dtype)
    V = V.at[:, 0:3, 0:3].set(0.25 * R0 * dt2)
    V = V.at[:, 0:3, 3:6].set(-0.125 * R1a1 * dt2 * dtc)
    V = V.at[:, 0:3, 6:9].set(0.25 * R1 * dt2)
    V = V.at[:, 0:3, 9:12].set(-0.125 * R1a1 * dt2 * dtc)
    V = V.at[:, 3:6, 3:6].set(0.5 * eyeN * dtc)
    V = V.at[:, 3:6, 9:12].set(0.5 * eyeN * dtc)
    V = V.at[:, 6:9, 0:3].set(0.5 * R0 * dtc)
    V = V.at[:, 6:9, 3:6].set(-0.25 * R1a1 * dt2)
    V = V.at[:, 6:9, 6:9].set(0.5 * R1 * dtc)
    V = V.at[:, 6:9, 9:12].set(-0.25 * R1a1 * dt2)
    V = V.at[:, 9:12, 12:15].set(eyeN * dtc)
    V = V.at[:, 12:15, 15:18].set(eyeN * dtc)
    VQV = V @ Q18 @ jnp.swapaxes(V, -1, -2)

    def comb(x, y):
        Jx, Px = x
        Jy, Py = y
        return (Jy @ Jx, Jy @ Px @ jnp.swapaxes(Jy, -1, -2) + Py)

    Jall, Pall = jax.lax.associative_scan(comb, (F, VQV))
    return Preintegrated(dp, lie.qnormalize(dq_after[-1]), dv,
                         Jall[-1], Pall[-1], jnp.sum(dt), ba, bg)


def bias_corrected_delta(pre: Preintegrated, ba: jnp.ndarray, bg: jnp.ndarray):
    """First-order bias correction of (dp, dq, dv) (integration_base.h:160-175)."""
    dba = ba - pre.ba
    dbg = bg - pre.bg
    dp = pre.dp + pre.jac[0:3, 9:12] @ dba + pre.jac[0:3, 12:15] @ dbg
    dv = pre.dv + pre.jac[6:9, 9:12] @ dba + pre.jac[6:9, 12:15] @ dbg
    dq = lie.qnormalize(lie.qmul(pre.dq, lie.so3_exp(pre.jac[3:6, 12:15] @ dbg)))
    return dp, dq, dv


def residual(
    pre: Preintegrated,
    p_i, q_i, v_i, ba_i, bg_i,
    p_j, q_j, v_j, ba_j, bg_j,
    gravity: jnp.ndarray,
) -> jnp.ndarray:
    """15-dim preintegration residual (integration_base.h evaluate :160-186).

    Pure function of all states — factor Jacobians come from jax.jacfwd over
    the tangent retraction (see models/factors.py), which traces to the same
    analytic expressions the reference hand-codes.
    """
    dp, dq, dv = bias_corrected_delta(pre, ba_i, bg_i)
    qi_inv = lie.qconj(q_i)
    s = pre.dt_sum
    r_p = lie.qrot(qi_inv, 0.5 * gravity * s * s + p_j - p_i - v_i * s) - dp
    r_q = 2.0 * lie.qmul(lie.qconj(dq), lie.qmul(qi_inv, q_j))[..., 1:]
    r_v = lie.qrot(qi_inv, gravity * s + v_j - v_i) - dv
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return jnp.concatenate([r_p, r_q, r_v, r_ba, r_bg], axis=-1)


def sqrt_information(pre: Preintegrated) -> jnp.ndarray:
    """15x15 sqrt-information from the propagated covariance.

    The reference uses LLT of cov^{-1} (imu_factor.h:55-60); we use the
    numerically-equivalent inverse Cholesky factor of a symmetrized,
    eps-regularized covariance (f32-safe).
    """
    dtype = pre.cov.dtype
    cov = 0.5 * (pre.cov + jnp.swapaxes(pre.cov, -1, -2))
    cov = cov + jnp.eye(15, dtype=dtype) * 1e-10
    L = jnp.linalg.cholesky(cov)
    eye = jnp.eye(15, dtype=dtype)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return Linv  # Linv.T @ Linv == cov^{-1}


def propagate_state(p, q, v, ba, bg, acc0, gyr0, acc1, gyr1, dt, gravity):
    """High-rate world-frame state propagation (estimator_node.cpp predict :44-80).

    Used for IMU-rate odometry output between image frames.
    """
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    q_new = lie.qnormalize(lie.qmul(q, lie.so3_exp(un_gyr * dt)))
    un_acc_0 = lie.qrot(q, acc0 - ba) - gravity
    un_acc_1 = lie.qrot(q_new, acc1 - ba) - gravity
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    p_new = p + v * dt + 0.5 * un_acc * dt * dt
    v_new = v + un_acc * dt
    return p_new, q_new, v_new
