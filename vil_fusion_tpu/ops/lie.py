"""Batched Lie-group / quaternion operations (SO(3), SE(3)).

Batched replacement for the reference's Eigen-based math utilities
(reference: src/visual_inertial_lidar/vins_estimator/utility/utility.h:12-185,
src/visual_inertial_lidar/feature_tracker/include/common.h:79-176,
src/global_fusion/include/common.h). Everything here is a pure function,
shape-polymorphic over leading batch dimensions, dtype-preserving, and safe
under `jit`/`vmap`/`grad` (no data-dependent branches; small-angle cases are
handled with Taylor switching via `jnp.where` on both branches).

Quaternion convention: Hamilton, stored (w, x, y, z) — matching Eigen's
coefficient order as used throughout the reference. Rotations act on column
vectors: `qrot(q, v) == q2R(q) @ v`.

Poses are (q, p) pairs ("Pose" = rotation quaternion + translation), with
`pose_apply((q, p), x) = qrot(q, x) + p`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Tangent-space state ordering used by the sliding-window estimator, matching
# the reference's local parameterization order (integration_base.h: O_P..O_BG).
O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12

_EPS = 1e-8


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix (utility.h skewSymmetric)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def qmul(q1, q2):
    """Hamilton product, (..., 4) x (..., 4) -> (..., 4)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def qconj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qinv(q):
    """Inverse of a (possibly non-unit) quaternion."""
    return qconj(q) / jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True), _EPS)


def qnormalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def positify(q):
    """Flip sign so w >= 0 (utility.h positify)."""
    return jnp.where(q[..., :1] < 0, -q, q)


def qrot(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def q2R(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def R2q(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), branchless.

    Computes all four Shepperd candidates and selects the best-conditioned one
    with `where` masks (no data-dependent control flow, vmap/jit safe).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # candidate 0: trace
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    # candidate 1: m00 dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    # candidate 2: m11 dominant
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
    # candidate 3: m22 dominant
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    return positify(qnormalize(q))


def so3_exp(theta):
    """Axis-angle (..., 3) -> unit quaternion (..., 4). Exact with Taylor fallback.

    Replaces the reference's first-order `deltaQ` (utility.h) with the exact
    exponential; agrees to first order for small angles.
    """
    angle2 = jnp.sum(theta * theta, axis=-1, keepdims=True)
    angle = jnp.sqrt(jnp.maximum(angle2, _EPS * _EPS))
    half = 0.5 * angle
    small = angle2 < 1e-12
    # sin(half)/angle: Taylor 0.5 - angle^2/48 for small angles
    k = jnp.where(small, 0.5 - angle2 / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - angle2 / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * theta], axis=-1)


def so3_log(q):
    """Unit quaternion (..., 4) -> axis-angle (..., 3)."""
    q = positify(q)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn = jnp.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-8
    k = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(vn, _EPS))
    return k * q[..., 1:]


def so3_exp_matrix(theta):
    """Axis-angle (..., 3) -> rotation matrix, Rodrigues (common.h:137-176 analog)."""
    return q2R(so3_exp(theta))


def so3_left_jacobian(theta):
    """Left Jacobian of SO(3): J_l(theta), (..., 3) -> (..., 3, 3)."""
    angle2 = jnp.sum(theta * theta, axis=-1)[..., None, None]
    angle = jnp.sqrt(jnp.maximum(angle2, _EPS * _EPS))
    K = skew(theta)
    K2 = K @ K
    small = angle2 < 1e-10
    a = jnp.where(small, 0.5 - angle2 / 24.0, (1.0 - jnp.cos(angle)) / jnp.maximum(angle2, _EPS))
    b = jnp.where(
        small, 1.0 / 6.0 - angle2 / 120.0, (angle - jnp.sin(angle)) / jnp.maximum(angle2 * angle, _EPS)
    )
    eye = jnp.eye(3, dtype=theta.dtype)
    return eye + a * K + b * K2


def so3_left_jacobian_inv(theta):
    angle2 = jnp.sum(theta * theta, axis=-1)[..., None, None]
    angle = jnp.sqrt(jnp.maximum(angle2, _EPS * _EPS))
    K = skew(theta)
    K2 = K @ K
    small = angle2 < 1e-10
    half = 0.5 * angle
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + angle2 / 720.0,
        (1.0 / jnp.maximum(angle2, _EPS)) - (1.0 + jnp.cos(angle)) / jnp.maximum(2.0 * angle * jnp.sin(angle), _EPS),
    )
    eye = jnp.eye(3, dtype=theta.dtype)
    return eye - 0.5 * K + cot_term * K2


def se3_exp(xi):
    """se(3) twist (..., 6) [rho, theta] -> pose (q, p).

    Matches the reference's `getTransformFromSe3` (common.h:137-176) which
    uses the [translation, rotation] ordering.
    """
    rho, theta = xi[..., :3], xi[..., 3:]
    q = so3_exp(theta)
    p = jnp.einsum("...ij,...j->...i", so3_left_jacobian(theta), rho)
    return q, p


def se3_log(q, p):
    """Pose (q, p) -> twist (..., 6) [rho, theta]."""
    theta = so3_log(q)
    rho = jnp.einsum("...ij,...j->...i", so3_left_jacobian_inv(theta), p)
    return jnp.concatenate([rho, theta], axis=-1)


def Qleft(q):
    """Left-multiplication matrix: Qleft(q) @ r == qmul(q, r) (utility.h Qleft)."""
    w = q[..., 0]
    v = q[..., 1:]
    top = jnp.concatenate([w[..., None], -v], axis=-1)[..., None, :]
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * jnp.eye(3, dtype=q.dtype) + skew(v)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def Qright(q):
    """Right-multiplication matrix: Qright(q) @ r == qmul(r, q) (utility.h Qright)."""
    w = q[..., 0]
    v = q[..., 1:]
    top = jnp.concatenate([w[..., None], -v], axis=-1)[..., None, :]
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * jnp.eye(3, dtype=q.dtype) - skew(v)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Euler (yaw-pitch-roll, degrees — matching utility.h R2ypr/ypr2R semantics)
# ---------------------------------------------------------------------------

def R2ypr(R):
    """Rotation matrix -> (yaw, pitch, roll) in degrees (utility.h R2ypr)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = jnp.arctan2(n[..., 1], n[..., 0])
    p = jnp.arctan2(-n[..., 2], n[..., 0] * jnp.cos(y) + n[..., 1] * jnp.sin(y))
    r = jnp.arctan2(
        a[..., 0] * jnp.sin(y) - a[..., 1] * jnp.cos(y),
        -o[..., 0] * jnp.sin(y) + o[..., 1] * jnp.cos(y),
    )
    return jnp.stack([y, p, r], axis=-1) / jnp.pi * 180.0


def ypr2R(ypr):
    """(yaw, pitch, roll) degrees -> rotation matrix (utility.h ypr2R)."""
    ypr_rad = ypr / 180.0 * jnp.pi
    y, p, r = ypr_rad[..., 0], ypr_rad[..., 1], ypr_rad[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    zero = jnp.zeros_like(y)
    one = jnp.ones_like(y)
    Rz = jnp.stack(
        [
            jnp.stack([cy, -sy, zero], axis=-1),
            jnp.stack([sy, cy, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    Ry = jnp.stack(
        [
            jnp.stack([cp, zero, sp], axis=-1),
            jnp.stack([zero, one, zero], axis=-1),
            jnp.stack([-sp, zero, cp], axis=-1),
        ],
        axis=-2,
    )
    Rx = jnp.stack(
        [
            jnp.stack([one, zero, zero], axis=-1),
            jnp.stack([zero, cr, -sr], axis=-1),
            jnp.stack([zero, sr, cr], axis=-1),
        ],
        axis=-2,
    )
    return Rz @ Ry @ Rx


def g2R(g):
    """Rotation taking gravity direction g to +z with zero yaw (utility.h g2R)."""
    ng1 = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), _EPS)
    ng2 = jnp.array([0.0, 0.0, 1.0], dtype=g.dtype)
    # rotation from ng1 to ng2
    v = jnp.cross(ng1, jnp.broadcast_to(ng2, ng1.shape))
    c = jnp.sum(ng1 * ng2, axis=-1)
    vn = jnp.linalg.norm(v, axis=-1)
    angle = jnp.arctan2(vn, c)
    axis = v / jnp.maximum(vn, _EPS)[..., None]
    R0 = so3_exp_matrix(axis * angle[..., None])
    yaw = R2ypr(R0)[..., 0]
    zero = jnp.zeros_like(yaw)
    return ypr2R(jnp.stack([-yaw, zero, zero], axis=-1)) @ R0


# ---------------------------------------------------------------------------
# Pose (q, p) algebra
# ---------------------------------------------------------------------------

def pose_identity(dtype=jnp.float32, batch=()):
    q = jnp.broadcast_to(jnp.array([1.0, 0, 0, 0], dtype=dtype), batch + (4,))
    p = jnp.zeros(batch + (3,), dtype=dtype)
    return q, p


def pose_apply(pose, x):
    q, p = pose
    return qrot(q, x) + p


def pose_compose(pose_a, pose_b):
    """T_a * T_b."""
    qa, pa = pose_a
    qb, pb = pose_b
    return qnormalize(qmul(qa, qb)), qrot(qa, pb) + pa


def pose_inverse(pose):
    q, p = pose
    qi = qconj(q)
    return qi, -qrot(qi, p)


def pose_between(pose_a, pose_b):
    """T_a^{-1} * T_b (relative pose)."""
    return pose_compose(pose_inverse(pose_a), pose_b)


def pose_retract(pose, delta):
    """Right-perturbation retraction: (q, p) ⊞ [dp, dtheta].

    Matches the reference's PoseLocalParameterization (p + dp, q * dq(dtheta))
    (pose_local_parameterization.cpp:3-27).
    """
    q, p = pose
    dp, dth = delta[..., :3], delta[..., 3:]
    return qnormalize(qmul(q, so3_exp(dth))), p + dp


def pose_local(pose_a, pose_b):
    """Inverse retraction: delta such that pose_a ⊞ delta ≈ pose_b."""
    qa, pa = pose_a
    qb, pb = pose_b
    dth = so3_log(qmul(qconj(qa), qb))
    return jnp.concatenate([pb - pa, dth], axis=-1)
