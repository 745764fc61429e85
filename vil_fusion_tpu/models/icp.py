"""Point-to-point ICP with fixed iterations (loop verification).

Rebuild of the reference's loop-verification ICP
(reference: src/global_fusion/poseGraphOptimization.cpp icpCalculation
:376-444: pcl::IterativeClosestPoint, 100 m correspondence distance, 100
iterations, fitness < 0.3 acceptance): tiled brute-force NN + weighted Kabsch
per iteration under one jit, fixed iteration count (no early exit).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vil_fusion_tpu.ops.pallas import knn_pallas as knn_ops  # fused kernel on GPU, XLA elsewhere
from vil_fusion_tpu.ops import lie


@functools.partial(jax.jit, static_argnames=("iters",))
def icp_point2point(
    src: jnp.ndarray,  # (N, 3) source points (body frame of query keyframe)
    src_valid: jnp.ndarray,
    tgt: jnp.ndarray,  # (M, 3) target submap points
    tgt_valid: jnp.ndarray,
    q_init: jnp.ndarray,
    p_init: jnp.ndarray,
    max_corr_dist: float = 10.0,
    iters: int = 25,
):
    """Returns (q, p, fitness): transform mapping src into tgt frame and the
    mean squared correspondence distance (pcl getFitnessScore analog)."""
    dtype = src.dtype

    def body(_, qp):
        q, p = qp
        src_w = lie.qrot(q, src) + p
        d2, idx = knn_ops.knn(src_w, tgt, tgt_valid, k=1)
        d2 = d2[:, 0]
        nn = tgt[idx[:, 0]]
        w = (src_valid & jnp.isfinite(d2) & (d2 < max_corr_dist**2)).astype(dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        # weighted Kabsch on (src_w -> nn)
        mu_s = jnp.sum(src_w * w[:, None], axis=0) / wsum
        mu_t = jnp.sum(nn * w[:, None], axis=0) / wsum
        X = (src_w - mu_s) * w[:, None]
        Y = nn - mu_t
        H = X.T @ Y
        U, _, Vt = jnp.linalg.svd(H)
        d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
        S = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype)).at[2, 2].set(d)
        R_d = Vt.T @ S @ U.T
        t_d = mu_t - R_d @ mu_s
        q_d = lie.R2q(R_d)
        return lie.qnormalize(lie.qmul(q_d, q)), lie.qrot(q_d, p) + t_d

    q, p = jax.lax.fori_loop(0, iters, body, (q_init, p_init))
    src_w = lie.qrot(q, src) + p
    d2, _ = knn_ops.knn(src_w, tgt, tgt_valid, k=1)
    d2 = d2[:, 0]
    w = (src_valid & jnp.isfinite(d2) & (d2 < max_corr_dist**2)).astype(dtype)
    matched = jnp.maximum(jnp.sum(w), 1.0)
    fitness = jnp.sum(jnp.where(w > 0, d2, 0.0)) / matched
    enough = jnp.sum(w) > 0.3 * jnp.maximum(jnp.sum(src_valid), 1)
    return q, p, jnp.where(enough, fitness, jnp.inf)
