"""SE(3) pose-graph optimization: batched GN + block-Jacobi PCG.

Rebuild of the reference's GTSAM back end
(reference: src/global_fusion/poseGraphOptimization.cpp: prior (1e-12 noise)
+ odometry BetweenFactors (1e-6/1e-4) + Cauchy-robust loop BetweenFactors,
initNoises :123-139; iSAM2 incremental solve at 1 Hz, isamUpdate :349-374).

Batched replacement for iSAM2: the graph is small (10^3-10^4 nodes), so a
full batched Gauss-Newton relinearization each update is cheaper on the
accelerator than incremental Bayes-tree surgery. The normal equations are never
materialized: H·v is computed edge-wise (gather -> per-edge 12-dim matvec ->
scatter-add), solved by preconditioned CG with a block-Jacobi (6x6 per node)
preconditioner. Fixed capacities + masks throughout.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.ops import lie


class PoseGraph(NamedTuple):
    q: jnp.ndarray  # (N, 4) node rotations
    p: jnp.ndarray  # (N, 3)
    n_nodes: jnp.ndarray  # () int32
    odo_q: jnp.ndarray  # (N, 4) T_{i-1 -> i} measurement (slot i)
    odo_p: jnp.ndarray  # (N, 3)
    loop_i: jnp.ndarray  # (L,) int32
    loop_j: jnp.ndarray  # (L,)
    loop_q: jnp.ndarray  # (L, 4) T_{i -> j} measurement
    loop_p: jnp.ndarray  # (L, 3)
    loop_valid: jnp.ndarray  # (L,)
    n_loops: jnp.ndarray  # () int32


def init_graph(capacity: int = 4096, loop_capacity: int = 512, dtype=jnp.float32) -> PoseGraph:
    qid = jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (capacity, 1))
    return PoseGraph(
        q=qid, p=jnp.zeros((capacity, 3), dtype), n_nodes=jnp.zeros((), jnp.int32),
        odo_q=qid, odo_p=jnp.zeros((capacity, 3), dtype),
        loop_i=jnp.zeros((loop_capacity,), jnp.int32),
        loop_j=jnp.zeros((loop_capacity,), jnp.int32),
        loop_q=jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (loop_capacity, 1)),
        loop_p=jnp.zeros((loop_capacity, 3), dtype),
        loop_valid=jnp.zeros((loop_capacity,), bool),
        n_loops=jnp.zeros((), jnp.int32),
    )


@jax.jit
def add_node(graph: PoseGraph, q_abs, p_abs, q_rel, p_rel) -> PoseGraph:
    """Append a node with its absolute initial pose and the odometry edge
    from the previous node (BetweenFactor add, :556-589)."""
    i = jnp.minimum(graph.n_nodes, graph.q.shape[0] - 1)
    return graph._replace(
        q=graph.q.at[i].set(q_abs), p=graph.p.at[i].set(p_abs),
        odo_q=graph.odo_q.at[i].set(q_rel), odo_p=graph.odo_p.at[i].set(p_rel),
        n_nodes=graph.n_nodes + 1)


@jax.jit
def add_loop(graph: PoseGraph, i, j, q_rel, p_rel) -> PoseGraph:
    k = jnp.minimum(graph.n_loops, graph.loop_i.shape[0] - 1)
    return graph._replace(
        loop_i=graph.loop_i.at[k].set(i), loop_j=graph.loop_j.at[k].set(j),
        loop_q=graph.loop_q.at[k].set(q_rel), loop_p=graph.loop_p.at[k].set(p_rel),
        loop_valid=graph.loop_valid.at[k].set(True),
        n_loops=graph.n_loops + 1)


def _edge_residual(delta12, q_i, p_i, q_j, p_j, q_m, p_m):
    """6-dim between-factor residual with retraction deltas (12)."""
    qi, pi = lie.pose_retract((q_i, p_i), delta12[:6])
    qj, pj = lie.pose_retract((q_j, p_j), delta12[6:])
    r_t = lie.qrot(lie.qconj(qi), pj - pi) - p_m
    r_q = 2.0 * lie.qmul(lie.qconj(q_m), lie.qmul(lie.qconj(qi), qj))[1:]
    return jnp.concatenate([r_t, r_q])


import numpy as _np

# Default sqrt-information [trans(3), rot(3)]. The reference's gtsam noises
# (odom var 1e-4/1e-6, loop var 0.5, initNoises :123-139) assume near-perfect
# odometry; calibrated here to realistic scan-matching noise so a single
# verified loop can actually close a long drifted chain (serial-chain
# stiffness argument — chain info/n vs loop info).
ODO_W = _np.array([20.0, 20.0, 20.0, 200.0, 200.0, 200.0], _np.float32)
LOOP_W = _np.array([20.0, 20.0, 20.0, 50.0, 50.0, 50.0], _np.float32)
PRIOR_W = 1e4


def _gather_edges(graph: PoseGraph):
    """(ei, ej, q_m, p_m, w (E, 6), valid (E,)) for odometry + loop edges."""
    N = graph.q.shape[0]
    dtype = graph.p.dtype
    idx = jnp.arange(N)
    odo_valid = (idx >= 1) & (idx < graph.n_nodes)
    ei = jnp.concatenate([idx - 1, graph.loop_i])
    ej = jnp.concatenate([idx, graph.loop_j])
    q_m = jnp.concatenate([graph.odo_q, graph.loop_q])
    p_m = jnp.concatenate([graph.odo_p, graph.loop_p])
    loop_ok = graph.loop_valid & (graph.loop_i < graph.n_nodes) & (graph.loop_j < graph.n_nodes)
    valid = jnp.concatenate([odo_valid, loop_ok])
    w = jnp.concatenate([
        jnp.tile(ODO_W.astype(dtype), (N, 1)),
        jnp.tile(LOOP_W.astype(dtype), (graph.loop_i.shape[0], 1))])
    ei = jnp.maximum(ei, 0)
    return ei, ej, q_m, p_m, w, valid


@functools.partial(jax.jit, static_argnames=("gn_iters", "cg_iters"))
def optimize(graph: PoseGraph, gn_iters: int = 6, cg_iters: int = 32) -> PoseGraph:
    """Batched GN over all nodes (the isamUpdate replacement)."""
    N = graph.q.shape[0]
    dtype = graph.p.dtype
    node_active = (jnp.arange(N) < graph.n_nodes).astype(dtype)

    def gn_step(it, qp):
        q, p = qp
        ei, ej, q_m, p_m, w, valid = _gather_edges(graph._replace(q=q, p=p))

        def one(ii, jj, qm, pm):
            z = jnp.zeros(12, dtype)
            args = (q[ii], p[ii], q[jj], p[jj], qm, pm)
            r = _edge_residual(z, *args)
            J = jax.jacfwd(_edge_residual)(z, *args)
            return r, J

        r, J = jax.vmap(one)(ei, ej, q_m, p_m)  # (E, 6), (E, 6, 12)
        # Annealed Huber on loop edges (robust BetweenFactor :425-438 is
        # Cauchy; Cauchy's 1/r influence would freeze large-but-correct loop
        # corrections, so: first GN iterations quadratic — the verified loop
        # closes — then Huber guards against any residual outlier).
        is_loop = jnp.arange(r.shape[0]) >= N
        rn = jnp.sqrt(jnp.sum((w * r) ** 2, axis=-1) + 1e-12)
        delta_h = jnp.maximum(4.0, 1e4 * 0.1 ** it.astype(dtype))
        rob = jnp.where(is_loop & (rn > delta_h), delta_h / rn, 1.0)
        wr = w * rob[:, None] * valid[:, None].astype(dtype)
        r = r * wr
        J = J * wr[:, :, None]

        # gradient b = -sum J^T r, scattered to nodes
        JTr = jnp.einsum("erd,er->ed", J, r)  # (E, 12)
        b = jnp.zeros((N, 6), dtype)
        b = b.at[ei].add(-JTr[:, :6])
        b = b.at[ej].add(-JTr[:, 6:])
        # gauge prior on node 0
        d0 = lie.pose_local((graph.q[0], graph.p[0]), (q[0], p[0]))
        b = b.at[0].add(-PRIOR_W * d0)

        # block-Jacobi preconditioner: 6x6 per node
        JTJ_ii = jnp.einsum("erd,erc->edc", J[:, :, :6], J[:, :, :6])
        JTJ_jj = jnp.einsum("erd,erc->edc", J[:, :, 6:], J[:, :, 6:])
        Pblk = jnp.zeros((N, 6, 6), dtype)
        Pblk = Pblk.at[ei].add(JTJ_ii).at[ej].add(JTJ_jj)
        Pblk = Pblk.at[0].add(PRIOR_W * jnp.eye(6, dtype=dtype))
        Pblk = Pblk + 1e-4 * jnp.eye(6, dtype=dtype)
        Pinv = jnp.linalg.inv(Pblk)

        def matvec(v):
            ve = jnp.concatenate([v[ei], v[ej]], axis=-1)  # (E, 12)
            u = jnp.einsum("erd,ed->er", J, ve)  # (E, 6)
            JTu = jnp.einsum("erd,er->ed", J, u)
            out = jnp.zeros((N, 6), dtype)
            out = out.at[ei].add(JTu[:, :6])
            out = out.at[ej].add(JTu[:, 6:])
            out = out.at[0].add(PRIOR_W * v[0])
            out = out + 1e-6 * v  # tiny damping for disconnected nodes
            return out * node_active[:, None]

        def apply_P(v):
            return jnp.einsum("nde,ne->nd", Pinv, v) * node_active[:, None]

        # PCG
        x = jnp.zeros((N, 6), dtype)
        r_cg = b * node_active[:, None]
        z_cg = apply_P(r_cg)
        pdir = z_cg
        rz = jnp.sum(r_cg * z_cg)

        def cg_body(_, st):
            x, r_cg, pdir, rz = st
            Ap = matvec(pdir)
            denom = jnp.sum(pdir * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
            x = x + alpha * pdir
            r_new = r_cg - alpha * Ap
            z_new = apply_P(r_new)
            rz_new = jnp.sum(r_new * z_new)
            beta = rz_new / jnp.where(jnp.abs(rz) > 1e-12, rz, 1e-12)
            pdir = z_new + beta * pdir
            return x, r_new, pdir, rz_new

        x, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body, (x, r_cg, pdir, rz))
        x = jnp.clip(x, -1.0, 1.0)
        q_new, p_new = lie.pose_retract((q, p), x * node_active[:, None])
        return q_new, p_new

    q, p = jax.lax.fori_loop(0, gn_iters, gn_step, (graph.q, graph.p))
    return graph._replace(q=q, p=p)


def optimize_bucketed(graph: PoseGraph, n_active: int,
                      gn_iters: int = 6, cg_iters: int = 32,
                      min_bucket: int = 64) -> PoseGraph:
    """optimize() on the smallest power-of-2 node slice covering the active
    nodes. The GN/PCG cost is linear in the node CAPACITY (every edge matvec
    and scatter runs over all N slots), so solving a 50-keyframe graph inside
    a 2048-slot buffer wastes 40x the work — the direct analog of iSAM2 only
    touching the affected sub-tree (poseGraphOptimization.cpp isamUpdate
    :349-374). One compile per bucket size, reused as the graph grows.

    `n_active` is the host-side node count (kept by the caller; reading
    graph.n_nodes would force a device sync)."""
    cap = graph.q.shape[0]
    bucket = min_bucket
    while bucket < min(n_active, cap):
        bucket *= 2
    if bucket >= cap:
        return optimize(graph, gn_iters, cg_iters)
    sub = graph._replace(q=graph.q[:bucket], p=graph.p[:bucket],
                         odo_q=graph.odo_q[:bucket], odo_p=graph.odo_p[:bucket])
    out = optimize(sub, gn_iters, cg_iters)
    return graph._replace(q=graph.q.at[:bucket].set(out.q),
                          p=graph.p.at[:bucket].set(out.p))
