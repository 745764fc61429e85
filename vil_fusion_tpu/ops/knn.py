"""Tiled brute-force k-nearest-neighbour search (the XLA form).

Replaces the reference's pointer-chasing kd-trees (PCL `KdTreeFLANN` in
EstimationMapping.hpp:254-285 and feature_tracker_node.cpp:54-199, nanoflann in
Scancontext.h) with a dense formulation: squared distances are computed as one
matmul per database tile (`|q|^2 + |d|^2 - 2 q·d^T`) and a running top-k is
merged tile by tile, so the full (Nq, Nd) distance matrix is never
materialized. No pointers, no recursion, static shapes. On the GPU the fused
kernel in ops/pallas/knn_pallas.py replaces it; this form serves every other
backend and is the kernel's reference.

All inputs carry validity masks (fixed-capacity buffers); invalid database
points get +inf distance and are never selected.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_INF = jnp.inf


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def knn(
    queries: jnp.ndarray,
    database: jnp.ndarray,
    db_valid: jnp.ndarray,
    k: int = 5,
    tile: int = 2048,
):
    """k nearest database points for each query.

    Args:
      queries: (Nq, 3) query points.
      database: (Nd, 3) database points (fixed capacity).
      db_valid: (Nd,) bool validity mask.
      k: neighbours to return.
      tile: database tile size (controls peak memory Nq*tile).

    Returns:
      (dists2 (Nq, k), idx (Nq, k)): squared distances (inf for missing) and
      database indices (0 where missing — check dists2 for validity).
    """
    nq = queries.shape[0]
    nd = database.shape[0]
    dtype = queries.dtype
    # pad database to a multiple of tile
    pad = (-nd) % tile
    if pad:
        database = jnp.concatenate([database, jnp.zeros((pad, 3), dtype)], axis=0)
        db_valid = jnp.concatenate([db_valid, jnp.zeros((pad,), bool)], axis=0)
    n_tiles = database.shape[0] // tile

    db_tiles = database.reshape(n_tiles, tile, 3)
    valid_tiles = db_valid.reshape(n_tiles, tile)

    q_norm2 = jnp.sum(queries * queries, axis=-1, keepdims=True)  # (Nq, 1)

    def body(carry, inp):
        best_d, best_i = carry
        d_tile, v_tile, t = inp
        d_norm2 = jnp.sum(d_tile * d_tile, axis=-1)  # (tile,)
        # HIGHEST precision: the expanded form cancels |q|^2 + |d|^2 against
        # 2 q.d, so a reduced-precision matmul (TF32 keeps ~3 decimal digits)
        # would leave errors of ~1e-3 |q|^2 — metres^2 at map ranges, which
        # silently corrupts correspondences.
        cross = jax.lax.dot_general(
            queries, d_tile.T, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)
        dist2 = q_norm2 + d_norm2[None, :] - 2.0 * cross
        dist2 = jnp.where(v_tile[None, :], dist2, _INF)
        idx = t * tile + jax.lax.broadcasted_iota(jnp.int32, (nq, tile), 1)
        # merge with running best: concat then top-k of negated distance
        cat_d = jnp.concatenate([best_d, dist2], axis=1)
        cat_i = jnp.concatenate([best_i, idx], axis=1)
        neg_top, arg = jax.lax.top_k(-cat_d, k)
        new_d = -neg_top
        new_i = jnp.take_along_axis(cat_i, arg, axis=1)
        return (new_d, new_i), None

    init = (jnp.full((nq, k), _INF, dtype), jnp.zeros((nq, k), jnp.int32))
    ts = jax.lax.broadcasted_iota(jnp.int32, (n_tiles, 1), 0)[:, 0]
    (best_d, best_i), _ = jax.lax.scan(body, init, (db_tiles, valid_tiles, ts))
    best_d = jnp.maximum(best_d, 0.0)  # numerical: |q-d|^2 can go slightly < 0
    best_i = jnp.where(jnp.isfinite(best_d), best_i, 0)
    return best_d, best_i


def nn1(queries, database, db_valid, tile: int = 2048):
    """Single nearest neighbour; convenience wrapper."""
    d2, idx = knn(queries, database, db_valid, k=1, tile=tile)
    return d2[:, 0], idx[:, 0]
