"""Fixed-capacity voxel-grid operations (downsampling, crop, compaction).

Replaces PCL `VoxelGrid`/`CropBox` (reference: EstimationMapping.hpp:246-251,
326-351 and featureExtraction.hpp voxel use) with sort-based, static-shape
kernels: quantize -> sort by voxel key -> segment-reduce centroids. Everything
returns fixed-capacity buffers with validity masks, the framework-wide
convention for dynamic cardinality under jit (SURVEY.md §7 "hard parts").
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact(points: jnp.ndarray, valid: jnp.ndarray, capacity: int):
    """Stable-compact valid rows to the front of a fixed-capacity buffer.

    Returns (out (capacity, D), out_valid (capacity,)).
    """
    n = points.shape[0]
    order = jnp.argsort(jnp.where(valid, 0, 1), stable=True)
    k = min(capacity, n)
    sel = order[:k]
    out = jnp.zeros((capacity,) + points.shape[1:], points.dtype)
    out = out.at[:k].set(points[sel])
    out_valid = jnp.zeros((capacity,), bool).at[:k].set(valid[sel])
    return out, out_valid


def _voxel_key(points, origin, inv_res, grid_dim):
    """Quantize points into a linear voxel key within a grid_dim^3 grid."""
    ijk = jnp.floor((points - origin) * inv_res).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, grid_dim - 1)
    return (ijk[:, 0] * grid_dim + ijk[:, 1]) * grid_dim + ijk[:, 2]


def hash_bucket(key, capacity: int):
    """Murmur3-finalizer bucket index for a linear voxel key.

    Shared by voxel_downsample_hash (table build) and hash_knn (lookup): the
    map buffers double as spatial hash tables keyed by this function.
    `key * A mod 2^k` alone keeps only low key bits (ignores whole
    coordinates); the finalizer mixes all bits.
    """
    k_u = key.astype(jnp.uint32)
    k_u = k_u ^ (k_u >> 16)
    k_u = k_u * jnp.uint32(0x85EBCA6B)
    k_u = k_u ^ (k_u >> 13)
    k_u = k_u * jnp.uint32(0xC2B2AE35)
    k_u = k_u ^ (k_u >> 16)
    return (k_u % jnp.uint32(capacity)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("capacity", "grid_dim"))
def voxel_downsample(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    resolution: float,
    origin: jnp.ndarray,
    capacity: int,
    grid_dim: int = 1024,
):
    """Centroid voxel-grid downsample into a fixed-capacity buffer.

    Exact centroids (like PCL VoxelGrid) for up to `capacity` occupied voxels;
    voxels beyond capacity are dropped (reference behavior is unbounded, but
    its maps are bounded by crop+voxel anyway — EstimationMapping.hpp:326-351).

    Args:
      points: (N, 3).
      valid: (N,) bool.
      resolution: voxel edge length.
      origin: (3,) grid origin (points outside origin + grid_dim*res are
        clamped into boundary voxels).
      capacity: max output points.

    Returns (out (capacity, 3), out_valid (capacity,)).
    """
    n = points.shape[0]
    inv_res = 1.0 / resolution
    key = _voxel_key(points, origin, inv_res, grid_dim)
    key = jnp.where(valid, key, jnp.iinfo(jnp.int32).max)  # invalid last
    order = jnp.argsort(key, stable=True)
    skey = key[order]
    spts = points[order]
    svalid = valid[order]
    first = jnp.concatenate([jnp.array([True]), skey[1:] != skey[:-1]]) & svalid
    # rank of each point's voxel among occupied voxels (0-based)
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1
    rank = jnp.where(svalid, rank, capacity)  # invalid -> overflow bucket
    rank = jnp.minimum(rank, capacity)  # voxels beyond capacity -> overflow
    seg_sum = jax.ops.segment_sum(
        jnp.where(svalid[:, None], spts, 0.0), rank, num_segments=capacity + 1
    )
    seg_cnt = jax.ops.segment_sum(svalid.astype(points.dtype), rank, num_segments=capacity + 1)
    out = seg_sum[:capacity] / jnp.maximum(seg_cnt[:capacity, None], 1.0)
    out_valid = seg_cnt[:capacity] > 0
    out = jnp.where(out_valid[:, None], out, 0.0)
    return out, out_valid


@functools.partial(jax.jit, static_argnames=("capacity", "grid_dim"))
def voxel_downsample_hash(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    resolution: float,
    origin: jnp.ndarray,
    capacity: int,
    grid_dim: int = 1024,
):
    """Sort-free voxel downsample: voxel key hashed into `capacity` buckets,
    one representative point per bucket (scatter-min + scatter-set).

    Trades exact centroids and collision-free voxels (voxel_downsample) for
    two scatters instead of a full argsort — the map-maintenance hot path.
    Hash collisions merge distant voxels (~N_occ/capacity of them), which a
    point-cloud map tolerates; use voxel_downsample where exactness matters.
    """
    n = points.shape[0]
    key = _voxel_key(points, origin, 1.0 / resolution, grid_dim)
    h = hash_bucket(key, capacity)
    big = jnp.iinfo(jnp.int32).max
    tag = jnp.where(valid, jnp.arange(n, dtype=jnp.int32), big)
    slot_min = jnp.full((capacity,), big, jnp.int32).at[h].min(tag)
    win = valid & (tag == slot_min[h])
    tgt = jnp.where(win, h, capacity)
    out = jnp.zeros((capacity + 1, 3), points.dtype).at[tgt].set(points)[:capacity]
    ov = jnp.zeros((capacity + 1,), bool).at[tgt].set(win)[:capacity]
    return out, ov


@functools.partial(jax.jit, static_argnames=("capacity", "grid_dim"))
def merge_voxel_hash(points_a, valid_a, points_b, valid_b, resolution, origin,
                     capacity: int, grid_dim: int = 1024):
    """Union + hash voxel downsample (sort-free map update)."""
    pts = jnp.concatenate([points_a, points_b], axis=0)
    val = jnp.concatenate([valid_a, valid_b], axis=0)
    return voxel_downsample_hash(pts, val, resolution, origin, capacity, grid_dim)


@functools.partial(jax.jit, static_argnames=("capacity",))
def crop_box(points, valid, center, half_extent, capacity: int):
    """Keep points within an axis-aligned box around `center`, compacted.

    Mirrors the reference's ±100 m crop of the local map
    (EstimationMapping.hpp:326-341)."""
    inside = jnp.all(jnp.abs(points - center) <= half_extent, axis=-1) & valid
    return compact(points, inside, capacity)


@functools.partial(jax.jit, static_argnames=("capacity", "grid_dim"))
def merge_voxel(
    points_a, valid_a, points_b, valid_b, resolution, origin, capacity: int, grid_dim: int = 1024
):
    """Union of two point buffers followed by voxel downsample (map update)."""
    pts = jnp.concatenate([points_a, points_b], axis=0)
    val = jnp.concatenate([valid_a, valid_b], axis=0)
    return voxel_downsample(pts, val, resolution, origin, capacity, grid_dim)
