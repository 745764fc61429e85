"""LiDAR edge/planar feature extraction as range-image tensor ops.

Rebuild of the reference's F-LOAM-style extractor
(reference: src/visual_inertial_lidar/feature_tracker/include/featureExtraction.hpp:
getLaserCloud :54-110 ring split, curvature :188-202, featureExtractionFromSector
:112-173): per-ring azimuth ordering becomes a fixed (n_scan, width) polar
range image; the 11-point curvature becomes circular-shift sums along the
azimuth axis; per-sector max-curvature picking with neighbor suppression
becomes windowed NMS + top-k per sector. All static shapes, one jit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vil_fusion_tpu.ops import voxel as voxel_ops


class LidarConfig(NamedTuple):
    n_scan: int = 64
    width: int = 1800  # azimuth bins (0.2 deg)
    n_sectors: int = 6
    min_range: float = 3.0  # blind radius (featureExtraction minimum distance)
    max_range: float = 90.0
    fov_up_deg: float = 2.0  # generic linear ring model (HDL-64: +2 .. -24.8)
    fov_down_deg: float = -24.8
    edge_per_sector: int = 4  # top-k edges per (ring, sector) after NMS
    edge_curv_min: float = 0.1
    surf_curv_max: float = 0.05
    nms_window: int = 11  # neighbor suppression span (5 each side)
    edge_cap: int = 2048
    surf_cap: int = 8192
    surf_voxel: float = 0.4


class LidarFeatures(NamedTuple):
    edge: jnp.ndarray  # (edge_cap, 3)
    edge_valid: jnp.ndarray  # (edge_cap,)
    surf: jnp.ndarray  # (surf_cap, 3)
    surf_valid: jnp.ndarray  # (surf_cap,)


def project_range_image(points: jnp.ndarray, valid: jnp.ndarray, cfg: LidarConfig):
    """Bucket a raw scan into a (n_scan, width) polar image.

    Ring assignment uses the linear vertical-angle model (equivalent to the
    reference's per-sensor formulas for evenly-spaced lasers,
    featureExtraction.hpp:68-101). Nearest point wins each cell.

    Returns (img_xyz (S, W, 3), img_valid (S, W)).
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = jnp.linalg.norm(points, axis=-1)
    valid = valid & (r > cfg.min_range) & (r < cfg.max_range)
    va = jnp.degrees(jnp.arctan2(z, jnp.sqrt(x * x + y * y)))
    ring_f = (cfg.fov_up_deg - va) / (cfg.fov_up_deg - cfg.fov_down_deg) * (cfg.n_scan - 1)
    ring = jnp.round(ring_f).astype(jnp.int32)
    valid = valid & (ring >= 0) & (ring < cfg.n_scan)
    az = jnp.arctan2(y, x)  # [-pi, pi)
    col = jnp.floor((az + jnp.pi) / (2 * jnp.pi) * cfg.width).astype(jnp.int32)
    col = jnp.clip(col, 0, cfg.width - 1)
    cell = ring * cfg.width + col
    cell = jnp.where(valid, cell, cfg.n_scan * cfg.width)  # overflow bucket

    # nearest point per cell via scatter-min (a full argsort of ~115k points
    # dominated the extraction cost; two
    # scatters + one gather do the same job)
    n_cells = cfg.n_scan * cfg.width
    img_r = jnp.full((n_cells + 1,), 1e9, points.dtype).at[cell].min(
        jnp.where(valid, r, 1e9))
    win = valid & (r <= img_r[cell] + 1e-3)  # ties resolved arbitrarily below
    tgt = jnp.where(win, cell, n_cells)
    img_xyz = jnp.zeros((n_cells + 1, 3), points.dtype).at[tgt].set(points)[:-1]
    img_valid = jnp.zeros((n_cells + 1,), bool).at[tgt].set(win)[:-1]
    return img_xyz.reshape(cfg.n_scan, cfg.width, 3), img_valid.reshape(cfg.n_scan, cfg.width)


def curvature_image(img_xyz, img_valid, cfg: LidarConfig):
    """11-point curvature along azimuth (featureExtraction.hpp:188-202 analog).

    curv = |sum_{j in +-5, j != 0} (p_j - p_0)|^2, valid only where all 10
    neighbors exist. Circular along azimuth (360 deg scans).

    Additionally applies the LOAM occlusion / parallel-beam rejection the
    reference's active extractor omits (its dead featureExtract.hpp had it):
    points on the FAR side of a range discontinuity shift with sensor motion
    (parallax at occlusion shadows) and grazing-incidence points are
    unreliable — both are excluded from feature selection. Without this,
    occlusion-boundary "edges" systematically drag the forward estimate.
    """
    half = (cfg.nms_window - 1) // 2
    acc = jnp.zeros_like(img_xyz)
    all_valid = img_valid
    for j in range(1, half + 1):
        for s in (j, -j):
            acc = acc + jnp.roll(img_xyz, s, axis=1)
            all_valid = all_valid & jnp.roll(img_valid, s, axis=1)
    acc = acc - (2 * half) * img_xyz
    curv = jnp.sum(acc * acc, axis=-1)

    # --- occlusion rejection ---
    r = jnp.linalg.norm(img_xyz, axis=-1)
    r_next = jnp.roll(r, -1, axis=1)
    r_prev = jnp.roll(r, 1, axis=1)
    pair_next = img_valid & jnp.roll(img_valid, -1, axis=1)
    pair_prev = img_valid & jnp.roll(img_valid, 1, axis=1)
    disc_far_right = pair_next & (r - r_next > 0.5)  # this cell occluded side
    disc_far_left = pair_prev & (r - r_prev > 0.5)
    occluded = jnp.zeros_like(img_valid)
    for j in range(half + 1):
        occluded = occluded | jnp.roll(disc_far_right, -j, axis=1)
        occluded = occluded | jnp.roll(disc_far_left, j, axis=1)
    # --- parallel-beam (grazing incidence) rejection ---
    grazing = (
        pair_next & pair_prev
        & (jnp.abs(r_next - r) > 0.02 * r)
        & (jnp.abs(r_prev - r) > 0.02 * r)
    )
    all_valid = all_valid & ~occluded & ~grazing
    return jnp.where(all_valid, curv, -1.0), all_valid


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_features(points: jnp.ndarray, valid: jnp.ndarray, cfg: LidarConfig = LidarConfig()) -> LidarFeatures:
    """Full extraction: range image -> curvature -> sector top-k edges + surf.

    Reference parity: featureExtraction::extractFeature
    (featureExtraction.hpp:223-232) + featureExtractionFromSector (:112-173).
    """
    img_xyz, img_valid = project_range_image(points, valid, cfg)
    curv, curv_valid = curvature_image(img_xyz, img_valid, cfg)

    # --- edges: windowed NMS then per-sector top-k ---
    half = (cfg.nms_window - 1) // 2
    pooled = curv
    for j in range(1, half + 1):
        pooled = jnp.maximum(pooled, jnp.maximum(jnp.roll(curv, j, 1), jnp.roll(curv, -j, 1)))
    is_peak = (curv >= pooled) & (curv > cfg.edge_curv_min) & curv_valid
    edge_score = jnp.where(is_peak, curv, -1.0)
    sector_w = cfg.width // cfg.n_sectors
    es = edge_score[:, : sector_w * cfg.n_sectors].reshape(cfg.n_scan, cfg.n_sectors, sector_w)
    top_v, top_i = jax.lax.top_k(es, cfg.edge_per_sector)  # (S, 6, k)
    sec_base = jax.lax.broadcasted_iota(jnp.int32, top_i.shape, 1) * sector_w
    cols = top_i + sec_base  # absolute column
    rows = jax.lax.broadcasted_iota(jnp.int32, top_i.shape, 0)
    edge_pts = img_xyz[rows.reshape(-1), cols.reshape(-1)]
    edge_ok = (top_v > 0).reshape(-1)
    edge, edge_valid = voxel_ops.compact(edge_pts, edge_ok, cfg.edge_cap)

    # --- planar: low-curvature cells, voxel-downsampled to capacity ---
    surf_mask = curv_valid & (curv >= 0) & (curv < cfg.surf_curv_max) & ~is_peak
    flat_pts = img_xyz.reshape(-1, 3)
    flat_ok = surf_mask.reshape(-1)
    origin = jnp.full((3,), -200.0, points.dtype)
    # sort-free hash downsample: the exact (argsort-based) variant bitonic-
    # sorts all ~115k cells and dominated extraction; one representative
    # per hashed voxel is equivalent for surf candidate thinning (the maps are
    # maintained with the same hash scheme)
    surf, surf_valid = voxel_ops.voxel_downsample_hash(
        flat_pts, flat_ok, cfg.surf_voxel, origin, cfg.surf_cap
    )
    return LidarFeatures(edge, edge_valid, surf, surf_valid)
