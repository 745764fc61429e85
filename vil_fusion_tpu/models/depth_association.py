"""LiDAR-to-visual feature depth association on the unit sphere.

Rebuild of the reference's `getFeatureDepth`
(reference: src/visual_inertial_lidar/feature_tracker/feature_tracker_node.cpp:54-199):
project the FOV-filtered LiDAR cloud (already transformed into the camera
frame by LIDAR_CAMERA_EX, :358-362) and the visual features onto the unit
sphere, find each feature's 3 nearest cloud points (reference: PCL kd-tree,
here the tiled brute-force kNN), intersect the feature's view ray with the
3-point plane, and gate the result exactly like the reference:
  * reject if the 3 NN ranges spread more than 2 m        (:119-131)
  * clamp the intersection depth into [min, max] NN range (:150-157)
  * require signed ray scale s > 0.5 and depth > 2 m      (:139-148, :164)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vil_fusion_tpu.ops.pallas import knn_pallas as knn_ops  # fused kernel on GPU, XLA elsewhere

# minimum |cos| between the view ray and the 3-NN plane normal (~6 deg off
# the surface plane); see the grazing-incidence gate below
MIN_INCIDENCE = 0.1


@functools.partial(jax.jit, static_argnames=())
def feature_depth(
    feat_xy: jnp.ndarray,  # (N, 2) normalized-plane feature coords
    feat_valid: jnp.ndarray,  # (N,)
    cloud_cam: jnp.ndarray,  # (M, 3) LiDAR points in camera frame
    cloud_valid: jnp.ndarray,  # (M,)
    min_incidence=None,  # strong/weak threshold (rig knob); None = module default
):
    """Returns (depth (N,), ok (N,)): depth along the camera ray, -1 invalid."""
    dtype = feat_xy.dtype
    # FOV filter: points in front of the camera within ~77 deg half-angle
    # (feature_tracker_node.cpp:348-356 keeps x/z,y/z in [-1.25, 1.25]-ish)
    z = cloud_cam[:, 2]
    ok_pt = cloud_valid & (z > 0.3)
    xz = cloud_cam[:, 0] / jnp.where(ok_pt, z, 1.0)
    yz = cloud_cam[:, 1] / jnp.where(ok_pt, z, 1.0)
    ok_pt = ok_pt & (jnp.abs(xz) < 1.3) & (jnp.abs(yz) < 1.3)

    rng = jnp.linalg.norm(cloud_cam, axis=-1)
    sphere_pts = cloud_cam / jnp.maximum(rng, 1e-6)[:, None]

    rays = jnp.concatenate([feat_xy, jnp.ones_like(feat_xy[:, :1])], axis=-1)
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)

    d2, idx = knn_ops.knn(rays, sphere_pts, ok_pt, k=3)
    found = jnp.isfinite(d2).all(axis=-1) & feat_valid
    nn = cloud_cam[idx]  # (N, 3, 3) actual 3D points
    nn_rng = rng[idx]  # (N, 3)

    # range-spread gate (2 m, :119-131)
    spread_ok = (jnp.max(nn_rng, axis=-1) - jnp.min(nn_rng, axis=-1)) < 2.0

    # ray-plane intersection: s such that s*ray lies on plane of the 3 NN
    v1 = nn[:, 1] - nn[:, 0]
    v2 = nn[:, 2] - nn[:, 0]
    n = jnp.cross(v1, v2)
    denom = jnp.einsum("ni,ni->n", n, rays)
    s = jnp.einsum("ni,ni->n", n, nn[:, 0]) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1e-6)
    s_ok = s > 0.5  # (:139-148)

    # grazing-incidence CLASSIFICATION (DELIBERATE refinement of the
    # reference's design): along view rays < ~6 deg off the local surface
    # plane the depth error is range_noise / sin(incidence) — bias-prone
    # error from cm of lidar noise — and the NN-band clamp below then
    # systematically UNDERESTIMATES depth. The reference holds EVERY
    # lidar-depthed feature CONSTANT in BA; with a textured ground plane
    # that feeds a coherent downward pull (measured 0.5 m/s of VIO z-sink
    # with |ba| ramping past the failure threshold every ~20 s at
    # acceptance scale; tools/diag_estimator_scale.py ablations). But
    # DROPPING grazing depths entirely starves geometry-poor small scenes
    # whose triangulation is weak (toy-scale estimator went unstable).
    # Resolution: STRONG (steep-incidence) depths are returned positive and
    # become reference-style constant-depth features; WEAK (grazing) depths
    # are returned NEGATED and serve as inverse-depth INITIALIZATION only —
    # BA refines them, so their bias cannot lock in (see
    # estimator.ingest_features).
    if min_incidence is None:
        min_incidence = MIN_INCIDENCE
    n_norm = jnp.linalg.norm(n, axis=-1)
    incidence = jnp.abs(denom) / jnp.maximum(n_norm, 1e-9)
    strong = incidence > min_incidence

    # clamp into NN range band (:150-157)
    s = jnp.clip(s, jnp.min(nn_rng, axis=-1), jnp.max(nn_rng, axis=-1))
    depth = s * rays[:, 2]  # z-depth along optical axis
    ok = found & spread_ok & s_ok & (depth > 2.0)  # min-depth gate (:164)
    signed = jnp.where(strong, depth, -depth)  # weak < -2; sentinel is -1
    return jnp.where(ok, signed, -1.0), ok
