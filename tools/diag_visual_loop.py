#!/usr/bin/env python
"""Offline diagnosis of the visual loop detector at acceptance scale.

An acceptance run once recorded 0 visual loops over 2 identical laps while
ScanContext found 64. This probe isolates the place-
recognition chain from the estimator: keyframes are built from GROUND-TRUTH
poses and raycast-true landmark depths on the same urban-block scene at full
KITTI image scale (1226x370), 2 laps, keyframe every 2 m. Every lap-2 query
has a lap-1 counterpart within ~1 m, the easiest possible setting — whatever
fraction fails here is intrinsic to BoW scoring / BRIEF matching / PnP, not
to drift.

    python tools/diag_visual_loop.py --radius 30 [--drift-per-m 0.015]

--drift-per-m adds a synthetic lap-2 pose drift (VIO-like, default 0) to
separate "detector dead" from "drift kills the gates".
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--kf-gap", type=float, default=2.0)
    ap.add_argument("--drift-per-m", type=float, default=0.0,
                    help="synthetic lap-2 drift, meters per meter traveled")
    ap.add_argument("--width", type=int, default=1226)
    ap.add_argument("--height", type=int, default=370)
    args = ap.parse_args()

    import jax

    from vil_fusion_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax.numpy as jnp

    from vil_fusion_tpu.models import cameras as cam_mod
    from vil_fusion_tpu.models import visual_loop as vl
    from vil_fusion_tpu.ops import image as im
    from vil_fusion_tpu.runtime import sim

    H, W = args.height, args.width
    FX = FY = 718.856
    CX, CY = W * 0.495, H * 0.5006
    R_BC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    cam = cam_mod.from_config(dict(
        model_type="PINHOLE",
        projection_parameters=dict(fx=FX, fy=FY, cx=CX, cy=CY),
        distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)))

    period = 2 * np.pi * args.radius / 8.0
    traj = sim.LoopTrajectory(radius=args.radius, period=period, laps=2.0)
    scene = sim.JaxRaycast(sim.urban_block_scene(
        args.radius, pillar_step_deg=4.0, box_step_deg=6.0))

    lap_len = 2 * np.pi * args.radius
    n_kf_lap = int(lap_len / args.kf_gap)
    n_kf = 2 * n_kf_lap
    cap = 1 << int(np.ceil(np.log2(n_kf + 8)))
    db = vl.VisualLoopDB(vl.VisualLoopConfig(capacity=cap),
                         qic=sim.R_to_q(R_BC), tic=np.zeros(3))

    print(f"{n_kf} keyframes over 2 laps of {lap_len:.0f} m at "
          f"{W}x{H}; drift {args.drift_per_m}/m", flush=True)

    t0 = 1.0
    results = []
    t_start = time.perf_counter()
    for i in range(n_kf):
        dist = i * args.kf_gap
        t = t0 + (dist / lap_len) * period
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        R_wc = R_wb @ R_BC
        img = np.clip(np.asarray(sim.render_camera_image(
            scene, R_wc, p_wb, FX, FY, CX, CY, H, W)) * 255.0 + 0.5,
            0, 255).astype(np.uint8)

        # window landmarks: detected corners + raycast-true depth (what the
        # estimator would hand over, minus triangulation error)
        exy, evalid = im.detect_features(
            jnp.asarray(img, jnp.float32), jnp.zeros((1, 2), jnp.float32),
            jnp.zeros((1,), bool), max_pts=db.cfg.win_cap, min_dist=20)
        exy = np.asarray(exy)
        evalid = np.asarray(evalid)
        rays_c = np.stack([(exy[:, 0] - CX) / FX, (exy[:, 1] - CY) / FY,
                           np.ones(len(exy))], -1)
        rays_c /= np.linalg.norm(rays_c, axis=-1, keepdims=True)
        t_hit = scene.raycast(np.broadcast_to(p_wb, rays_c.shape),
                              rays_c @ R_wc.T, max_range=120.0)
        hit = np.isfinite(t_hit)
        pts_w = p_wb + np.where(hit, t_hit, 0.0)[:, None] * (rays_c @ R_wc.T)
        ok = evalid & hit

        # synthetic VIO drift on lap 2 (pose AND landmarks move together,
        # like real drifted-estimator exports)
        d = args.drift_per_m * dist if i >= n_kf_lap else 0.0
        offs = np.array([d, 0.3 * d, 0.05 * d])
        q_wb = sim.R_to_q(R_wb)
        i_cur = db.add_keyframe(img, q_wb, p_wb + offs, pts_w + offs, exy,
                                ok, cam)
        if i_cur is None:
            break
        hit_res = db.detect_and_verify(i_cur)
        if i >= n_kf_lap:
            expect = i - n_kf_lap  # same arc position, one lap earlier
            got = hit_res[0] if hit_res is not None else None
            good = got is not None and abs(got - expect) <= 3
            results.append(good)
            if i % 20 == 0:
                print(f"  kf {i}: expect ~{expect} got {got} "
                      f"({'OK' if good else 'miss'})", flush=True)

    wall = time.perf_counter() - t_start
    stats = db.stats_summary()
    recall = float(np.mean(results)) if results else 0.0
    print(json.dumps({
        "n_keyframes": int(db.n), "lap2_queries": len(results),
        "recall_at_3kf": round(recall, 3),
        "wall_s": round(wall, 1),
        "stats": stats,
    }, indent=1))


if __name__ == "__main__":
    main()
