#!/usr/bin/env python
"""Per-frame estimator telemetry at acceptance scale: reproduce the periodic
z_jump/bias divergence (an acceptance run: 8 restarts, all z_jump or
acc_bias_norm, every 13-23 s) with enough signal to name the mechanism.

    python tools/diag_estimator_scale.py --frames 280
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=280)
    ap.add_argument("--radius", type=float, default=100.0)
    ap.add_argument("--no-depth", action="store_true",
                    help="disable lidar->visual depth association")
    ap.add_argument("--no-lidar-factor", action="store_true",
                    help="disable lidar relative-pose factors in BA")
    args = ap.parse_args()

    import jax

    from vil_fusion_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax.numpy as jnp

    from vil_fusion_tpu.runtime import sim
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime import pipeline as pl

    R_BC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    H, W = 370, 1226
    FX = FY = 718.856
    CX, CY = 607.19, 185.22
    rig = RigConfig(
        name="diag",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=FX, fy=FY, cx=CX, cy=CY),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W,
        q_ic=sim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(R_BC.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=64,
        lidar_fov_up=2.0, lidar_fov_down=-24.8, lidar_min_range=1.0,
        lidar_max_range=80.0, use_lidar=True)
    ba_over = {"use_lidar": False} if args.no_lidar_factor else None
    pipe = pl.VILFusionPipeline(rig, mode="vil", sync_depth=0,
                                scan_quant=0.0025, ba_overrides=ba_over)
    if args.no_depth:
        from vil_fusion_tpu.models import depth_association as da

        real = da.feature_depth
        da.feature_depth = lambda xy, v, c, cv: (
            jnp.full(xy.shape[0], -1.0, xy.dtype), v & False)
        pl._vil_frame_program.clear_cache()

    period = 2 * np.pi * args.radius / 8.0
    traj = sim.LoopTrajectory(radius=args.radius, period=period, laps=2.0)
    scene = sim.JaxRaycast(sim.urban_block_scene(
        args.radius, pillar_step_deg=4.0, box_step_deg=6.0))
    noise = type("N", (), dict(acc_n=0.08, gyr_n=0.004))()
    bias_a = np.array([0.05, -0.03, 0.02])
    bias_g = np.array([0.002, -0.001, 0.0015])

    t0 = 1.0
    for i in range(args.frames):
        t = t0 + i * 0.1
        if i:
            ts, a, g = sim.simulate_imu(traj, t - 0.1, t, 200.0, noise=noise,
                                        bias_a=bias_a, bias_g=bias_g, seed=i)
            pipe.push_imu_batch(ts[1:], a[1:], g[1:])
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        pts, val = sim.simulate_lidar_scan(
            scene, R_wb, p_wb, n_scan=64, width=1800, fov_up_deg=2.0,
            fov_down_deg=-24.8, max_range=80.0, range_noise=0.02, seed=i)
        pipe.push_scan(t, pts, val)
        img = np.clip(np.asarray(sim.render_camera_image(
            scene, R_wb @ R_BC, p_wb, FX, FY, CX, CY, H, W)) * 255.0 + 0.5,
            0, 255).astype(np.uint8)
        pipe.push_image(t, img)
        if i % 10 == 0 and pipe.estimator.initialized:
            est = pipe.estimator
            f, w = est.feats, est.window
            act = int(np.asarray(f.active).sum())
            dep = int((np.asarray(f.active)
                       & np.asarray(f.lidar_flag)).sum())
            tri = int((np.asarray(f.active)
                       & (np.asarray(f.inv_depth) > 0)).sum()) - dep
            ba_n = float(np.linalg.norm(np.asarray(w.ba[-1])))
            gt_p = traj.position(t) + np.array([0, 0, 1.5])
            p_now = np.asarray(w.p[-2])
            z_err = float(p_now[2] - gt_p[2])
            xy_err = float(np.linalg.norm(p_now[:2] - gt_p[:2]))
            print(f"i={i:3d} act={act:3d} lidar_dep={dep:3d} tri={tri:3d} "
                  f"|ba|={ba_n:6.3f} z={z_err:+7.3f} xy={xy_err:6.2f} "
                  f"cost={getattr(est, 'last_cost', float('nan')):9.1f} "
                  f"restarts={pipe.restarts}",
                  flush=True)
    print("restart_log:", pipe.restart_log)


if __name__ == "__main__":
    main()
