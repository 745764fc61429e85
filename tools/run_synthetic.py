#!/usr/bin/env python
"""Run the full vil pipeline over a KITTI-scale synthetic city circuit.

The environment has no real KITTI data (zero egress), so this is the
dataset-replay acceptance run at honest scale: a >=1 km urban-block raycast
circuit (radius 100 m -> 628 m/lap), KITTI sensor shapes (1226x370 camera,
HDL-64 64x1800 scan, 200 Hz IMU with noise+bias, 10 Hz frames), cold start
(no initial state), loop closure over multiple laps. Mirrors the reference's
`rosbag play kitti_08.bag` validation (README.md:40-55) with analytic ground
truth instead of GPS/INS.

    python tools/run_synthetic.py --laps 2 --out out/city

Events stream through the ring-bus prefetch (runtime/transport.py), so
raycast generation on the host overlaps device compute.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_events(traj, scene, rig_geom, n_frames, frame_dt=0.1, t0=1.0,
                imu_rate=200.0, range_noise=0.02, seed0=0):
    """Time-ordered imu/scan/image events for the circuit (generator: frames
    are rendered lazily inside the prefetch producer thread)."""
    from vil_fusion_tpu.runtime import sim

    R_BC, H, W, FX, FY, CX, CY = rig_geom
    noise = type("N", (), dict(acc_n=0.08, gyr_n=0.004))()
    bias_a = np.array([0.05, -0.03, 0.02])
    bias_g = np.array([0.002, -0.001, 0.0015])
    for i in range(n_frames):
        t = t0 + i * frame_dt
        if i > 0:
            ts_i, acc, gyr = sim.simulate_imu(
                traj, t - frame_dt, t, imu_rate, noise=noise,
                bias_a=bias_a, bias_g=bias_g, seed=seed0 + i)
            for k in range(1, len(ts_i)):
                yield ("imu", ts_i[k], acc[k], gyr[k])
        if i and i % 100 == 0:
            print(f"  frame {i}/{n_frames}", file=sys.stderr, flush=True)
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        pts, val = sim.simulate_lidar_scan(
            scene, R_wb, p_wb, n_scan=64, width=1800, fov_up_deg=2.0,
            fov_down_deg=-24.8, max_range=80.0, range_noise=range_noise,
            seed=seed0 + i)
        yield ("scan", t, np.asarray(pts), np.asarray(val))
        img = np.clip(np.asarray(sim.render_camera_image(
            scene, R_wb @ R_BC, p_wb, FX, FY, CX, CY, H, W)) * 255.0 + 0.5,
            0, 255).astype(np.uint8)
        yield ("image", t, img)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--radius", type=float, default=100.0, help="circuit radius (m)")
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--speed", type=float, default=8.0, help="mean speed (m/s)")
    ap.add_argument("--out", default="out/city")
    ap.add_argument("--sync-depth", type=int, default=2)
    ap.add_argument("--frames", type=int, default=None,
                    help="override frame count (default: laps * lap time * 10 Hz)")
    args = ap.parse_args()

    import jax

    from vil_fusion_tpu.utils.compile_cache import use_compile_cache

    # persistent compile cache (same as bench.py): repeat runs skip the
    # compiles of the fused frame / keyframe / loop programs
    use_compile_cache()

    from vil_fusion_tpu.models import global_fusion as gf
    from vil_fusion_tpu.models import visual_loop as vl
    from vil_fusion_tpu.runtime import datasets, sim, tum
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu.utils.tracing import GLOBAL_TIMERS

    R_BC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    H, W = 370, 1226
    FX = FY = 718.856
    CX, CY = 607.19, 185.22
    rig = RigConfig(
        name="city",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=FX, fy=FY, cx=CX, cy=CY),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W,
        q_ic=sim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(R_BC.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=64,
        lidar_fov_up=2.0, lidar_fov_down=-24.8, lidar_min_range=1.0,
        lidar_max_range=80.0, use_lidar=True)

    period = 2 * np.pi * args.radius / args.speed
    traj = sim.LoopTrajectory(radius=args.radius, period=period, laps=args.laps)
    # device-vectorized raycast: the numpy primitive loop is ~26 s/frame at
    # this scene's ~300 primitives (10+ h for the circuit); JaxRaycast runs
    # the whole (rays x primitives) test as one jitted dispatch per sensor
    scene = sim.JaxRaycast(sim.urban_block_scene(
        args.radius, pillar_step_deg=4.0, box_step_deg=6.0))
    n_frames = args.frames or int(args.laps * period * 10)
    path_len = args.laps * 2 * np.pi * args.radius

    # keyframe gates at the reference's defaults (2 m / 10 deg); capacities
    # sized for the circuit
    n_kf_max = int(path_len / 2.0 * 1.5) + 64
    cap = 1 << int(np.ceil(np.log2(n_kf_max)))
    pipe = VILFusionPipeline(
        rig, mode="vil", visual_loop=True, sync_depth=args.sync_depth,
        scan_quant=0.0025,
        gf_cfg=gf.GlobalFusionConfig(node_capacity=cap),
        vl_cfg=vl.VisualLoopConfig(capacity=cap, keyframe_gap=2.0))

    print(f"city circuit: {path_len:.0f} m, {n_frames} frames, "
          f"{cap}-slot graphs", flush=True)
    rig_geom = (R_BC, H, W, FX, FY, CX, CY)
    events = make_events(traj, scene, rig_geom, n_frames)
    t_start = time.perf_counter()
    datasets.replay(pipe, events)
    wall = time.perf_counter() - t_start

    os.makedirs(args.out, exist_ok=True)
    pipe.outputs.write(args.out, pipe.fusion)
    try:
        from vil_fusion_tpu.runtime import viz
    except ImportError as e:  # matplotlib is optional
        print(f"note: {e}; skipping the PNG report")
    else:
        viz.render_pipeline_report(pipe, args.out)

    gt = {round(1.0 + i * 0.1, 6): traj.position(1.0 + i * 0.1) + np.array([0, 0, 1.5])
          for i in range(n_frames)}
    gt_frames = np.stack([gt[round(t, 6)] for t in pipe.outputs.ts])
    # VIO trajectories are evaluated on initialized frames only — the
    # reference publishes odometry only in NON_LINEAR state (pubOdometry)
    ini = np.asarray(pipe.outputs.initialized, bool)
    report = {
        "path_length_m": round(path_len, 1),
        "frames": len(pipe.outputs.ts),
        "frames_initialized": int(ini.sum()),
        "wall_s": round(wall, 1),
        "fps": round(len(pipe.outputs.ts) / wall, 2),
        "restarts": pipe.restarts,
        "restart_log": pipe.restart_log,
        "n_sc_loops": len(pipe.fusion.loops_found) if pipe.fusion else 0,
        "n_visual_loops": int(pipe.visual_loop.graph.n_loops)
        if pipe.visual_loop is not None else 0,
        "visual_loop_stats": pipe.visual_loop.stats_summary()
        if pipe.visual_loop is not None else None,
        "ate_rmse_vio": tum.ate_rmse(np.stack(pipe.outputs.vio_p)[ini],
                                     gt_frames[ini]),
        "ate_rmse_loop": tum.ate_rmse(np.stack(pipe.outputs.loop_p)[ini],
                                      gt_frames[ini])
        if pipe.outputs.loop_p else None,
        # p50/p90 are the steady-state decomposition; means include the
        # first-call XLA compiles and only say how expensive compilation was
        "timers": {k: {kk: (round(vv, 2) if isinstance(vv, float) else vv)
                       for kk, vv in v.items()}
                   for k, v in GLOBAL_TIMERS.summary().items()},
    }
    if pipe.fusion is not None and pipe.fusion.n_kf:
        gt_kf = np.stack([gt[round(t, 6)] for t in pipe.fusion.kf_ts])
        _, p_kf = pipe.fusion.poses()
        report["ate_rmse_fusion"] = tum.ate_rmse(np.asarray(p_kf), gt_kf)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "timers"},
                     indent=2))


if __name__ == "__main__":
    main()
