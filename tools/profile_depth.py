#!/usr/bin/env python
"""Marginal in-program cost of depth association: chained timing of the FULL
frame program vs the same program with feature_depth stubbed to zeros.
(Stage-in-isolation timings miss fusion with the neighbouring stages; the
marginal difference inside the deployed program is the honest number.)
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from vil_fusion_tpu.utils.compile_cache import use_compile_cache

use_compile_cache()
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import depth_association
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu.runtime.config import RigConfig


def main():
    from vil_fusion_tpu.runtime import pipeline as pl

    R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    H, W = 370, 1226
    FX = FY = 718.856
    CX, CY = 607.19, 185.22
    rig = RigConfig(
        name="kitti-bench",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=FX, fy=FY, cx=CX, cy=CY),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W,
        q_ic=sim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(R_BC.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=64,
        lidar_fov_up=2.0, lidar_fov_down=-24.8, lidar_min_range=1.0,
        lidar_max_range=80.0, use_lidar=True)
    pipe = pl.VILFusionPipeline(rig, mode="vil", sync_depth=2,
                                scan_quant=0.0025)

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    t0 = 1.0
    q0, p0 = traj.pose(t0)
    pipe.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0,
                                     v=traj.velocity(t0))
    frames = []
    for i in range(16):
        t = t0 + i * 0.1
        imu = sim.simulate_imu(traj, t - 0.1, t, 200.0) if i else None
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        img = np.clip(np.asarray(sim.render_camera_image(
            scene, R_wb @ R_BC, p_wb, FX, FY, CX, CY, H, W)) * 255.0 + 0.5,
            0, 255).astype(np.uint8)
        pts, val = sim.simulate_lidar_scan(
            scene, R_wb, p_wb, n_scan=64, width=1800, fov_up_deg=2.0,
            fov_down_deg=-24.8, max_range=80.0)
        frames.append((t, imu, img, np.asarray(pts), np.asarray(val)))
    for (t, imu, img, pts, val) in frames:
        if imu is not None:
            ts_i, acc, gyr = imu
            pipe.push_imu_batch(ts_i[1:], acc[1:], gyr[1:])
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
    while pipe._pending:
        pipe._complete_frame(pipe._pending.pop(0))

    imgs = [jnp.asarray(f[2]) for f in frames[-4:]]
    scans_q = [(jnp.asarray(np.clip(np.round(
                    np.asarray(f[3]) * (1.0 / pipe.scan_quant)),
                    -32767, 32767).astype(np.int16)),
                jnp.asarray(np.packbits(np.asarray(f[4], bool))))
               for f in frames[-4:]]
    est = pipe.estimator
    cam, tcfg, lcfg, ecfg = (pipe.cam, pipe.tracker_cfg, pipe.lidar_cfg,
                             pipe.est_cfg)
    t, imu, img, pts, val = frames[-1]
    acc, gyr, dts = (np.asarray(imu[1][1:]), np.asarray(imu[2][1:]),
                     np.diff(imu[0]))
    acc_b, gyr_b, dt_b, n_imu = est._pack_imu(acc, gyr, dts)
    blk = np.zeros((acc_b.shape[0] + 1, 7), np.float32)
    blk[:-1, 0:3] = acc_b
    blk[:-1, 3:6] = gyr_b
    blk[:len(dt_b), 6] = dt_b
    blk[-1, :4] = (1.0, len(dts), 0.0, pipe.scan_quant)
    imu_hdr = jnp.asarray(blk)

    def chained(fn, state0, n=12, warm=3):
        s = state0
        for i in range(warm):
            s = fn(s, i)
        jax.block_until_ready(s)
        t0_ = time.perf_counter()
        for i in range(n):
            s = fn(s, i)
        jax.block_until_ready(s)
        return (time.perf_counter() - t0_) / n * 1e3

    def run_variant(label):
        def full_step(s, i):
            r = pl._vil_frame_program(
                *s, imgs[i % 4], *scans_q[i % 4], imu_hdr,
                pipe.q_il, pipe.t_il, pipe.q_li, pipe.t_li,
                pipe.q_cl, pipe.t_cl,
                cam, tcfg, lcfg, ecfg)
            return r[:7]
        ms = chained(full_step, (pipe.tracker_state, pipe.lidar_state,
                                 est.window, est.feats, est.pre, est.lidar,
                                 est.prior))
        print(f"{label:28s} {ms:7.2f} ms", flush=True)
        return ms

    a = run_variant("full (with depth assoc)")

    real_fd = depth_association.feature_depth

    def stub_fd(feat_xy, feat_valid, cloud_cam, cloud_valid):
        z = jnp.zeros(feat_xy.shape[0], feat_xy.dtype)
        return z - 1.0, feat_valid & False

    depth_association.feature_depth = stub_fd
    pl._vil_frame_program.clear_cache()
    try:
        b = run_variant("full (depth stubbed)")
    finally:
        depth_association.feature_depth = real_fd
        pl._vil_frame_program.clear_cache()
    print(f"marginal depth-association cost: {a - b:.2f} ms")


if __name__ == "__main__":
    main()
