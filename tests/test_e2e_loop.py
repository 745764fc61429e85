"""Cold-start full-pipeline loop closure — the reference's de-facto
acceptance test (README.md:40-55, the KITTI-08 loop plot) in CI form.

One 390-frame lap of the urban-block raycast world driven through
`VILFusionPipeline` in full "vil" mode with NO `set_initial_state`:

- cold-start initialization (essential-RANSAC SfM + IMU alignment) fires,
- the ScanContext global graph fires >= 1 verified (ICP) loop,
- the visual loop path (BRIEF/BoW + PnP + 4-DoF graph) fires >= 1 loop and
  re-anchors the VIO window (relocalization feedback, estimator.cpp
  setReloFrame :1188-1206),
- the global-fusion trajectory ("fs_loam_loop") beats the raw VIO
  trajectory ("vins_result_no_loop") on ATE,
- the retroactively rebuilt loop path (pose_graph.cpp updatePath analog)
  is no worse than the VIO path.

Runs on the deployed deferred path (sync_depth=2) — the same cross-frame
overlap configuration the benchmark uses — so the async drift
bookkeeping and the deferred ScanContext gate are exercised end to end.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from vil_fusion_tpu.runtime import sim, tum
from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline
from vil_fusion_tpu.runtime.config import RigConfig
from vil_fusion_tpu.models import visual_loop as vl, global_fusion as gf

N_FRAMES = 390
R_BC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
H, W = 240, 320
FX = FY = 250.0
CX, CY = W / 2, H / 2


def _build_pipeline():
    rig = RigConfig(
        name="loop",
        camera=dict(
            model_type="PINHOLE",
            projection_parameters=dict(fx=FX, fy=FY, cx=CX, cy=CY),
            distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W,
        q_ic=sim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(R_BC.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=12, n_scan=32,
        lidar_fov_up=30.0, lidar_fov_down=-30.0, lidar_min_range=1.0,
        lidar_max_range=80.0, use_lidar=True,
        # small indoor-scale rig: surfaces close, triangulation weak — hold
        # lidar depths constant down to very shallow incidence (the KITTI
        # rigs keep the 0.1 default; see RigConfig.depth_min_incidence)
        depth_min_incidence=0.02)
    return VILFusionPipeline(
        rig, mode="vil", visual_loop=True, sync_depth=2,
        gf_cfg=gf.GlobalFusionConfig(keyframe_dist=1.5, node_capacity=512,
                                     optimize_every=8),
        vl_cfg=vl.VisualLoopConfig(capacity=512, keyframe_gap=0.75),
        odom_overrides=dict(width=600, edge_map_cap=4096, surf_map_cap=8192,
                            use_hash_knn=True))


@pytest.mark.slow
def test_cold_start_pipeline_closes_loop():
    radius = 12.0
    traj = sim.LoopTrajectory(radius=radius, period=35.0)
    scene = sim.urban_block_scene(radius)
    pipe = _build_pipeline()

    frame_dt = 0.1
    imu_rate = 200.0
    t0 = 1.0
    noise = type("N", (), dict(acc_n=0.08, gyr_n=0.004))()
    bias_a = np.array([0.05, -0.03, 0.02])
    bias_g = np.array([0.002, -0.001, 0.0015])
    gt = {}
    vio_errs = []  # (frame, |vio - gt|) once initialized
    loop_frame = None  # first frame with an accepted visual loop

    for i in range(N_FRAMES):
        t = t0 + i * frame_dt
        if i > 0:
            ts_i, acc, gyr = sim.simulate_imu(
                traj, t - frame_dt, t, imu_rate, noise=noise,
                bias_a=bias_a, bias_g=bias_g, seed=i)
            for k in range(1, len(ts_i)):
                pipe.push_imu(ts_i[k], acc[k], gyr[k])
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        img = sim.render_camera_image(scene, R_wb @ R_BC, p_wb,
                                      FX, FY, CX, CY, H, W)
        pts, val = sim.simulate_lidar_scan(scene, R_wb, p_wb, n_scan=32,
                                           width=600, range_noise=0.01, seed=i)
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
        gt[round(t, 6)] = p_wb
        if pipe.outputs.vio_p and pipe.estimator.initialized:
            err = np.linalg.norm(
                pipe.outputs.vio_p[-1] - gt[round(pipe.outputs.ts[-1], 6)])
            vio_errs.append((i, err))
        if loop_frame is None and pipe.visual_loop.graph.n_loops >= 1:
            loop_frame = i

    pipe.finalize()

    # --- cold start + stability --------------------------------------
    assert pipe.estimator.initialized, "cold-start initialization never fired"
    assert pipe.restarts == 0, f"{pipe.restarts} failure-detection restarts"
    assert len(pipe.outputs.ts) >= N_FRAMES - 10

    # --- loops fired through the WHOLE pipeline ----------------------
    assert len(pipe.fusion.loops_found) >= 1, "no verified ScanContext loop"
    assert int(pipe.visual_loop.graph.n_loops) >= 1, "no visual loop"
    assert loop_frame is not None

    # --- trajectory quality: the reference's acceptance criterion ----
    # (initialized frames only: pubOdometry publishes in NON_LINEAR state)
    ini = np.asarray(pipe.outputs.initialized, bool)
    gt_frames = np.stack([gt[round(t, 6)] for t in pipe.outputs.ts])[ini]
    ate_vio = tum.ate_rmse(np.stack(pipe.outputs.vio_p)[ini], gt_frames)
    gt_kf = np.stack([gt[round(t, 6)] for t in pipe.fusion.kf_ts])
    _, p_kf = pipe.fusion.poses()
    ate_fs = tum.ate_rmse(np.asarray(p_kf), gt_kf)
    assert ate_fs < ate_vio, (
        f"fs_loam_loop ATE {ate_fs:.3f} !< vins_result_no_loop ATE {ate_vio:.3f}")
    assert ate_fs < 0.5, f"global-fusion ATE too large: {ate_fs:.3f}"

    # updatePath-rebuilt loop trajectory is no worse than raw VIO
    ate_loop = tum.ate_rmse(np.stack(pipe.outputs.loop_p)[ini], gt_frames)
    assert ate_loop <= ate_vio * 1.05, (
        f"loop-corrected ATE {ate_loop:.3f} worse than VIO {ate_vio:.3f}")

    # --- relocalization feedback re-converges the VIO itself ---------
    pre = [e for f, e in vio_errs if loop_frame - 5 <= f <= loop_frame]
    post = [e for f, e in vio_errs if f >= loop_frame + 3]
    if post:  # loop may fire on the very last frames
        assert min(post) < max(pre), (
            f"VIO error did not drop after relo feedback: "
            f"pre={max(pre):.2f} post={min(post):.2f}")
