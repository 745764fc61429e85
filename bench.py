"""Benchmark: full VIL pipeline frames/s, lidar-only odometry frames/s and
BA iterations/s on one NVIDIA GPU.

Refuses any backend but the GPU and fails on any error. Prints the device and
the card's name and power limit, then ONE JSON line: {"metric", "value",
"unit", "vs_baseline", ...}.

Baseline: the reference is a real-time system driven at 10 Hz frame cadence
(kitti_config.yaml freq: 10; BASELINE.md "Front-end cadence") with no
published throughput numbers, so vs_baseline = frames_per_s / 10.0 — how many
times faster than the reference's real-time requirement the fused pipeline
runs the same per-frame work at KITTI HDL-64 scale.
"""
from __future__ import annotations

import json
import time

import numpy as np


def bench_lidar_odometry(n_frames=24, warmup=3):
    import jax
    import jax.numpy as jnp

    from vil_fusion_tpu.models import lidar_features as lf
    from vil_fusion_tpu.models import lidar_odometry as lo
    from vil_fusion_tpu.runtime import sim

    cfg = lo.OdomConfig(
        lidar=lf.LidarConfig(n_scan=64, width=1800, fov_up_deg=2.0,
                             fov_down_deg=-24.8, edge_cap=2048, surf_cap=8192),
        edge_map_cap=16384, surf_map_cap=32768)
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=2.0))

    scans = []
    for i in range(6):
        R = traj.rotation(i * 0.1)
        p = traj.position(i * 0.1) + np.array([0, 0, 1.5])
        pts, val = sim.simulate_lidar_scan(
            scene, R, p, n_scan=64, width=1800, fov_up_deg=2.0,
            fov_down_deg=-24.8, max_range=80.0)
        scans.append((jnp.asarray(pts), jnp.asarray(val)))

    state = lo.init_state(cfg)
    # warmup / compile
    for i in range(warmup):
        state, out = lo.odometry_step(state, *scans[i % len(scans)], cfg)
    np.asarray(out[1])

    # bounded-depth pipelined measurement: a host sync every frame-minus-2
    # keeps at most 2 frames in flight (deployment-shaped double buffering)
    inflight = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        state, out = lo.odometry_step(state, *scans[i % len(scans)], cfg)
        inflight.append(out[1])
        if len(inflight) > 2:
            np.asarray(inflight.pop(0))
    for x in inflight:
        np.asarray(x)
    dt = time.perf_counter() - t0
    return n_frames / dt


def _chained_stage_breakdown(pipe, frames, n=10,
                             stages=("tracker", "lidar_odometry", "estimator",
                                     "full_frame_program")):
    """Honest per-stage DEVICE ms via chained calls (each call's carried
    state feeds the next, so async dispatch cannot hide sequential cost —
    the GLOBAL_TIMERS numbers only time ENQUEUE under sync_depth>0 and say
    nothing about where device time goes). Uses the
    already-compiled programs of a driven pipeline, so it costs ~n frames."""
    import jax
    import jax.numpy as jnp

    from vil_fusion_tpu.models import estimator as est_mod
    from vil_fusion_tpu.models import lidar_odometry as lo
    from vil_fusion_tpu.models import tracker as trk
    from vil_fusion_tpu.runtime.pipeline import _vil_frame_program

    imgs = [jnp.asarray(f[2]) for f in frames[-4:]]
    scans = [(jnp.asarray(f[3], jnp.float32), jnp.asarray(f[4]))
             for f in frames[-4:]]
    # the deployed fused program's variant is selected by the scan dtype:
    # quantized rigs upload int16 + bit-packed validity (push_scan). Feed the
    # SAME representation here or the breakdown would compile (and measure) a
    # second, undeployed f32 variant of the whole frame program.
    if pipe.scan_quant:
        scans_q = [(jnp.asarray(np.clip(np.round(
                        np.asarray(f[3]) * (1.0 / pipe.scan_quant)),
                        -32767, 32767).astype(np.int16)),
                    jnp.asarray(np.packbits(np.asarray(f[4], bool))))
                   for f in frames[-4:]]
    else:
        scans_q = scans
    est = pipe.estimator
    cam, tcfg, lcfg, ecfg = pipe.cam, pipe.tracker_cfg, pipe.lidar_cfg, pipe.est_cfg
    t, imu, img, pts, val = frames[-1]
    acc = np.asarray(imu[1][1:])
    gyr = np.asarray(imu[2][1:])
    dts = np.diff(imu[0])
    acc_b, gyr_b, dt_b, n_imu = est._pack_imu(acc, gyr, dts)
    blk = np.zeros((acc_b.shape[0] + 1, 7), np.float32)
    blk[:-1, 0:3] = acc_b
    blk[:-1, 3:6] = gyr_b
    blk[:len(dt_b), 6] = dt_b
    blk[-1, :5] = (1.0, len(dts), 0.0, pipe.scan_quant,
                   pipe.rig.depth_min_incidence)
    imu_hdr = jnp.asarray(blk)
    acc_b, gyr_b, dt_b = jnp.asarray(acc_b), jnp.asarray(gyr_b), jnp.asarray(dt_b)

    def chained(step_fn, state0):
        s = state0
        for i in range(2):
            s = step_fn(s, i)
        jax.block_until_ready(s)
        t0 = time.perf_counter()
        for i in range(n):
            s = step_fn(s, i)
        jax.block_until_ready(s)
        return (time.perf_counter() - t0) / n * 1e3

    out = {}
    if "tracker" in stages:
        out["tracker"] = chained(
            lambda s, i: trk.track_step(s, imgs[i % 4], jnp.float32(i * 0.1),
                                        cam, tcfg, key=jax.random.PRNGKey(i))[0],
            pipe.tracker_state)
    if "lidar_odometry" in stages:
        out["lidar_odometry"] = chained(
            lambda s, i: lo.odometry_step(s, *scans[i % 4], lcfg)[0],
            pipe.lidar_state)

    _, obs = trk.track_step(pipe.tracker_state, imgs[0], jnp.float32(0.0),
                            cam, tcfg, key=jax.random.PRNGKey(0))

    def est_step(s, i):
        window, feats, pre, lidarc, prior = s
        window, feats, pre, lidarc, prior, _ = est_mod.fused_full_step(
            window, feats, pre, lidarc, prior,
            acc_b, gyr_b, dt_b, jnp.int32(len(dts)),
            obs["ids"], obs["xy"], obs["vel"],
            jnp.zeros((tcfg.cap,), jnp.float32), jnp.zeros((tcfg.cap,), jnp.float32),
            jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.asarray(True), jnp.asarray(True), ecfg)
        return (window, feats, pre, lidarc, prior)
    if "estimator" in stages:
        out["estimator"] = chained(
            est_step, (est.window, est.feats, est.pre, est.lidar, est.prior))

    def full_step(s, i):
        r = _vil_frame_program(
            *s, imgs[i % 4], *scans_q[i % 4], imu_hdr,
            pipe.q_il, pipe.t_il, pipe.q_li, pipe.t_li,
            pipe.q_cl, pipe.t_cl,
            cam, tcfg, lcfg, ecfg)
        return r[:7]
    if "full_frame_program" in stages:
        out["full_frame_program"] = chained(
            full_step, (pipe.tracker_state, pipe.lidar_state, est.window,
                        est.feats, est.pre, est.lidar, est.prior))
    return {k: round(v, 2) for k, v in out.items()}


def bench_vil_pipeline(n_frames=40, warmup=26, passes=3):
    # warmup must cover the FIRST steady-state frame (the fused estimator
    # step compiles there, ~20-40 s) and the first global-graph optimize
    # (every 8 keyframes), or their compiles pollute the timed region.
    """PRIMARY metric: the full camera+IMU+LiDAR deployment pipeline — the
    thing that IS VIL_Fusion (launch/run_fusion.launch) — at KITTI scale:
    1226x370 image, HDL-64 64x1800 scan, 200 Hz IMU, 10 Hz frame cadence.

    Drives the actual VILFusionPipeline with sync_depth=2 (cross-frame stage
    overlap; one batched device_get per frame = bounded-depth pipelining).

    The timed region runs `passes` times on the warmed pipeline and the
    MEDIAN is the headline, so one bad sample cannot decide the record. Each
    pass drains the in-flight frames before stopping its clock so passes
    are independent.
    Returns (median_fps, all pass fps, per-stage mean ms, device stage ms)."""
    import jax
    import numpy as np

    from vil_fusion_tpu.runtime import sim
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu.utils.tracing import GLOBAL_TIMERS

    R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    H, W = 370, 1226  # KITTI image size
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
    pipe = VILFusionPipeline(rig, mode="vil", sync_depth=2,
                         scan_quant=0.0025)

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))  # urban KITTI pace
    frame_dt = 0.1
    t0 = 1.0
    q0, p0 = traj.pose(t0)
    pipe.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0,
                                     v=traj.velocity(t0))

    # pre-generate all sensor data (host) so the loop times only the pipeline
    frames = []
    total = warmup + passes * n_frames
    for i in range(total):
        t = t0 + i * frame_dt
        imu = sim.simulate_imu(traj, t - frame_dt, t, 200.0) if i else None
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        # sensor-native uint8 upload: the tracker normalizes on device;
        # f32 pixels quadruple the per-frame host->device payload
        img = np.clip(np.asarray(sim.render_camera_image(
            scene, R_wb @ R_BC, p_wb, FX, FY, CX, CY, H, W)) * 255.0 + 0.5,
            0, 255).astype(np.uint8)
        pts, val = sim.simulate_lidar_scan(
            scene, R_wb, p_wb, n_scan=64, width=1800, fov_up_deg=2.0,
            fov_down_deg=-24.8, max_range=80.0)
        frames.append((t, imu, img, np.asarray(pts), np.asarray(val)))

    def feed(frame):
        t, imu, img, pts, val = frame
        if imu is not None:
            ts_i, acc, gyr = imu
            pipe.push_imu_batch(ts_i[1:], acc[1:], gyr[1:])
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)

    for f in frames[:warmup]:
        feed(f)
    while len(pipe._pending) > 0:
        pipe._complete_frame(pipe._pending.pop(0))
    # compile the gate-dependent rare-event programs (first ICP verification,
    # first graph relaxation) BEFORE the timed region: on a cold compile
    # cache their compiles would otherwise land inside it whenever a loop
    # candidate first fires mid-measurement
    if pipe.fusion is not None:
        pipe.fusion.prewarm()
    GLOBAL_TIMERS.reset()
    pass_fps = []
    for k in range(passes):
        chunk = frames[warmup + k * n_frames: warmup + (k + 1) * n_frames]
        t_start = time.perf_counter()
        for f in chunk:
            feed(f)
        while len(pipe._pending) > 0:  # drain so passes are independent
            pipe._complete_frame(pipe._pending.pop(0))
        pass_fps.append(n_frames / (time.perf_counter() - t_start))
    pipe.finalize()
    stages = {k: round(v["mean_ms"], 2)
              for k, v in GLOBAL_TIMERS.summary().items()}
    device_ms = _chained_stage_breakdown(pipe, frames)
    return float(np.median(pass_fps)), pass_fps, stages, device_ms


def bench_ba(n_solves=10, warmup=2):
    import jax

    import __graft_entry__ as ge
    from vil_fusion_tpu.models import ba

    cfg = ba.BAConfig(max_iters=8)
    state, feats, pre, lidar, prior = ge._example_problem(f_cap=128)
    for _ in range(warmup):
        out = ba.optimize(state, feats, pre, lidar, prior, cfg)
    np.asarray(out[2])
    t0 = time.perf_counter()
    for _ in range(n_solves):
        out = ba.optimize(state, feats, pre, lidar, prior, cfg)
        np.asarray(out[2])  # per-solve host sync
    dt = time.perf_counter() - t0
    return n_solves * cfg.max_iters / dt


def main():
    import subprocess
    import sys

    import jax

    from vil_fusion_tpu.utils.compile_cache import use_compile_cache

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX found platform "
                 f"{jax.default_backend()!r}")
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {smi}", flush=True)
    use_compile_cache()
    vil_fps, pass_fps, stages, device_ms = bench_vil_pipeline()
    lidar_fps = bench_lidar_odometry()
    ba_iters_per_s = bench_ba()
    if vil_fps < 10.0:
        print(f"\n*** BELOW REAL-TIME BUDGET: {vil_fps:.2f} fps < the "
              f"reference's 10 Hz frame cadence (kitti_config freq: 10) "
              f"***\n", file=sys.stderr, flush=True)
    # solver time-boxing check (the reference bounds BA by wall clock,
    # max_solver_time=0.04 s, estimator.cpp:843-850; this design uses fixed
    # iteration counts instead — this verifies the chosen budgets
    # actually keep the whole fused frame inside the 100 ms frame period)
    ffp = device_ms.get("full_frame_program")
    if ffp is not None and ffp > 100.0:
        print(f"\n*** FRAME BUDGET EXCEEDED ON DEVICE: fused frame program "
              f"{ffp:.1f} ms > the 100 ms frame period — lower the fixed "
              f"iteration budgets (BAConfig.max_iters / OdomConfig.n_outer/"
              f"n_inner / KLT iters) ***\n", file=sys.stderr, flush=True)
    stage_str = " ".join(f"{k}={v}ms" for k, v in sorted(stages.items()))
    dev_str = " ".join(f"{k}={v}ms" for k, v in device_ms.items())
    passes_r = [round(x, 2) for x in pass_fps]
    print(json.dumps({
        "metric": "vil_pipeline_frames_per_s",
        "value": round(vil_fps, 3),
        "unit": ("frames/s (median of %d timed passes %s — full camera+IMU+"
                 "LiDAR deployment pipeline, KITTI scale, sync_depth=2; "
                 "device stage ms (chained): %s; "
                 "host: %s; aux: lidar_only_fps=%.2f ba_iters_per_s=%.1f)"
                 ) % (len(passes_r), passes_r, dev_str, stage_str, lidar_fps,
                      ba_iters_per_s),
        "vs_baseline": round(vil_fps / 10.0, 3),
        "pass_fps": passes_r,
        "device_stage_ms": device_ms,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
