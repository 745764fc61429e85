#!/usr/bin/env python
"""Smoke test of the VIL frame pipeline on one NVIDIA GPU.

    python chip_smoke.py              # phases a-e on one card
    python chip_smoke.py --multichip  # the sharded paths on four cards

Phases (one JAX process; any failure exits non-zero):
  a  device check: JAX must report the GPU backend; prints the card's name
     and power limit (nvidia-smi).
  b  kNN check: the GPU kNN path against a float64 NumPy brute force at the
     three main-path shapes (surf pass, edge pass, depth association), with
     the per-call time of the fused kernel and of the XLA form.
  c  BA precision: the f32 Schur step against the f64 golden on the
     ill-conditioned window of tests/test_precision.py, under the package's
     matmul-precision policy.
  d  pipeline: VILFusionPipeline(mode="vil", sync_depth=2,
     scan_quant=0.0025) on simulated KITTI-shaped frames (1226x370 uint8
     image, HDL-64 64x1800 scan, 200 Hz IMU, 10 Hz) past initialization into
     the fused frame program, keyframes into global fusion, then
     GlobalFusion.prewarm(). Asserts no restarts, a finite trajectory and
     VIO / lidar ATE under ATE_BOUND_M.
  e  bench paths: one short pass each of bench.py's lidar-only odometry and
     BA benchmarks.

Earlier lines carry the numbers worth keeping; the last line is one JSON
object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Phase d bounds on the ATE (m, Umeyama-aligned RMSE) of the VIO and lidar
# trajectories against the simulator's ground truth over PIPE_FRAMES frames
# (~48 m of urban driving at 8 m/s). A CPU rehearsal of this phase at the
# same shapes (JAX_PLATFORMS=cpu) measured VIO 0.168 m and lidar 0.027 m;
# the bounds give about 3x headroom for the GPU's other summation order and
# its TF32 image convolutions (the H100 measured 0.24-0.25 and 0.023-0.025).
PIPE_FRAMES = 60
ATE_BOUND_M = {"vio": 0.5, "lidar": 0.1}

# kNN tolerances against the float64 brute force: map-range distances
# (metres^2) and unit-sphere distances (depth association)
KNN_TOL_MAP = (1e-3, 1e-4)  # atol + rtol * d
KNN_TOL_SPHERE = 1e-6

_COMPILE_S = [0.0]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A phase's verdict (not an assert: it must hold under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _on_event(event: str, duration: float, **_) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE_S[0] += duration


def _phase(name: str, fn, *args, **kw):
    """Run one phase; print its wall and XLA backend-compile seconds."""
    c0, t0 = _COMPILE_S[0], time.perf_counter()
    out = fn(*args, **kw)
    log(f"[{name}] wall {time.perf_counter() - t0:.1f} s, "
        f"compile {_COMPILE_S[0] - c0:.1f} s")
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device(n_devices: int = 1):
    """a: the GPU backend with at least `n_devices` cards, or exit."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found platform {backend!r}")
    devs = jax.devices()
    if len(devs) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs, found {len(devs)}")
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    log(f"nvidia-smi: {nvidia_smi()}")
    return devs


# ---------------------------------------------------------------------------
# b: kNN
# ---------------------------------------------------------------------------

def _brute_knn(q, db, valid, k, chunk=256):
    """float64 brute force: ascending (d2, idx) with d2 = inf where missing,
    and the (k+1)-th minus k-th neighbour distance per query."""
    q = q.astype(np.float64)
    db = db.astype(np.float64)
    out_d = np.empty((len(q), k + 1))
    out_i = np.empty((len(q), k + 1), np.int64)
    for a in range(0, len(q), chunk):
        d = ((q[a:a + chunk, None, :] - db[None]) ** 2).sum(-1)
        d[:, ~valid] = np.inf
        part = np.argpartition(d, k, axis=1)[:, :k + 1]
        dp = np.take_along_axis(d, part, 1)
        order = np.argsort(dp, axis=1, kind="stable")
        out_d[a:a + chunk] = np.take_along_axis(dp, order, 1)
        out_i[a:a + chunk] = np.take_along_axis(part, order, 1)
    return out_d[:, :k], out_i[:, :k], out_d[:, k] - out_d[:, k - 1]


def knn_cases(seed: int = 0):
    """The three main-path kNN shapes, built from simulated HDL-64 scans:
    surf pass (8192 x 32768, k=5), edge pass (2048 x 16384, k=5), depth
    association (~200 feature rays x the 115,200-point scan on the unit
    sphere, k=3). Map buffers are randomly ordered, as the voxel-hash map
    merge leaves them, with ~10% invalid slots."""
    from vil_fusion_tpu.runtime import sim

    rng = np.random.default_rng(seed)
    scene = sim.JaxRaycast(sim.RaycastScene())
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    scans = []
    for t in (1.0, 1.1):
        R, p = traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5])
        pts, val = sim.simulate_lidar_scan(
            scene, R, p, n_scan=64, width=1800, fov_up_deg=2.0,
            fov_down_deg=-24.8, max_range=80.0)
        pts = np.asarray(pts, np.float32) @ R.T.astype(np.float32) + p
        scans.append((pts.astype(np.float32), np.asarray(val, bool)))

    def map_case(n_q, n_map):
        (m_pts, m_val), (q_pts, q_val) = scans
        db = m_pts[rng.choice(np.flatnonzero(m_val), n_map, replace=False)]
        valid = rng.random(n_map) > 0.1
        q = q_pts[rng.choice(np.flatnonzero(q_val), n_q, replace=False)]
        return q, db, valid

    cases = {"surf": map_case(8192, 32768) + (5,),
             "edge": map_case(2048, 16384) + (5,)}
    # depth association: camera-frame cloud on the unit sphere, FOV-gated
    # exactly like models/depth_association.feature_depth
    R_BC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    pts, val = scans[1]
    R, p = traj.rotation(1.1), traj.position(1.1) + np.array([0, 0, 1.5])
    body = (pts - p) @ R.astype(np.float32)
    cam = body @ R_BC  # lidar == body frame; camera RDF
    z = cam[:, 2]
    ok = val & (z > 0.3)
    zs = np.where(ok, z, 1.0)
    ok &= (np.abs(cam[:, 0] / zs) < 1.3) & (np.abs(cam[:, 1] / zs) < 1.3)
    sphere = cam / np.maximum(np.linalg.norm(cam, axis=-1), 1e-6)[:, None]
    uv = rng.uniform([0, 0], [1226, 370], (200, 2))
    rays = np.concatenate([(uv - [607.19, 185.22]) / 718.856,
                           np.ones((200, 1))], -1)
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True))
    cases["depth"] = (rays.astype(np.float32), sphere.astype(np.float32),
                      ok, 3)
    return cases


def _time_call(fn, *args, n: int = 20):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_knn(cases=None, timing: bool = True):
    """b: fused GPU kNN vs float64 brute force at the main-path shapes;
    returns {case: max error stats and kernel / XLA ms}."""
    import jax
    import jax.numpy as jnp

    from vil_fusion_tpu.ops import knn as knn_xla
    from vil_fusion_tpu.ops.pallas import knn_pallas

    cases = cases or knn_cases()
    report = {}
    for name, (q, db, valid, k) in cases.items():
        args = (jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid))
        d, i = jax.device_get(knn_pallas.knn(*args, k=k))
        d_ref, i_ref, gap = _brute_knn(q, db, valid, k)
        if name == "depth":
            tol = np.full_like(d_ref, KNN_TOL_SPHERE)
        else:
            tol = KNN_TOL_MAP[0] + KNN_TOL_MAP[1] * d_ref
        fin = np.isfinite(d_ref)
        check((np.isfinite(d) == fin).all(), f"{name}: missing-neighbour mismatch")
        err = np.abs(d[fin] - d_ref[fin])
        check((err <= tol[fin]).all(),
              f"{name}: distance error {err.max():.3g} over tolerance")
        # neighbour sets must agree wherever the k-th/(k+1)-th gap exceeds
        # the tolerance (inside it, either choice is a correct answer)
        sure = gap > tol[:, -1]
        same = np.array([set(a) == set(b) for a, b in
                         zip(i[sure].tolist(), i_ref[sure].tolist())])
        check(same.all(), f"{name}: {int((~same).sum())} rows pick other neighbours")
        rec = dict(shape=f"{len(q)}x{len(db)} k={k}",
                   max_abs_err=float(err.max()) if err.size else 0.0,
                   rows_checked=int(sure.sum()), rows=len(q))
        if timing:
            rec["fused_ms"] = _time_call(
                lambda a, b, c: knn_pallas.knn_fused(a, b, c, k=k), *args)
            rec["xla_ms"] = _time_call(
                lambda a, b, c: knn_xla.knn(a, b, c, k=k), *args)
        log(f"knn {name}: {json.dumps(rec)}")
        report[name] = rec
    return report


# ---------------------------------------------------------------------------
# c: BA precision
# ---------------------------------------------------------------------------

def phase_precision():
    """c: f32 vs f64 BA step on the ill-conditioned window."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import test_precision

    rep = test_precision.f32_vs_f64_step()
    log(f"ba precision: {json.dumps(rep)}")
    failed = test_precision.f32_vs_f64_failures(rep)
    check(not failed, f"BA precision: {failed}")
    return rep


# ---------------------------------------------------------------------------
# d: pipeline
# ---------------------------------------------------------------------------

R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
# KITTI camera (1226x370) and HDL-64 ring model (64x1800, +2..-24.8 deg)
KITTI = dict(H=370, W=1226, fx=718.856, cx=607.19, cy=185.22, max_cnt=150,
             min_dist=30, n_scan=64, width=1800, fov_up=2.0, fov_down=-24.8)


def make_rig(g=KITTI, name="kitti-smoke"):
    from vil_fusion_tpu.runtime import sim
    from vil_fusion_tpu.runtime.config import RigConfig

    return RigConfig(
        name=name,
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=g["fx"], fy=g["fx"],
                                               cx=g["cx"], cy=g["cy"]),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0,
                                               p2=0.0)),
        image_height=g["H"], image_width=g["W"],
        q_ic=sim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(R_BC.T), t_cl=np.zeros(3),
        max_cnt=g["max_cnt"], min_dist=g["min_dist"], n_scan=g["n_scan"],
        lidar_fov_up=g["fov_up"], lidar_fov_down=g["fov_down"],
        lidar_min_range=1.0, lidar_max_range=80.0, use_lidar=True)


def phase_pipeline(n_frames: int = PIPE_FRAMES, bounds=None, warmup: int = 26,
                   g=KITTI):
    """d: the deployed VIL pipeline on simulated frames of geometry `g`
    (KITTI-shaped by default; smaller only for CPU rehearsals). Returns
    (report, pipeline, last four frames as bench.py's tuples)."""
    from vil_fusion_tpu.runtime import sim, tum
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu.utils.tracing import GLOBAL_TIMERS

    bounds = ATE_BOUND_M if bounds is None else bounds
    GLOBAL_TIMERS.reset()
    pipe = VILFusionPipeline(make_rig(g), mode="vil", sync_depth=2,
                             scan_quant=0.0025)
    odom_kw = dict(n_scan=g["n_scan"], width=g["width"],
                   fov_up_deg=g["fov_up"], fov_down_deg=g["fov_down"],
                   max_range=80.0)
    scene = sim.JaxRaycast(sim.RaycastScene())
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    frame_dt, t0 = 0.1, 1.0
    q0, p0 = traj.pose(t0)
    pipe.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0,
                                     v=traj.velocity(t0))
    gt, n_tracked, tail = {}, [], []
    c0, t_wall = _COMPILE_S[0], time.perf_counter()
    for i in range(n_frames):
        t = t0 + i * frame_dt
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        gt[round(t, 6)] = p_wb
        if i:
            ts_i, acc, gyr = sim.simulate_imu(traj, t - frame_dt, t, 200.0)
            pipe.push_imu_batch(ts_i[1:], acc[1:], gyr[1:])
        img = np.clip(np.asarray(sim.render_camera_image(
            scene, R_wb @ R_BC, p_wb, g["fx"], g["fx"], g["cx"], g["cy"],
            g["H"], g["W"])) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        pts, val = sim.simulate_lidar_scan(scene, R_wb, p_wb, **odom_kw)
        pts, val = np.asarray(pts), np.asarray(val)
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
        if i:
            tail = (tail + [(t, (ts_i, acc, gyr), img, pts, val)])[-4:]
        n_tracked.append(int(np.asarray(pipe.tracker_state.valid).sum()))
        if i + 1 == warmup:
            pipe._drain_pending()
            check(pipe.fusion.n_kf >= 1, "no keyframe reached global fusion")
            pipe.fusion.prewarm()
            log(f"pipeline warmup ({warmup} frames): "
                f"{time.perf_counter() - t_wall:.1f} s, compile "
                f"{_COMPILE_S[0] - c0:.1f} s")
            t_steady = time.perf_counter()
    pipe.finalize()
    steady_s = time.perf_counter() - t_steady
    out = pipe.outputs
    vio = np.stack(out.vio_p)
    lidar = np.stack(out.lidar_p)
    ini = np.asarray(out.initialized, bool)
    gt_p = np.stack([gt[round(t, 6)] for t in out.ts])
    fused = GLOBAL_TIMERS.summary().get("vil_fused_frame", {}).get("n", 0)
    rep = dict(
        frames=len(out.ts), fused_frames=int(fused),
        keyframes=int(pipe.fusion.n_kf), restarts=pipe.restarts,
        ate_vio_m=tum.ate_rmse(vio[ini], gt_p[ini]),
        ate_lidar_m=tum.ate_rmse(lidar, gt_p),
        tracked_min=min(n_tracked[3:]), tracked_mean=float(np.mean(n_tracked)),
        steady_frames_per_s_host=(n_frames - warmup) / steady_s)
    log(f"pipeline: {json.dumps(rep)}")
    check(pipe.restarts == 0, f"estimator restarted: {pipe.restart_log}")
    check(np.isfinite(vio).all() and np.isfinite(lidar).all(),
          "non-finite trajectory")
    check(rep["frames"] == n_frames and ini[warmup:].all(), rep)
    check(fused >= n_frames - warmup, "fused frame program did not run")
    check(rep["ate_vio_m"] < bounds["vio"], rep)
    check(rep["ate_lidar_m"] < bounds["lidar"], rep)
    return rep, pipe, tail


# ---------------------------------------------------------------------------
# e: bench paths
# ---------------------------------------------------------------------------

def phase_bench():
    """e: one short pass of bench.py's lidar-only and BA paths."""
    import bench

    fps = bench.bench_lidar_odometry(n_frames=6, warmup=2)
    ips = bench.bench_ba(n_solves=3, warmup=1)
    rep = dict(lidar_odometry_frames_per_s=fps, ba_iters_per_s=ips)
    log(f"bench: {json.dumps(rep)}")
    check(np.isfinite(fps) and fps > 0 and np.isfinite(ips) and ips > 0, rep)
    return rep


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_sharded_odometry(n_seq: int = 4, n_frames: int = 3, cfg=None):
    """Sequence-sharded odometry over `n_seq` cards against
    lidar_odometry.odometry_step per sequence on one card. Default `cfg`:
    HDL-64 widths (smaller only for CPU rehearsals)."""
    import jax
    import jax.numpy as jnp

    from vil_fusion_tpu.models import lidar_odometry as lo
    from vil_fusion_tpu.parallel import batched_odometry as bo
    from vil_fusion_tpu.parallel import mesh as mesh_mod
    from vil_fusion_tpu.runtime import sim

    mesh = mesh_mod.make_mesh(n_seq)
    # default: HDL-64 64x1800, 2048/8192 features, 16k/32k maps
    cfg = cfg or lo.OdomConfig()
    lc = cfg.lidar
    n_pts = lc.n_scan * lc.width
    scene = sim.JaxRaycast(sim.RaycastScene())
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    scans = np.zeros((n_frames, n_seq, n_pts, 3), np.float32)
    vals = np.zeros((n_frames, n_seq, n_pts), bool)
    for f in range(n_frames):
        for s in range(n_seq):
            t = 1.0 + 2.0 * s + 0.1 * f  # each sequence its own stretch
            pts, val = sim.simulate_lidar_scan(
                scene, traj.rotation(t),
                traj.position(t) + np.array([0, 0, 1.5]), n_scan=lc.n_scan,
                width=lc.width, fov_up_deg=lc.fov_up_deg,
                fov_down_deg=lc.fov_down_deg, max_range=80.0)
            scans[f, s], vals[f, s] = np.asarray(pts), np.asarray(val)
    states = bo.shard_states(mesh, lo.init_state_batched(cfg, n_seq))
    for f in range(n_frames):
        states, (q_sh, p_sh, _, _) = bo.odometry_step_sharded(
            mesh, states, jnp.asarray(scans[f]), jnp.asarray(vals[f]), cfg)
    q_sh, p_sh = np.asarray(q_sh), np.asarray(p_sh)
    dev0 = jax.devices()[0]
    dp = dq = 0.0
    for s in range(n_seq):
        st = jax.device_put(lo.init_state(cfg), dev0)
        for f in range(n_frames):
            st, (q1, p1, _, _) = lo.odometry_step(
                st, jax.device_put(scans[f, s], dev0),
                jax.device_put(vals[f, s], dev0), cfg)
        dp = max(dp, float(np.abs(np.asarray(p1) - p_sh[s]).max()))
        dq = max(dq, float(np.abs(np.asarray(q1) - q_sh[s]).max()))
    moved = float(np.linalg.norm(p_sh, axis=-1).min())
    rep = dict(sequences=n_seq, frames=n_frames, max_dp_m=dp, max_dq=dq,
               min_travel_m=moved, devices=int(mesh.devices.size))
    log(f"sharded odometry vs one card: {json.dumps(rep)}")
    # every sequence registered real motion (8 m/s x 0.1 s per frame)
    check(moved > 0.4 * (n_frames - 1), rep)
    check(dp < 1e-3 and dq < 1e-4, rep)
    return rep


def phase_multichip(n: int = 4):
    import __graft_entry__

    __graft_entry__.dryrun_multichip(n)
    return phase_sharded_odometry(n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    n_cards = 4 if args.multichip else 1
    devs = phase_device(n_cards)

    import jax

    import vil_fusion_tpu  # noqa: F401  (matmul-precision policy)
    from vil_fusion_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    if args.multichip:
        _phase("multichip", phase_multichip, n_cards)
    else:
        _phase("b knn", phase_knn)
        _phase("c ba-precision", phase_precision)
        _phase("d pipeline", phase_pipeline)
        _phase("e bench", phase_bench)
    log(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
