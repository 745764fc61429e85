"""The full VIL-Fusion pipeline: sensors in, trajectories out.

Rebuild of the reference's 5-process ROS graph as a single-controller
frame-synchronous pipeline (SURVEY §2.3):

  camera ─┐                 ┌─ tracker (KLT+RANSAC) ── features ─┐
  lidar ──┼─ sync (±0.03 s) ┼─ feature extraction + scan-to-map ─┼─ estimator ─ odometry ─ global fusion
  imu ────┘                 └─ depth association (unit sphere) ──┘

Replaces: feature_tracker_node.cpp processing() :218-477 (sync + front end),
estimator_node.cpp process() :419+ (measurement bundling), and the
poseGraphOptimization node (global graph). The ROS topics become host-side
queues; every compute stage is a jitted fixed-shape call.

Failure handling (SURVEY §5): estimator failureDetection triggers a full
clearState-style reboot seeded from the LiDAR odometry pose; a camera-stream
gap triggers the `restart` path (restart_callback analog).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import ba
from vil_fusion_tpu.models import cameras as cam_mod
from vil_fusion_tpu.models import depth_association
from vil_fusion_tpu.models import estimator as est_mod
from vil_fusion_tpu.models import global_fusion as gf
from vil_fusion_tpu.models import lidar_features as lf
from vil_fusion_tpu.models import lidar_odometry as lo
from vil_fusion_tpu.models import tracker as trk
from vil_fusion_tpu.ops import lie
from vil_fusion_tpu.runtime import tum
from vil_fusion_tpu.runtime.config import RigConfig
from vil_fusion_tpu.utils.tracing import GLOBAL_TIMERS


# -- tiny numpy quaternion kit for the host-side high-rate propagator --------
# (the IMU-rate predict() path runs at 100-500 Hz; device dispatches there
# would dominate deployment latency, so it is pure numpy)
def _np_qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _np_qrot(q, v):
    w, xyz = q[0], q[1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _np_so3_exp_q(phi):
    a = np.linalg.norm(phi)
    if a < 1e-8:
        q = np.array([1.0, 0.5 * phi[0], 0.5 * phi[1], 0.5 * phi[2]])
    else:
        q = np.concatenate([[np.cos(0.5 * a)], np.sin(0.5 * a) * phi / a])
    return q / np.linalg.norm(q)


def _np_q2R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _np_R2q(R):
    w = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                  (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    return q / np.linalg.norm(q)


def _np_propagate(p, q, v, ba_, bg_, acc0, gyr0, acc1, gyr1, dt, g):
    """numpy mirror of imu.propagate_state (estimator_node.cpp predict :44-80)."""
    un_gyr = 0.5 * (gyr0 + gyr1) - bg_
    q_new = _np_qmul(q, _np_so3_exp_q(un_gyr * dt))
    q_new = q_new / np.linalg.norm(q_new)
    un_acc = 0.5 * (_np_qrot(q, acc0 - ba_) + _np_qrot(q_new, acc1 - ba_)) - g
    p_new = p + v * dt + 0.5 * un_acc * dt * dt
    v_new = v + un_acc * dt
    return p_new, q_new, v_new


import functools


@functools.partial(jax.jit, static_argnames=("n",))
def _dequant_scan(pts_i16, val_packed, quant, n: int):
    pts = pts_i16.astype(jnp.float32) * quant
    bits = (val_packed[:, None] >> jnp.arange(8, dtype=val_packed.dtype)) & 1
    # numpy packbits is MSB-first
    val = (bits[:, ::-1].reshape(-1) > 0)[:n]
    return pts, val


@functools.partial(jax.jit, static_argnames=("cam", "tcfg", "lcfg", "ecfg"))
def _vil_frame_program(tracker_state, lidar_state,
                       window, feats, pre, lidarc, prior,
                       img, pts, val, imu_hdr,
                       q_il, t_il, q_li, t_li, q_cl, t_cl,
                       cam, tcfg, lcfg, ecfg):
    """The ENTIRE steady-state vil frame as ONE XLA program: tracker ->
    lidar odometry -> extrinsic glue -> depth association -> fused estimator
    step (IMU/ingest/triangulate/BA/marginalize/slide).

    Why: under dispatch latency the five per-stage dispatches dominate
    the frame budget; fusing them into one program makes
    a vil frame cost the same round trip as a single stage. This is the end
    state of the SURVEY §7 'frame-synchronous pipeline of jitted stages' —
    the stages still exist as functions, the deployment composes them into
    one device program per frame (the reference's per-frame work across its
    4 processes, launch/run_fusion.launch:13-36, with the process hops
    compiled away).

    Per-frame host->device traffic is FOUR uploads: img (uint8), pts, val,
    and `imu_hdr` — a (imu_cap+1, 7) f32 block whose rows [:cap] carry
    [acc | gyr | dt] and whose LAST row is the frame header
    [t, n_imu, tsh_scale (rolling-shutter readout scale TR/ROW), quant].
    Every other per-frame scalar (timestamp, RNG key, counts) is derived
    in-program: each additional small upload costs a transfer's fixed
    latency. Scan dequantization (int16
    fixed-point + bit-packed validity, see push_scan) happens here too —
    the dtype of `pts` selects the variant at trace time — and the f32
    cloud is returned for global fusion, so no separate dequant dispatch."""
    hdr = imu_hdr[-1]
    t = hdr[0]
    n_imu = hdr[1].astype(jnp.int32)
    tsh_scale = hdr[2]
    # acc/gyr fill rows [:cap]; dt is (cap-1,) by _pack_imu's contract
    acc_b, gyr_b, dt_b = imu_hdr[:-1, 0:3], imu_hdr[:-1, 3:6], imu_hdr[:-2, 6]
    if pts.dtype == jnp.int16:  # static at trace time
        n = pts.shape[0]
        pts = pts.astype(jnp.float32) * hdr[3]
        bits = (val[:, None] >> jnp.arange(8, dtype=val.dtype)) & 1
        val = (bits[:, ::-1].reshape(-1) > 0)[:n]  # numpy packbits: MSB-first
    key = jax.random.PRNGKey(jnp.floor(t * 1e3).astype(jnp.int32)
                             & 0x7FFFFFFF)
    tracker_state, obs = trk.track_step(tracker_state, img, t, cam, tcfg,
                                        key=key)
    lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(lidar_state, pts, val,
                                                       lcfg)
    # lidar relative pose through the extrinsics into the IMU frame
    # (lidar_factor.h composition) + cloud into the camera frame
    qt, pt = lie.pose_compose((q_il, t_il), (lqr, lpr))
    q_imu, p_imu = lie.pose_compose((qt, pt), (q_li, t_li))
    cloud_cam = lie.qrot(q_cl[None, :], pts) + t_cl[None, :]
    depth, _ok = depth_association.feature_depth(
        obs["xy"], obs["valid"], cloud_cam, val, min_incidence=hdr[4])
    # rolling-shutter readout shift TR*(row-ROW/2)/ROW; tsh_scale = TR/ROW
    # (zero for global-shutter rigs)
    tsh = tsh_scale * (obs["uv"][:, 1] - 0.5 * img.shape[0])
    window, feats, pre, lidarc, prior, out = est_mod.fused_full_step(
        window, feats, pre, lidarc, prior,
        acc_b, gyr_b, dt_b, n_imu,
        obs["ids"], obs["xy"], obs["vel"], depth, tsh,
        q_imu, p_imu, jnp.asarray(True), jnp.asarray(True), ecfg)
    return (tracker_state, lidar_state, window, feats, pre, lidarc, prior,
            out, lq, lp, obs["ids"], depth, pts, val)


@dataclass
class PipelineOutputs:
    ts: list = field(default_factory=list)
    vio_p: list = field(default_factory=list)  # no-loop trajectory
    vio_q: list = field(default_factory=list)
    loop_p: list = field(default_factory=list)  # drift-corrected (visual loop)
    loop_q: list = field(default_factory=list)
    lidar_p: list = field(default_factory=list)
    lidar_q: list = field(default_factory=list)
    # per-frame attachment to the latest visual-loop keyframe: index into the
    # keyframe DB plus the frame's pose relative to that keyframe at output
    # time — lets rebuild_loop_path() rewrite the whole past trajectory from
    # the optimized 4-DoF graph (pose_graph.cpp updatePath: every keyframe
    # pose is refreshed after optimize4DoF and intermediate frames ride
    # their keyframe)
    anchor_kf: list = field(default_factory=list)
    anchor_rel: list = field(default_factory=list)  # (R_rel, p_rel) or None
    # per-frame estimator-initialized flag: the reference publishes VIO
    # odometry only in NON_LINEAR state (pubOdometry, visualization.cpp) —
    # pre-initialization rows are excluded from the VIO trajectories/ATE
    initialized: list = field(default_factory=list)

    def rebuild_loop_path(self, db):
        """Rewrite loop_p/loop_q retroactively from the optimized keyframe
        poses (reference pose_graph.cpp updatePath). Idempotent: anchor_rel
        is immutable, db.q/db.p are the current optimized poses."""
        if db is None or not self.anchor_kf:
            return
        for k, (a, rel) in enumerate(zip(self.anchor_kf, self.anchor_rel)):
            if a < 0 or rel is None:
                continue
            R_a = _np_q2R(np.asarray(db.q[a], np.float64))
            R_rel, p_rel = rel
            R_k = R_a @ R_rel
            self.loop_p[k] = R_a @ p_rel + np.asarray(db.p[a], np.float64)
            self.loop_q[k] = _np_R2q(R_k)

    def write(self, out_dir: str, fusion: Optional[gf.GlobalFusion] = None):
        """The reference's three TUM outputs (vins_result_no_loop,
        vins_result_loop, fs_loam_loop)."""
        import os

        os.makedirs(out_dir, exist_ok=True)
        ini = self.initialized or [True] * len(self.ts)
        sel = [k for k, ok in enumerate(ini) if ok]
        tum.write_tum(os.path.join(out_dir, "vins_result_no_loop.txt"),
                      [self.ts[k] for k in sel], [self.vio_p[k] for k in sel],
                      [self.vio_q[k] for k in sel])
        if self.loop_p:
            tum.write_tum(os.path.join(out_dir, "vins_result_loop.txt"),
                          [self.ts[k] for k in sel],
                          [self.loop_p[k] for k in sel],
                          [self.loop_q[k] for k in sel])
        tum.write_tum(os.path.join(out_dir, "lidar_odometry.txt"),
                      self.ts, self.lidar_p, self.lidar_q)
        if fusion is not None and fusion.n_kf:
            q_all, p_all = fusion.poses()
            tum.write_tum(os.path.join(out_dir, "fs_loam_loop.txt"),
                          fusion.kf_ts, p_all, q_all)


class VILFusionPipeline:
    """Modes: "vil" (full), "vio" (no lidar), "lidar" (lidar-only odometry),
    "mask" (dynamic-scene VIO with mask gating, no lidar) — the reference's
    four executables (SURVEY §2.1)."""

    SYNC_WINDOW = 0.03  # camera-lidar pairing (feature_tracker_node.cpp:225)
    CAMERA_GAP_RESTART = 1.0  # stream watchdog (restart path)
    # steady-state vil frames run as ONE device program (_vil_frame_program);
    # False falls back to per-stage dispatches (A/B and debugging)
    FUSE_FRAMES = True

    def __init__(self, rig: RigConfig, mode: str = "vil",
                 f_cap: int = 128, sc_capacity: int = 1024,
                 visual_loop: bool = False, gf_cfg=None, vl_cfg=None,
                 odom_overrides: Optional[dict] = None, sync_depth: int = 0,
                 ba_overrides: Optional[dict] = None, scan_quant: float = 0.0):
        self.rig = rig
        self.scan_quant = float(scan_quant)
        self.mode = mode
        self.cam = cam_mod.from_config(rig.camera)
        use_lidar = mode in ("vil", "lidar")

        # feature capacity: max_cnt live tracks + headroom for churn, rounded
        # to a lane-friendly multiple of 64. The old fixed 256 carried 106
        # dead slots through every KLT gather round at the default
        # max_cnt=150 — the tracker's cost is linear in cap (sequential
        # patch gathers), so shaving slack is a direct wall-clock cut.
        cap = max(-(-int(rig.max_cnt * 1.25) // 64) * 64, f_cap)
        self.tracker_cfg = trk.TrackerConfig(
            max_cnt=rig.max_cnt, min_dist=rig.min_dist, cap=cap,
            use_clahe=rig.equalize, f_thresh_px=rig.f_threshold,
            mask_gate=(mode == "mask"))
        self.tracker_state = trk.init_tracker(rig.image_height, rig.image_width,
                                              self.tracker_cfg)
        self.lidar_cfg = lo.OdomConfig(
            lidar=lf.LidarConfig(
                n_scan=rig.n_scan, width=1800 if rig.n_scan >= 64 else 900,
                min_range=rig.lidar_min_range, max_range=rig.lidar_max_range,
                fov_up_deg=rig.lidar_fov_up, fov_down_deg=rig.lidar_fov_down))
        if odom_overrides:
            lidar_kw = {k: v for k, v in odom_overrides.items()
                        if k in lf.LidarConfig._fields}
            odom_kw = {k: v for k, v in odom_overrides.items()
                       if k in lo.OdomConfig._fields}
            if lidar_kw:
                odom_kw["lidar"] = self.lidar_cfg.lidar._replace(**lidar_kw)
            self.lidar_cfg = self.lidar_cfg._replace(**odom_kw)
        self.lidar_state = lo.init_state(self.lidar_cfg)

        from vil_fusion_tpu.models.imu import ImuNoise

        # ba_overrides: deployment-mode BAConfig fields the rig YAML doesn't
        # carry — e.g. {"sharded": True} runs the LM loop landmark-sharded
        # over parallel.mesh.set_active_mesh()'s mesh (multi-chip deployment)
        self.est_cfg = est_mod.EstimatorConfig(
            ba=ba.BAConfig(
                use_lidar=use_lidar and mode == "vil",
                max_iters=rig.max_num_iterations,
                estimate_td=rig.estimate_td,
                estimate_extrinsic=rig.estimate_extrinsic,
                gravity=(0.0, 0.0, rig.g_norm),
                **(ba_overrides or {})),
            f_cap=f_cap, obs_cap=cap,  # == tracker cap (device handoff)
            imu_noise=ImuNoise(rig.acc_n, rig.gyr_n, rig.acc_w, rig.gyr_w),
            min_parallax=rig.keyframe_parallax / 460.0)
        self.estimator = est_mod.VILEstimator(self.est_cfg)
        self.estimator.set_extrinsics(qic=rig.q_ic, tic=rig.t_ic, td=rig.td)

        if gf_cfg is None:
            gf_cfg = gf.GlobalFusionConfig(
                keyframe_dist=rig.keyframe_meter_gap,
                keyframe_angle=np.deg2rad(rig.keyframe_deg_gap),
                sc_dist_thres=rig.sc_dist_thres,
                node_capacity=sc_capacity)
        self.fusion = gf.GlobalFusion(gf_cfg) if use_lidar else None

        # camera-lidar extrinsic (points lidar->camera)
        if rig.q_cl is not None:
            self.q_cl = jnp.asarray(rig.q_cl, jnp.float32)
            self.t_cl = jnp.asarray(rig.t_cl, jnp.float32)
        else:
            self.q_cl = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
            self.t_cl = jnp.zeros(3, jnp.float32)
        self.q_ic = jnp.asarray(rig.q_ic, jnp.float32)
        self.t_ic = jnp.asarray(rig.t_ic, jnp.float32)
        # constant composed extrinsics (hoisted: eager lie ops on the hot
        # path cost one device dispatch each)
        q_il, t_il = lie.pose_compose((self.q_ic, self.t_ic),
                                      (self.q_cl, self.t_cl))
        self.q_il, self.t_il = q_il, t_il
        self.q_li, self.t_li = lie.pose_inverse((q_il, t_il))

        @jax.jit
        def _lidar_glue(lqr, lpr, pts, q_il, t_il, q_li, t_li, q_cl, t_cl):
            qt, pt = lie.pose_compose((q_il, t_il), (lqr, lpr))
            q_imu, p_imu = lie.pose_compose((qt, pt), (q_li, t_li))
            cloud_cam = lie.qrot(q_cl[None, :], pts) + t_cl[None, :]
            return q_imu, p_imu, cloud_cam

        self._lidar_glue = _lidar_glue

        # visual loop closure (the dormant pose_graph node's capability,
        # SURVEY §1: place recognition + 4-DoF graph + drift feedback)
        self.visual_loop = None
        if visual_loop and mode in ("vil", "vio", "mask"):
            from vil_fusion_tpu.models import visual_loop as vl

            self.visual_loop = vl.VisualLoopDB(
                vl.VisualLoopConfig(capacity=sc_capacity) if vl_cfg is None else vl_cfg,
                qic=rig.q_ic, tic=rig.t_ic)
            self.loop_drift_R = np.eye(3, dtype=np.float32)
            self.loop_drift_t = np.zeros(3, np.float32)
            self._last_kf_p = None
            # worker thread: the reference runs visual loop closure as its
            # own PROCESS (sensor_fusion_pose_graph; pose_graph_node.cpp
            # process() thread) — keyframe BRIEF extraction, BoW query, PnP
            # verification and the 4-DoF solve all happen off the odometry
            # path, with relocalization results fed back asynchronously
            # (setReloFrame). Same architecture here: jobs carry the frame
            # snapshot, the worker's blocking device reads release the GIL,
            # and accepted drifts apply at the next completed frame.
            import queue as _queue
            import threading as _threading

            self._vl_lock = _threading.Lock()
            self._vl_jobs: Optional[_queue.Queue] = None
            self._vl_results = _queue.Queue()
            self._vl_idle = _threading.Event()
            self._vl_idle.set()
            if sync_depth > 0:
                self._vl_jobs = _queue.Queue()
                t = _threading.Thread(target=self._vl_worker, daemon=True,
                                      name="visual-loop-worker")
                t.start()

        # host-side queues ("topics")
        self.imu_buf: list = []  # (t, acc, gyr)
        self.image_buf: list = []
        self.scan_buf: list = []
        self.mask_buf: list = []
        self.last_image_t = None
        self.last_processed_t = None
        self.outputs = PipelineOutputs()
        self.restarts = 0
        # per-restart cause record: which failure_detection
        # predicate(s) fired / which watchdog, at what stream time, how long
        # after the estimator (re)initialized — dumped into acceptance
        # reports so restarts are diagnosable, not just counted
        self.restart_log: list = []
        self._init_t: Optional[float] = None  # last (re)initialization time

        # cross-frame stage overlap (the reference's 4 concurrent processes,
        # launch/run_fusion.launch:13-36, reborn as bounded-depth async
        # dispatch): with sync_depth=N the steady-state issue path enqueues
        # the whole frame program with ZERO host reads and the host-side
        # logic (failure detection, global fusion, visual loops, outputs)
        # completes N frames later. sync_depth=0 is fully synchronous.
        self.sync_depth = max(0, int(sync_depth))
        self._pending: list = []  # in-flight frame records
        self._gen = 0  # restart generation (stale in-flight frames skip logic)
        self._imu_hist: list = []  # retained samples for deferred hr reseed

    # ------------------------------------------------------------------
    def push_imu(self, t, acc, gyr):
        """Buffer the sample and return an IMU-rate pose estimate
        (pubLatestOdometry / predict(), estimator_node.cpp:44-80)."""
        self.imu_buf.append((float(t), np.asarray(acc), np.asarray(gyr)))
        # retained history for the deferred-sync reseed (re-propagation from
        # a frame solved sync_depth frames ago; estimator_node update() analog)
        self._imu_hist.append((float(t), np.asarray(acc, np.float64),
                               np.asarray(gyr, np.float64)))
        if len(self._imu_hist) > 4096:
            del self._imu_hist[:2048]
        return self._propagate_high_rate(float(t), np.asarray(acc), np.asarray(gyr))

    def push_imu_batch(self, ts, acc, gyr):
        """Feed a contiguous IMU segment in ONE call. The per-sample
        push_imu costs ~4 ms/frame of pure python overhead at 200 Hz under
        the deployment feed (20 calls x conversions); ROS delivered samples
        one callback at a time (estimator_node.cpp imu_callback :158-182) —
        a single-controller host can hand over the whole inter-frame batch.
        Returns the high-rate pose after the last sample (pubLatestOdometry
        semantics are preserved: propagation is still per-sample)."""
        ts = np.asarray(ts, np.float64)
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        rows = list(zip(ts.tolist(), acc, gyr))
        self.imu_buf.extend(rows)
        self._imu_hist.extend(rows)
        if len(self._imu_hist) > 4096:
            del self._imu_hist[:2048]
        out = None
        for k in range(len(rows)):
            out = self._propagate_high_rate(rows[k][0], acc[k], gyr[k])
        return out

    def _propagate_high_rate(self, t, acc, gyr):
        hr = getattr(self, "_hr", None)
        if hr is None or not self.estimator.initialized:
            return None
        dt = t - hr["t"]
        if dt <= 0 or dt > 1.0:
            self._hr = None
            return None
        g = np.asarray(self.estimator.gravity, np.float64)
        p, q, v = _np_propagate(
            hr["p"], hr["q"], hr["v"], hr["ba"], hr["bg"],
            hr["acc"], hr["gyr"], np.asarray(acc, np.float64),
            np.asarray(gyr, np.float64), dt, g)
        self._hr = dict(t=t, p=p, q=q, v=v, ba=hr["ba"], bg=hr["bg"],
                        acc=np.asarray(acc, np.float64),
                        gyr=np.asarray(gyr, np.float64))
        return self._hr["p"], self._hr["q"], self._hr["v"]

    def _reset_high_rate(self, t):
        """Re-seed the high-rate propagator from the latest solved state."""
        est = self.estimator
        slot = est_mod.K - 2 if est.frame_count >= est_mod.K - 1 else max(
            min(est.frame_count, est_mod.K - 1) - 1, 0)
        if self.imu_buf:
            acc, gyr = self.imu_buf[-1][1], self.imu_buf[-1][2]
        else:
            acc = np.asarray([0.0, 0, 9.81], np.float32)
            gyr = np.zeros(3, np.float32)
        self._hr = dict(
            t=t, p=np.asarray(est.window.p[slot]), q=np.asarray(est.window.q[slot]),
            v=np.asarray(est.window.v[slot]), ba=np.asarray(est.window.ba[slot]),
            bg=np.asarray(est.window.bg[slot]),
            acc=np.asarray(acc, np.float32), gyr=np.asarray(gyr, np.float32))

    def push_image(self, t, img, mask=None):
        # stream watchdog: a long camera gap restarts the estimator
        if self.last_image_t is not None and t - self.last_image_t > self.CAMERA_GAP_RESTART:
            self._restart(cause="camera_gap")
        self.last_image_t = float(t)
        self.image_buf.append((float(t), img, mask))
        return self._try_process()

    def push_scan(self, t, points, valid):
        # optional LiDAR upload quantization (scan_quant > 0): fixed-point
        # int16 points + bit-packed validity cut the host->device scan
        # payload ~2.6x. 2.5 mm resolution sits under the ~2 cm range noise;
        # measured cost: lidar trajectory moves < 2.5 cm, VIO < 10 cm
        # (test_pipeline.py::test_scan_quantization_equivalence). A
        # throughput/accuracy DEPLOYMENT KNOB (bench + acceptance run it
        # on), default off: depth-association selections can flip across
        # depth discontinuities, which perturbs marginal visual-loop PnP.
        if (self.scan_quant and isinstance(points, np.ndarray)
                and points.dtype != np.int16):
            points = np.clip(np.round(points * (1.0 / self.scan_quant)),
                             -32767, 32767).astype(np.int16)
            valid = np.packbits(np.asarray(valid, bool))
        self.scan_buf.append((float(t), points, valid))
        return self._try_process()

    def _scan_dev(self, pts, val):
        """Upload a scan: dequantize int16 fixed-point + unpack bit-packed
        validity on DEVICE (one tiny fused dispatch); f32 passes through."""
        if getattr(pts, "dtype", None) == np.int16:
            n = pts.shape[0]
            return _dequant_scan(jnp.asarray(pts), jnp.asarray(val),
                                 jnp.float32(self.scan_quant), n)
        return jnp.asarray(pts, jnp.float32), jnp.asarray(val)

    # ------------------------------------------------------------------
    def _restart(self, cause: str = "estimator_failure"):
        """restart_callback analog (estimator_node.cpp:199-218): flush and
        reinitialize the estimator; tracker and maps survive. In LiDAR modes
        the reboot is seeded from the surviving LiDAR odometry pose so the
        estimator resumes in a consistent world frame instead of re-running
        visual-inertial initialization from scratch."""
        t_now = self.last_processed_t if self.last_processed_t is not None \
            else self.last_image_t
        entry = dict(t=t_now, cause=cause,
                     since_init_s=(None if self._init_t is None or t_now is None
                                   else round(t_now - self._init_t, 2)))
        if cause == "estimator_failure":
            mask = getattr(self.estimator, "fail_mask", 0)
            entry["predicates"] = est_mod.decode_failure(mask)
        self.restart_log.append(entry)
        self._init_t = None
        self.estimator = est_mod.VILEstimator(self.est_cfg)
        self.estimator.set_extrinsics(qic=self.rig.q_ic, tic=self.rig.t_ic,
                                      td=self.rig.td)
        if self.mode == "vil" and int(self.lidar_state.frame_count) > 1:
            ls = self.lidar_state
            dt = 0.1
            v_est = np.asarray(lie.qrot(ls.q_prev, lie.pose_between(
                (ls.q_prev, ls.p_prev), (ls.q, ls.p))[1])) / dt
            self.estimator.set_initial_state(
                p=np.asarray(ls.p), q=np.asarray(ls.q), v=v_est)
        self._hr = None
        self.restarts += 1
        self._gen += 1  # in-flight frames of the failed estimator are stale
        self.sequence = getattr(self, "sequence", 0) + 1  # new_sequence()
        # drop loop drifts computed against the failed estimator's frame:
        # applying them to the rebooted window would re-anchor fresh state
        # by a stale transform (the reference's restart likewise clears the
        # relo buffer via clearState)
        if self.visual_loop is not None:
            while not self._vl_results.empty():
                self._vl_results.get()

    def _pop_imu_until(self, t):
        seg = [s for s in self.imu_buf if s[0] <= t + 1e-9]
        self.imu_buf = [s for s in self.imu_buf if s[0] > t + 1e-9]
        return seg

    def _imu_segment_for_frame(self, t):
        """Samples spanning the FULL inter-frame interval: the boundary
        sample consumed by the previous frame is re-used as this segment's
        first sample, and the last interval is extended to the frame time
        (getMeasurements boundary handling, estimator_node.cpp:100-155 —
        without this every segment under-integrates by ~one IMU period)."""
        seg = self._pop_imu_until(t)
        prev = getattr(self, "_imu_boundary", None)
        if prev is not None and (not seg or prev[0] < seg[0][0] - 1e-9):
            seg = [prev] + seg
        if seg:
            self._imu_boundary = seg[-1]
        if not seg:
            return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
        ts_ = np.array([s[0] for s in seg])
        acc = np.stack([s[1] for s in seg])
        gyr = np.stack([s[2] for s in seg])
        dts = np.diff(ts_)
        if t - ts_[-1] > 1e-6:
            # extend to the frame epoch with a held last sample
            acc = np.concatenate([acc, acc[-1:]])
            gyr = np.concatenate([gyr, gyr[-1:]])
            dts = np.concatenate([dts, [t - ts_[-1]]])
        return acc, gyr, dts

    def _try_process(self):
        need_scan = self.mode in ("vil", "lidar")
        if not self.image_buf and self.mode != "lidar":
            return None
        if need_scan and not self.scan_buf:
            return None
        if self.mode == "lidar":
            t, pts, val = self.scan_buf.pop(0)
            return self._process_lidar_only(t, pts, val)
        t_img, img, mask = self.image_buf[0]
        scan = None
        if need_scan:
            # camera-lidar pairing within the sync window (:220-263)
            t_s, pts, val = self.scan_buf[0]
            if t_s < t_img - self.SYNC_WINDOW:
                self.scan_buf.pop(0)
                return self._try_process()
            if t_s > t_img + self.SYNC_WINDOW:
                scan = None  # no matching scan; proceed VIO-style
            else:
                scan = self.scan_buf.pop(0)
        self.image_buf.pop(0)
        return self._process_frame(t_img, img, mask, scan)

    # ------------------------------------------------------------------
    def _process_lidar_only(self, t, pts, val):
        pts_dev, val_dev = self._scan_dev(pts, val)
        with GLOBAL_TIMERS.timed("lidar_odometry"):
            self.lidar_state, (q, p, q_rel, p_rel) = lo.odometry_step(
                self.lidar_state, pts_dev, val_dev, self.lidar_cfg)
        if self.fusion is not None:
            with GLOBAL_TIMERS.timed("global_fusion"):
                self.fusion.add_frame(q, p, pts_dev, val_dev, t=t)
        self.outputs.ts.append(t)
        self.outputs.lidar_p.append(np.asarray(p))
        self.outputs.lidar_q.append(np.asarray(q))
        self.outputs.vio_p.append(np.asarray(p))
        self.outputs.vio_q.append(np.asarray(q))
        self.outputs.initialized.append(True)  # lidar odometry: always valid
        self.last_processed_t = t
        return np.asarray(p), np.asarray(q)

    def _process_frame(self, t, img, mask, scan):
        if self.sync_depth == 0 or not (
                self.estimator.initialized
                and self.estimator.frame_count >= est_mod.K - 1):
            # cold start / filling phase is host-orchestrated anyway
            self._drain_pending()
            return self._process_frame_sync(t, img, mask, scan)
        rec = self._issue_frame(t, img, mask, scan)
        self._pending.append(rec)
        if len(self._pending) > self.sync_depth:
            return self._complete_frame(self._pending.pop(0))
        return None

    def finalize(self):
        """Drain in-flight frames, the visual-loop worker, and in-flight
        loop queries (call once at the end of a replay)."""
        out = self._drain_pending()
        if self.fusion is not None:
            self.fusion.flush()
        if self.visual_loop is not None and self._vl_jobs is not None:
            # wait for the worker to go idle, then apply any accepted drift
            # to the estimator (outputs are rewritten below)
            self._vl_idle.wait(timeout=120.0)
            while not self._vl_results.empty():
                gen, drift = self._vl_results.get()
                if gen == self._gen:
                    self._apply_reloc_drift(drift, np.zeros(3),
                                            np.array([1.0, 0, 0, 0]))
        # pose_graph.cpp updatePath: rewrite the loop-corrected trajectory
        # from the optimized 4-DoF graph so corrections reach PAST frames
        self.outputs.rebuild_loop_path(self.visual_loop)
        return out

    def _append_loop_output(self, p_est, q_est):
        """Append the loop-corrected output plus its keyframe attachment
        (anchor index + relative pose) for retroactive path rebuild."""
        db = self.visual_loop
        self.outputs.loop_p.append(self.loop_drift_R @ p_est + self.loop_drift_t)
        self.outputs.loop_q.append(_np_R2q(self.loop_drift_R @ _np_q2R(q_est)))
        with self._vl_lock:  # db.q/db.p may be mid-rewrite in the worker
            n = db.n
            if n > 0:
                a = n - 1
                q_a = np.asarray(db.q[a], np.float64).copy()
                p_a = np.asarray(db.p[a], np.float64).copy()
        if n > 0:
            R_a = _np_q2R(q_a)
            self.outputs.anchor_kf.append(a)
            self.outputs.anchor_rel.append(
                (R_a.T @ _np_q2R(np.asarray(q_est, np.float64)),
                 R_a.T @ (np.asarray(p_est, np.float64) - p_a)))
        else:
            self.outputs.anchor_kf.append(-1)
            self.outputs.anchor_rel.append(None)

    def _drain_pending(self):
        out = None
        while self._pending:
            out = self._complete_frame(self._pending.pop(0))
        return out

    def _issue_frame(self, t, img, mask, scan):
        """Enqueue one frame's full device program with NO host reads:
        tracker -> lidar odometry -> depth association -> fused estimator
        step. Host-side consequences run in _complete_frame, sync_depth
        frames later, so successive frames' stages overlap on device exactly
        like the reference's concurrent processes overlap on successive
        frames."""
        import jax

        rec: dict = dict(t=t, img=img, gen=self._gen, scan=None,
                         drift_R=None, drift_t=None)
        if (self.FUSE_FRAMES and self.mode == "vil" and scan is not None
                and mask is None):
            return self._issue_frame_fused(rec, t, img, scan)
        with GLOBAL_TIMERS.timed("tracker"):
            self.tracker_state, obs = trk.track_step(
                self.tracker_state, jnp.asarray(img),
                jnp.float32(t), self.cam, self.tracker_cfg,
                dyn_mask=None if mask is None else jnp.asarray(mask),
                key=jax.random.PRNGKey(int(t * 1e3) & 0x7FFFFFFF))

        lidar_q_rel_imu = lidar_p_rel_imu = None
        depth = None
        if scan is not None:
            _t_s, pts, val = scan
            pts_dev, val_dev = self._scan_dev(pts, val)
            with GLOBAL_TIMERS.timed("lidar_odometry"):
                self.lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(
                    self.lidar_state, pts_dev, val_dev, self.lidar_cfg)
            lidar_q_rel_imu, lidar_p_rel_imu, cloud_cam = self._lidar_glue(
                lqr, lpr, pts_dev, self.q_il, self.t_il,
                self.q_li, self.t_li, self.q_cl, self.t_cl)
            with GLOBAL_TIMERS.timed("depth_association"):
                depth, _ok = depth_association.feature_depth(
                    obs["xy"], obs["valid"], cloud_cam, val_dev,
                    min_incidence=self.rig.depth_min_incidence)
            rec["scan"] = (lq, lp, pts_dev, val_dev)

        acc, gyr, dts = self._imu_segment_for_frame(t)
        acc_b, gyr_b, dt_b, n_imu = self.estimator._pack_imu(acc, gyr, dts)
        dep_dev = (jnp.asarray(depth) if depth is not None
                   else jnp.zeros((self.tracker_cfg.cap,), jnp.float32))
        tsh_dev = None
        if self.rig.rolling_shutter and self.rig.tr != 0.0:
            # device-side row->readout-shift math (no host read)
            tsh_dev = (self.rig.tr / self.rig.image_height
                       * (obs["uv"][:, 1] - 0.5 * self.rig.image_height))
        with GLOBAL_TIMERS.timed("estimator"):
            out = self.estimator.process_frame_device_async(
                jnp.asarray(acc_b), jnp.asarray(gyr_b), jnp.asarray(dt_b),
                n_imu, obs["ids"], obs["xy"], obs["vel"], dep_dev,
                lidar_q_rel=lidar_q_rel_imu, lidar_p_rel=lidar_p_rel_imu,
                tsh=tsh_dev)
        # capture refs for deferred completion (newest frame slid to K-2)
        w = self.estimator.window
        slot = est_mod.K - 2
        rec.update(out=out, window=w, feats=self.estimator.feats,
                   hr_ba=w.ba[slot], hr_bg=w.bg[slot],
                   obs_ids=obs["ids"], obs_dep=dep_dev)
        # start the host copies NOW: by completion time (sync_depth frames
        # later) the values are already on host, so the per-frame device_get
        # costs ~0 instead of a full round trip
        fetch = [out["p"], out["q"], out["v"], out["cost"], out["failed"],
                 rec["hr_ba"], rec["hr_bg"], rec["obs_ids"], rec["obs_dep"]]
        if rec["scan"] is not None:
            fetch += [rec["scan"][0], rec["scan"][1]]
        for x in fetch:
            x.copy_to_host_async()
        rec["fetch"] = fetch
        return rec

    def _imu_hdr_upload(self, t, tsh_scale):
        """(imu_cap+1, 7) f32 block: IMU segment + frame header, ONE upload
        (see _vil_frame_program's traffic contract)."""
        acc, gyr, dts = self._imu_segment_for_frame(t)
        acc_b, gyr_b, dt_b, n_imu = self.estimator._pack_imu(acc, gyr, dts)
        blk = np.zeros((acc_b.shape[0] + 1, 7), np.float32)
        blk[:-1, 0:3] = acc_b
        blk[:-1, 3:6] = gyr_b
        blk[:len(dt_b), 6] = dt_b  # dt is (cap-1,) by _pack_imu's contract
        blk[-1, :5] = (t, n_imu, tsh_scale, self.scan_quant,
                       self.rig.depth_min_incidence)
        return jnp.asarray(blk)

    def _issue_frame_fused(self, rec, t, img, scan):
        """One-dispatch steady-state vil frame (see _vil_frame_program)."""
        est = self.estimator
        _t_s, pts, val = scan
        with GLOBAL_TIMERS.timed("feed_uploads"):
            # quantized scans upload raw (int16 + packed bits); the program
            # dequantizes on device and returns the f32 cloud
            pts_dev = jnp.asarray(pts)
            val_dev = jnp.asarray(val)
            img_dev = jnp.asarray(img)
            tsh_scale = (self.rig.tr / self.rig.image_height
                         if self.rig.rolling_shutter and self.rig.tr != 0.0
                         else 0.0)
            imu_hdr = self._imu_hdr_upload(t, tsh_scale)
        with GLOBAL_TIMERS.timed("vil_fused_frame"):
            (self.tracker_state, self.lidar_state, est.window, est.feats,
             est.pre, est.lidar, est.prior, out, lq, lp, obs_ids,
             dep_dev, pts_f, val_f) = _vil_frame_program(
                self.tracker_state, self.lidar_state,
                est.window, est.feats, est.pre, est.lidar, est.prior,
                img_dev, pts_dev, val_dev, imu_hdr,
                self.q_il, self.t_il, self.q_li, self.t_li,
                self.q_cl, self.t_cl,
                self.cam, self.tracker_cfg, self.lidar_cfg, self.est_cfg)
        rec["scan"] = (lq, lp, pts_f, val_f)
        slot = est_mod.K - 2
        rec.update(out=out, window=est.window, feats=est.feats,
                   hr_ba=est.window.ba[slot], hr_bg=est.window.bg[slot],
                   obs_ids=obs_ids, obs_dep=dep_dev)
        fetch = [out["p"], out["q"], out["v"], out["cost"], out["failed"],
                 rec["hr_ba"], rec["hr_bg"], obs_ids, dep_dev, lq, lp]
        for x in fetch:
            x.copy_to_host_async()
        rec["fetch"] = fetch
        return rec

    def _complete_frame(self, rec):
        """Deferred host-side half of a frame: one batched device_get, then
        failure handling, global fusion, visual loop closure, outputs."""
        import jax

        host = jax.device_get(rec["fetch"])
        p_est = np.asarray(host[0])
        q_est = np.asarray(host[1])
        v_est = np.asarray(host[2])
        stale = rec["gen"] != self._gen
        if not stale:
            if self._init_t is None:
                self._init_t = rec["t"]  # deferred path implies initialized
            self.estimator.absorb_result(host[3], host[4])
            if self.estimator.failed:
                # failureDetection reboot, sync_depth frames late (the
                # reference's detection is equally asynchronous to the
                # front end: it lives in another process)
                self._restart()
            else:
                self._reset_high_rate_from(rec["t"], p_est, q_est, v_est,
                                           np.asarray(host[5]),
                                           np.asarray(host[6]))
        live = rec["gen"] == self._gen  # _restart above bumps gen

        # global fusion is lidar-driven and survives estimator restarts
        if rec["scan"] is not None and self.fusion is not None:
            with GLOBAL_TIMERS.timed("global_fusion"):
                self.fusion.add_frame(np.asarray(host[-2]),
                                      np.asarray(host[-1]),
                                      rec["scan"][2], rec["scan"][3],
                                      t=rec["t"])

        # snapshot was captured pre-drift: apply any loop drift accepted
        # while this frame was in flight
        if rec["drift_R"] is not None:
            R_d0, t_d0 = rec["drift_R"], rec["drift_t"]
            p_est = R_d0 @ p_est + t_d0
            q_est = _np_R2q(R_d0 @ _np_q2R(q_est))
            v_est = R_d0 @ v_est

        if (self.visual_loop is not None and live
                and self.estimator.initialized and not self.estimator.failed):
            # apply any drift the worker accepted while frames were in flight
            p_est, q_est = self._drain_vl_results(p_est, q_est)
            if self._vl_jobs is not None:
                # threaded path: gate on the main thread (host floats only),
                # enqueue at most one job at a time — the reference's
                # process() thread likewise consumes keyframes serially and
                # skips while busy (keyframe_buf drop-to-newest)
                gap = self.visual_loop.cfg.keyframe_gap
                if (self._vl_idle.is_set() and self._vl_jobs.empty()
                        and (self._last_kf_p is None
                             or np.linalg.norm(p_est - self._last_kf_p) >= gap)):
                    self._vl_idle.clear()
                    self._vl_jobs.put(dict(
                        gen=self._gen,
                        img=rec["img"], p_est=p_est, q_est=q_est,
                        window=rec["window"], feats=rec["feats"],
                        pre_drift=(rec["drift_R"], rec["drift_t"]),
                        fresh=(np.asarray(host[7]), np.asarray(host[8])),
                        scan=(None if rec["scan"] is None
                              else (rec["scan"][2], rec["scan"][3]))))
                    self._last_kf_p = np.asarray(p_est)
            else:
                drift = self._visual_loop_step(
                    rec["img"], p_est, q_est,
                    window=rec["window"], feats=rec["feats"],
                    pre_drift=(rec["drift_R"], rec["drift_t"]),
                    fresh=(np.asarray(host[7]), np.asarray(host[8])),
                    scan=(None if rec["scan"] is None
                          else (rec["scan"][2], rec["scan"][3])))
                if drift is not None:
                    p_est, q_est = self._apply_reloc_drift(drift, p_est, q_est)

        self.outputs.ts.append(rec["t"])
        self.outputs.vio_p.append(p_est)
        self.outputs.vio_q.append(q_est)
        self.outputs.initialized.append(True)  # deferred path requires init
        if self.visual_loop is not None:
            self._append_loop_output(p_est, q_est)
        if rec["scan"] is not None:
            self.outputs.lidar_p.append(np.asarray(host[-1]))
            self.outputs.lidar_q.append(np.asarray(host[-2]))
        else:
            self.outputs.lidar_p.append(np.asarray(self.lidar_state.p))
            self.outputs.lidar_q.append(np.asarray(self.lidar_state.q))
        self.last_processed_t = rec["t"]
        return p_est, q_est

    def _reset_high_rate_from(self, t, p, q, v, ba_, bg_):
        """Reseed the numpy high-rate propagator from a frame solved
        sync_depth frames ago, then re-propagate the retained IMU samples up
        to now (estimator_node.cpp update() :84-97 — it re-propagates
        tmp_imu_buf after every solve for exactly this reason)."""
        hist = [s for s in self._imu_hist if s[0] > t + 1e-9]
        anchor = None
        for s in self._imu_hist:
            if s[0] <= t + 1e-9:
                anchor = s
        if anchor is None:
            acc0 = np.array([0.0, 0, 9.81])
            gyr0 = np.zeros(3)
        else:
            acc0, gyr0 = anchor[1], anchor[2]
        hr = dict(t=float(t), p=np.asarray(p, np.float64),
                  q=np.asarray(q, np.float64), v=np.asarray(v, np.float64),
                  ba=np.asarray(ba_, np.float64), bg=np.asarray(bg_, np.float64),
                  acc=acc0, gyr=gyr0)
        g = np.asarray(self.estimator.gravity, np.float64)
        for (ts_, acc, gyr) in hist:
            dt = ts_ - hr["t"]
            if dt <= 0 or dt > 1.0:
                hr.update(t=ts_, acc=acc, gyr=gyr)
                continue
            pn, qn, vn = _np_propagate(hr["p"], hr["q"], hr["v"], hr["ba"],
                                       hr["bg"], hr["acc"], hr["gyr"],
                                       acc, gyr, dt, g)
            hr.update(t=ts_, p=pn, q=qn, v=vn, acc=acc, gyr=gyr)
        self._hr = hr

    def _process_frame_sync(self, t, img, mask, scan):
        import jax

        # 1. visual tracking
        with GLOBAL_TIMERS.timed("tracker"):
            self.tracker_state, obs = trk.track_step(
                self.tracker_state, jnp.asarray(img),
                jnp.float32(t), self.cam, self.tracker_cfg,
                dyn_mask=None if mask is None else jnp.asarray(mask),
                key=jax.random.PRNGKey(int(t * 1e3) & 0x7FFFFFFF))

        # 2. lidar odometry + depth association
        lidar_q_rel_imu = lidar_p_rel_imu = None
        depth = None
        if scan is not None:
            t_s, pts, val = scan
            pts_dev, val_dev = self._scan_dev(pts, val)
            with GLOBAL_TIMERS.timed("lidar_odometry"):
                self.lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(
                    self.lidar_state, pts_dev, val_dev, self.lidar_cfg)
            # relative pose through extrinsics into the IMU frame
            # (lidar_factor.h composes through camera-lidar & imu-camera) +
            # cloud transform, one fused dispatch
            lidar_q_rel_imu, lidar_p_rel_imu, cloud_cam = self._lidar_glue(
                lqr, lpr, pts_dev, self.q_il, self.t_il,
                self.q_li, self.t_li, self.q_cl, self.t_cl)
            with GLOBAL_TIMERS.timed("depth_association"):
                depth, _ok = depth_association.feature_depth(
                    obs["xy"], obs["valid"], cloud_cam, val_dev,
                    min_incidence=self.rig.depth_min_incidence)
            if self.fusion is not None:
                with GLOBAL_TIMERS.timed("global_fusion"):
                    self.fusion.add_frame(lq, lp, pts_dev, val_dev, t=t)

        # 3. IMU segment (full-interval spanning, boundary-sample reuse)
        acc, gyr, dts = self._imu_segment_for_frame(t)

        # 4. estimator — device-resident handoff: tracker outputs are
        # already fixed-capacity device arrays; the estimator's obs_cap is
        # sized to the tracker cap in __init__ so no host repacking happens
        acc_b, gyr_b, dt_b, n_imu = self.estimator._pack_imu(acc, gyr, dts)
        dep_dev = (jnp.asarray(depth) if depth is not None
                   else jnp.zeros((self.tracker_cfg.cap,), jnp.float32))
        # rolling shutter: per-observation readout shift TR*(row-ROW/2)/ROW
        # (projection_td_factor.cpp:51-52, feature_tracker_node row channel)
        tsh_dev = None
        if self.rig.rolling_shutter and self.rig.tr != 0.0:
            rows = obs["uv"][:, 1]
            tsh_dev = (self.rig.tr / self.rig.image_height
                       * (rows - 0.5 * self.rig.image_height))
        with GLOBAL_TIMERS.timed("estimator"):
            p_est, q_est, v_est = self.estimator.process_frame_device(
                jnp.asarray(acc_b), jnp.asarray(gyr_b), jnp.asarray(dt_b),
                n_imu, obs["ids"], obs["xy"], obs["vel"], dep_dev,
                lidar_q_rel=lidar_q_rel_imu, lidar_p_rel=lidar_p_rel_imu,
                tsh=tsh_dev)
        if self.estimator.failed:
            # failureDetection reboot (estimator.cpp:212-219)
            self._restart()
        elif self.estimator.initialized:
            if self._init_t is None:
                self._init_t = t
            self._reset_high_rate(t)  # re-seed IMU-rate propagation

        # 5. visual loop closure (pose_graph node rebuild): keyframe-gated
        # BRIEF/BoW detection + PnP verification + 4-DoF graph + drift
        if (self.visual_loop is not None and self.estimator.initialized
                and self.estimator.frame_count >= est_mod.K - 1):
            drift = self._visual_loop_step(
                img, p_est, q_est,
                fresh=(np.asarray(obs["ids"]), np.asarray(dep_dev)),
                scan=None if scan is None else (pts_dev, val_dev))
            if drift is not None:
                # relocalization feedback (estimator.cpp setReloFrame
                # :1188-1206 + relo factors :799-836): re-anchor the VIO
                # window itself into the loop-corrected frame (gauge
                # transform), so the VIO output re-converges after a loop.
                R_d, t_d = drift
                self.estimator.apply_drift(R_d, t_d)
                p_est = R_d @ p_est + t_d
                q_est = np.asarray(lie.qmul(
                    jnp.asarray(lie.R2q(jnp.asarray(R_d, jnp.float32))),
                    jnp.asarray(q_est, jnp.float32)))
                hr = getattr(self, "_hr", None)
                if hr is not None:
                    hr["p"] = R_d @ hr["p"] + t_d
                    hr["q"] = np.asarray(lie.qmul(
                        jnp.asarray(lie.R2q(jnp.asarray(R_d, jnp.float32))),
                        jnp.asarray(hr["q"], jnp.float32)))
                    hr["v"] = R_d @ hr["v"]
                if self._last_kf_p is not None:
                    self._last_kf_p = R_d @ self._last_kf_p + t_d

        self.outputs.ts.append(t)
        self.outputs.vio_p.append(p_est)
        self.outputs.vio_q.append(q_est)
        self.outputs.initialized.append(bool(self.estimator.initialized))
        if self.visual_loop is not None:
            self._append_loop_output(p_est, q_est)
        self.outputs.lidar_p.append(np.asarray(self.lidar_state.p))
        self.outputs.lidar_q.append(np.asarray(self.lidar_state.q))
        self.last_processed_t = t
        return p_est, q_est

    def _vl_worker(self):
        """Visual-loop worker loop (the pose_graph node's process() thread).
        Blocking device reads inside _visual_loop_step release the GIL, so
        the odometry path keeps dispatching while loops verify."""
        while True:
            job = self._vl_jobs.get()
            try:
                drift = self._visual_loop_step(
                    job["img"], job["p_est"], job["q_est"],
                    window=job["window"], feats=job["feats"],
                    pre_drift=job["pre_drift"], fresh=job["fresh"],
                    scan=job.get("scan"), gate=False)
                if drift is not None:
                    self._vl_results.put((job["gen"], drift))
            except Exception as e:  # never kill the pipeline from the worker
                import traceback

                traceback.print_exc()
                print(f"visual-loop worker error (continuing): {e}")
            finally:
                self._vl_idle.set()

    def _drain_vl_results(self, p_est, q_est):
        """Apply every drift the worker produced since the last frame
        (skipping any computed against a pre-restart estimator)."""
        while not self._vl_results.empty():
            gen, drift = self._vl_results.get()
            if gen != self._gen:
                continue  # stale: estimator rebooted since the job was cut
            p_est, q_est = self._apply_reloc_drift(drift, p_est, q_est)
        return p_est, q_est

    def _apply_reloc_drift(self, drift, p_est, q_est):
        """Relocalization feedback (setReloFrame :1188-1206 + relo factors
        :799-836): re-anchor the VIO window, the high-rate propagator, and
        every in-flight snapshot into the loop-corrected frame."""
        R_d, t_d = drift
        self.estimator.apply_drift(R_d, t_d)
        p_est = R_d @ p_est + t_d
        q_est = _np_R2q(R_d @ _np_q2R(q_est))
        for pr in self._pending:
            if pr["drift_R"] is None:
                pr["drift_R"], pr["drift_t"] = R_d.copy(), t_d.copy()
            else:
                pr["drift_R"] = R_d @ pr["drift_R"]
                pr["drift_t"] = R_d @ pr["drift_t"] + t_d
        hr = getattr(self, "_hr", None)
        if hr is not None:
            hr["p"] = R_d @ hr["p"] + t_d
            hr["q"] = _np_R2q(R_d @ _np_q2R(hr["q"]))
            hr["v"] = R_d @ hr["v"]
        if self._last_kf_p is not None:
            self._last_kf_p = R_d @ self._last_kf_p + t_d
        return p_est, q_est

    def _visual_loop_step(self, img, p_est, q_est, window=None, feats=None,
                          pre_drift=(None, None), fresh=None, scan=None,
                          gate=True):
        """Keyframe insert (gated) + detection + verification + 4-DoF drift
        update (pose_graph node process() + optimize4DoF rebuild).

        window/feats: estimator snapshot captured at issue time (deferred
        path); defaults to the live estimator state. pre_drift: loop drift
        accepted while the snapshot was in flight — the snapshot landmarks
        are still in the pre-drift frame and must be moved (p_est/q_est
        arrive already corrected).

        Returns None, or the accepted loop's (R_d, t_d) yaw+translation drift
        for relocalization feedback into the estimator window."""
        gap = self.visual_loop.cfg.keyframe_gap  # SKIP_DIS analog, configurable
        if gate and self._last_kf_p is not None and np.linalg.norm(
                p_est - self._last_kf_p) < gap:
            return None
        est = self.estimator
        if window is None:
            window = est.window
        if feats is None:
            feats = est.feats
        # process_frame already slid the window: the newest frame's
        # observations and state live at slot K-2 now
        slot = est_mod.K - 2
        pts_w_all, obs_all, ids, valid, observed = est_mod.landmarks_world(
            window, feats, jnp.int32(slot))
        valid = np.asarray(valid)
        observed = np.asarray(observed)
        pts_w_all = np.asarray(pts_w_all).copy()
        obs_all = np.asarray(obs_all)
        ids_all = np.asarray(ids)
        if pre_drift[0] is not None:
            pts_w_all = pts_w_all @ pre_drift[0].T + pre_drift[1]
        # prefer THIS frame's lidar depths for the exported landmarks:
        # anchor-frame inverse depths decay through marginalization
        # handovers (removeBackShiftDepth), while a fresh depth is rigidly
        # consistent with the current keyframe pose — exactly what loop PnP
        # measures. Features observed NOW with a fresh lidar depth but no
        # estimator depth are exported too (an acceptance run: only ~30-50
        # estimator-depthed landmarks per keyframe starved the Hamming
        # gate's MIN_LOOP_NUM=25 — the depth source does not matter to
        # matching, only the 3-D quality, and the fresh lidar depth is the
        # best available). (Idiomatic improvement over pubKeyframe's
        # anchor-depth export, visualization.cpp:385-440.)
        has_fresh = np.zeros(len(ids_all), bool)
        if fresh is not None:
            fids, fdep = fresh
            fok = (fids >= 0) & (fdep > 0)
            lut = {int(i): float(d) for i, d in zip(fids[fok], fdep[fok])}
            z = np.array([lut.get(int(i), -1.0) for i in ids_all], np.float32)
            has_fresh = observed & (z > 0)
            if has_fresh.any():
                R_wb = _np_q2R(np.asarray(q_est, np.float64))
                R_ic = _np_q2R(np.asarray(self.rig.q_ic, np.float64))
                R_wc = R_wb @ R_ic
                p_wc = R_wb @ np.asarray(self.rig.t_ic, np.float64) + p_est
                rays = np.concatenate(
                    [obs_all[has_fresh],
                     np.ones((int(has_fresh.sum()), 1), np.float32)], -1)
                pts_w_all[has_fresh] = ((rays * z[has_fresh, None]) @ R_wc.T
                                        + p_wc)
        export = valid | has_fresh
        # distribution of exportable window landmarks per keyframe: the
        # Hamming gate needs >= MIN_LOOP_NUM matches OF these, so a low
        # count starves verification regardless of descriptor quality
        self.visual_loop.stats.setdefault("win_landmarks", []).append(
            int(export.sum()))
        if export.sum() < 10:
            self.visual_loop.stats["skip_few_landmarks"] = \
                self.visual_loop.stats.get("skip_few_landmarks", 0) + 1
            return None
        pts_w = pts_w_all[export]
        obs_xy = obs_all[export]
        # pixel coords of the observations for descriptor extraction
        px = np.asarray(cam_mod.project(
            self.cam, jnp.concatenate(
                [jnp.asarray(obs_xy, jnp.float32),
                 jnp.ones((len(obs_xy), 1), jnp.float32)], axis=-1)))
        db = self.visual_loop
        # this frame's camera-frame cloud: lidar-depthed extra corners
        # become additional 3-D anchors (see VisualLoopDB.add_keyframe)
        cloud_cam = cloud_val = None
        if scan is not None:
            cloud_cam = lie.qrot(self.q_cl[None, :], scan[0]) \
                + self.t_cl[None, :]
            cloud_val = scan[1]
        i_cur = db.add_keyframe(img, q_est, p_est, pts_w, px,
                                np.ones(len(px), bool), self.cam,
                                sequence=getattr(self, "sequence", 0),
                                cloud_cam=cloud_cam, cloud_valid=cloud_val)
        if i_cur is None:
            return None  # keyframe DB full
        if gate:
            self._last_kf_p = np.asarray(p_est)  # gate on successful insert
        hit = db.detect_and_verify(i_cur)
        if hit is None:
            return None
        cand, q_rel, p_rel = hit
        graph_before = db.graph
        # db pose mutations under the lock: the odometry thread reads
        # db.q/db.p for per-frame keyframe anchors (_append_loop_output)
        with self._vl_lock:
            db.close_loop(i_cur, cand, q_rel, p_rel)
            # drift: corrected keyframe pose vs VIO keyframe pose (:552-574)
            from vil_fusion_tpu.models import posegraph4dof as pg4

            dyaw, R_d, t_d = pg4.drift_transform(graph_before, db.graph, i_cur)
            # move the insert-time (VIO-frame) records into the corrected
            # frame (the estimator is about to be re-anchored by the same
            # transform), then pull optimized poses back into the keyframe
            # store (updatePath)
            db.apply_drift_to_vio(np.asarray(R_d), float(dyaw), np.asarray(t_d))
            db.sync_from_graph()
        # with relocalization feedback the window itself is re-anchored, so
        # no residual display drift remains (the reference instead keeps the
        # VIO in its own frame and applies this to outputs, :552-574)
        self.loop_drift_R = np.eye(3, dtype=np.float32)
        self.loop_drift_t = np.zeros(3, np.float32)
        return np.asarray(R_d), np.asarray(t_d)
