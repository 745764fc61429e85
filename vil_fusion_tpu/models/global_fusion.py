"""Global fusion: keyframe gating + ScanContext loops + ICP + pose graph.

Rebuild of the reference's `sensor_fusion_poseGraphOptimization` node
(reference: src/global_fusion/poseGraphOptimization.cpp: keyframe gate by
2 m / 10 deg accumulated motion :518-538, makeAndSaveScancontextAndKeys
:544-554, loopDetection @1 Hz :598-615, icpCalculation vs +-25-keyframe
submap :376-444, isamUpdate @1 Hz :349-374, loopPath re-broadcast :239-308).

The reference's 5 threads collapse into one host loop: every keyframe runs
descriptor insert + loop query; accepted candidates run ICP verification and
a pose-graph relaxation. Keyframe clouds are kept in a fixed-capacity
device-resident store for submap assembly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import icp as icp_mod
from vil_fusion_tpu.models import posegraph as pg
from vil_fusion_tpu.models import scancontext as sc
from vil_fusion_tpu.ops import lie


@functools.partial(jax.jit, static_argnames=("first",))
def _keyframe_program(graph, db, clouds, cloud_valid, q_prev_kf, p_prev_kf,
                      q_dev, p_dev, pts, val, i, first):
    """The ENTIRE keyframe hot path as ONE device program: odometry-edge
    glue + graph node append + ScanContext insert/detect + cloud subsample/
    store. The host-orchestrated version paid ~7 dispatch enqueues per
    keyframe — at urban keyframe rates (1 per 2-3 frames) the largest
    NON-compute cost of the deployed vil loop."""
    if first:
        q_rel = jnp.asarray([1.0, 0, 0, 0], clouds.dtype)
        p_rel = jnp.zeros(3, clouds.dtype)
        q_abs, p_abs = q_dev, p_dev
    else:
        q_rel, p_rel = lie.pose_between((q_prev_kf, p_prev_kf), (q_dev, p_dev))
        q_abs, p_abs = lie.pose_compose((graph.q[i - 1], graph.p[i - 1]),
                                        (q_rel, p_rel))
    graph = pg.add_node(graph, q_abs, p_abs, q_rel, p_rel)
    desc = sc.make_descriptor(pts, val)
    db = sc.add_keyframe(db, desc)
    cand, dist, shift = sc.detect_loop(db, desc)
    idx = jnp.linspace(0, pts.shape[0] - 1, clouds.shape[1]).astype(jnp.int32)
    clouds = clouds.at[i].set(pts[idx])
    cloud_valid = cloud_valid.at[i].set(val[idx])
    return graph, db, clouds, cloud_valid, cand, dist, shift


@jax.jit
def _submap_icp(qs, ps, clouds, cloud_valid, ks, dup, i, j, yaw0):
    """Submap assembly + ICP verification in ONE device program
    (icpCalculation :376-444). `ks` is the fixed-length clamped index span
    around j; `dup` masks clamp-duplicated entries. The former host loop paid
    ~25 dispatches for the same assembly."""
    q_j, p_j = qs[j], ps[j]

    def one(k, d):
        q_rel, p_rel = lie.pose_between((q_j, p_j), (qs[k], ps[k]))
        return (lie.qrot(q_rel[None, :], clouds[k]) + p_rel[None, :],
                cloud_valid[k] & ~d)

    tgt, tgtv = jax.vmap(one)(ks, dup)
    tgt = tgt.reshape(-1, 3)
    tgtv = tgtv.reshape(-1)

    # Two initial guesses, keep the better fit: (a) the graph relative pose —
    # the reference's init (clouds pre-transformed by graph poses, ICP from
    # identity); (b) same translation but the yaw REPLACED by the SC shift
    # estimate, which survives large yaw drift where (a) fails. The prior
    # version multiplied the full SC yaw ONTO the graph pose, double-counting
    # the relative rotation.
    q0, p0 = lie.pose_between((q_j, p_j), (qs[i], ps[i]))
    yaw_q0 = lie.R2ypr(lie.q2R(q0))[0] * (jnp.pi / 180.0)
    z = jnp.zeros_like(yaw0)
    q_corr = lie.so3_exp(jnp.stack([z, z, yaw0 - yaw_q0]))
    q0b = lie.qnormalize(lie.qmul(q_corr, q0))

    qa, pa, fa = icp_mod.icp_point2point(clouds[i], cloud_valid[i], tgt, tgtv, q0, p0)
    qb, pb, fb = icp_mod.icp_point2point(clouds[i], cloud_valid[i], tgt, tgtv, q0b, p0)
    pick_a = fa <= fb
    return (jnp.where(pick_a, qa, qb), jnp.where(pick_a, pa, pb),
            jnp.minimum(fa, fb))


@jax.jit
def _sc_insert_and_detect(db: sc.ScanContextDB, pts, val):
    """Descriptor build + DB insert + loop query in one device program
    (the host-orchestrated version paid one dispatch per stage)."""
    desc = sc.make_descriptor(pts, val)
    db = sc.add_keyframe(db, desc)
    cand, dist, shift = sc.detect_loop(db, desc)
    return db, cand, dist, shift


class GlobalFusionConfig(NamedTuple):
    keyframe_dist: float = 2.0  # m (:518-538)
    keyframe_angle: float = 10.0 * np.pi / 180.0
    sc_dist_thres: float = sc.SC_DIST_THRES
    icp_fitness_max: float = 0.3  # (:431)
    submap_half_span: int = 12  # +-keyframes in ICP target (reference 25)
    node_capacity: int = 2048
    loop_capacity: int = 256
    cloud_capacity: int = 2048  # stored points per keyframe (downsampled)
    optimize_every: int = 4  # keyframes between relaxations (isam 1 Hz analog:
    # at the 2 m / 10 deg gate and urban speeds, ~1-4 keyframes/s)


class GlobalFusion:
    """Host orchestration; heavy ops jitted. Mirrors the node's lifecycle."""

    def __init__(self, cfg: GlobalFusionConfig = GlobalFusionConfig(), dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.graph = pg.init_graph(cfg.node_capacity, cfg.loop_capacity, dtype)
        self.scdb = sc.init_db(cfg.node_capacity, dtype)
        self.clouds = jnp.zeros((cfg.node_capacity, cfg.cloud_capacity, 3), dtype)
        self.cloud_valid = jnp.zeros((cfg.node_capacity, cfg.cloud_capacity), bool)
        self.kf_q_odom = []  # odometry pose at each keyframe (host list)
        self.kf_p_odom = []
        self.kf_ts = []  # keyframe timestamps (for TUM export / ATE)
        self.n_kf = 0
        self.last_q = None
        self.last_p = None
        self.loops_found = []  # (i, j) pairs accepted
        self._pending_opt = 0
        self._pending_sc = []  # in-flight loop queries (async host copies)
        self._pending_icp = []  # in-flight ICP verifications

    # ------------------------------------------------------------------
    def is_keyframe(self, q, p) -> bool:
        if self.last_q is None:
            return True
        q = np.asarray(q)
        lq = np.asarray(self.last_q)
        dp = np.linalg.norm(np.asarray(p) - np.asarray(self.last_p))
        # host-side angle check (no device dispatch on the non-keyframe path)
        dth = 2.0 * np.arccos(np.clip(np.abs(np.dot(q, lq)), 0.0, 1.0))
        return dp > self.cfg.keyframe_dist or dth > self.cfg.keyframe_angle

    def add_frame(self, q_odom, p_odom, scan_points, scan_valid,
                  t: Optional[float] = None) -> Optional[tuple]:
        """Feed one odometry pose + body-frame scan. Returns (i, j) if a loop
        was accepted this keyframe, else None. Non-keyframes are ignored
        (the gate :518-538).

        Poses normalize to HOST numpy exactly once: the gate and the
        keyframe bookkeeping are host math, and every extra np.asarray on a
        device array is a full device round trip — the
        old device-first flow paid up to six per keyframe and two per
        non-keyframe, dominating deployed frame cost."""
        q_np = np.asarray(q_odom, np.float32)
        p_np = np.asarray(p_odom, np.float32)
        if not self.is_keyframe(q_np, p_np):
            return None
        cfg = self.cfg
        i = self.n_kf
        if i >= cfg.node_capacity:
            return None  # graph full

        # one fused dispatch: edge glue + node append + SC insert/detect +
        # cloud subsample/store (loopDetection :598-615 + addOdomFactor)
        (self.graph, self.scdb, self.clouds, self.cloud_valid, cand, dist,
         shift) = _keyframe_program(
            self.graph, self.scdb, self.clouds, self.cloud_valid,
            jnp.asarray(self.last_q if i else q_np, self.dtype),
            jnp.asarray(self.last_p if i else p_np, self.dtype),
            jnp.asarray(q_np, self.dtype), jnp.asarray(p_np, self.dtype),
            jnp.asarray(scan_points, self.dtype), jnp.asarray(scan_valid),
            jnp.int32(i), i == 0)
        self.last_q = q_np
        self.last_p = p_np
        self.kf_q_odom.append(q_np)
        self.kf_p_odom.append(p_np)
        self.kf_ts.append(float(t) if t is not None else float(i))
        self.n_kf += 1

        # start the host copy of this keyframe's loop query NOW; resolve
        # queries only once their copies have actually landed (is_ready) —
        # the reference's loopDetection/ICP workers are equally asynchronous
        # to graph building (1 Hz threads, poseGraphOptimization.cpp:669-675).
        # Blocking here, even one keyframe late, drains the whole dispatch
        # queue and leaves the device idle while the host refills it — a
        # pipeline bubble per keyframe that cost ~40% of deployment fps.
        for x in (cand, dist, shift):
            x.copy_to_host_async()
        self._pending_sc.append((i, cand, dist, shift))
        res_icp = self._poll_icp()
        res_sc = self._poll_sc()
        result = res_sc if res_sc is not None else res_icp

        self._pending_opt += 1
        # relaxation is a no-op until the first loop edge exists: nodes are
        # initialized by exact odometry composition, so every odometry
        # residual is zero and GN moves nothing — skip the dispatch entirely
        # (the reference's iSAM2 pays ~0 for the same reason: no new info)
        if self.loops_found and (
                result is not None or self._pending_opt >= cfg.optimize_every):
            self.graph = pg.optimize_bucketed(self.graph, self.n_kf)
            self._pending_opt = 0
        return result

    def prewarm(self) -> None:
        """Compile the RARE-EVENT device programs (ICP loop verification,
        graph relaxation) before deployment enters its steady state. Their
        first dispatch is gate-dependent (first ScanContext hit / first
        accepted loop), and a cold-cache compile landing mid-run blows the
        frame budget. Requires at
        least one keyframe; discards all side effects except the compiles."""
        if self.n_kf < 1:
            return
        self._dispatch_icp(self.n_kf - 1, max(self.n_kf - 2, 0), 0.0)
        pend = self._pending_icp.pop()  # compile side effect only
        jax.block_until_ready(pend[4])
        g = pg.optimize_bucketed(self.graph, self.n_kf)
        jax.block_until_ready(g.p)

    def _poll_sc(self, block: bool = False) -> Optional[tuple]:
        """Resolve every queued loop query whose host copy has landed
        (never blocks unless `block`). Returns the last accepted loop."""
        result = None
        while self._pending_sc:
            if not block and not self._pending_sc[0][2].is_ready():
                break
            r = self._resolve_sc(self._pending_sc.pop(0))
            result = r if r is not None else result
        return result

    def _resolve_sc(self, pending) -> Optional[tuple]:
        """Evaluate a completed ScanContext loop query: gate on distance and
        dispatch the ICP verification (resolved by _poll_icp when its
        fitness copy lands — icpCalculation is its own worker thread in the
        reference, :376-444)."""
        i, cand, dist, shift = pending
        if float(dist) >= self.cfg.sc_dist_thres:
            return None
        j = int(cand)
        # host-side yaw seed: shift * 2pi/N_SECTOR (sc.shift_to_yaw semantics
        # without dispatching a device op on the already-copied scalar)
        yaw0 = float(int(shift)) * (2.0 * np.pi / sc.N_SECTOR)
        self._dispatch_icp(i, j, yaw0)
        return self._poll_icp()

    def flush(self) -> Optional[tuple]:
        """Resolve ALL in-flight loop queries + ICP verifications (call at
        the end of a sequence / on shutdown)."""
        res_sc = self._poll_sc(block=True)
        res_icp = self._poll_icp(block=True)
        result = res_icp if res_icp is not None else res_sc
        if result is not None:
            self.graph = pg.optimize_bucketed(self.graph, self.n_kf)
            self._pending_opt = 0
        return result

    # ------------------------------------------------------------------
    def _subsample(self, pts, val, cap):
        idx = jnp.linspace(0, pts.shape[0] - 1, cap).astype(jnp.int32)
        return pts[idx], val[idx]

    def _dispatch_icp(self, i: int, j: int, yaw0: float) -> None:
        """Dispatch ICP of keyframe i vs the +-submap_half_span submap around
        j (icpCalculation :376-444) in ONE device program (submap assembly
        vmapped inside); the fitness verdict is read by _poll_icp once its
        async host copy lands."""
        cfg = self.cfg
        # fixed-size submap (static shapes): clamped index span around j
        ks = np.clip(np.arange(j - cfg.submap_half_span,
                               j + cfg.submap_half_span + 1), 0, self.n_kf - 1)
        dup = np.zeros(len(ks), bool)
        dup[1:] = ks[1:] == ks[:-1]  # clamp duplicates (ks is nondecreasing)
        q_fit, p_fit, fitness = _submap_icp(
            self.graph.q, self.graph.p, self.clouds, self.cloud_valid,
            jnp.asarray(ks, jnp.int32), jnp.asarray(dup),
            jnp.int32(i), jnp.int32(j), jnp.asarray(yaw0, self.dtype))
        fitness.copy_to_host_async()
        self._pending_icp.append((i, j, q_fit, p_fit, fitness))

    def _poll_icp(self, block: bool = False) -> Optional[tuple]:
        """Accept every completed ICP verification whose fitness passes
        (never blocks unless `block`). Returns the last accepted loop."""
        result = None
        while self._pending_icp:
            if not block and not self._pending_icp[0][4].is_ready():
                break
            i, j, q_fit, p_fit, fitness = self._pending_icp.pop(0)
            f = float(fitness)
            if np.isfinite(f) and f <= self.cfg.icp_fitness_max:
                self.graph = pg.add_loop(self.graph, jnp.int32(j),
                                         jnp.int32(i), q_fit, p_fit)
                result = (i, j)
                self.loops_found.append(result)
        return result

    # ------------------------------------------------------------------
    def poses(self):
        """(q (n, 4), p (n, 3)) of the optimized keyframe trajectory."""
        n = self.n_kf
        return np.asarray(self.graph.q[:n]), np.asarray(self.graph.p[:n])
