"""Visual loop closure: keyframe database, BoW detection, geometric
verification, 4-DoF graph integration, relocalization, save/load.

Rebuild of the reference's pose_graph node (C13, dormant in the shipped
launch but fully implemented — SURVEY §1 mandates rebuilding its capability):
  * KeyFrame build: corners + BRIEF for window points and extra points
    (keyframe.cpp:14-42, 75-113; 500 extra points -> `extra_cap`).
  * detectLoop: DBoW2 query top-4 with recency exclusion and score gates
    (pose_graph.cpp:307-389) -> LSH-BoW scores (models/brief.py).
  * findConnection: Hamming matching (<80) + PnP-RANSAC against the window's
    3-D points + yaw/translation acceptance gates (keyframe.cpp:200-256,
    :472-517, MIN_LOOP_NUM=25, |yaw|<30 deg, |t|<20 m).
  * 4-DoF pose graph + drift application (models/posegraph4dof.py).
  * fast relocalization: the accepted match is returned so the estimator can
    compute the drift (the reference feeds relo factors into BA,
    estimator.cpp:799-836; here the drift is solved by PnP against the loop
    keyframe — functionally equivalent decoupled form).
  * savePoseGraph/loadPoseGraph (pose_graph.cpp:701-874) -> npz checkpoint.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import brief, initialization as init_mod
from vil_fusion_tpu.models import posegraph4dof as pg4
from vil_fusion_tpu.ops import image as im
from vil_fusion_tpu.ops import lie

MIN_LOOP_NUM = 25  # keyframe.cpp MIN_LOOP_NUM
MAX_YAW_DEG = 30.0
MAX_TRANS = 20.0
RECENT_EXCLUDE = 50  # pose_graph.cpp detectLoop skip last 50


class VisualLoopConfig(NamedTuple):
    capacity: int = 2048
    win_cap: int = 256  # 3-D-anchored descriptors per keyframe: estimator
    # window landmarks PLUS lidar-depthed extra corners (see add_keyframe) —
    # raised from 128 so the depthed extras fit; the Hamming stage needs
    # >= MIN_LOOP_NUM of THESE to match, so this cap bounds verification
    # recall directly
    extra_cap: int = 384  # extra corners (reference: 500; raised from 256 —
    # every cur-window point needs its counterpart present among the OLD
    # keyframe's extras for the Hamming stage to count it, so extra
    # coverage directly scales loop-verification recall)
    score_best: float = 0.05  # detectLoop tier-1 gate on the top score
    score_min: float = 0.015  # detectLoop tier-2 gate on runner-up scores
    top_k: int = 4  # BoW query width (db.query(..., 4, ...))
    keyframe_gap: float = 1.0  # m between loop keyframes (SKIP_DIS analog)
    pnp_ransac_hyp: int = 64
    pnp_inlier_px: float = 10.0 / 460.0  # solvePnPRansac reprojectionError
    # (keyframe.cpp:227-232: 10.0/460.0 on the virtual-focal normalized plane)


class VisualLoopDB:
    """Host-side keyframe store with device-resident matrices."""

    def __init__(self, cfg: VisualLoopConfig = VisualLoopConfig(), dtype=jnp.float32,
                 qic=None, tic=None):
        self.cfg = cfg
        # camera-IMU extrinsic (keyframe poses are BODY poses; matching and
        # PnP operate in the camera frame)
        self.qic = np.asarray([1.0, 0, 0, 0] if qic is None else qic, np.float32)
        self.tic = np.asarray([0.0, 0, 0] if tic is None else tic, np.float32)
        C = cfg.capacity
        self.hists = jnp.zeros((C, brief.N_WORDS), dtype)  # BoW histograms
        self.win_desc = np.zeros((C, cfg.win_cap, 8), np.int32)
        self.win_pts3d = np.zeros((C, cfg.win_cap, 3), np.float32)  # world
        self.win_valid = np.zeros((C, cfg.win_cap), bool)
        self.extra_desc = np.zeros((C, cfg.extra_cap, 8), np.int32)
        self.extra_xy = np.zeros((C, cfg.extra_cap, 2), np.float32)  # normalized
        self.extra_valid = np.zeros((C, cfg.extra_cap), bool)
        self.q = np.zeros((C, 4), np.float32)
        self.p = np.zeros((C, 3), np.float32)
        # immutable insert-time (VIO) copies: sync_from_graph recomputes the
        # corrected q/p/win_pts3d from these, so repeated loop corrections
        # never compound (the graph likewise keeps vio_p/vio_yaw immutable)
        self.vio_q = np.zeros((C, 4), np.float32)
        self.vio_pts3d = np.zeros((C, cfg.win_cap, 3), np.float32)
        self.graph = pg4.init_graph(C)
        self.n = 0
        # per-gate observability (a 0-loop failure was once
        # unobservable — no score distribution, no per-gate kill counts).
        # Every query/verification records what each gate saw so a dead
        # detector is diagnosable from the acceptance artifact alone.
        self.stats = {
            "queries": 0, "kill_recent": 0, "kill_score_best": 0,
            "kill_score_second": 0, "detect_pass": 0,
            "verify_attempts": 0, "kill_hamming": 0, "kill_pnp": 0,
            "kill_yaw_trans": 0, "accepted": 0,
            "best_scores": [],      # top BoW score per query
            "second_scores": [],    # runner-up score per query
            "hamming_matches": [],  # Hamming-gate survivors per verification
            "pnp_inliers": [],      # PnP inlier count per verification
        }

    # ------------------------------------------------------------------
    def add_keyframe(self, img, q_wb, p_wb, pts3d_w, pts2d_px, pts_valid, cam,
                     sequence: int = 0, cloud_cam=None, cloud_valid=None):
        """Build + insert a keyframe; returns its index.

        pts3d_w: window landmarks (world); pts2d_px their pixel coords.
        cloud_cam/cloud_valid: optional camera-frame LiDAR cloud of THIS
        frame — extra corners that get a depth from it become additional
        3-D-anchored match points (filling win slots beyond the window
        landmarks). A VIL-native densification the camera-only reference
        cannot do: the estimator exports only ~50 depth-resolved landmarks
        per keyframe, and MIN_LOOP_NUM=25 Hamming matches OF the 3-D set is
        the verification bottleneck (measured: pipeline keyframes matched
        p50 15 survivors vs the 128-corner probe's 25+ at the same scale).
        `sequence` tags the session (new_sequence support): the 4-DoF graph
        omits sequential edges across session boundaries; a verified loop
        between sessions stitches them (pose_graph.cpp:45-126 merge)."""
        cfg = self.cfg
        if self.n >= cfg.capacity:
            return None  # DB full: stop inserting (caller tolerates None)
        i = self.n
        img = jnp.asarray(img, jnp.float32)

        # window-point descriptors
        wn = min(len(pts2d_px), cfg.win_cap)
        wxy = np.zeros((cfg.win_cap, 2), np.float32)
        wval = np.zeros((cfg.win_cap,), bool)
        wxy[:wn] = pts2d_px[:wn]
        wval[:wn] = pts_valid[:wn]
        wdesc = brief.brief_descriptors(img, jnp.asarray(wxy), jnp.asarray(wval))
        self.win_desc[i] = np.asarray(wdesc)
        self.win_pts3d[i, :wn] = pts3d_w[:wn]
        self.win_valid[i] = wval

        # extra corners (keyframe.cpp computeBRIEFPoint: 500 new corners,
        # detected independently — NOT suppressed around window points, since
        # loop matching must find the window points' counterparts among them)
        exy, evalid = im.detect_features(
            img, jnp.zeros((1, 2), jnp.float32), jnp.zeros((1,), bool),
            max_pts=cfg.extra_cap, min_dist=10)
        edesc = brief.brief_descriptors(img, exy, evalid)
        self.extra_desc[i] = np.asarray(edesc)
        ray = self._lift(cam, np.asarray(exy))
        self.extra_xy[i] = ray
        self.extra_valid[i] = np.asarray(evalid)

        # lidar-depthed extras -> extra 3-D anchors in the win set
        if cloud_cam is not None and wn < cfg.win_cap:
            from vil_fusion_tpu.models import depth_association as da

            dep, okd = da.feature_depth(
                jnp.asarray(ray), jnp.asarray(evalid), cloud_cam, cloud_valid)
            dep = np.asarray(dep)
            # strong-incidence (positive) depths only: grazing depths are
            # bias-prone and these points anchor loop PnP
            okd = np.asarray(okd) & (dep > 0)
            sel = np.nonzero(okd)[0][: cfg.win_cap - wn]
            if len(sel):
                R_wb = np.asarray(lie.q2R(jnp.asarray(q_wb, jnp.float32)),
                                  np.float64)
                R_ic = np.asarray(lie.q2R(jnp.asarray(self.qic, jnp.float32)),
                                  np.float64)
                R_wc = R_wb @ R_ic
                p_wc = R_wb @ np.asarray(self.tic, np.float64) \
                    + np.asarray(p_wb, np.float64)
                pc = np.concatenate([ray[sel] * dep[sel, None],
                                     dep[sel, None]], axis=1)
                m = len(sel)
                self.win_desc[i, wn:wn + m] = np.asarray(edesc)[sel]
                self.win_pts3d[i, wn:wn + m] = pc @ R_wc.T + p_wc
                self.win_valid[i, wn:wn + m] = True

        # BoW histogram over all descriptors
        all_desc = jnp.concatenate([wdesc, edesc], axis=0)
        all_valid = jnp.concatenate([jnp.asarray(wval), evalid], axis=0)
        words = brief.words_of(all_desc)
        self.hists = self.hists.at[i].set(brief.word_histogram(words, all_valid))

        self.q[i] = np.asarray(q_wb)
        self.p[i] = np.asarray(p_wb)
        self.vio_q[i] = np.asarray(q_wb)
        self.vio_pts3d[i] = self.win_pts3d[i]
        ypr = np.asarray(lie.R2ypr(lie.q2R(jnp.asarray(q_wb, jnp.float32)))) * np.pi / 180.0
        self.graph = pg4.add_node(self.graph, jnp.asarray(p_wb, jnp.float32),
                                  jnp.float32(ypr[0]), jnp.float32(ypr[1]),
                                  jnp.float32(ypr[2]), sequence)
        self.n += 1
        return i

    def _lift(self, cam, px):
        from vil_fusion_tpu.models import cameras

        ray = np.asarray(cameras.lift(cam, jnp.asarray(px, jnp.float32)))
        z = np.maximum(ray[:, 2], 1e-6)
        return (ray[:, :2] / z[:, None]).astype(np.float32)

    # ------------------------------------------------------------------
    def detect_candidates(self, i_query: int):
        """Two-tier top-k BoW query with recency exclusion (detectLoop
        :307-389): the best candidate must score > 0.05 and at least one
        RUNNER-UP must score > 0.015; the gated candidates are returned
        earliest-first (the reference's min_index scan picks the first)."""
        cfg = self.cfg
        st = self.stats
        st["queries"] += 1
        if i_query <= RECENT_EXCLUDE:
            st["kill_recent"] += 1
            return []
        scores = np.array(brief.bow_scores(self.hists[i_query], self.hists))
        scores[max(0, i_query - RECENT_EXCLUDE):] = -1.0  # db.query max_id
        top = np.argsort(scores)[::-1][: cfg.top_k]
        top_s = scores[top]
        st["best_scores"].append(float(top_s[0]))
        st["second_scores"].append(float(top_s[1]) if len(top_s) > 1 else -1.0)
        if top_s[0] < cfg.score_best:
            st["kill_score_best"] += 1
            return []
        ok = top_s > cfg.score_min
        if not ok[1:].any():  # need a second independent candidate
            st["kill_score_second"] += 1
            return []
        st["detect_pass"] += 1
        return sorted(int(j) for j in top[ok])

    def detect(self, i_query: int):
        """Earliest gated candidate (min_index scan) or None."""
        cands = self.detect_candidates(i_query)
        return cands[0] if cands else None

    def detect_and_verify(self, i_query: int):
        """Detection + geometric verification in one policy: gated candidates
        are tried earliest-first until one verifies. (The reference verifies
        only min_index each keyframe and relies on re-detection at later
        keyframes; trying the whole gated set is strictly more robust under
        our flatter LSH-BoW score distribution, with the same PnP gates as
        the arbiter.) Returns (i_old, q_rel, p_rel) or None."""
        for cand in self.detect_candidates(i_query):
            conn = self.find_connection(i_query, cand)
            if conn is not None:
                return cand, conn[0], conn[1]
        return None

    def find_connection(self, i_cur: int, i_old: int):
        """Geometric verification (findConnection keyframe.cpp:259-519):
        Hamming match cur window descriptors vs old extra descriptors, then
        PnP RANSAC of cur 3-D points against old normalized obs; accept on
        inlier count + yaw/translation gates.

        Returns None or (q_old_cur, p_old_cur): the relative pose of the
        current keyframe in the old keyframe's (drift-free) frame."""
        cfg = self.cfg
        st = self.stats
        st["verify_attempts"] += 1
        idx, ok = brief.match(
            jnp.asarray(self.win_desc[i_cur]), jnp.asarray(self.win_valid[i_cur]),
            jnp.asarray(self.extra_desc[i_old]), jnp.asarray(self.extra_valid[i_old]))
        idx = np.asarray(idx)
        ok = np.asarray(ok)
        st["hamming_matches"].append(int(ok.sum()))
        if ok.sum() < MIN_LOOP_NUM:
            st["kill_hamming"] += 1
            return None
        pts3d = self.win_pts3d[i_cur]  # current-world landmarks
        obs_old = self.extra_xy[i_old][idx]  # matched normalized obs in old cam

        # PnP RANSAC: pose of the old CAMERA in current world (keyframe poses
        # are body poses -> compose with the camera-IMU extrinsic).
        # TWO hypothesis seeds (pnp_ransac alternates between them):
        #   seed A = the old keyframe's stored pose — the reference's init
        #     (keyframe.cpp:200-256 solvePnPRansac with useExtrinsicGuess
        #     from w_R_old) — exact when the map is drift-free;
        #   seed B = the CURRENT keyframe's camera pose — under accumulated
        #     VIO drift the true solution (old camera re-expressed in the
        #     drifted current world) sits within metres of the CURRENT pose
        #     (a loop means "same place"), while seed A is a full drift
        #     length away and the local GN refinement cannot cross that
        #     basin (an acceptance run saw 0 loops at 19.4 m drift).
        qic = jnp.asarray(self.qic)
        tic = jnp.asarray(self.tic)
        q_b0 = jnp.asarray(self.q[i_old], jnp.float32)
        p_b0 = jnp.asarray(self.p[i_old], jnp.float32)
        q0, p0 = lie.pose_compose((q_b0, p_b0), (qic, tic))
        q_bc = jnp.asarray(self.q[i_cur], jnp.float32)
        p_bc = jnp.asarray(self.p[i_cur], jnp.float32)
        q0b, p0b = lie.pose_compose((q_bc, p_bc), (qic, tic))
        self._ransac_calls = getattr(self, "_ransac_calls", 0) + 1
        q_pnp_c, p_pnp_c, inl = pnp_ransac(
            jnp.asarray(pts3d), jnp.asarray(obs_old), jnp.asarray(ok),
            q0, p0, q0_alt=q0b, p0_alt=p0b,
            n_hyp=cfg.pnp_ransac_hyp, inlier_tol=cfg.pnp_inlier_px,
            key=jax.random.PRNGKey(self._ransac_calls))
        st["pnp_inliers"].append(int(inl.sum()))
        n_match = int(ok.sum())
        if (int(inl.sum()) < MIN_LOOP_NUM
                or int(inl.sum()) < 0.45 * n_match):
            # count gate = reference (MIN_LOOP_NUM, keyframe.cpp:472-517);
            # the FRACTION floor is ours: a false candidate in a repetitive
            # scene can scrape together 25 borderline-consistent inliers
            # out of 60+ matches, while genuine revisits turn 65-100% of
            # their matches into inliers (probe distributions). A wrongly
            # ACCEPTED loop re-anchors the whole window (relocalization
            # feedback) — measured a 666 m VIO teleport from one at toy
            # scale — so acceptance must be conservative.
            st["kill_pnp"] += 1
            return None
        # back to a body pose
        q_pnp, p_pnp = lie.pose_compose((q_pnp_c, p_pnp_c),
                                        lie.pose_inverse((qic, tic)))

        # relative pose: T_old_cur = T_old(pnp in cur world)^-1 * T_cur
        q_cur = jnp.asarray(self.q[i_cur], jnp.float32)
        p_cur = jnp.asarray(self.p[i_cur], jnp.float32)
        q_rel, p_rel = lie.pose_between((q_pnp, p_pnp), (q_cur, p_cur))
        ypr = np.asarray(lie.R2ypr(lie.q2R(q_rel)))
        # |yaw| / ||t|| gates at the reference's constants, PLUS a
        # drift-model bound: the loop translation measures accumulated VIO
        # drift, which cannot exceed a generous fraction of the path
        # traveled since the old keyframe — a candidate demanding a bigger
        # correction than ~8%-of-path + slack is a false match, not drift
        # (the reference's flat 20 m admits teleports on small circuits).
        path_since = abs(i_cur - i_old) * self.cfg.keyframe_gap
        t_bound = min(MAX_TRANS, max(2.0, 0.08 * path_since
                                     + 2.0 * self.cfg.keyframe_gap))
        if (abs(ypr[0]) > MAX_YAW_DEG
                or float(jnp.linalg.norm(p_rel)) > t_bound):
            st["kill_yaw_trans"] += 1
            return None
        st["accepted"] += 1
        return np.asarray(q_rel), np.asarray(p_rel)

    def close_loop(self, i_cur: int, i_old: int, q_rel, p_rel):
        """Add the loop edge (4-dof form) and re-optimize the graph."""
        ypr_rel = np.asarray(lie.R2ypr(lie.q2R(jnp.asarray(q_rel, jnp.float32))))
        self.graph = pg4.add_loop(
            self.graph, jnp.int32(i_old), jnp.int32(i_cur),
            jnp.asarray(p_rel, jnp.float32), jnp.float32(np.deg2rad(ypr_rel[0])))
        self.graph = pg4.optimize(self.graph)
        return self.graph

    def apply_drift_to_vio(self, R_d, dyaw: float, t_d):
        """Relocalization-feedback bookkeeping: when the estimator window is
        re-anchored by the loop drift, the insert-time (VIO-frame) records —
        the graph's vio_p/vio_yaw (sequential-edge measurements) and this
        store's vio_q/vio_pts3d — must move into the corrected frame too,
        or the first post-loop sequential edge would bake in the frame jump.
        A global yaw+t transform preserves all relative measurements, so the
        graph solution is unchanged."""
        n = self.n
        if n == 0:
            return
        R_d = np.asarray(R_d, np.float32)
        t_d = np.asarray(t_d, np.float32)
        g = self.graph
        vio_p_new = np.asarray(g.vio_p[:n]) @ R_d.T + t_d
        self.graph = g._replace(
            vio_p=g.vio_p.at[:n].set(jnp.asarray(vio_p_new)),
            vio_yaw=g.vio_yaw.at[:n].add(jnp.float32(dyaw)))
        half = 0.5 * float(dyaw)
        qz = np.asarray([np.cos(half), 0.0, 0.0, np.sin(half)], np.float32)
        self.vio_q[:n] = np.asarray(lie.qmul(
            jnp.asarray(np.broadcast_to(qz, (n, 4))),
            jnp.asarray(self.vio_q[:n], jnp.float32)))
        self.vio_pts3d[:n] = self.vio_pts3d[:n] @ R_d.T + t_d

    def sync_from_graph(self):
        """updatePath/updatePoses analog (pose_graph.cpp:526-576): pull the
        optimized node poses back into the keyframe store and move each
        keyframe's world landmarks by its per-node yaw+t correction, so
        future detections/verifications run in the corrected frame. Always
        recomputed from the immutable insert-time copies."""
        n = self.n
        if n == 0:
            return
        g = self.graph
        p_new = np.asarray(g.p[:n], np.float32)
        dyaw = np.asarray(g.yaw[:n] - g.vio_yaw[:n], np.float32)
        c, s = np.cos(dyaw), np.sin(dyaw)
        R = np.zeros((n, 3, 3), np.float32)
        R[:, 0, 0] = c
        R[:, 0, 1] = -s
        R[:, 1, 0] = s
        R[:, 1, 1] = c
        R[:, 2, 2] = 1.0
        t = p_new - np.einsum("nij,nj->ni", R, np.asarray(g.vio_p[:n], np.float32))
        self.p[:n] = p_new
        self.win_pts3d[:n] = (np.einsum("nij,nkj->nki", R, self.vio_pts3d[:n])
                              + t[:, None, :])
        half = 0.5 * dyaw
        qz = np.stack([np.cos(half), np.zeros_like(half), np.zeros_like(half),
                       np.sin(half)], axis=-1)
        self.q[:n] = np.asarray(lie.qmul(jnp.asarray(qz, jnp.float32),
                                         jnp.asarray(self.vio_q[:n], jnp.float32)))

    # ------------------------------------------------------------------
    def stats_summary(self) -> dict:
        """Aggregate the per-gate counters into an artifact-sized dict:
        kill counts per gate plus distributions (p50/p90/max) of the BoW
        scores, Hamming survivor counts, and PnP inlier counts actually
        observed — enough to see WHERE candidate loops die."""
        st = self.stats

        def dist(xs):
            if not xs:
                return None
            s = sorted(xs)
            n = len(s)
            return {"n": n, "p50": round(float(s[n // 2]), 4),
                    "p90": round(float(s[min(n - 1, (9 * n) // 10)]), 4),
                    "max": round(float(s[-1]), 4)}

        out = {k: v for k, v in st.items() if isinstance(v, int)}
        out["win_landmarks"] = dist(st.get("win_landmarks", []))
        out["best_score"] = dist(st["best_scores"])
        out["second_score"] = dist(st["second_scores"])
        out["hamming_survivors"] = dist(st["hamming_matches"])
        out["pnp_inlier_count"] = dist(st["pnp_inliers"])
        out["gates"] = {"score_best": self.cfg.score_best,
                        "score_min": self.cfg.score_min,
                        "min_loop_num": MIN_LOOP_NUM}
        return out

    def save(self, path: str):
        """savePoseGraph analog (pose_graph.cpp:701-755)."""
        np.savez_compressed(
            path, n=self.n, hists=np.asarray(self.hists[: self.n]),
            win_desc=self.win_desc[: self.n], win_pts3d=self.win_pts3d[: self.n],
            win_valid=self.win_valid[: self.n], extra_desc=self.extra_desc[: self.n],
            extra_xy=self.extra_xy[: self.n], extra_valid=self.extra_valid[: self.n],
            q=self.q[: self.n], p=self.p[: self.n],
            vio_q=self.vio_q[: self.n], vio_pts3d=self.vio_pts3d[: self.n],
            graph_p=np.asarray(self.graph.p), graph_yaw=np.asarray(self.graph.yaw),
            graph_pitch=np.asarray(self.graph.pitch), graph_roll=np.asarray(self.graph.roll),
            graph_seq=np.asarray(self.graph.seq),
            graph_vio_p=np.asarray(self.graph.vio_p),
            graph_vio_yaw=np.asarray(self.graph.vio_yaw))

    def load(self, path: str):
        """loadPoseGraph analog (pose_graph.cpp:756-874)."""
        d = np.load(path)
        n = int(d["n"])
        self.n = n
        self.hists = self.hists.at[:n].set(jnp.asarray(d["hists"]))
        self.win_desc[:n] = d["win_desc"]
        self.win_pts3d[:n] = d["win_pts3d"]
        self.win_valid[:n] = d["win_valid"]
        self.extra_desc[:n] = d["extra_desc"]
        self.extra_xy[:n] = d["extra_xy"]
        self.extra_valid[:n] = d["extra_valid"]
        self.q[:n] = d["q"]
        self.p[:n] = d["p"]
        self.vio_q[:n] = d["vio_q"] if "vio_q" in d else d["q"]
        self.vio_pts3d[:n] = (d["vio_pts3d"] if "vio_pts3d" in d
                              else d["win_pts3d"])
        g = self.graph
        self.graph = g._replace(
            p=g.p.at[: len(d["graph_p"])].set(jnp.asarray(d["graph_p"])),
            yaw=g.yaw.at[: len(d["graph_yaw"])].set(jnp.asarray(d["graph_yaw"])),
            pitch=g.pitch.at[: len(d["graph_pitch"])].set(jnp.asarray(d["graph_pitch"])),
            roll=g.roll.at[: len(d["graph_roll"])].set(jnp.asarray(d["graph_roll"])),
            seq=(g.seq.at[: len(d["graph_seq"])].set(jnp.asarray(d["graph_seq"]))
                 if "graph_seq" in d else g.seq),
            vio_p=(g.vio_p.at[: len(d["graph_vio_p"])].set(jnp.asarray(d["graph_vio_p"]))
                   if "graph_vio_p" in d else g.vio_p),
            vio_yaw=(g.vio_yaw.at[: len(d["graph_vio_yaw"])].set(jnp.asarray(d["graph_vio_yaw"]))
                     if "graph_vio_yaw" in d else g.vio_yaw),
            n_nodes=jnp.int32(n))


@functools.partial(jax.jit, static_argnames=("n_hyp",))
def pnp_ransac(pts3d, obs, valid, q0, p0, q0_alt=None, p0_alt=None,
               n_hyp: int = 64, inlier_tol: float = 3.0 / 460.0, key=None):
    """Batched PnP RANSAC (PnPRANSAC keyframe.cpp:200-256): each hypothesis
    refines from a prior pose using a random 6-point subset (fixed GN
    iterations), then the best-by-inliers pose is re-refined on all inliers.

    With (q0_alt, p0_alt) given, hypotheses alternate between the two seeds
    (even index -> q0/p0, odd -> alt); argmax-by-inliers picks whichever
    basin wins. See find_connection for why two seeds matter under drift.

    `key` must vary per call: with a fixed key a degenerate hypothesis set
    repeats forever instead of washing out across retries."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if q0_alt is None:
        q0_alt, p0_alt = q0, p0
    N = pts3d.shape[0]
    dtype = pts3d.dtype
    u = jax.random.uniform(key, (n_hyp, N))
    order = jnp.argsort(u - 10.0 * valid[None, :].astype(dtype), axis=1)
    sel = order[:, :6]
    use_alt = (jnp.arange(n_hyp) % 2).astype(dtype)

    def hyp(s, a):
        m = jnp.zeros((N,), dtype).at[s].set(1.0) * valid.astype(dtype)
        qs = lie.qnormalize(q0 * (1.0 - a) + q0_alt * a)
        ps = p0 * (1.0 - a) + p0_alt * a
        q, p, rep = init_mod.pnp_gn(pts3d, obs, m, qs, ps, iters=6)
        inl = valid & (rep < inlier_tol)
        return q, p, jnp.sum(inl)

    qs, ps, counts = jax.vmap(hyp)(sel, use_alt)
    b = jnp.argmax(counts)
    # iterated refinement on the growing inlier set (solvePnPRansac's
    # internal LM refinement over 100 iterations does the same: each refine
    # pulls borderline-correct correspondences inside the tolerance)
    def refine(carry, _):
        q, p = carry
        pc = lie.qrot(lie.qconj(q)[None, :], pts3d - p[None, :])
        z = jnp.maximum(pc[..., 2], 1e-4)
        rep = jnp.linalg.norm(pc[..., :2] / z[..., None] - obs, axis=-1)
        inl = valid & (rep < inlier_tol)
        q2, p2, _ = init_mod.pnp_gn(pts3d, obs, inl.astype(dtype), q, p, iters=8)
        return (q2, p2), None

    (q, p), _ = jax.lax.scan(refine, (qs[b], ps[b]), None, length=3)
    pc = lie.qrot(lie.qconj(q)[None, :], pts3d - p[None, :])
    z = jnp.maximum(pc[..., 2], 1e-4)
    rep2 = jnp.linalg.norm(pc[..., :2] / z[..., None] - obs, axis=-1)
    inl_final = valid & (rep2 < inlier_tol)
    return q, p, inl_final
