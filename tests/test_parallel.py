"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vil_fusion_tpu.parallel import mesh as mesh_mod
from vil_fusion_tpu.parallel.sharded_ba import optimize_step_sharded
from vil_fusion_tpu.parallel.sharded_knn import knn_sharded
from vil_fusion_tpu.ops import knn as knn_ops


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_mesh(8)


def test_sharded_knn_matches_single_device(mesh):
    rng = np.random.default_rng(0)
    db = jnp.asarray(rng.uniform(-50, 50, (2048, 3)), jnp.float32)
    valid = jnp.asarray(rng.random(2048) > 0.1)
    q = jnp.asarray(rng.uniform(-50, 50, (128, 3)), jnp.float32)
    d2_s, idx_s = knn_sharded(mesh, q, db, valid, k=5)
    d2_r, idx_r = knn_ops.knn(q, db, valid, k=5)
    np.testing.assert_allclose(np.sort(d2_s, 1), np.sort(d2_r, 1), rtol=1e-3, atol=5e-3)
    # indices map to equivalent points
    got = ((np.asarray(q)[:, None, :] - np.asarray(db)[np.asarray(idx_s)]) ** 2).sum(-1)
    np.testing.assert_allclose(np.sort(got, 1), np.sort(d2_r, 1), rtol=1e-3, atol=5e-3)


def test_sharded_ba_step_matches_single_device(mesh):
    import __graft_entry__ as ge
    from vil_fusion_tpu.models import ba

    cfg = ba.BAConfig(max_iters=1)
    state, feats, pre, lidar, prior = ge._example_problem(f_cap=128)
    new_state, new_feats, cost = optimize_step_sharded(
        mesh, state, feats, pre, lidar, prior, cfg)
    assert np.isfinite(float(cost))
    # single-device reference: one GN step with same lambda
    sys_ = ba.build_system(state, feats, pre, lidar, prior, cfg, 1.0)
    np.testing.assert_allclose(float(cost), float(sys_.cost), rtol=1e-3)
    delta, delta_d = ba.schur_solve(sys_, jnp.float32(1e-4), cfg)
    ref_state, ref_feats = ba._apply(state, feats, delta, delta_d, cfg)
    np.testing.assert_allclose(new_state.p, ref_state.p, atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(new_feats.inv_depth), np.asarray(ref_feats.inv_depth), atol=5e-4)


def test_sharded_full_lm_loop_matches_single_device(mesh):
    """The FULL annealed LM loop (accept/reject, GNC schedule,
    re-anchoring) sharded over the mesh must match ba.optimize."""
    import __graft_entry__ as ge
    from vil_fusion_tpu.models import ba
    from vil_fusion_tpu.parallel.sharded_ba import optimize_sharded

    cfg = ba.BAConfig(max_iters=8)
    state, feats, pre, lidar, prior = ge._example_problem(f_cap=128)
    st_sh, ft_sh, cost_sh = optimize_sharded(
        mesh, state, feats, pre, lidar, prior, cfg)
    st_ref, ft_ref, cost_ref = ba.optimize(state, feats, pre, lidar, prior, cfg)
    np.testing.assert_allclose(float(cost_sh), float(cost_ref), rtol=1e-3,
                               atol=1e-5)
    # states agree to convergence level: f32 psum reduction-order noise
    # compounds through 8 accept/reject iterations in near-null directions
    np.testing.assert_allclose(np.asarray(st_sh.p), np.asarray(st_ref.p),
                               atol=5e-3)
    np.testing.assert_allclose(np.asarray(st_sh.q), np.asarray(st_ref.q),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(ft_sh.inv_depth),
                               np.asarray(ft_ref.inv_depth), atol=5e-3)


def test_sharded_ba_estimator_option(mesh):
    """BAConfig.sharded wires the sharded LM loop into the fused estimator
    step via the active mesh."""
    from vil_fusion_tpu.models import ba
    from vil_fusion_tpu.parallel import mesh as mesh_mod

    import __graft_entry__ as ge

    mesh_mod.set_active_mesh(mesh)
    try:
        state, feats, pre, lidar, prior = ge._example_problem(f_cap=128)
        cfg = ba.BAConfig(max_iters=4, sharded=True)
        from vil_fusion_tpu.parallel.sharded_ba import optimize_on_active_mesh

        st, ft, cost = optimize_on_active_mesh(state, feats, pre, lidar,
                                               prior, cfg)
        st_ref, ft_ref, cost_ref = ba.optimize(
            state, feats, pre, lidar, prior, cfg._replace(sharded=False))
        np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(st.p), np.asarray(st_ref.p),
                                   atol=1e-3)
    finally:
        mesh_mod.set_active_mesh(None)


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out[2]))


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_scancontext_matches_single_device(mesh):
    from vil_fusion_tpu.models import scancontext as sc
    from vil_fusion_tpu.parallel.sharded_sc import detect_loop_sharded
    from vil_fusion_tpu.runtime import sim

    scene = sim.RaycastScene()
    db = sc.init_db(256)
    rngs = []
    for i in range(40):
        pts, val = sim.simulate_lidar_scan(
            scene, np.eye(3), np.array([1.2 * i, 0.1 * i, 1.5]),
            n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0)
        db = sc.add_keyframe(db, sc.make_descriptor(jnp.asarray(pts), jnp.asarray(val)))
    pts, val = sim.simulate_lidar_scan(
        scene, np.eye(3), np.array([2.5, 0.25, 1.5]),
        n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0)
    q = sc.make_descriptor(jnp.asarray(pts), jnp.asarray(val))
    i_ref, d_ref, s_ref = sc.detect_loop(db, q)
    i_sh, d_sh, s_sh = detect_loop_sharded(mesh, db, q)
    assert int(i_sh) == int(i_ref)
    np.testing.assert_allclose(float(d_sh), float(d_ref), atol=1e-5)
    assert int(s_sh) == int(s_ref)


def test_batched_odometry_matches_sequential(mesh):
    """S sequences in one vmapped step == S independent runs; sequence axis
    sharded over the mesh."""
    from vil_fusion_tpu.models import lidar_features as lf, lidar_odometry as lo
    from vil_fusion_tpu.parallel import batched_odometry as bo
    from vil_fusion_tpu.runtime import sim

    cfg = lo.OdomConfig(
        lidar=lf.LidarConfig(n_scan=16, width=360, fov_up_deg=20.0,
                             fov_down_deg=-20.0, min_range=1.0,
                             edge_cap=256, surf_cap=1024),
        edge_map_cap=2048, surf_map_cap=4096)
    scene = sim.RaycastScene()
    S = 8
    scans = []
    for s in range(S):
        pts, val = sim.simulate_lidar_scan(
            scene, np.eye(3), np.array([3.0 + 2 * s, 0.5 * s, 1.5]),
            n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0)
        scans.append((pts, val))
    pts_b = jnp.asarray(np.stack([p for p, _ in scans]))
    val_b = jnp.asarray(np.stack([v for _, v in scans]))

    states = bo.shard_states(mesh, lo.init_state_batched(cfg, S))
    for _ in range(2):
        states, out = bo.odometry_step_sharded(mesh, states, pts_b, val_b, cfg)
    # reference: sequence 3 run alone
    st = lo.init_state(cfg)
    for _ in range(2):
        st, out_ref = lo.odometry_step(st, jnp.asarray(scans[3][0]),
                                       jnp.asarray(scans[3][1]), cfg)
    np.testing.assert_allclose(np.asarray(out[1][3]), np.asarray(out_ref[1]),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(states.p[3]), np.asarray(st.p), atol=1e-4)


@pytest.mark.slow
def test_pipeline_sharded_ba_deployed_e2e(mesh):
    """Multi-chip as a DEPLOYED mode, not only a solver capability: the full
    VILFusionPipeline driven for ~30 steady frames with
    ba_overrides={"sharded": True} on the 8-device mesh must reproduce the
    unsharded pipeline's trajectory."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import make_rig, R_BC, FX, FY, CX, CY, H, W
    from vil_fusion_tpu.runtime import sim
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=1.5))
    frame_dt, imu_rate, n_frames, t0 = 0.1, 200.0, 28, 1.0

    frames = []
    for i in range(n_frames):
        t = t0 + i * frame_dt
        imu = sim.simulate_imu(traj, t - frame_dt, t, imu_rate) if i else None
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        img = np.asarray(sim.render_camera_image(
            scene, R_wb @ R_BC, p_wb, FX, FY, CX, CY, H, W))
        pts, val = sim.simulate_lidar_scan(
            scene, R_wb, p_wb, n_scan=32, width=900, fov_up_deg=30.0,
            fov_down_deg=-30.0, max_range=80.0)
        frames.append((t, imu, img, np.asarray(pts), np.asarray(val)))

    def drive(ba_overrides):
        pipe = VILFusionPipeline(make_rig(), mode="vil",
                                 ba_overrides=ba_overrides)
        q0, p0 = traj.pose(t0)
        pipe.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0,
                                         v=traj.velocity(t0))
        for (t, imu, img, pts, val) in frames:
            if imu is not None:
                ts_i, acc, gyr = imu
                for k in range(1, len(ts_i)):
                    pipe.push_imu(ts_i[k], acc[k], gyr[k])
            pipe.push_scan(t, pts, val)
            pipe.push_image(t, img)
        pipe.finalize()
        assert pipe.restarts == 0
        return np.asarray(pipe.outputs.vio_p)

    mesh_mod.set_active_mesh(mesh)
    try:
        p_sharded = drive({"sharded": True})
    finally:
        mesh_mod.set_active_mesh(None)
    p_ref = drive(None)
    assert len(p_sharded) == len(p_ref) == n_frames
    # same trajectory to solver-noise level (psum reduction order compounds
    # through 28 frames of accept/reject LM + marginalization)
    np.testing.assert_allclose(p_sharded, p_ref, atol=2e-2)
