"""Dataset reader tests against synthesized on-disk fixtures (no real
datasets on this machine — layouts reproduced from the published formats)."""
import os

import numpy as np
import pytest

from vil_fusion_tpu.runtime import datasets


@pytest.fixture
def kitti_odom_fixture(tmp_path):
    rng = np.random.default_rng(0)
    seq = tmp_path / "sequences" / "07"
    (seq / "velodyne").mkdir(parents=True)
    (seq / "image_0").mkdir()
    n = 4
    np.savetxt(seq / "times.txt", np.arange(n) * 0.1)
    for i in range(n):
        pts = rng.normal(size=(500, 4)).astype(np.float32)
        pts.tofile(seq / "velodyne" / f"{i:06d}.bin")
        img = (rng.random((60, 80)) * 255).astype(np.uint8)
        with open(seq / "image_0" / f"{i:06d}.pgm", "wb") as f:
            f.write(b"P5\n80 60\n255\n" + img.tobytes())
    poses = np.tile(np.eye(3, 4).reshape(-1), (n, 1))
    poses[:, 3] = np.arange(n) * 1.0  # x translation
    (tmp_path / "poses").mkdir()
    np.savetxt(tmp_path / "poses" / "07.txt", poses)
    return str(tmp_path)


def test_kitti_odometry_reader(kitti_odom_fixture):
    ds = datasets.KittiOdometry(kitti_odom_fixture, "07")
    assert len(ds) == 4
    t, xyz, img = ds.frame(0)
    assert xyz.shape == (500, 3)
    assert img.shape == (60, 80)
    p, R = ds.ground_truth()
    np.testing.assert_allclose(p[:, 0], np.arange(4) * 1.0)
    evs = list(ds.events())
    kinds = [e[0] for e in evs]
    assert kinds.count("scan") == 4
    assert kinds.count("image") == 4


@pytest.fixture
def euroc_fixture(tmp_path):
    rng = np.random.default_rng(1)
    mav = tmp_path / "mav0"
    (mav / "imu0").mkdir(parents=True)
    (mav / "cam0" / "data").mkdir(parents=True)
    (mav / "state_groundtruth_estimate0").mkdir()
    t0 = 1_400_000_000_000_000_000
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for i in range(20):
            f.write(f"{t0 + i * 5_000_000},0.01,0.02,0.03,0.1,0.2,9.8\n")
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp,filename\n")
        for i in range(2):
            ts = t0 + i * 50_000_000
            name = f"{ts}.pgm"
            f.write(f"{ts},{name}\n")
            img = (rng.random((48, 64)) * 255).astype(np.uint8)
            with open(mav / "cam0" / "data" / name, "wb") as g:
                g.write(b"P5\n64 48\n255\n" + img.tobytes())
    with open(mav / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#ts,px,py,pz,qw,qx,qy,qz\n")
        for i in range(5):
            f.write(f"{t0 + i * 10_000_000},{0.1 * i},0,0,1,0,0,0\n")
    return str(tmp_path)


def test_euroc_reader(euroc_fixture):
    ds = datasets.EuRoC(euroc_fixture)
    evs = list(ds.events())
    kinds = [e[0] for e in evs]
    assert kinds.count("imu") == 20
    assert kinds.count("image") == 2
    # events time-ordered
    ts = [e[1] for e in evs]
    assert ts == sorted(ts)
    t_gt, p_gt, q_gt = ds.ground_truth()
    np.testing.assert_allclose(p_gt[:, 0], 0.1 * np.arange(5))
    # imu units mapping: acc column comes after gyro in EuRoC
    imu_evs = [e for e in evs if e[0] == "imu"]
    np.testing.assert_allclose(imu_evs[0][2], [0.1, 0.2, 9.8])
    np.testing.assert_allclose(imu_evs[0][3], [0.01, 0.02, 0.03])


@pytest.fixture
def advio_fixture(tmp_path):
    """Minimal ADVIO-like tree: separate acc/gyro clocks, extracted frames,
    one mask, ground-truth pose.csv."""
    rng = np.random.default_rng(1)
    ip = tmp_path / "advio-05" / "iphone"
    (ip / "frames").mkdir(parents=True)
    (ip / "masks").mkdir()
    (tmp_path / "advio-05" / "ground-truth").mkdir()
    t0 = 100.0
    # gyro at 100 Hz, accelerometer at 125 Hz (different clocks)
    with open(ip / "gyro.csv", "w") as f:
        for i in range(20):
            f.write(f"{t0 + i * 0.01},{0.01 * i},0.02,0.03\n")
    with open(ip / "accelerometer.csv", "w") as f:
        for i in range(25):
            f.write(f"{t0 + i * 0.008},{0.1},{0.2},{9.8 + 0.01 * i}\n")
    from PIL import Image

    with open(ip / "frames.csv", "w") as f:
        for i in range(3):
            f.write(f"{t0 + 0.02 + i * 0.05},{i}\n")
            arr = (rng.random((48, 64)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(ip / "frames" / f"{i:05d}.png")
    mask = np.zeros((48, 64), np.uint8)
    mask[10:20, 10:20] = 255
    Image.fromarray(mask).save(ip / "masks" / "00001.png")
    with open(tmp_path / "advio-05" / "ground-truth" / "pose.csv", "w") as f:
        for i in range(5):
            f.write(f"{t0 + i * 0.1},{0.2 * i},0,0,1,0,0,0\n")
    return str(tmp_path / "advio-05")


def test_advio_reader(advio_fixture):
    ds = datasets.ADVIO(advio_fixture)
    evs = list(ds.events())
    kinds = [e[0] for e in evs]
    assert kinds.count("imu") == 20
    assert kinds.count("image") == 3
    ts = [e[1] for e in evs]
    assert ts == sorted(ts)
    # accelerometer interpolated onto gyro clock: t = 100.01 -> az 9.8+0.0125
    imu_evs = [e for e in evs if e[0] == "imu"]
    np.testing.assert_allclose(imu_evs[1][2][2], 9.8 + 0.01 * (0.01 / 0.008),
                               atol=1e-6)
    np.testing.assert_allclose(imu_evs[1][3], [0.01, 0.02, 0.03])
    # the second frame carries its mask
    img_evs = [e for e in evs if e[0] == "image"]
    assert len(img_evs[1]) == 4 and img_evs[1][3][15, 15]
    assert len(img_evs[0]) == 3  # no mask extracted for frame 0
    t_gt, p_gt, q_gt = ds.ground_truth()
    np.testing.assert_allclose(p_gt[:, 0], 0.2 * np.arange(5))


def test_advio_mask_stream_through_replay(advio_fixture):
    """The reference's 4th executable workflow end-to-end: an ADVIO-style
    stream (separate-clock IMU + frames + per-frame masks,
    feature_tracker_node_mask.cpp:443-457 exact-stamp image<->mask sync)
    driven through datasets.replay into the mask-gated pipeline — NOT direct
    pipeline calls."""
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    ds = datasets.ADVIO(advio_fixture)
    rig = RigConfig(
        name="advio-test",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=40.0, fy=40.0, cx=32.0, cy=24.0),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=48, image_width=64, max_cnt=20, min_dist=8,
        q_ic=np.array([1.0, 0, 0, 0]), t_ic=np.zeros(3),
        use_lidar=False)
    pipe = VILFusionPipeline(rig, mode="mask")
    seen_masks = []
    orig_push = pipe.push_image

    def spy_push(t, img, mask=None):
        seen_masks.append(mask is not None)
        return orig_push(t, img, mask=mask)

    pipe.push_image = spy_push
    datasets.replay(pipe, ds.events())
    # all 3 frames processed; the mask shipped for frame 1 reached the
    # pipeline through the replay transport (others are mask-less VIO)
    assert len(pipe.outputs.ts) == 3
    assert seen_masks == [False, True, False]


def test_all_shipped_rigs_load():
    """Every rig the reference ships (config/{kitti,euroc,daheng,iphone,
    mynteye}) must load (C16 parity), with per-rig key facts intact."""
    from vil_fusion_tpu.runtime.config import load_rig

    rigs = {name: load_rig(f"configs/{name}.yaml")
            for name in ("kitti", "euroc", "daheng", "iphone", "mynteye")}
    assert rigs["kitti"].n_scan == 64 and rigs["kitti"].use_lidar
    assert rigs["daheng"].n_scan == 32 and rigs["daheng"].use_lidar
    assert not rigs["iphone"].use_lidar
    assert rigs["iphone"].rolling_shutter and rigs["iphone"].tr > 0
    assert rigs["iphone"].estimate_td
    assert not rigs["mynteye"].use_lidar
    assert rigs["mynteye"].td == 0.013
    for r in rigs.values():
        # extrinsic quaternions normalized
        np.testing.assert_allclose(np.linalg.norm(r.q_ic), 1.0, atol=1e-5)


def test_run_dataset_tool_on_fixture(kitti_odom_fixture, tmp_path, monkeypatch):
    """End-to-end CLI: fixture KITTI sequence through the lidar pipeline."""
    import subprocess, sys, os, json
    out = str(tmp_path / "out")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "tools/run_dataset.py", "--dataset", "kitti",
         "--data", kitti_odom_fixture, "--seq", "07",
         "--config", "configs/kitti.yaml", "--mode", "lidar", "--out", out],
        capture_output=True, text=True, timeout=420,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.load(open(os.path.join(out, "report.json")))
    assert rep["frames"] == 4
    assert "ate_rmse_vio" in rep
    assert os.path.exists(os.path.join(out, "lidar_odometry.txt"))
