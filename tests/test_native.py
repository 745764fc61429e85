"""Native runtime tests: build, ring bus semantics, sensor loaders."""
import threading

import numpy as np
import pytest

from vil_fusion_tpu.runtime import native


def test_native_builds():
    assert native.build(), "native toolchain should build libvilrt.so"
    assert native.have_native()


def test_topic_pub_poll_roundtrip():
    t = native.Topic("test", slot_bytes=1024, capacity=8)
    payload = np.arange(64, dtype=np.float32)
    assert t.publish(1.5, payload)
    assert t.pending() == 1
    ts, data = t.poll(dtype=np.float32)
    assert ts == 1.5
    np.testing.assert_array_equal(data, payload)
    assert t.poll() is None


def test_topic_drop_oldest_when_full():
    t = native.Topic("drops", slot_bytes=8, capacity=4)
    for i in range(10):
        t.publish(float(i), np.asarray([i], np.int64))
    assert t.pending() <= 4
    assert t.dropped() >= 1
    ts, data = t.poll(dtype=np.int64)
    assert ts >= 4.0  # oldest messages were dropped


def test_topic_oversized_payload_rejected():
    t = native.Topic("small", slot_bytes=16, capacity=4)
    assert not t.publish(0.0, np.zeros(100, np.float64))


def test_topic_threaded_producer_consumer():
    t = native.Topic("spsc", slot_bytes=64, capacity=64)
    n = 2000
    got = []

    def producer():
        for i in range(n):
            while not t.publish(float(i), np.asarray([i], np.int64)):
                pass

    def consumer():
        while len(got) < n - t.dropped():
            r = t.poll(dtype=np.int64)
            if r is not None:
                got.append(int(r[1][0]))
            if t.pending() == 0 and not prod.is_alive():
                break

    prod = threading.Thread(target=producer)
    cons = threading.Thread(target=consumer)
    prod.start()
    cons.start()
    prod.join()
    cons.join(timeout=10)
    # values arrive in order (drops allowed under backpressure)
    assert len(got) > 0
    assert all(b > a for a, b in zip(got, got[1:]))


def test_load_kitti_bin(tmp_path):
    pts = np.random.default_rng(0).normal(size=(1000, 4)).astype(np.float32)
    path = tmp_path / "000000.bin"
    pts.tofile(path)
    xyz, inten = native.load_kitti_bin(str(path))
    np.testing.assert_allclose(xyz, pts[:, :3], atol=0)
    np.testing.assert_allclose(inten, pts[:, 3], atol=0)


def test_load_csv_floats(tmp_path):
    path = tmp_path / "data.csv"
    path.write_text("#header\n1.0,2.0,3.0\n4.5,5.5,6.5\n")
    out = native.load_csv_floats(str(path), 3, skip_lines=1)
    np.testing.assert_allclose(out, [[1, 2, 3], [4.5, 5.5, 6.5]])


def test_load_pgm(tmp_path):
    img = (np.arange(12, dtype=np.uint8).reshape(3, 4) * 20)
    path = tmp_path / "img.pgm"
    with open(path, "wb") as f:
        f.write(b"P5\n4 3\n255\n")
        f.write(img.tobytes())
    out = native.load_pgm(str(path))
    assert out.shape == (3, 4)
    np.testing.assert_allclose(out, img / 255.0, atol=1e-6)


# ---------------------------------------------------------------------------
# Sensor transport (runtime/transport.py): the ring bus as the deployment
# data path — reference launch/run_fusion.launch topic wiring.
# ---------------------------------------------------------------------------

def _example_events():
    rng = np.random.default_rng(3)
    evs = []
    t = 0.0
    for i in range(40):
        t += 0.005
        evs.append(("imu", t, rng.normal(size=3), rng.normal(size=3)))
        if i % 4 == 0:
            evs.append(("scan", t, rng.normal(size=(128, 3)).astype(np.float32),
                        rng.random(128) > 0.1))
        if i % 4 == 1:
            img = rng.random((24, 32)).astype(np.float32)
            if i % 8 == 1:
                evs.append(("image", t, img, rng.random((24, 32)) > 0.5))
            else:
                evs.append(("image", t, img))
    return evs


def test_transport_pack_unpack_roundtrip():
    from vil_fusion_tpu.runtime import transport

    for ev in _example_events():
        out = transport.unpack_event(ev[1], transport.pack_event(ev))
        assert out[0] == ev[0]
        assert out[1] == ev[1]
        assert len(out) == len(ev)
        for a, b in zip(out[2:], ev[2:]):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def test_sensor_bus_preserves_order_and_values():
    from vil_fusion_tpu.runtime import transport

    evs = _example_events()
    # tiny capacity so producer backpressure (no drop-oldest) is exercised
    bus = transport.SensorBus(slot_bytes=1 << 16, capacity=4).start(iter(evs))
    got = list(bus.subscribe())
    assert bus.topic.dropped() == 0, "replay transport must never drop"
    assert len(got) == len(evs)
    for g, e in zip(got, evs):
        assert g[0] == e[0] and g[1] == e[1]
        for a, b in zip(g[2:], e[2:]):
            np.testing.assert_array_equal(a, b)


def test_transport_propagates_producer_error():
    from vil_fusion_tpu.runtime import transport

    def bad_iter():
        yield ("imu", 0.1, np.zeros(3), np.zeros(3))
        raise IOError("corrupt file")

    with pytest.raises(IOError, match="corrupt file"):
        list(transport.prefetch(bad_iter()))
