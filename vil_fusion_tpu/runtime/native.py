"""ctypes bindings for the native runtime (ring bus + sensor IO).

Builds `libvilrt.so` on demand (make in vil_fusion_tpu/native). Every entry
point has a pure-Python fallback so the framework stays usable without a
toolchain; the native path is the production one (the reference's runtime is
C++ throughout — this is its counterpart for the host side).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvilrt.so")
_lib = None


def build(force: bool = False) -> bool:
    """Compile the native library; returns True on success."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.topic_create.restype = ctypes.c_void_p
    lib.topic_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.topic_destroy.argtypes = [ctypes.c_void_p]
    lib.topic_publish.restype = ctypes.c_int
    lib.topic_publish.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                  ctypes.c_void_p, ctypes.c_uint32]
    lib.topic_poll.restype = ctypes.c_int
    lib.topic_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                               ctypes.c_void_p, ctypes.c_uint32]
    lib.topic_pending.restype = ctypes.c_uint64
    lib.topic_pending.argtypes = [ctypes.c_void_p]
    lib.topic_dropped.restype = ctypes.c_uint64
    lib.topic_dropped.argtypes = [ctypes.c_void_p]
    lib.load_kitti_bin.restype = ctypes.c_int64
    lib.load_kitti_bin.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64]
    lib.load_csv_floats.restype = ctypes.c_int64
    lib.load_csv_floats.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.load_pgm.restype = ctypes.c_int64
    lib.load_pgm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_int64]
    _lib = lib
    return lib


def have_native() -> bool:
    return _load() is not None


class Topic:
    """Typed message channel: native lock-free SPSC ring when available,
    Python deque otherwise. Payloads are numpy arrays of a fixed dtype/shape
    budget (slot_bytes)."""

    def __init__(self, name: str, slot_bytes: int, capacity: int = 256):
        self.name = name
        self.slot_bytes = slot_bytes
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.topic_create(name.encode(), slot_bytes, capacity)
        else:
            from collections import deque

            self._q = deque(maxlen=capacity)
            self._dropped = 0

    def publish(self, timestamp: float, payload: np.ndarray) -> bool:
        buf = np.ascontiguousarray(payload)
        if self._lib is not None:
            return bool(self._lib.topic_publish(
                self._h, float(timestamp), buf.ctypes.data_as(ctypes.c_void_p),
                buf.nbytes))
        if buf.nbytes > self.slot_bytes:
            return False
        if len(self._q) == self._q.maxlen:
            self._dropped += 1
        self._q.append((float(timestamp), buf.copy()))
        return True

    def poll(self, dtype=np.uint8) -> Optional[tuple]:
        """Returns (timestamp, array) or None."""
        if self._lib is not None:
            out = np.empty(self.slot_bytes, np.uint8)
            ts = ctypes.c_double()
            n = self._lib.topic_poll(self._h, ctypes.byref(ts),
                                     out.ctypes.data_as(ctypes.c_void_p),
                                     self.slot_bytes)
            if n <= 0:
                return None
            return ts.value, out[:n].view(dtype)
        if not self._q:
            return None
        ts, buf = self._q.popleft()
        return ts, buf.reshape(-1).view(dtype)

    def pending(self) -> int:
        if self._lib is not None:
            return int(self._lib.topic_pending(self._h))
        return len(self._q)

    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.topic_dropped(self._h))
        return self._dropped

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.topic_destroy(self._h)
            self._h = None


def load_kitti_bin(path: str, max_pts: int = 200_000):
    """(xyz (n, 3) float32, intensity (n,)) from a velodyne .bin."""
    lib = _load()
    if lib is not None:
        xyz = np.empty((max_pts, 3), np.float32)
        inten = np.empty((max_pts,), np.float32)
        n = lib.load_kitti_bin(path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
                               inten.ctypes.data_as(ctypes.c_void_p), max_pts)
        if n < 0:
            raise FileNotFoundError(path)
        return xyz[:n], inten[:n]
    raw = np.fromfile(path, np.float32).reshape(-1, 4)[:max_pts]
    return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3])


def load_csv_floats(path: str, n_cols: int, max_rows: int = 1_000_000,
                    skip_lines: int = 0):
    lib = _load()
    if lib is not None:
        out = np.empty((max_rows, n_cols), np.float64)
        n = lib.load_csv_floats(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                                n_cols, max_rows, skip_lines)
        if n < 0:
            raise FileNotFoundError(path)
        return out[:n]
    return np.loadtxt(path, delimiter=",", skiprows=skip_lines,
                      usecols=range(n_cols), ndmin=2)[:max_rows]


def load_pgm(path: str, max_h: int = 2048, max_w: int = 2048):
    lib = _load()
    if lib is not None:
        out = np.zeros((max_h, max_w), np.float32)
        r = lib.load_pgm(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                         max_h, max_w)
        if r < 0:
            raise IOError(f"failed to read PGM {path}")
        h, w = int(r >> 32), int(r & 0xFFFFFFFF)
        return np.ascontiguousarray(out[:h, :w])
    # minimal python fallback
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
    return (data / maxval).astype(np.float32)
