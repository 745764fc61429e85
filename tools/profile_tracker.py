#!/usr/bin/env python
"""Per-piece device timing of the visual tracker (chained; see profile_vil)."""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from vil_fusion_tpu.utils.compile_cache import use_compile_cache

use_compile_cache()
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import cameras as cam_mod
from vil_fusion_tpu.models import klt, tracker as trk
from vil_fusion_tpu.ops import image as im


def chained(name, step_fn, state0, n=20, warm=3):
    s = state0
    for i in range(warm):
        s = step_fn(s, i)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    for i in range(n):
        s = step_fn(s, i)
    jax.block_until_ready(s)
    ms = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:40s} {ms:8.2f} ms", flush=True)
    return s


def main():
    H, W = 370, 1226
    rng = np.random.default_rng(0)
    imgs = [jnp.asarray(rng.random((H, W), np.float32)) for _ in range(4)]
    cam = cam_mod.from_config(dict(
        model_type="PINHOLE",
        projection_parameters=dict(fx=718.0, fy=718.0, cx=607.0, cy=185.0),
        distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)))
    cfg = trk.TrackerConfig(max_cnt=150, min_dist=30, cap=256)
    state = trk.init_tracker(H, W, cfg)

    pts = jnp.asarray(rng.uniform((20, 20), (W - 20, H - 20),
                                  (256, 2)).astype(np.float32))
    valid = jnp.ones(256, bool)

    @jax.jit
    def pyr_grad(img):
        pyr = im.build_pyramid(img, 4)
        grads = [im.sobel(p) for p in pyr]
        return sum(g[0][0, 0] + g[1][0, 0] for g in grads)

    chained("build_pyramid+sobel (1 image)",
            lambda s, i: pyr_grad(imgs[i % 4] + s * 0),
            jnp.zeros(()))

    @jax.jit
    def det(img):
        xy, ok = im.detect_features(img, pts, valid, max_pts=256, min_dist=30)
        return xy[0, 0]

    chained("detect_features", lambda s, i: det(imgs[i % 4] + s * 0),
            jnp.zeros(()))

    @jax.jit
    def lk(img1, img2, p):
        out, st = klt.track_pyramidal(img1, img2, p, valid)
        return out

    chained("track_pyramidal (256 pts)",
            lambda s, i: lk(imgs[i % 4], imgs[(i + 1) % 4], pts + s * 0),
            pts)

    @jax.jit
    def rans(p, i):
        x1 = p / 460.0
        x2 = x1 + 0.001
        inl, F = klt.ransac_fundamental(x1, x2, valid, jax.random.PRNGKey(i))
        return p + F[0, 0] * 0

    chained("ransac_fundamental", lambda s, i: rans(s, i), pts)

    def full(s, i):
        s2, obs = trk.track_step(s, imgs[i % 4], jnp.float32(i * 0.1), cam,
                                 cfg, key=jax.random.PRNGKey(i))
        return s2

    chained("FULL track_step", full, state)


if __name__ == "__main__":
    main()
