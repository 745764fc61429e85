#!/usr/bin/env python
"""Per-piece device timing of the fused estimator step (chained: each call's
carry feeds the next, perturbed at full magnitude, so no two calls are
value-identical)."""
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

import __graft_entry__ as ge
from vil_fusion_tpu.models import ba, estimator as est_mod, marginalization as marg


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
    cfg = ba.BAConfig(max_iters=8)
    state, feats, pre, lidar, prior = ge._example_problem(f_cap=128)
    ecfg = est_mod.EstimatorConfig(ba=cfg, f_cap=128, obs_cap=256)

    def wiggle(st, i):
        # full-magnitude, never-repeating perturbation of the window
        return st._replace(p=st.p + 0.01 * ((i % 7) - 3))

    def opt_step(st, i):
        st = wiggle(st, i)
        st2, _, _ = ba.optimize(st, feats, pre, lidar, prior, cfg)
        return st2

    chained("ba.optimize (8 LM iters)", opt_step, state)

    def build_step(st, i):
        st = wiggle(st, i)
        sys = ba.build_system(st, feats, pre, lidar, prior, cfg)
        return st._replace(p=st.p + sys.b[:3][None, :] * 1e-9)

    chained("  build_system (1x)", build_step, state)

    @jax.jit
    def solve_only(st):
        sys = ba.build_system(st, feats, pre, lidar, prior, cfg)
        d, dd = ba.schur_solve(sys, jnp.asarray(1e-4, st.p.dtype), cfg)
        return st._replace(p=st.p + d[:3][None, :] * 1e-9)

    chained("  build+schur_solve (1x)",
            lambda st, i: solve_only(wiggle(st, i)), state)

    def cost_step(st, i):
        st = wiggle(st, i)
        c = ba.total_cost(st, feats, pre, lidar, prior, cfg)
        return st._replace(p=st.p + c * 1e-12)

    chained("  total_cost (1x)", cost_step, state)

    def marg_step(st, i):
        st = wiggle(st, i)
        pr = marg.marginalize_old(st, feats, pre, lidar, prior, cfg)
        return st._replace(p=st.p + pr.r0[:3][None, :] * 1e-9)

    chained("marginalize_old", marg_step, state)

    def tri_step(st, i):
        st = wiggle(st, i)
        f2 = est_mod.triangulate(st, feats._replace(
            inv_depth=jnp.where(feats.lidar_flag, feats.inv_depth, -1.0)))
        return st._replace(p=st.p + f2.inv_depth[:3][None] * 1e-9)

    chained("triangulate", tri_step, state)

    def slide_step(st, i):
        st = wiggle(st, i)
        st2, f2, p2, l2 = marg.slide_old(st, feats, pre, lidar)
        return st2

    chained("slide_old", slide_step, state)

    # whole fused step for reference
    acc_b = jnp.zeros((ecfg.imu_cap, 3), jnp.float32) + jnp.asarray([0.0, 0, 9.81])
    gyr_b = jnp.zeros((ecfg.imu_cap, 3), jnp.float32)
    dt_b = jnp.full((ecfg.imu_cap - 1,), 0.005, jnp.float32)
    ids = jnp.arange(256, dtype=jnp.int32)
    xy = jnp.zeros((256, 2), jnp.float32)
    vel = jnp.zeros((256, 2), jnp.float32)
    dep = jnp.zeros((256,), jnp.float32)
    tsh = jnp.zeros((256,), jnp.float32)

    def fused(carry, i):
        window, ft, pr, ld, prior_ = carry
        window = wiggle(window, i)
        window, ft, pr, ld, prior_, out = est_mod.fused_full_step(
            window, ft, pr, ld, prior_,
            acc_b, gyr_b, dt_b, jnp.int32(20),
            ids, xy, vel, dep, tsh,
            jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.asarray(True), jnp.asarray(True), ecfg)
        return (window, ft, pr, ld, prior_)

    chained("FULL fused_full_step", fused, (state, feats, pre, lidar, prior))


if __name__ == "__main__":
    main()
