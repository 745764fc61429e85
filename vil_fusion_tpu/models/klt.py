"""Pyramidal Lucas-Kanade tracking + batched RANSAC fundamental matrix.

Rebuild of the reference tracker's core algorithms
(feature_tracker.cpp: cv::calcOpticalFlowPyrLK(21x21, 3 levels) :151,
rejectWithF (lift -> virtual pinhole -> FM_RANSAC, 1 px) :383-420).

Accelerator-first: one vmapped LK solver over all features (each feature is
a 2x2 normal system per iteration — pure elementwise work), fixed pyramid levels and
iteration counts; RANSAC as a fixed batch of hypotheses solved with batched
eigh + argmax (no early exit — SURVEY.md §7 "RANSAC/PnP control flow").
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vil_fusion_tpu.ops import image as im


def _patch(img_padded, center, size: int, pad: int):
    """(size, size) bilinear patch centered at fractional `center` via ONE
    contiguous dynamic_slice + 4-tap mix. Per-pixel gather indexing lowers
    to slow random gathers; a contiguous (size+1)^2 slice per feature
    is the fast access pattern.

    `img_padded` is edge-padded by `pad` >= size//2 + 1 so slices never
    clamp: start-clamping silently misaligns template vs current patches for
    features near the borders of coarse pyramid levels (observed as divergent
    tracks). Centers are in UNPADDED image coordinates."""
    r = size // 2
    tl = center - r + pad  # top-left (x, y) in padded coords
    tl_i = jnp.floor(tl)
    fx = tl[0] - tl_i[0]
    fy = tl[1] - tl_i[1]
    y0 = jnp.clip(tl_i[1].astype(jnp.int32), 0, img_padded.shape[0] - size - 1)
    x0 = jnp.clip(tl_i[0].astype(jnp.int32), 0, img_padded.shape[1] - size - 1)
    raw = jax.lax.dynamic_slice(img_padded, (y0, x0), (size + 1, size + 1))
    return ((1 - fx) * (1 - fy) * raw[:size, :size]
            + fx * (1 - fy) * raw[:size, 1:]
            + (1 - fx) * fy * raw[1:, :size]
            + fx * fy * raw[1:, 1:])


def _patch_stack(stack_padded, center, size: int, pad: int):
    """Like _patch but over a (C, Hp, Wp) channel stack: ONE dynamic_slice
    fetches all C planes (template + both gradients), cutting the dominant
    per-feature gather count 3x at template-build time."""
    r = size // 2
    tl = center - r + pad
    tl_i = jnp.floor(tl)
    fx = tl[0] - tl_i[0]
    fy = tl[1] - tl_i[1]
    y0 = jnp.clip(tl_i[1].astype(jnp.int32), 0, stack_padded.shape[1] - size - 1)
    x0 = jnp.clip(tl_i[0].astype(jnp.int32), 0, stack_padded.shape[2] - size - 1)
    C = stack_padded.shape[0]
    raw = jax.lax.dynamic_slice(stack_padded, (0, y0, x0),
                                (C, size + 1, size + 1))
    return ((1 - fx) * (1 - fy) * raw[:, :size, :size]
            + fx * (1 - fy) * raw[:, :size, 1:]
            + (1 - fx) * fy * raw[:, 1:, :size]
            + fx * fy * raw[:, 1:, 1:])


@functools.partial(jax.jit,
                   static_argnames=("win_radius", "iters", "levels", "taper",
                                    "region"))
def track_pyramidal(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    pts: jnp.ndarray,  # (N, 2) positions in img1
    valid: jnp.ndarray,  # (N,)
    win_radius: int = 10,  # 21x21 window like the reference
    iters: int = 10,
    levels: int = 4,  # cv::calcOpticalFlowPyrLK(21x21, maxLevel=3) = levels 0..3
    taper: bool = True,
    region: bool = True,  # gather-free refinement levels (False: per-iteration gathers everywhere)
):
    """Track pts from img1 to img2. Returns (new_pts (N, 2), status (N,)).

    `iters` is the budget at the COARSEST level; with `taper` (deployed
    default) finer levels run a tapering count (the coarse solve leaves
    sub-pixel residual motion, 3-5 Newton steps absorb it —
    cv::TermCriteria(30, 0.01) converges in the same range). The sequential
    gather rounds are the tracker's dominant device cost, so the taper is a
    direct wall-clock cut. `taper=False` runs the full budget at every level
    (the accuracy-reference configuration the quality-guard test compares
    against, tests/test_vision.py::test_klt_taper_quality_guard)."""
    dtype = img1.dtype
    pyr1 = im.build_pyramid(img1, levels)
    pyr2 = im.build_pyramid(img2, levels)
    grads1 = [im.sobel(p) for p in pyr1]

    S = 2 * win_radius + 1
    # region margin for the gather-free refinement levels: after the coarser
    # level converged and its estimate was upsampled, the residual motion at
    # the next level is a few px; M bounds it. A residual beyond M clamps the
    # sampling offset -> the track fails the final appearance check instead
    # of silently diverging (held by test_klt_taper_quality_guard).
    M = 5
    SR = S + 2 * M + 1  # region side (=32 at the default win_radius 10)
    PAD = win_radius + M + 2
    epad = lambda a: jnp.pad(a, PAD, mode="edge")
    guess = pts / (2.0 ** (levels - 1))

    dgrid = jnp.arange(S, dtype=dtype) - win_radius
    sgrid = jnp.arange(S, dtype=dtype)
    rgrid = jnp.arange(SR, dtype=dtype)

    for lvl in range(levels - 1, -1, -1):
        # taper: full budget at the coarsest level, >=4 at the finest
        lvl_iters = (max(iters - 2 * (levels - 1 - lvl), min(iters, 4))
                     if taper else iters)
        scale = 2.0 ** lvl
        p1_l = pts / scale
        Hl, Wl = pyr1[lvl].shape  # unpadded level dims for in-bounds masks
        tpl_stack = jnp.stack([epad(pyr1[lvl]), epad(grads1[lvl][0]),
                               epad(grads1[lvl][1])])
        i2 = epad(pyr2[lvl])

        def _wmask(p):
            # separable in-bounds weights: padded content must NOT enter the
            # normal equations (replicated edges are fabricated data and drag
            # the solution at coarse levels where patches overlap borders)
            wx = ((p[0] + dgrid >= 0) & (p[0] + dgrid <= Wl - 1.001)).astype(dtype)
            wy = ((p[1] + dgrid >= 0) & (p[1] + dgrid <= Hl - 1.001)).astype(dtype)
            return wy[:, None] * wx[None, :]

        def _template(p1):
            t, gx, gy = _patch_stack(tpl_stack, p1, S, PAD)
            w = _wmask(p1)
            gxx = jnp.sum(w * gx * gx)
            gxy = jnp.sum(w * gx * gy)
            gyy = jnp.sum(w * gy * gy)
            det = gxx * gyy - gxy * gxy
            ok = det > 1e-8
            inv = jnp.where(ok, 1.0 / jnp.maximum(det, 1e-8), 0.0)
            return t, gx, gy, w, gxx, gxy, gyy, inv, ok

        def _newton(t, gx, gy, w, gxx, gxy, gyy, inv, cur, wm2):
            e = (t - cur) * w * wm2
            bx = jnp.sum(gx * e)
            by = jnp.sum(gy * e)
            dx = inv * (gyy * bx - gxy * by)
            dy = inv * (-gxy * bx + gxx * by)
            return jnp.stack([dx, dy])

        if lvl == levels - 1 or not region:
            # coarsest level: the initial displacement is unbounded, so the
            # current patch is re-gathered from the image every iteration.
            # NOTE: a fixed fori_loop, not a convergence-gated
            # lax.while_loop: the opaque loop defeats XLA's unrolling and
            # pipelining of the patch gathers and adds a cross-feature cond
            # reduction per round.
            def track_one(p1, g):
                t, gx, gy, w, gxx, gxy, gyy, inv, ok = _template(p1)

                def body(_, p2):
                    cur = _patch(i2, p2, S, PAD)
                    return p2 + _newton(t, gx, gy, w, gxx, gxy, gyy, inv,
                                        cur, _wmask(p2))

                p2 = jax.lax.fori_loop(0, lvl_iters, body, g)
                return p2, ok
        else:
            # refinement levels: ONE region gather per feature, then every
            # Newton iteration samples the window by bilinear interpolation
            # MATMULS against the in-register region — the per-iteration
            # image gathers (the tracker's dominant device cost: random
            # 22x22 slices are latency-bound at ~2 GB/s effective) never
            # happen here. cur = Wy @ R @ Wx^T with banded (S, SR) weights.
            def track_one(p1, g):
                t, gx, gy, w, gxx, gxy, gyy, inv, ok = _template(p1)
                tl = jnp.floor(g - win_radius - M)  # region top-left (x, y)
                ry = jnp.clip(tl[1].astype(jnp.int32) + PAD, 0,
                              i2.shape[0] - SR - 1)
                rx = jnp.clip(tl[0].astype(jnp.int32) + PAD, 0,
                              i2.shape[1] - SR - 1)
                R = jax.lax.dynamic_slice(i2, (ry, rx), (SR, SR))
                anchor = jnp.stack([(rx - PAD).astype(dtype),
                                    (ry - PAD).astype(dtype)])

                def body(_, p2):
                    off = jnp.clip(p2 - win_radius - anchor, 0.0, 2.0 * M + 0.999)
                    Wx = jnp.maximum(
                        0.0, 1.0 - jnp.abs(rgrid[None, :] - (off[0] + sgrid[:, None])))
                    Wy = jnp.maximum(
                        0.0, 1.0 - jnp.abs(rgrid[None, :] - (off[1] + sgrid[:, None])))
                    cur = Wy @ R @ Wx.T
                    p2c = anchor + off + win_radius  # clamped effective pos
                    return p2 + _newton(t, gx, gy, w, gxx, gxy, gyy, inv,
                                        cur, _wmask(p2c))

                p2 = jax.lax.fori_loop(0, lvl_iters, body, g)
                return p2, ok

        guess, g_ok = jax.vmap(track_one)(p1_l, guess)
        if lvl > 0:
            guess = guess * 2.0

    H, W = img1.shape
    inb = ((guess[:, 0] >= 1) & (guess[:, 0] < W - 1)
           & (guess[:, 1] >= 1) & (guess[:, 1] < H - 1))

    # final appearance check: mean abs residual over the window
    p1_pad = epad(pyr1[0])
    p2_pad = epad(pyr2[0])

    def resid(p1, p2):
        t = _patch(p1_pad, p1, S, PAD)
        c = _patch(p2_pad, p2, S, PAD)
        return jnp.mean(jnp.abs(t - c))

    res = jax.vmap(resid)(pts, guess)
    status = valid & g_ok & inb & (res < 0.25)
    return guess, status


@functools.partial(jax.jit, static_argnames=("n_hyp", "thresh_px", "focal"))
def ransac_fundamental(
    x1: jnp.ndarray,  # (N, 2) normalized-plane coords, frame 1
    x2: jnp.ndarray,  # (N, 2) frame 2
    valid: jnp.ndarray,  # (N,)
    key: jnp.ndarray,
    n_hyp: int = 128,
    thresh_px: float = 1.0,  # F_THRESHOLD (reference rejectWithF)
    focal: float = 460.0,  # virtual pinhole focal (rejectWithF :395)
):
    """Batched 8-point RANSAC; returns (inlier_mask (N,), best_F (3, 3)).

    Fixed hypothesis count + argmax instead of adaptive early exit."""
    N = x1.shape[0]
    dtype = x1.dtype
    # virtual pinhole pixels (translation drops out of F estimation)
    p1 = x1 * focal
    p2 = x2 * focal

    # biased random permutations: valid points first
    u = jax.random.uniform(key, (n_hyp, N))
    order = jnp.argsort(u - 10.0 * valid[None, :].astype(dtype), axis=1)
    sel = order[:, :8]  # (B, 8)

    a1 = p1[sel]  # (B, 8, 2)
    a2 = p2[sel]

    def hartley(p):
        c = p.mean(axis=1, keepdims=True)
        s = jnp.sqrt(2.0) / (jnp.linalg.norm(p - c, axis=-1).mean(axis=1, keepdims=True) + 1e-9)
        return (p - c) * s[..., None], c[:, 0], s[:, 0]

    n1, c1, s1 = hartley(a1)
    n2, c2, s2 = hartley(a2)

    def rows(q1, q2):
        x1_, y1_ = q1[..., 0], q1[..., 1]
        x2_, y2_ = q2[..., 0], q2[..., 1]
        one = jnp.ones_like(x1_)
        return jnp.stack([x2_ * x1_, x2_ * y1_, x2_, y2_ * x1_, y2_ * y1_, y2_,
                          x1_, y1_, one], axis=-1)

    A = rows(n1, n2)  # (B, 8, 9)
    AtA = jnp.einsum("bri,brj->bij", A, A)
    # nullspace via Cholesky inverse iteration (batched 9x9 eigh lowers to a
    # long QR chain; this is one factorization + 4 triangular solves)
    from vil_fusion_tpu.ops import linalg as fast_linalg

    f = fast_linalg.smallest_eigvec_inverse_iteration(AtA)
    Fn = f.reshape(-1, 3, 3)
    # rank-2 projection without SVD: v3 = smallest right-singular vector
    # (smallest eigenvector of F^T F, closed form), F2 = F (I - v3 v3^T)
    _, v3 = fast_linalg.sym3x3_smallest(
        jnp.einsum("bki,bkj->bij", Fn, Fn))
    Fn = Fn - jnp.einsum("bij,bj,bk->bik", Fn, v3, v3)
    # denormalize: F = T2^T Fn T1  with T = [[s,0,-s cx],[0,s,-s cy],[0,0,1]]
    def make_T(c, s):
        B = c.shape[0]
        T = jnp.zeros((B, 3, 3), dtype)
        T = T.at[:, 0, 0].set(s).at[:, 1, 1].set(s).at[:, 2, 2].set(1.0)
        T = T.at[:, 0, 2].set(-s * c[:, 0]).at[:, 1, 2].set(-s * c[:, 1])
        return T

    T1 = make_T(c1, s1)
    T2 = make_T(c2, s2)
    F = jnp.swapaxes(T2, 1, 2) @ Fn @ T1  # (B, 3, 3)

    # Sampson distance of ALL points under each hypothesis
    ph1 = jnp.concatenate([p1, jnp.ones((N, 1), dtype)], axis=-1)  # (N, 3)
    ph2 = jnp.concatenate([p2, jnp.ones((N, 1), dtype)], axis=-1)
    Fx1 = jnp.einsum("bij,nj->bni", F, ph1)
    Ftx2 = jnp.einsum("bji,nj->bni", F, ph2)
    num = jnp.einsum("ni,bni->bn", ph2, Fx1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    d2 = num / jnp.maximum(den, 1e-12)  # (B, N)
    inl = (d2 < thresh_px**2) & valid[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    return inl[best], F[best]
