"""Image operations for the visual front end (pure jnp/lax).

Replaces the OpenCV primitives the reference's tracker uses
(feature_tracker.cpp: cv::calcOpticalFlowPyrLK :151, cv::goodFeaturesToTrack
:190, cv::CLAHE :125-131): pyramids via average pooling, gradients via Sobel
convs, patch gathers via vectorized bilinear sampling, NMS via reduce_window —
all static-shape, batched over features.

Convention: grayscale images (H, W) float32; points are (x, y) = (col, row).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def bilinear_sample(img: jnp.ndarray, xy: jnp.ndarray):
    """Sample img (H, W) at xy (..., 2) float positions; clamps to border.

    Returns (values (...,), in_bounds (...,))."""
    H, W = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return val, inb


# Image convs explicitly opt OUT of the package-wide float32 matmul
# precision (vil_fusion_tpu/__init__.py): on the GPU they may run in TF32,
# whose 10-bit mantissa resolves 0..1 pixel values finer than the sensor's
# own 1/255 quantization (the reference runs on uint8 images). chip_smoke.py's
# pipeline phase (tracked-feature count and ATE) covers this choice.
_FAST = jax.lax.Precision.DEFAULT


def _conv2(img, kernel):
    return jax.lax.conv_general_dilated(
        img[None, None], kernel[None, None].astype(img.dtype),
        window_strides=(1, 1), padding="SAME", precision=_FAST)[0, 0]


# Shift-and-add in place of conv_general_dilated for the tiny fixed stencils:
# a single-channel 2-D conv has no channel parallelism to amortize the
# convolution emitter, while padded slices + fused adds are plain
# elementwise work. Zero padding matches padding="SAME" semantics exactly.

def sobel(img: jnp.ndarray):
    """(Ix, Iy) Sobel gradients, scaled 1/8 (derivative of intensity/px)."""
    p = jnp.pad(img, 1)
    tl, tc, tr = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    ml, mr = p[1:-1, :-2], p[1:-1, 2:]
    bl, bc, br = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    ix = ((tr - tl) + 2.0 * (mr - ml) + (br - bl)) * 0.125
    iy = ((bl - tl) + 2.0 * (bc - tc) + (br - tr)) * 0.125
    return ix, iy


def box_filter(img: jnp.ndarray, radius: int):
    """Sum over (2r+1)^2 window, separable shift-and-add (zero-padded)."""
    p = jnp.pad(img, ((radius, radius), (0, 0)))
    H = img.shape[0]
    tmp = p[:H]
    for d in range(1, 2 * radius + 1):
        tmp = tmp + p[d:d + H]
    p = jnp.pad(tmp, ((0, 0), (radius, radius)))
    W = img.shape[1]
    out = p[:, :W]
    for d in range(1, 2 * radius + 1):
        out = out + p[:, d:d + W]
    return out


def avg_pool2(img: jnp.ndarray):
    """2x2 average pooling (pyramid downsample)."""
    H, W = img.shape
    return img[: H // 2 * 2, : W // 2 * 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))


def build_pyramid(img: jnp.ndarray, levels: int):
    """[img, img/2, img/4, ...] — cv::buildOpticalFlowPyramid analog."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(avg_pool2(pyr[-1]))
    return pyr


def max_pool_same(img: jnp.ndarray, radius: int):
    """Separable max pool: two 1-D windows instead of one (2r+1)^2 window —
    a 61x61 2-D reduce_window costs ~30x more and dominated feature
    detection at KITTI image sizes."""
    w = 2 * radius + 1
    tmp = jax.lax.reduce_window(img, -jnp.inf, jax.lax.max, (w, 1), (1, 1), "SAME")
    return jax.lax.reduce_window(tmp, -jnp.inf, jax.lax.max, (1, w), (1, 1), "SAME")


def shi_tomasi_response(img: jnp.ndarray, window_radius: int = 1):
    """Min-eigenvalue of the structure tensor (goodFeaturesToTrack score)."""
    ix, iy = sobel(img)
    a = box_filter(ix * ix, window_radius)
    b = box_filter(ix * iy, window_radius)
    c = box_filter(iy * iy, window_radius)
    tr = a + c
    det_part = jnp.sqrt(jnp.maximum((a - c) ** 2 + 4 * b * b, 0.0))
    return 0.5 * (tr - det_part)


def clahe(img: jnp.ndarray, grid: int = 8, clip_limit: float = 3.0,
          bins: int = 128):
    """True CLAHE (cv::createCLAHE(3.0, 8x8), feature_tracker.cpp:125-131):
    per-tile clip-limited histogram -> CDF lookup tables, bilinearly blended
    between the 4 neighboring tiles per pixel, with intra-bin interpolation
    so float imagery is not quantized to `bins` levels.

    Dense shape: the histogram is a one-hot matmul per tile, the LUTs are a
    (grid*grid*bins,) table small enough that the 8 per-pixel gathers stay
    in cache. Input/output float [0, 1]."""
    H, W = img.shape
    th, tw = -(-H // grid), -(-W // grid)
    Hp, Wp = th * grid, tw * grid
    imgp = jnp.pad(img, ((0, Hp - H), (0, Wp - W)), mode="edge")
    tiles = imgp.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(grid * grid, th * tw)
    idx = jnp.clip((tiles * bins).astype(jnp.int32), 0, bins - 1)
    hist = jax.nn.one_hot(idx, bins, dtype=img.dtype).sum(axis=1)  # (T, B)
    # clip + uniform redistribution of the excess (single pass, as OpenCV)
    limit = max(clip_limit * (th * tw) / bins, 1.0)
    excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=-1, keepdims=True)
    hist = jnp.minimum(hist, limit) + excess / bins
    cdf = jnp.cumsum(hist, axis=-1)
    cdf_min = cdf[:, :1]
    denom = jnp.maximum(cdf[:, -1:] - cdf_min, 1.0)
    lut = (cdf - cdf_min) / denom  # (T, B) in [0, 1]
    flat = lut.reshape(-1)

    # tile-space pixel coords (tile centers at integer coords)
    yy = (jnp.arange(H, dtype=img.dtype) + 0.5) / th - 0.5
    xx = (jnp.arange(W, dtype=img.dtype) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, grid - 1)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, grid - 1)
    y1 = jnp.minimum(y0 + 1, grid - 1)
    x1 = jnp.minimum(x0 + 1, grid - 1)
    fy = jnp.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = jnp.clip(xx - x0, 0.0, 1.0)[None, :]
    # intra-bin interpolation: value v sits between bin centers b and b+1
    bf = jnp.clip(img * bins - 0.5, 0.0, bins - 1.001)
    b0 = bf.astype(jnp.int32)
    fb = bf - b0

    def sample(ty, tx, b):
        gi = (ty[:, None] * grid + tx[None, :]) * bins + b
        return flat[gi]

    def tile_val(ty, tx):
        return (sample(ty, tx, b0) * (1.0 - fb)
                + sample(ty, tx, jnp.minimum(b0 + 1, bins - 1)) * fb)

    v00 = tile_val(y0, x0)
    v01 = tile_val(y0, x1)
    v10 = tile_val(y1, x0)
    v11 = tile_val(y1, x1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def clahe_like(img: jnp.ndarray, grid: int = 8, clip: float = 0.03):
    """Cheap local contrast normalization standing in for cv::CLAHE
    (feature_tracker.cpp:125-131): per-tile mean/std normalization blended
    bilinearly — preserves the tracker-relevant property (gradient
    equalization in dark regions) with pure tensor ops."""
    H, W = img.shape
    th, tw = H // grid, W // grid
    tiles = img[: th * grid, : tw * grid].reshape(grid, th, grid, tw)
    mean = tiles.mean((1, 3))
    std = tiles.std((1, 3)) + clip
    mean_up = jax.image.resize(mean, (H, W), "linear")
    std_up = jax.image.resize(std, (H, W), "linear")
    out = (img - mean_up) / std_up
    return (out - out.min()) / (out.max() - out.min() + 1e-6)


@functools.partial(jax.jit, static_argnames=("max_pts", "min_dist", "block"))
def detect_features(
    img: jnp.ndarray,
    occupied_xy: jnp.ndarray,  # (M, 2) existing feature positions
    occupied_valid: jnp.ndarray,  # (M,)
    max_pts: int,
    min_dist: int = 30,
    quality: float = 0.01,
    block: int = 3,
):
    """Shi-Tomasi corners with min-dist suppression and existing-track masking
    (FeatureTracker::setMask :36-71 + goodFeaturesToTrack :190).

    Returns (xy (max_pts, 2), valid (max_pts,)).
    """
    H, W = img.shape
    resp = shi_tomasi_response(img, block // 2)
    # mask borders (BORDER_SIZE=1 in reference; use min_dist/3 for safety)
    r = jnp.arange(H)[:, None]
    c = jnp.arange(W)[None, :]
    border = 8
    resp = jnp.where((r < border) | (r >= H - border) | (c < border) | (c >= W - border),
                     -1.0, resp)
    # suppress around existing features: splat + dilate
    occ = jnp.zeros((H, W), img.dtype)
    ox = jnp.clip(occupied_xy[:, 0].astype(jnp.int32), 0, W - 1)
    oy = jnp.clip(occupied_xy[:, 1].astype(jnp.int32), 0, H - 1)
    occ = occ.at[oy, ox].max(occupied_valid.astype(img.dtype))
    occ = max_pool_same(occ, min_dist)
    resp = jnp.where(occ > 0, -1.0, resp)
    # quality gate relative to max response
    resp = jnp.where(resp > quality * jnp.max(resp), resp, -1.0)
    # min-dist NMS between new detections: local-max over min_dist window
    nms_r = min_dist // 2
    pooled = max_pool_same(resp, nms_r)
    resp = jnp.where(resp >= pooled, resp, -1.0)
    # top-k via per-tile reduction: NMS suppression is Chebyshev radius
    # nms_r, so two survivors can never share a (nms_r x nms_r) tile
    # (except exact ties) — per-tile max is exact, and the global top_k
    # then runs over ~2k tile maxima instead of H*W pixels (a full-image
    # lax.top_k was ~8 ms of the tracker's budget at KITTI size). Two-stage
    # reduction keeping the wide axis minor (a (H/T, W/T, T, T) transpose
    # puts the T=15 dims minor).
    T = max(nms_r, 1)
    Hp = -(-H // T) * T
    Wp = -(-W // T) * T
    resp_p = jnp.pad(resp, ((0, Hp - H), (0, Wp - W)), constant_values=-1.0)
    # stage 1: reduce rows within each tile-row band -> (Hp/T, Wp)
    band = resp_p.reshape(Hp // T, T, Wp)
    rmax = jnp.max(band, axis=1)
    rarg = jnp.argmax(band, axis=1).astype(jnp.int32)  # row within band
    # stage 2: reduce cols within each tile -> (Hp/T, Wp/T)
    tile = rmax.reshape(Hp // T, Wp // T, T)
    tmax = tile.reshape(Hp // T, Wp // T, T).max(axis=2)
    carg = jnp.argmax(tile, axis=2).astype(jnp.int32)  # col within tile
    gx = jnp.arange(Wp // T, dtype=jnp.int32)[None, :] * T + carg
    gy = (jnp.arange(Hp // T, dtype=jnp.int32)[:, None] * T
          + jnp.take_along_axis(rarg, gx, axis=1))
    n_tiles = tmax.size
    k = min(max_pts, n_tiles)
    vals, sel = jax.lax.top_k(tmax.reshape(-1), k)
    xy = jnp.stack([gx.reshape(-1)[sel].astype(img.dtype),
                    gy.reshape(-1)[sel].astype(img.dtype)], axis=-1)
    if k < max_pts:
        xy = jnp.pad(xy, ((0, max_pts - k), (0, 0)))
        vals = jnp.pad(vals, (0, max_pts - k), constant_values=-1.0)
    return xy, vals > 0
