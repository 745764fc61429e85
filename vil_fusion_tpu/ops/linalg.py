"""Small closed-form linear algebra for batched geometry.

jnp.linalg.eigh on batched 3x3 matrices lowers to iterative QR; the
scan-matching hot path calls it for thousands of covariance matrices per
frame. Closed forms (Cardano eigenvalues + cross-product eigenvectors) are
branch-free elementwise arithmetic.
"""
from __future__ import annotations

import jax.numpy as jnp


def sym3x3_eigvalsh(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending — Cardano's formula
    (Smith's algorithm; matches jnp.linalg.eigvalsh to ~1e-6 rel)."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    iso = p2 < 1e-20  # (near-)isotropic: all eigenvalues equal q
    p = jnp.sqrt(jnp.maximum(jnp.where(iso, 1.0, p2) / 6.0, 1e-30))
    inv_p = 1.0 / p
    # det(B/p) / 2
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    half_det = (b00 * c00 - a01 * c01 + a02 * c02) * (inv_p * inv_p * inv_p) * 0.5
    half_det = jnp.clip(half_det, -1.0, 1.0)
    phi = jnp.arccos(half_det) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    out = jnp.stack([e_lo, e_mid, e_hi], axis=-1)
    return jnp.where(iso[..., None], q[..., None], out)


def gram3(x):
    """(..., K, 3) -> (..., 3, 3) Gram matrix sum_k x_k x_k^T via explicit
    elementwise products (6 unique entries). einsum("nki,nkj->nij") lowers
    to batched tiny dot_generals; this form is pure elementwise work."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    g00 = jnp.sum(x0 * x0, axis=-1)
    g01 = jnp.sum(x0 * x1, axis=-1)
    g02 = jnp.sum(x0 * x2, axis=-1)
    g11 = jnp.sum(x1 * x1, axis=-1)
    g12 = jnp.sum(x1 * x2, axis=-1)
    g22 = jnp.sum(x2 * x2, axis=-1)
    row0 = jnp.stack([g00, g01, g02], axis=-1)
    row1 = jnp.stack([g01, g11, g12], axis=-1)
    row2 = jnp.stack([g02, g12, g22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def solve3x3(A, b):
    """Batched closed-form 3x3 solve by Cramer's rule (A (..., 3, 3),
    b (..., 3)). jnp.linalg.solve LU-factorizes thousands of tiny systems
    through the linalg library; the adjugate form is ~15 fused elementwise ops.
    Singular A gives non-finite output — callers gate like they do for the
    library solve."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / det
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + (a02 * a21 - a01 * a22) * b1 + (a01 * a12 - a02 * a11) * b2)
    x1 = (c01 * b0 + (a00 * a22 - a02 * a20) * b1 + (a02 * a10 - a00 * a12) * b2)
    x2 = (c02 * b0 + (a01 * a20 - a00 * a21) * b1 + (a00 * a11 - a01 * a10) * b2)
    return jnp.stack([x0, x1, x2], axis=-1) * inv_det[..., None]


def sym3x3_smallest(A):
    """(eigvals ascending (..., 3), SMALLEST eigenvector (..., 3)) of a
    symmetric 3x3 batch — same cross-product construction as
    sym3x3_principal but at l_min (null direction of A - l_min I)."""
    lams = sym3x3_eigvalsh(A)
    l_min = lams[..., 0]
    B = A - l_min[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where((n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
                     jnp.where((n02 >= n12)[..., None], c02, c12))
    norm = jnp.linalg.norm(best, axis=-1, keepdims=True)
    v = best / jnp.maximum(norm, 1e-12)
    z = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where(norm > 1e-10, v, z)
    return lams, v


def smallest_eigvec_inverse_iteration(A, iters: int = 4, shift: float = 1e-6):
    """Smallest eigenvector of each symmetric PSD (..., n, n) by inverse
    iteration on one Cholesky factor (factor once, `iters` cheap triangular
    solves). Replaces batched jnp.linalg.eigh on small normal matrices —
    eigh lowers to a long iterative QR chain.

    Assumes the smallest eigenvalue is well-separated (true for RANSAC
    nullspace problems; degenerate hypotheses produce garbage vectors that
    downstream consensus scoring rejects anyway)."""
    import jax

    n = A.shape[-1]
    tr = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None]
    M = A + (shift * jnp.maximum(tr, 1e-12) / n) * jnp.eye(n, dtype=A.dtype)
    L = jnp.linalg.cholesky(M)
    # NaN guard: indefinite/rank-deficient A (degenerate sample) -> identity
    bad = ~jnp.isfinite(L[..., n - 1, n - 1])
    L = jnp.where(bad[..., None, None], jnp.eye(n, dtype=A.dtype), L)
    x = jnp.ones(A.shape[:-1], A.dtype)

    def solve(x):
        y = jax.scipy.linalg.solve_triangular(L, x[..., None], lower=True)
        z = jax.scipy.linalg.solve_triangular(
            L, y, lower=True, trans=1)[..., 0]
        return z / jnp.maximum(
            jnp.linalg.norm(z, axis=-1, keepdims=True), 1e-30)

    for _ in range(iters):
        x = solve(x)
    return x


def sym3x3_principal(A):
    """(eigvals ascending (..., 3), principal eigenvector (..., 3)) of a
    symmetric 3x3 batch. Eigenvector by cross-product of rows of (A - l_max I)
    (the two most independent rows give its null direction)."""
    lams = sym3x3_eigvalsh(A)
    l_max = lams[..., 2]
    B = A - l_max[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    # pick the largest-norm cross product (branch-free select)
    best = jnp.where((n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
                     jnp.where((n02 >= n12)[..., None], c02, c12))
    norm = jnp.linalg.norm(best, axis=-1, keepdims=True)
    v = best / jnp.maximum(norm, 1e-12)
    # degenerate (repeated eigenvalue): fall back to +z
    z = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where(norm > 1e-10, v, z)
    return lams, v


def solve_spd_unrolled(A, b):
    """x = A^{-1} b for small SPD systems (n <= ~12, n static) via a fully
    UNROLLED scalar Cholesky + two triangular solves, batched over leading
    dims. A 6x6 jnp.linalg.solve dispatches the general LU custom
    call (pivoting, blocked paths built for large matrices) — a latency-
    bound library detour inside tight GN loops (scan_to_map runs 8 solves
    per frame). The unrolled form is ~n^3/3 scalar fmas that XLA fuses
    straight into the surrounding loop body.

    A must be SPD (callers damp their normal matrices); a non-positive pivot
    is clamped, yielding a finite (if inexact) step that the caller's
    accept/reject or trust-region logic absorbs."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-20))
        L[j][j] = d
        for i in range(j + 1, n):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 / d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)
