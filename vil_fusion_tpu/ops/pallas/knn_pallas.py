"""Fused exact k-nearest-neighbour kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA form (ops/knn.py) writes an (Nq, tile + k) distance block to device
memory for every database tile and reads it back through lax.top_k. This
kernel keeps the distances and the running top-k in registers:

  * the grid is (query blocks, database splits);
  * inside a block, a fori_loop walks the split's database tiles and carries
    the k best (distance, index) pairs per query as k register vectors;
  * per tile, the block's row minima are compared against the current k-th
    best; extraction rounds (argmin -> sorted insert -> mask) run only while
    some row still has a closer candidate, so once the running best is tight
    most tiles cost one distance pass and one min reduction;
  * distances are an fp32 difference-square: a dot product may run in TF32,
    whose ~1e-3 relative error would bury the 1e-5 unit-sphere distances of
    depth association.

Shapes with few query blocks (the 2048-query edge pass, the ~200-ray depth
association) split the database across blocks so the card's SMs fill; the
per-split top-k lists are merged afterwards by lax.top_k over split*k
candidates. `knn` dispatches: this kernel on the GPU backend, ops/knn.py
elsewhere.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from vil_fusion_tpu.ops import knn as knn_xla

# block shape measured fastest on the H100 at all three main-path shapes
# (PERF.md): 16 queries x 512 database points per tile
_BQ = 16
_BD = 512
_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100


def _knn_kernel(q_ref, db_ref, out_d_ref, out_i_ref, *, k: int, bq: int,
                bd: int, tiles_per_split: int):
    i = pl.program_id(0)
    s = pl.program_id(1)
    qs = pl.ds(i * bq, bq)
    qx, qy, qz = q_ref[0, qs], q_ref[1, qs], q_ref[2, qs]
    col = jax.lax.broadcasted_iota(jnp.int32, (bq, bd), 1)
    inf = jnp.full((bq,), jnp.inf, jnp.float32)
    zero = jnp.zeros((bq,), jnp.int32)

    def insert(best_d, best_i, m, idx, take):
        # sorted insert of (m, idx) into ascending best lists, rows `take`
        best_d, best_i = list(best_d), list(best_i)
        cd, ci = jnp.where(take, m, jnp.inf), idx
        for r in range(k):
            lt = cd < best_d[r]
            best_d[r], cd = jnp.where(lt, cd, best_d[r]), jnp.where(lt, best_d[r], cd)
            best_i[r], ci = jnp.where(lt, ci, best_i[r]), jnp.where(lt, best_i[r], ci)
        return tuple(best_d), tuple(best_i)

    def tile(t, carry):
        best_d, best_i = carry
        base = (s * tiles_per_split + t) * bd
        ds = pl.ds(base, bd)
        dx = qx[:, None] - db_ref[0, ds][None, :]
        dy = qy[:, None] - db_ref[1, ds][None, :]
        dz = qz[:, None] - db_ref[2, ds][None, :]
        dist = dx * dx + dy * dy + dz * dz  # invalid points carry inf coords
        m = jnp.min(dist, axis=1)

        def more(c):
            r, _, m, best_d, _ = c
            live = jnp.where(m < best_d[k - 1], 1, 0)
            return (r < k) & (jnp.max(live) > 0)

        def extract(c):
            r, dist, m, best_d, best_i = c
            a = jnp.argmin(dist, axis=1).astype(jnp.int32)
            best_d, best_i = insert(best_d, best_i, m, base + a,
                                    m < best_d[k - 1])
            dist = jnp.where(col == a[:, None], jnp.inf, dist)
            return r + 1, dist, jnp.min(dist, axis=1), best_d, best_i

        _, _, _, best_d, best_i = jax.lax.while_loop(
            more, extract, (0, dist, m, best_d, best_i))
        return best_d, best_i

    best_d, best_i = jax.lax.fori_loop(
        0, tiles_per_split, tile, ((inf,) * k, (zero,) * k))
    for r in range(k):
        out_d_ref[s * k + r, qs] = best_d[r]
        out_i_ref[s * k + r, qs] = best_i[r]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _n_split(nq_blocks: int, n_tiles: int) -> int:
    """Database splits so that query blocks x splits fills the card, keeping
    at least four tiles per split."""
    want = _next_pow2(-(-_TARGET_BLOCKS // nq_blocks))
    return max(1, min(want, _next_pow2(max(1, n_tiles // 4 + 1)) // 2))


@functools.partial(jax.jit, static_argnames=("k", "n_split", "interpret"))
def knn_fused(queries, database, db_valid, k: int = 5,
              n_split: int | None = None, interpret: bool = False):
    """Exact kNN with the same contract as ops.knn.knn: returns
    (dists2 (Nq, k) ascending, inf where missing; idx (Nq, k), 0 where
    missing). `n_split` defaults to the occupancy rule in _n_split."""
    nq, nd = queries.shape[0], database.shape[0]
    bq, bd = _BQ, _BD
    nq_blocks = -(-nq // bq)
    n_tiles = -(-nd // bd)
    if n_split is None:
        n_split = _n_split(nq_blocks, n_tiles)
    tiles_per_split = -(-n_tiles // n_split)
    nd_pad = n_split * tiles_per_split * bd

    q = jnp.zeros((4, nq_blocks * bq), jnp.float32)
    q = q.at[:3, :nq].set(queries.astype(jnp.float32).T)
    db = jnp.where(db_valid[:, None], database.astype(jnp.float32), jnp.inf)
    db = jnp.full((4, nd_pad), jnp.inf, jnp.float32).at[:3, :nd].set(db.T)

    kern = functools.partial(_knn_kernel, k=k, bq=bq, bd=bd,
                             tiles_per_split=tiles_per_split)
    out_d, out_i = pl.pallas_call(
        kern,
        grid=(nq_blocks, n_split),
        out_shape=[
            jax.ShapeDtypeStruct((n_split * k, q.shape[1]), jnp.float32),
            jax.ShapeDtypeStruct((n_split * k, q.shape[1]), jnp.int32),
        ],
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="knn_fused",
    )(q, db)
    d = out_d[:, :nq].T  # (nq, n_split * k)
    idx = out_i[:, :nq].T
    if n_split > 1:
        neg, arg = jax.lax.top_k(-d, k)
        d, idx = -neg, jnp.take_along_axis(idx, arg, axis=1)
    idx = jnp.where(jnp.isfinite(d), idx, 0)
    return d, idx


def knn(queries, database, db_valid, k: int = 5):
    """kNN dispatch: the fused kernel on the GPU backend, the XLA form
    (ops/knn.py) elsewhere."""
    if jax.default_backend() == "gpu":
        return knn_fused(queries, database, db_valid, k=k)
    return knn_xla.knn(queries, database, db_valid, k=k)
