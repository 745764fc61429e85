"""Binary descriptors: BRIEF extraction, Hamming matching, bag-of-words scoring.

Rebuild of the reference's visual place-recognition primitives (C13/C14):
  * BRIEF descriptors from a fixed random pattern
    (reference: pose_graph/ThirdParty/DVision/BRIEF.cpp + brief_pattern.yml;
    keyframe.cpp computeBRIEFPoint :87-113).
  * brute-force Hamming matching with the < 80 gate
    (keyframe.cpp searchInAera/searchByBRIEFDes :121-171).
  * DBoW2 vocabulary scoring replaced by random-hyperplane LSH words +
    TF-IDF-free cosine scoring over dense word histograms — the shipped
    vocabulary asset (brief_k10L6.bin) is missing from the reference tree
    (SURVEY §2 C14), so the new framework trains nothing and ships nothing:
    the LSH words are derived from the descriptor bits themselves.

Descriptors are packed into (n, 8) int32 lanes; Hamming distance is
XOR + popcount, elementwise — one (N, M) matrix per matching call.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.ops import image as im

N_BITS = 256
# multi-table bit-sampling LSH: T tables of B raw descriptor bits each.
# A word survives a descriptor-noise bit flip with prob (1-p)^B per table;
# with several tables the same-place histogram overlap stays high — the
# robustness role DBoW2's hierarchical k-means vocabulary plays. (A parity-
# of-16-bits hash — the first design — flips the whole word on ANY single
# bit flip and cannot re-detect a place under viewpoint noise.)
N_TABLES = 4
BITS_PER_TABLE = 12
N_WORDS = N_TABLES << BITS_PER_TABLE  # 16384 histogram bins
_PATTERN_SEED = 7


def _brief_pattern(dtype=np.float32):
    """Fixed 256-pair sampling pattern within a 31x31 patch (isotropic
    gaussian, like the classic BRIEF pattern file). numpy constant: safe to
    close over under jit (a cached jnp array would leak tracers)."""
    rng = np.random.default_rng(_PATTERN_SEED)
    return np.clip(rng.normal(0, 6.5, (N_BITS, 2, 2)), -15, 15).astype(dtype)


_PATTERN_NP = _brief_pattern()


def _pattern():
    return jnp.asarray(_PATTERN_NP)


@jax.jit
def brief_descriptors(img: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray):
    """(N, 2) keypoints -> (N, 8) int32 packed BRIEF; smoothed by box filter."""
    sm = im.box_filter(img, 2) / 25.0
    pat = _pattern()  # (256, 2, 2)

    def one(p):
        a, _ = im.bilinear_sample(sm, p[None, :] + pat[:, 0, :])
        b, _ = im.bilinear_sample(sm, p[None, :] + pat[:, 1, :])
        bits = (a < b).astype(jnp.uint32)  # (256,)
        lanes = bits.reshape(8, 32)
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
        return jnp.sum(lanes * weights[None, :], axis=-1).astype(jnp.int32)

    desc = jax.vmap(one)(xy)
    return jnp.where(valid[:, None], desc, 0)


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


@jax.jit
def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray):
    """(N, 8) x (M, 8) int32 -> (N, M) int32 Hamming distances."""
    ax = a.astype(jnp.uint32)[:, None, :]
    bx = b.astype(jnp.uint32)[None, :, :]
    x = jnp.bitwise_xor(ax, bx)
    return jnp.sum(_popcount32(x), axis=-1).astype(jnp.int32)


@jax.jit
def match(desc_a, valid_a, desc_b, valid_b, max_dist: int = 80,
          ratio: float = 0.9):
    """Best-match per row with the reference's Hamming < 80 gate
    (keyframe.cpp:121-171) PLUS a Lowe-style ratio test against the
    second-best match (best < ratio * second). The reference's DBoW2-BRIEF
    matching ships the absolute gate only; our BRIEF over low-texture
    imagery produces clusters of near-identical descriptors whose arbitrary
    best-matches pass < 80 and then collapse PnP to ~1 inlier (measured:
    tools/diag_visual_loop.py, p50 PnP inliers = 1 before this gate). A
    genuine counterpart is far closer than the runner-up; an ambiguous
    match is not. Returns (idx (N,), ok (N,))."""
    d = hamming_matrix(desc_a, desc_b)
    d = jnp.where(valid_b[None, :], d, 10_000)
    idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    d_wo = d.at[jnp.arange(d.shape[0]), idx].set(10_000)
    second = jnp.min(d_wo, axis=1)
    ok = valid_a & (best < max_dist) \
        & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return idx, ok


# ---------------------------------------------------------------------------
# LSH bag-of-words (DBoW2 replacement)
# ---------------------------------------------------------------------------

def _word_projection():
    """Per-table random bit positions: table t's word = the B raw descriptor
    bits at these positions (bit-sampling LSH)."""
    rng = np.random.default_rng(11)
    return rng.choice(N_BITS, size=(N_TABLES, BITS_PER_TABLE),
                      replace=False).astype(np.int32)


_WORD_SEL_NP = _word_projection()


def _word_sel():
    return jnp.asarray(_WORD_SEL_NP)


@jax.jit
def words_of(desc: jnp.ndarray):
    """(N, 8) packed descriptors -> (N, T) word ids, table t's ids offset
    into [t << B, (t+1) << B) so one histogram holds all tables."""
    lanes = desc.astype(jnp.uint32)  # (N, 8)
    bit_idx = jnp.arange(N_BITS)
    bits = (lanes[:, bit_idx // 32] >> (bit_idx % 32).astype(jnp.uint32)) & 1  # (N, 256)
    sel = _word_sel()  # (T, B)
    group = bits[:, sel]  # (N, T, B)
    weights = (1 << jnp.arange(BITS_PER_TABLE)).astype(jnp.uint32)
    w = jnp.sum(group * weights[None, None, :], axis=-1)  # (N, T)
    offs = (jnp.arange(N_TABLES, dtype=jnp.uint32) << BITS_PER_TABLE)
    return (w + offs[None, :]).astype(jnp.int32)


@jax.jit
def word_histogram(words: jnp.ndarray, valid: jnp.ndarray):
    """(N, T) word ids -> (N_WORDS,) L2-normalized histogram over all tables."""
    wflat = jnp.where(valid[:, None], words, N_WORDS - 1).reshape(-1)
    h = jnp.zeros((N_WORDS,), jnp.float32).at[wflat].add(
        jnp.broadcast_to(valid[:, None], words.shape).reshape(-1)
        .astype(jnp.float32))
    return h / jnp.maximum(jnp.linalg.norm(h), 1e-6)


@jax.jit
def bow_scores(query_hist: jnp.ndarray, db_hists: jnp.ndarray):
    """Cosine similarity against the whole database — the inverted-file query
    (TemplatedDatabase.h) collapsed into one matvec."""
    return db_hists @ query_hist
