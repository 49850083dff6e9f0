"""Banded Smith–Waterman extension (the minimap2 alignment-extension
analog) — jnp reference implementation; the CUDA kernel in
``banded_sw.cu`` (built and called by :mod:`monica_tpu.ops.sw_cuda`)
computes the same integers on a GPU.

The reference consumes mappy's per-hit ``NM``/``mlen`` (edit distance /
matched bases, `monica/genomes/aligner.py:193-195`) produced by
minimap2's banded extension in C.  Here extension is a first-party
data-parallel DP:

* the band (width ``W``) lies along the last axis, one read per row;
* DP runs row-per-read-base in shifted-band coordinates, where the
  band window over the reference advances one base per row — the
  wavefront parallelism SURVEY.md §5 calls for, without anti-diagonal
  index gymnastics;
* the in-row horizontal dependency ``H[i][d-1] - G`` is resolved
  EXACTLY for linear gap cost by a prefix-max scan:
      H[i][d] = max_{k<=d} (T[i][k] - (d-k)·G)
              = prefixmax_d(T[i][k] + k·G) - d·G
  computed in log2(reach) shifted-max passes — elementwise ops with no
  sequential chain along the band;
* matches along the optimal path are tracked as a paired value through
  every max, giving an ``mlen`` analog and, with the score, an ``NM``
  estimate:  S = MA·mlen - MM·mismatch - G·gaps  =>
  NM ~ (MA·mlen - S) / min(MM, G)  (lower bound; calibrated constants).

Scoring defaults follow map-ont's spirit (match 2, mismatch 4, linear
gap 4 approximating open 4/extend 2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 20)  # -inf for int32 DP without overflow


class ExtendParams(NamedTuple):
    band: int = 128  # band width in cells (the CUDA kernel takes 32, 64, 128)
    match: int = 2
    mismatch: int = 4  # positive penalty
    gap: int = 4  # positive linear gap penalty
    # horizontal (deletion) reach per DP row in cells: prefix-max passes
    # = ceil(log2(max_gap)).  Deletions longer than this split the local
    # alignment instead of bridging it — at nanopore error profiles
    # (indels overwhelmingly 1-3 bp) the score loss is negligible, and
    # each halving of the reach removes one pass per row.  0 = exact
    # (full band reach, log2(band) passes).
    max_gap: int = 16


# ---------------------------------------------------------------------------
# band setup: orient reads, extract reference windows
# ---------------------------------------------------------------------------

def orient_reads(codes: jnp.ndarray, lengths: jnp.ndarray, rc: jnp.ndarray):
    """Reverse-complement the rows where ``rc`` is True.

    codes (B, L) uint8, lengths (B,), rc (B,) bool -> (B, L) uint8 with
    PAD (4) beyond each read's true length.  NOT on the hot path any
    more — extend_hits flips the *reference window* instead (a layout
    op) because this per-row variable-length reverse lowers to an
    expensive per-element gather; kept for host-side/testing use.
    """
    B, L = codes.shape
    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = jnp.where(rc[:, None], lengths[:, None] - 1 - i, i)
    c = jnp.take_along_axis(codes, jnp.clip(src, 0, L - 1), axis=1)
    c = jnp.where(rc[:, None] & (c < 4), 3 - c, c)
    return jnp.where(i < lengths[:, None], c, jnp.uint8(4)).astype(jnp.uint8)


def extract_ref_windows(ref_codes: jnp.ndarray, diag: jnp.ndarray, L: int, band: int):
    """Per-read reference window refwin[p] = ref[diag - band//2 + p],
    p in [0, L + band): row i of the DP reads refwin[i : i + band].

    One sliced gather (an L+band contiguous slice per read); starts are
    clipped to the table, which only distorts anchors within ``band`` of
    the packed-reference ends (records are separated by N guards).
    """
    T = ref_codes.shape[0]
    start = jnp.clip(diag - band // 2, 0, max(T - (L + band), 0))
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
    )
    return jax.lax.gather(
        ref_codes,
        start[:, None],
        dnums,
        slice_sizes=(L + band,),
        mode=jax.lax.GatherScatterMode.CLIP,
    )


# ---------------------------------------------------------------------------
# row-update math
# ---------------------------------------------------------------------------

def _gap_reach(width: int, max_gap: int) -> int:
    """Horizontal prefix-max reach in lanes (0 = exact/full band)."""
    return width if max_gap <= 0 else min(max_gap, width)


def _prefix_max_pair(u, m, width: int, reach: int):
    """Windowed prefix max along the last axis (window = ``reach``
    trailing lanes), carrying ``m`` with the argmax.  ceil(log2(reach))
    shifted passes of elementwise select."""
    s = 1
    while s < reach:
        pu = jnp.concatenate([jnp.full_like(u[..., :s], NEG), u[..., :-s]], axis=-1)
        pm = jnp.concatenate([jnp.zeros_like(m[..., :s]), m[..., :-s]], axis=-1)
        take = pu > u
        u = jnp.where(take, pu, u)
        m = jnp.where(take, pm, m)
        s *= 2
    return u, m


def _row_update(h, m, qcol, rrow, lane_g, p: ExtendParams):
    """One DP row. h/m: (B, W) int32 state; qcol: (B, 1) read base;
    rrow: (B, W) ref bases; lane_g: (W,) = arange(W)·gap."""
    is_match = (qcol == rrow) & (qcol < 4)
    sub = jnp.where(is_match, p.match, -p.mismatch)
    cand_d = h + sub
    md = m + is_match.astype(jnp.int32)
    floor = jnp.full_like(h[..., :1], NEG)
    cand_u = jnp.concatenate([h[..., 1:], floor], axis=-1) - p.gap
    mu = jnp.concatenate([m[..., 1:], jnp.zeros_like(m[..., :1])], axis=-1)
    up = cand_u > cand_d
    t = jnp.where(up, cand_u, cand_d)
    mt = jnp.where(up, mu, md)
    # local alignment floor: restart at 0 with no matches
    zero = t < 0
    t = jnp.where(zero, 0, t)
    mt = jnp.where(zero, 0, mt)
    # horizontal term via prefix max (exact for linear gap within reach)
    u, mh = _prefix_max_pair(t + lane_g, mt, t.shape[-1], _gap_reach(t.shape[-1], p.max_gap))
    hz = u - lane_g
    hor = hz > t
    h_new = jnp.where(hor, hz, t)
    m_new = jnp.where(hor, mh, mt)
    return h_new, m_new


# ---------------------------------------------------------------------------
# packed-state row update: P = score * 2^mbits + mlen
#
# For reads up to ~16 kb, (score, mlen) packs into ONE int32 whose
# integer order IS the lexicographic (score, mlen) order (mlen ∈
# [0, 2^mbits)), so every max/select of the pair DP collapses to one
# arithmetic op — the row update drops from ~2x state arrays to one.
# Tie-breaking differs from the pair version only in which EQUAL-score
# path's mlen survives (packed keeps the largest), which is the more
# useful invariant anyway.
# ---------------------------------------------------------------------------


def packed_mbits(L: int, p: ExtendParams) -> int:
    """mlen bit width for reads of length <= L, or 0 if the packed DP
    cannot hold (score, mlen) for this length/scoring in int32."""
    mbits = max(int(np.ceil(np.log2(L + 1))), 1)
    score_max = p.match * L + p.gap * p.band + 1  # + lane_g headroom
    if (score_max << mbits) + L < (1 << 31):
        return mbits
    return 0


def _prefix_max_packed(u, width: int, reach: int):
    s = 1
    while s < reach:
        pu = jnp.concatenate([jnp.full_like(u[..., :s], NEG), u[..., :-s]], axis=-1)
        u = jnp.maximum(pu, u)
        s *= 2
    return u


def _row_update_packed(P, qcol, rrow, lane_gp, p: ExtendParams, mbits: int):
    """One DP row over packed state P (B, W) int32.

    lane_gp: (W,) = arange(W)·gap·2^mbits.  The zero floor maps to
    max(P, 0): score < 0  <=>  P < 0 because mlen ∈ [0, 2^mbits)."""
    one = jnp.int32(1)
    scale = jnp.int32(1 << mbits)
    is_match = (qcol == rrow) & (qcol < 4)
    # substitution: score += ±, mlen += is_match
    cand_d = P + jnp.where(is_match, p.match * scale + one, -p.mismatch * scale)
    # vertical gap: lane+1, score -= gap, mlen carried
    floor = jnp.full_like(P[..., :1], NEG)
    cand_u = jnp.concatenate([P[..., 1:], floor], axis=-1) - p.gap * scale
    t = jnp.maximum(cand_u, cand_d)
    t = jnp.maximum(t, 0)  # local floor: restart at (score 0, mlen 0)
    u = _prefix_max_packed(t + lane_gp, t.shape[-1], _gap_reach(t.shape[-1], p.max_gap))
    return jnp.maximum(u - lane_gp, t)


# ---------------------------------------------------------------------------
# jnp implementation (the reference for the CUDA kernel)
# ---------------------------------------------------------------------------

def banded_sw_jnp(q, refwin, lengths, p: ExtendParams):
    """q (B, L) uint8 oriented reads; refwin (B, L+W) uint8;
    lengths (B,) int32.  Returns (best_score, best_matches) int32 (B,).
    Uses the packed-state DP whenever (score, mlen) fits int32 (reads
    up to ~16 kb), the pair DP beyond."""
    B, L = q.shape
    W = p.band
    mbits = packed_mbits(L, p)
    if mbits:
        lane_gp = jnp.arange(W, dtype=jnp.int32) * (p.gap << mbits)

        def body_p(i, carry):
            P, best = carry
            qcol = jax.lax.dynamic_slice(q, (0, i), (B, 1)).astype(jnp.int32)
            rrow = jax.lax.dynamic_slice(refwin, (0, i), (B, W)).astype(jnp.int32)
            P = _row_update_packed(P, qcol, rrow, lane_gp, p, mbits)
            rb = jnp.max(P, axis=-1)
            return P, jnp.where(i < lengths, jnp.maximum(rb, best), best)

        z = jnp.zeros((B, W), jnp.int32)
        _, best = jax.lax.fori_loop(0, L, body_p, (z, jnp.zeros((B,), jnp.int32)))
        return best >> mbits, best & ((1 << mbits) - 1)

    lane_g = jnp.arange(W, dtype=jnp.int32) * p.gap

    def body(i, carry):
        h, m, best, bm = carry
        qcol = jax.lax.dynamic_slice(q, (0, i), (B, 1)).astype(jnp.int32)
        rrow = jax.lax.dynamic_slice(refwin, (0, i), (B, W)).astype(jnp.int32)
        h, m = _row_update(h, m, qcol, rrow, lane_g, p)
        active = i < lengths
        rb = jnp.max(h, axis=-1)
        rm = jnp.max(jnp.where(h == rb[:, None], m, 0), axis=-1)
        better = active & (rb > best)
        return (
            h,
            m,
            jnp.where(better, rb, best),
            jnp.where(better, rm, bm),
        )

    z = jnp.zeros((B, W), jnp.int32)
    zb = jnp.zeros((B,), jnp.int32)
    _, _, best, bm = jax.lax.fori_loop(0, L, body, (z, z, zb, zb))
    return best, bm


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def prefix_passes(p: ExtendParams) -> int:
    """Number of horizontal prefix-max passes per row (ceil(log2(reach)))."""
    return max(_gap_reach(p.band, p.max_gap) - 1, 0).bit_length()


def resolve_impl(impl: str, band: int) -> str:
    """``"auto"`` -> the CUDA kernel on a GPU backend when it supports the
    band, the jnp DP everywhere else."""
    from monica_tpu.ops import sw_cuda

    if impl == "auto":
        return "cuda" if jax.default_backend() == "gpu" and sw_cuda.supports(band) else "jnp"
    if impl not in ("cuda", "jnp"):
        raise ValueError(f"unknown banded-SW implementation {impl!r}")
    return impl


def banded_sw(q, refwin, lengths, p: ExtendParams, impl: str = "auto"):
    """Dispatch between the CUDA kernel (ops/banded_sw.cu) and the jnp
    DP; both compute the same integers (packed DP up to packed_mbits,
    pair DP beyond)."""
    if resolve_impl(impl, p.band) == "cuda":
        from monica_tpu.ops import sw_cuda

        return sw_cuda.banded_sw_cuda(
            q, refwin, lengths, p, packed_mbits(q.shape[1], p), prefix_passes(p)
        )
    return banded_sw_jnp(q, refwin, lengths, p)


# ---------------------------------------------------------------------------
# hit refinement (pipeline hook)
# ---------------------------------------------------------------------------

class Extension(NamedTuple):
    score: jnp.ndarray  # (B,) int32 best local score
    mlen: jnp.ndarray  # (B,) int32 matched bases on the optimal path
    nm: jnp.ndarray  # (B,) int32 edit-distance estimate
    inv_identity: jnp.ndarray  # (B,) f32 NM/mlen


def extend_hits(ref_codes, codes, lengths, rep_ref_pos, rep_read_pos, rc,
                k: int, p: ExtendParams, impl: str = "auto") -> Extension:
    """Banded extension of each read at its chained locus — refines the
    anchor-count identity estimate into an alignment-based NM/mlen
    (`monica/genomes/aligner.py:195`'s hit.NM / hit.mlen analog).

    The read is NEVER reoriented (a per-row variable reverse is a
    per-element gather); instead, for rc anchors the
    reference window is gathered on the anti-diagonal and then flipped
    + complemented — whole-array layout/elementwise ops XLA handles
    cheaply.  Row i of the DP then always pairs read base i with
    window[i + band/2] regardless of orientation:

      fwd:  partner(i) = ref[(ref_pos - read_pos) + i]
      rc:   partner(i) = comp(ref[D - i]),  D = ref_pos + read_pos + k-1
            -> window = flip(comp(ref[D - L - band/2 + 1 .. D + band/2]))
    """
    B, L = codes.shape
    W = p.band
    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    q = jnp.where(i < lengths[:, None], codes, jnp.uint8(4))

    fwd_start = rep_ref_pos - rep_read_pos - W // 2
    anti = rep_ref_pos + rep_read_pos + (k - 1)
    rc_start = anti - (L - 1) - W // 2
    start = jnp.where(rc, rc_start, fwd_start)
    refwin = extract_ref_windows(ref_codes, start + W // 2, L, W)
    flipped = jnp.flip(refwin, axis=-1)
    comp = jnp.where(flipped < 4, 3 - flipped, flipped)
    refwin = jnp.where(rc[:, None], comp, refwin)
    score, mlen = banded_sw(q, refwin, lengths, p, impl=impl)
    # S = MA·mlen − MM·X − G·gaps ⇒ X + gaps ≥ (MA·mlen − S)/max(MM,G)
    denom = max(min(p.mismatch, p.gap), 1)
    nm = jnp.maximum((p.match * mlen - score) // denom, 0)
    inv_identity = nm.astype(jnp.float32) / jnp.maximum(mlen, 1).astype(jnp.float32)
    return Extension(score=score, mlen=mlen, nm=nm, inv_identity=inv_identity)
