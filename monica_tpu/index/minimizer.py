"""Minimizer sketching (the mm_sketch analog), numpy- and jax-compatible.

The reference delegates sketching to minimap2's C core via the ``mappy``
index (`monica/genomes/aligner.py:45-46`, preset ``map-ont`` = k=15,
w=10).  Here sketching is expressed as pure array ops so the same code
runs vectorized on host (numpy, for the one-off index build) and inside
``jit`` on the accelerator (jax.numpy, for per-batch read sketching).

Algorithm: 2-bit rolling k-mers on both strands, canonical = min(fwd,
rc), murmur3-finalizer hash, then (w)-window minimum selection done in
O(log w) shifted-minimum passes:

    m[j]      = min(h[j .. j+w-1])                 (sliding min)
    keep[p]   = ( max(m[p-w+1 .. p]) == h[p] )     (sliding max of mins)

``keep[p]`` is exactly "h[p] is the minimum of at least one window",
including ties (all tied minima kept) — the standard winnowing set.
Invalid k-mers (containing non-ACGT, or strand-symmetric) get hash
0xFFFFFFFF and are never selected as real seeds.
"""

from __future__ import annotations

from functools import partial

import numpy as np

# map-ont preset parameters (minimap2 defaults the reference relies on).
K_DEFAULT = 15
W_DEFAULT = 10
# scaled-winnowing fraction: keep only minimizers with hash below
# frac * 2^32 (fmix32 output is uniform, so this subsamples the
# winnowing set uniformly ON BOTH SIDES — index and query — preserving
# matches at density frac).  1.0 = classic winnowing (map-ont parity).
# The value is recorded in IndexMeta.frac at build time and copied into
# ClassifyParams by Classifier/evaluate, so index and query sides cannot
# diverge; `scripts/concordance.py --sweep` measures accuracy vs frac.
FRAC_DEFAULT = 1.0

INVALID_HASH = np.uint32(0xFFFFFFFF)


def frac_threshold(frac: float) -> np.uint32:
    """Largest hash kept under scaled winnowing (inclusive)."""
    t = int(frac * 4294967296.0)
    return np.uint32(min(max(t, 1), 0xFFFFFFFE))


def _u32(xp, v):
    return xp.uint32(v) if xp is np else v  # jax handles python ints fine


def fmix32(xp, h):
    """Murmur3 32-bit finalizer — invertible avalanche mix."""
    h = h ^ (h >> 16)
    h = h * xp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * xp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _shift_fill(xp, x, s, fill):
    """x shifted left by s positions (x[i] := x[i+s]), tail filled.
    A shift past the width yields an all-fill array (short sequences:
    a w-window pass over an m < w hash array must not widen it)."""
    if s == 0:
        return x
    if s >= x.shape[-1]:
        return xp.full(x.shape, fill, dtype=x.dtype)
    pad = xp.full(x.shape[:-1] + (s,), fill, dtype=x.dtype)
    return xp.concatenate([x[..., s:], pad], axis=-1)


def _windowed(xp, x, w, fill, op):
    """op-reduction over forward windows: out[i] = op(x[i..i+w-1])."""
    p2 = 1
    while p2 * 2 <= w:
        p2 *= 2
    a = x
    s = 1
    while s < p2:
        a = op(a, _shift_fill(xp, a, s, fill))
        s *= 2
    if w != p2:
        a = op(a, _shift_fill(xp, a, w - p2, fill))
    return a


def kmer_hashes(codes, k: int = K_DEFAULT, xp=np):
    """Canonical k-mer hashes at every position.

    codes: (..., n) uint8 base codes.
    Returns (hashes, strands): (..., n-k+1) uint32 / bool.  ``strands``
    is True where the reverse complement is the canonical strand.

    Built by log-composition instead of a k-pass rolling loop: width-2^j
    block values double in log2(k) shifted-combine passes, then the
    binary decomposition of k stitches the final k-mer value — ~4x
    fewer elementwise passes at k=15 (same values bit-for-bit: the k-mer
    integer, and hence fmix32, is position-order-defined).
    """
    n = codes.shape[-1]
    m = n - k + 1
    if m <= 0:
        raise ValueError(f"sequence shorter than k={k}")
    c = codes.astype(xp.uint32)
    # width-1 blocks: fw[i] = base value, rv[i] = complement value
    # (first base most significant in all block values)
    fw = c & xp.uint32(3)
    rv = (xp.uint32(3) - fw) & xp.uint32(3)
    bd = c >= 4
    blocks = {1: (fw, rv, bd)}
    width = 1
    while width * 2 <= k:
        sh = xp.uint32(2 * width)
        fw2 = (fw << sh) | _shift_fill(xp, fw, width, xp.uint32(0))
        # rc(AB) = rc(B) rc(A): the right half's complement leads
        rv2 = (_shift_fill(xp, rv, width, xp.uint32(0)) << sh) | rv
        bd2 = bd | _shift_fill(xp, bd, width, True)
        width *= 2
        fw, rv, bd = fw2, rv2, bd2
        blocks[width] = (fw, rv, bd)
    # stitch k = sum of powers of two, most-significant segment first
    fwd = rc = bad = None
    off = 0
    for p in sorted((1 << b for b in range(k.bit_length()) if (k >> b) & 1),
                    reverse=True):
        fp, rp, bp = blocks[p]
        fseg = _shift_fill(xp, fp, off, xp.uint32(0)) if off else fp
        rseg = _shift_fill(xp, rp, off, xp.uint32(0)) if off else rp
        bseg = _shift_fill(xp, bp, off, True) if off else bp
        if fwd is None:
            fwd, rc, bad = fseg, rseg, bseg
        else:
            fwd = (fwd << xp.uint32(2 * p)) | fseg
            rc = (rseg << xp.uint32(2 * off)) | rc
            bad = bad | bseg
        off += p
    fwd, rc, bad = fwd[..., :m], rc[..., :m], bad[..., :m]
    strand = rc < fwd
    canonical = xp.minimum(fwd, rc)
    h = fmix32(xp, canonical)
    # mask non-ACGT windows and strand-symmetric k-mers (ambiguous strand)
    h = xp.where(bad | (fwd == rc), xp.uint32(INVALID_HASH), h)
    return h, strand


def select_minimizers(hashes, w: int = W_DEFAULT, xp=np, frac: float = FRAC_DEFAULT):
    """Winnowing selection mask over k-mer hash arrays (..., m).

    ``frac < 1`` applies scaled winnowing: only minimizers with
    hash <= frac * 2^32 are kept (must match the index's frac)."""
    fill_min = xp.uint32(INVALID_HASH)
    mins = _windowed(xp, hashes, w, fill_min, xp.minimum)  # m[j]
    # max over the w windows *ending* at p == shifted-right window on mins.
    # Implement as forward window on a right-shifted array: prepend fill.
    pad = xp.zeros(hashes.shape[:-1] + (w - 1,), dtype=hashes.dtype)
    mins_r = xp.concatenate([pad, mins], axis=-1)
    maxs = _windowed(xp, mins_r, w, xp.uint32(0), xp.maximum)[..., : hashes.shape[-1]]
    keep = (maxs == hashes) & (hashes != INVALID_HASH)
    # positions past the last full window start still participate via
    # earlier windows covering them, which the max pass already handles.
    if frac < 1.0:
        keep = keep & (hashes <= frac_threshold(frac))
    return keep


def sketch_array(codes, k: int = K_DEFAULT, w: int = W_DEFAULT, xp=np,
                 frac: float = FRAC_DEFAULT):
    """hashes, keep-mask and strands for a batch of code arrays."""
    h, s = kmer_hashes(codes, k, xp)
    keep = select_minimizers(h, w, xp, frac=frac)
    return h, keep, s


def sketch_sequence_np(codes: np.ndarray, k: int = K_DEFAULT, w: int = W_DEFAULT,
                       frac: float = FRAC_DEFAULT):
    """Host-side sketch of one long sequence -> (hash, pos, strand) arrays."""
    h, keep, s = sketch_array(codes[None, :], k, w, np, frac=frac)
    pos = np.nonzero(keep[0])[0].astype(np.int64)
    return h[0][pos].astype(np.uint32), pos, s[0][pos]


def sketch_reads_jax(codes, n_slots: int, k: int = K_DEFAULT, w: int = W_DEFAULT,
                     frac: float = FRAC_DEFAULT):
    """Device-side sketch of a read batch into fixed minimizer slots.

    codes: (B, L) uint8.  Returns (hash, pos, strand, valid) each of
    shape (B, n_slots).

    Slot assignment is *positional*: the read is cut into ``n_slots``
    equal segments and each slot takes the smallest-hash minimizer of
    its segment (or is invalid if the segment has none).  This needs
    only a tiny axis-reduction — no top_k / sort — and subsamples
    uniformly across the read, which is what chaining wants.  The
    winnowing guarantee (>=1 minimizer per w consecutive k-mers) keeps
    segments of length >= w nearly always populated.
    """
    import jax
    import jax.numpy as jnp

    h, s = kmer_hashes(codes, k, jnp)
    B, m = h.shape
    seg = -(-m // n_slots)  # segment length (ceil)
    pad_to = seg * n_slots
    pad = pad_to - m

    if seg >= w and frac >= 1.0:
        # The winnowing keep-mask is REDUNDANT here: each slot takes its
        # segment's argmin hash, and with seg >= w that position is
        # always a w-window minimum — some w-window lies fully inside
        # the segment and contains it (start in [p-w+1, p] ∩
        # [seg_start, seg_start+seg-w], nonempty for seg >= w), and the
        # segment min is the min of that window.  Equal-hash ties are
        # all winnow-kept, so argmin's first-occurrence choice matches
        # too: the selected (hash, pos) set is BIT-IDENTICAL to the
        # winnow-then-argmin path (tested) while skipping the ~8
        # shifted min/max passes of select_minimizers — the sketch
        # stage was the largest single cost of the pipeline.
        # (Only true tail segments shortened below w by read end/padding
        # can select a non-winnowed position; such a seed just misses
        # in the index — a sub-seed-level sensitivity effect.)
        key = h
    else:
        # short segments (the <=512 bp bucket at n_slots=128) or scaled
        # winnowing: the index keeps winnow ∧ (hash <= frac*2^32), so
        # the read side must select from exactly that set
        keep = select_minimizers(h, w, jnp, frac=frac)
        key = jnp.where(keep, h, jnp.uint32(INVALID_HASH))
    if pad:
        fill = jnp.full((B, pad), INVALID_HASH, dtype=key.dtype)
        key = jnp.concatenate([key, fill], axis=-1)

    # Per-segment argmin WITHOUT the (B, n_slots, seg) reshape: that
    # layout puts seg (16) on the minor axis — 16/128 lane occupancy
    # for the reductions — and needs a take_along_axis gather for the
    # strand.  Instead run log2(seg) full-width shifted min-SELECT
    # passes carrying (hash, position, strand) together: after pass j,
    # val[i] = min over [i, i+2^j); strided-slicing every seg-th lane
    # then yields each segment's (min, argmin-pos, strand) directly.
    # Strict '<' keeps the FIRST occurrence on ties, matching argmin.
    # Measured: the reshape/argmin/gather form was ~1.5 ms of a 2.2 ms
    # sketch at (2048 x 1024); this form is full-lane and gather-free.
    val = key
    pos = jnp.broadcast_to(
        jnp.arange(pad_to, dtype=jnp.int32)[None, :], (B, pad_to)
    )
    st = s
    if pad:
        # (pos needs no padding: its iota already covers the full width)
        st = jnp.concatenate([st, jnp.zeros((B, pad), dtype=s.dtype)], axis=-1)
    def combine(val, pos, st, dist):
        v2 = _shift_fill(jnp, val, dist, jnp.uint32(INVALID_HASH))
        p2 = _shift_fill(jnp, pos, dist, jnp.int32(0))
        s2 = _shift_fill(jnp, st, dist, False)
        better = v2 < val
        return (
            jnp.where(better, v2, val),
            jnp.where(better, p2, pos),
            jnp.where(better, s2, st),
        )

    d = 1
    while d * 2 <= seg:  # val[i] = min over [i, i+d) after each pass
        val, pos, st = combine(val, pos, st, d)
        d *= 2
    if d != seg:
        # seg is a power of two for power-of-two buckets/n_slots
        # (m = L - k + 1 > L - n_slots), but stay correct for exotic
        # shapes: overlapping-window combine covers [i, i+seg) since
        # seg - d <= d
        val, pos, st = combine(val, pos, st, seg - d)
    hh = val[:, ::seg]
    pos = pos[:, ::seg]
    ss = st[:, ::seg]
    valid = hh != INVALID_HASH
    pos_c = jnp.minimum(pos, m - 1)
    return hh, pos_c, ss, valid
