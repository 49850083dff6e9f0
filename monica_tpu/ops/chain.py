"""Chain scoring by diagonal voting (the minimap2-chaining analog).

minimap2 chains anchors with an O(n·lookback) DP full of data-dependent
branches — hostile to a SIMD machine.  Classification doesn't need the
chain itself, only (a) the best location's strength, (b) the runner-up
for a mapq-style uniqueness score, and (c) a representative anchor to
seat banded extension.  Diagonal voting delivers all three with
sort + batched binary searches: anchors sharing a (strand, diagonal-bin)
key are co-linear with bounded indel drift, so the vote count of a bin
is a gapless-chain score.

Adjacent-bin merging (votes of bin + bin+1) removes the quantization
cliff when a true chain straddles a bin boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from monica_tpu.ops.lookup import INVALID_KEY


class ChainResult(NamedTuple):
    f1: jnp.ndarray  # (B,) int32 best merged-bin vote count (0 = no anchors)
    f2: jnp.ndarray  # (B,) int32 runner-up votes outside the best locus
    best_key: jnp.ndarray  # (B,) int32 packed (strand, diag bin)
    rep_diag: jnp.ndarray  # (B,) int32 representative unquantized diagonal
    rep_read_pos: jnp.ndarray  # (B,) int32
    rep_ref_pos: jnp.ndarray  # (B,) int32
    rc: jnp.ndarray  # (B,) bool reverse-complement mapping
    rep2_ref_pos: jnp.ndarray  # (B,) int32 runner-up locus anchor (tie attribution)


def _pair_votes(skeys, max_run: int):
    """Merged-pair voting on row-sorted keys (B, A).

    merged[i] = length (capped at max_run) of the consecutive stretch
    starting at i whose keys are in {skeys[i], skeys[i]+1} — i.e. the
    vote count of the (bin, bin+1) locus.  Because the row is sorted,
    the stretch is exactly run(k) followed by run(k+1).

    Computed as a prefix-AND chain of shifted comparisons: pure
    elementwise ops XLA fuses into a handful of passes — no prefix
    scans along the lane axis, no gathers.
    """
    B, A = skeys.shape
    merged = jnp.ones((B, A), jnp.int32)
    alive = jnp.ones((B, A), bool)
    for d in range(1, min(max_run, A)):
        nxt = jnp.concatenate(
            [skeys[:, d:], jnp.full((B, d), jnp.iinfo(jnp.int32).max, skeys.dtype)],
            axis=-1,
        )
        alive = alive & ((nxt == skeys) | (nxt == skeys + 1))
        merged = merged + alive.astype(jnp.int32)
    return merged


def sort_keys(key):
    """Row-wise ascending sort of the packed anchor keys (B, A)."""
    return jnp.sort(key, axis=-1)


def chain_votes(key, diag, read_pos, ref_pos, max_run: int = 64) -> ChainResult:
    """Vote over anchor keys; all inputs (B, A) from lookup_anchors.

    ``max_run`` caps the counted stretch (and the _pair_votes pass
    count, the chain stage's main elementwise cost).  The caller should pass
    ``min(128, n_slots)``: a locus can legitimately collect up to the
    read's valid-seed count in votes, and in the <=512 bp bucket
    n_slots stays 128 (pipeline.params_for_bucket) — a clean ~500 bp
    read carries ~85 minimizers on one diagonal, so capping at 64
    there would saturate f1 and bias the statistical identity/mlen low
    wherever extension does not override it (no-extend runs,
    non-rescued reads, 'matching' count mode).  Buckets > 512 bp run
    n_slots=64, so the default 64 is exact for them."""
    skeys = sort_keys(key)
    valid = skeys != INVALID_KEY
    merged = jnp.where(valid, _pair_votes(skeys, max_run), 0)

    best_i = jnp.argmax(merged, axis=-1)
    f1 = jnp.take_along_axis(merged, best_i[:, None], axis=-1)[:, 0]
    best_key = jnp.take_along_axis(skeys, best_i[:, None], axis=-1)[:, 0]

    # runner-up: strongest locus at least 2 bins away from the best
    far = valid & (jnp.abs(skeys - best_key[:, None]) > 1)
    f2m = jnp.where(far, merged, 0)
    f2_i = jnp.argmax(f2m, axis=-1)
    f2 = jnp.take_along_axis(f2m, f2_i[:, None], axis=-1)[:, 0]
    second_key = jnp.take_along_axis(skeys, f2_i[:, None], axis=-1)[:, 0]

    # representative anchor: smallest read_pos within the winning pair
    big = jnp.int32(1 << 30)

    def rep_of(k):
        in_locus = (key == k[:, None]) | (key == k[:, None] + 1)
        i = jnp.argmin(jnp.where(in_locus, read_pos, big), axis=-1)
        take1 = lambda x: jnp.take_along_axis(x, i[:, None], axis=-1)[:, 0]
        return take1(diag), take1(read_pos), take1(ref_pos)

    rep_diag, rep_read_pos, rep_ref_pos = rep_of(best_key)
    # runner-up locus anchor: lets the caller attribute the second-best
    # location to an accession for tie -> ambiguous semantics
    _, _, rep2_ref_pos = rep_of(second_key)
    rc = (best_key >> 24) > 0

    return ChainResult(
        f1=f1,
        f2=f2,
        best_key=best_key,
        rep_diag=rep_diag,
        rep_read_pos=rep_read_pos,
        rep_ref_pos=rep_ref_pos,
        rc=rc,
        rep2_ref_pos=rep2_ref_pos,
    )


def mapq_from_votes(f1, f2, scale: float = 40.0, cap: float = 60.0,
                    anchor_bases: float = 15.0):
    """minimap2-shaped mapping quality from chain votes
    (`aligner.py:194` consumes mappy's mapq; this is its analog):
    mapq = 40·(1 - f2/f1)·min(1, m/10)·ln(s1), clamped to [0, cap].

    minimap2 feeds chain SCORES (~ matched bases) into the log term and
    the anchor COUNT into the m/10 saturation term; here votes stand in
    for anchors and votes·anchor_bases (~ k bases matched per anchor)
    for the score.  Using raw votes in the log term instead makes short
    reads unmappable: a unique 8-anchor chain would score
    40·0.8·ln 8 ≈ 66 barely over 60, and anything below 7 anchors could
    never reach mapq 60 even with no runner-up (measured: 50% of 300 bp
    reads at r9_hac error rates dropped to unmapped).
    """
    f1f = f1.astype(jnp.float32)
    f2f = f2.astype(jnp.float32)
    safe_f1 = jnp.maximum(f1f, 1.0)
    q = (
        scale
        * (1.0 - f2f / safe_f1)
        * jnp.minimum(1.0, f1f / 10.0)
        * jnp.log(safe_f1 * anchor_bases)
    )
    q = jnp.where(f1 > 0, q, 0.0)
    return jnp.clip(q, 0.0, cap)
