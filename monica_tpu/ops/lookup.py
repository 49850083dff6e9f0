"""Seed lookup: read minimizers -> reference anchors.

The mappy ``index.map(seq)`` seed-finding stage
(`monica/genomes/aligner.py:193`) re-designed around random device
memory access: the structure should need the fewest dependent gathers
per seed, each fetching one aligned row.  Whether the gather is bound
by accesses or by bytes on the H100 is not measured yet.

Design: a direct-addressed bucketed hash table.

* rows = 2^rbits, row index = TOP rbits of the minimizer hash — no
  directory, no binary search, no probing;
* each row holds up to ROW_SLOTS packed entries
  ``(tag | pos << 1 | strand)`` where ``tag`` is the LOW tag_bits of
  the full hash — a single row gather both *verifies* candidates (tag
  equality; the row index pins the top bits) and delivers payloads;
* equal-hash runs land in one row (hash-sorted insertion), so
  multi-occurrence seeds keep up to ROW_SLOTS positions and anything
  more repetitive is truncated — the minimap2 repetitive-seed cut;
* empty slots are 0: the packed reference starts with a guard block
  (io.encode.PackedSeqsBuilder), so payload 0 (position 0) is
  unreachable for real entries.

Cost per seed: exactly ONE row gather (vs 18 dependent gathers for a
two-binary-search design).

Anchor = (key, diag, read_pos, ref_pos) where ``key`` packs
(orientation, quantized diagonal) into an int32 for sort-based chain
voting in :mod:`monica_tpu.ops.chain`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from monica_tpu.index.minimizer import INVALID_HASH

# diagonal quantization: anchors of one gapless-ish chain share a bin.
DIAG_SHIFT = 8  # 256-base bins
# NB: a plain numpy scalar, NOT jnp — a module-level jnp array is a
# committed device constant that defeats XLA constant folding.
INVALID_KEY = np.int32(1 << 30)

ROW_SLOTS = 8  # entries per hash-table row (one 32-byte gather)
MIN_TAG_BITS = 5  # shard size cap 2^26 bases (pos<<1|strand in 27 bits)


def tag_bits_for(ref_len: int) -> int:
    """Tag width for a shard: whatever the payload doesn't need.

    payload = pos << 1 | strand needs 1 + ceil(log2(ref_len)) bits; the
    remaining top bits hold the LOW bits of the minimizer hash for
    match verification (false-positive rate 2^-tag_bits per slot).
    """
    payload_bits = 1 + max(int(np.ceil(np.log2(max(ref_len, 2)))), 1)
    tb = 32 - payload_bits
    if tb < MIN_TAG_BITS:
        raise ValueError(
            f"shard of {ref_len} bases leaves only {tb} tag bits "
            f"(< {MIN_TAG_BITS}); raise n_shards / lower max_shard_bytes"
        )
    return tb


def pack_entries(mz_hash, mz_pos, mz_strand, tag_bits: int) -> np.ndarray:
    """Host-side: parallel arrays -> packed uint32 entries."""
    payload_bits = 32 - tag_bits
    tag = mz_hash.astype(np.uint32) & np.uint32((1 << tag_bits) - 1)
    ps = (mz_pos.astype(np.uint32) << 1) | mz_strand.astype(np.uint32)
    if len(mz_pos) and int(mz_pos.max()) >= 1 << (payload_bits - 1):
        raise ValueError("positions overflow payload bits")
    return ((tag << np.uint32(payload_bits)) | ps).astype(np.uint32)


def row_bits_for(n_entries: int) -> int:
    """rows = 2^rbits with load factor n/2^rbits in (1, 2]: overflow
    beyond ROW_SLOTS is negligible (Poisson tail) while the table stays
    within ~8x the entry count in memory."""
    return max(int(np.ceil(np.log2(max(n_entries, 2)))) - 1, 1)


def build_hash_rows(
    mz_hash, mz_pos, mz_strand, tag_bits: int, rbits: int | None = None
) -> np.ndarray:
    """Host-side: hash-SORTED parallel arrays -> (2^rbits, ROW_SLOTS)
    uint32 direct-addressed table.  Returns the table; entries beyond
    ROW_SLOTS per row (hyper-repetitive minimizers or rare row
    collisions) are dropped."""
    rbits = rbits if rbits is not None else row_bits_for(len(mz_hash))
    n_rows = 1 << rbits
    table = np.zeros((n_rows, ROW_SLOTS), dtype=np.uint32)
    if not len(mz_hash):
        return table
    entries = pack_entries(mz_hash, mz_pos, mz_strand, tag_bits)
    row = (mz_hash.astype(np.uint64) >> np.uint64(32 - rbits)).astype(np.int64)
    # sorted hashes -> sorted rows: rank within row via run arithmetic
    first = np.searchsorted(row, np.arange(n_rows, dtype=np.int64))
    rank = np.arange(len(row)) - first[row]
    keep = rank < ROW_SLOTS
    table[row[keep], rank[keep]] = entries[keep]
    return table


def compact_rows(rows, keep: int):
    """The ``keep`` largest entries of each row, descending — equal to
    ``jnp.sort(rows)[..., ::-1][..., :keep]`` for unsigned entries, as
    ``keep`` max-and-remove passes over the minor axis, which XLA fuses
    into the gather that produced the rows instead of running a sort."""
    slot = jnp.arange(rows.shape[-1])
    out = []
    for _ in range(keep):
        m = jnp.max(rows, axis=-1, keepdims=True)
        out.append(m)
        first = jnp.argmax(rows == m, axis=-1, keepdims=True)
        rows = jnp.where(slot == first, jnp.zeros_like(rows), rows)
    return jnp.concatenate(out, axis=-1)


def lookup_anchors(
    mz_rows,  # (R, ROW_SLOTS) uint32 direct-addressed packed table
    q_hash,  # (B, S) uint32 read minimizer hashes
    q_pos,  # (B, S) int32 read positions
    q_strand,  # (B, S) bool
    q_valid,  # (B, S) bool
    tag_bits: int,
    bucket_len: int = 0,  # L, for diag offset bias
    anchors_per_seed: int = 0,  # compact each seed's row to this many
    # verified hits (0 = keep all ROW_SLOTS).  Real rows carry 1-2
    # verified entries (load factor <= 2 + tag filtering); compaction
    # shrinks every downstream per-anchor array — the chain stage's
    # sort cost scales with it — while a seed with more matching
    # positions than the budget (a repeat) just loses surplus copies.
):
    """Return per-read anchors with packed chain keys.

    Outputs, each (B, S*A) where A = anchors_per_seed or ROW_SLOTS:
      key:      int32 packed (strand, diag bin); INVALID_KEY when unused
      diag:     int32 unquantized diagonal (ref-read for fwd, ref+read for rc)
      read_pos: int32
      ref_pos:  int32
    """
    B, S = q_hash.shape
    R = mz_rows.shape[0]
    rbits = int(np.log2(R))
    payload_bits = 32 - tag_bits

    row = (q_hash >> (32 - rbits)).astype(jnp.int32)
    e = mz_rows[row]  # (B, S, ROW_SLOTS) — the ONE gather per seed

    qtag = (q_hash & jnp.uint32((1 << tag_bits) - 1))[..., None]  # (B, S, 1)
    seed_ok = q_valid & (q_hash != INVALID_HASH)
    ps = (e & jnp.uint32((1 << payload_bits) - 1)).astype(jnp.int32)
    hit_ok = seed_ok[..., None] & ((e >> payload_bits) == qtag) & (ps != 0)

    if anchors_per_seed and anchors_per_seed < ROW_SLOTS:
        # verified-hits-first compaction: zero out non-hits and keep the
        # A largest entries (valid entries are nonzero, invalid exactly
        # 0) — then every derived array below is A/ROW_SLOTS the size.
        e = compact_rows(jnp.where(hit_ok, e, jnp.uint32(0)), anchors_per_seed)
        ps = (e & jnp.uint32((1 << payload_bits) - 1)).astype(jnp.int32)
        hit_ok = e != 0

    ref_pos = ps >> 1
    ref_strand = (ps & 1).astype(jnp.bool_)

    # anchor orientation: read maps forward iff read/ref canonical
    # strands agree at the shared minimizer
    rc = q_strand[..., None] ^ ref_strand  # (B, S, A) True = rc mapping
    rp = q_pos[..., None]  # broadcast read pos
    diag = jnp.where(rc, ref_pos + rp, ref_pos - rp)

    L = bucket_len
    dbin = (diag + L) >> DIAG_SHIFT
    key = jnp.where(
        hit_ok,
        (rc.astype(jnp.int32) << 24) | dbin,
        INVALID_KEY,
    )

    A = key.shape[-1]
    flat = lambda x: x.reshape(B, S * A)
    return (
        flat(key),
        flat(diag),
        flat(jnp.broadcast_to(rp, rc.shape)),
        flat(ref_pos),
    )
