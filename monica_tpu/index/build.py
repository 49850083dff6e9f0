"""Reference index builder — the database+indexer replacement.

Reference behavior being re-designed (not ported):

* `monica/genomes/database.py:16-92` greedily bin-packs genome FASTAs
  into ≤ max_chunk_size chunks, rewriting every record header to
  ``species_name:accession`` and accumulating per-accession genome
  lengths.
* `monica/genomes/aligner.py:31-53` then builds one minimap2 ``.mmi``
  index per chunk.

Design: genomes are packed into flat uint8 code arrays (one per *index
shard*; shard count = the ``index`` mesh axis size, and the byte budget
per shard replaces ``max_chunk_size``), each with a hash-sorted
minimizer table that becomes the direct-addressed lookup table of
ops/lookup.py.
``species_name:accession`` headers become integer accession ids with a
metadata table — string work never reaches the device.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

from monica_tpu.io import encode as enc
from monica_tpu.io import seq as seqio
from monica_tpu.index import minimizer as mz

# THE per-seed occurrence policy, in one place (ADVICE r3): a
# minimizer occurring more than OCC_CAP times in a shard is dropped
# WHOLESALE from the table (the minimap2 repetitive-seed filter
# analog, cf. its -f top-fraction cut) — repeats produce bogus anchors
# everywhere.  OCC_CAP equals ops.lookup.ROW_SLOTS (the hash-row
# capacity, one 32-byte gather per seed) so every *kept* run fits its
# row and build_hash_rows never silently truncates a run: the
# effective budget is exactly "<= ROW_SLOTS occurrences kept in full,
# more -> seed dropped".  (Rare row COLLISIONS — different hashes
# sharing a row — can still overflow a row and drop surplus entries;
# load factor <= 2 keeps that in the Poisson tail.)
from monica_tpu.ops.lookup import ROW_SLOTS as _ROW_SLOTS

OCC_CAP = _ROW_SLOTS

# hard shard-size cap from the packed lookup entry: pos<<1|strand plus
# >= MIN_TAG_BITS of hash tag must fit 32 bits (ops/lookup.py)
SHARD_CAP = 1 << 26
# records longer than this are segmented before packing, so one human
# chromosome (~250 Mb) no longer jams a shard: each segment carries the
# same accession id and reads align within one segment (k-mers spanning
# a cut are lost — ~(k-1)/SEG_LEN of positions, negligible).  The
# reference reaches the same via minimap2 multi-part indexes.
SEG_LEN = 1 << 25


@dataclass
class IndexMeta:
    """Host-side metadata shared by all shards.

    ``frac`` is the scaled-winnowing fraction the shards were sketched
    with; it is stored here so the query side can never diverge from the
    index side (a one-sided frac silently kills seed matches)."""

    tax_units: list[str]  # per accession-id: species_name (header part 0)
    accessions: list[str]  # per accession-id: accession (header part 1)
    genome_lengths: np.ndarray  # (n_accessions,) int64 total bp (database.py:65)
    k: int = mz.K_DEFAULT
    w: int = mz.W_DEFAULT
    frac: float = mz.FRAC_DEFAULT
    occ_cap: int = OCC_CAP

    @property
    def n_accessions(self) -> int:
        return len(self.accessions)


@dataclass
class IndexShard:
    """One shard: packed reference + sorted minimizer table (numpy)."""

    ref_codes: np.ndarray  # (T,) uint8
    seq_starts: np.ndarray  # (n_seqs,) int64
    seq_lengths: np.ndarray  # (n_seqs,) int64
    seq_accession_id: np.ndarray  # (n_seqs,) int32
    mz_hash: np.ndarray  # (M,) uint32 sorted ascending
    mz_pos: np.ndarray  # (M,) int32 global position within shard ref
    mz_strand: np.ndarray  # (M,) uint8 (1 = canonical k-mer is on rc strand)
    # per ref position -> accession id, for O(1) candidate attribution
    # on device (uint16 supports 65k accessions/shard; plenty).
    pos_accession_id: np.ndarray = field(default=None)  # (T,) uint16

    @property
    def n_minimizers(self) -> int:
        return len(self.mz_hash)


@dataclass
class BuiltIndex:
    meta: IndexMeta
    shards: list[IndexShard]
    # device-resident build (single shard): [(mz_rows device table,
    # tag_bits)] — Classifier uses it directly, skipping both the
    # minimizer D2H fetch and the host table rebuild + re-upload.
    # None for host builds; host arrays remain reachable through the
    # (lazy) shards either way.
    device: list | None = None


# ---------------------------------------------------------------------------
# sketching a long reference in bounded-memory chunks
# ---------------------------------------------------------------------------

def sketch_long_sequence(
    codes: np.ndarray, k: int, w: int, chunk: int = 1 << 19,
    frac: float = mz.FRAC_DEFAULT, workers: int = 4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chunked host sketch of one flat code array.

    Selection at k-mer position p depends only on hashes in
    [p-w+1, p+w-1], so chunks overlapping by ``2w + k`` reproduce the
    global selection except at the true array ends (where windows are
    naturally truncated).

    The chunk size is a pure cache knob — output is bit-identical for
    any value.  The numpy sketch chain allocates ~30 u32 temporaries
    of chunk length; at 2^19 bases they stay L2/L3-resident and the
    whole sketch runs 5x faster than at 2^23 (measured: 24 Mbase in
    0.9 s vs 4.8 s), cutting 64 Mbase index builds from ~14 s to ~4 s.
    Chunks are independent, so they run on a small thread pool (numpy
    releases the GIL on the large array ops); order is preserved by
    ``ex.map``, keeping output bit-identical to the serial loop.
    """
    n = len(codes)
    if n < k:
        e = np.zeros(0)
        return e.astype(np.uint32), e.astype(np.int64), e.astype(np.uint8)
    overlap = 2 * w + k

    def sketch_chunk(start: int):
        stop = min(n, start + chunk)
        lo = max(0, start - overlap)
        hi = min(n, stop + overlap)
        h, keep, s = mz.sketch_array(codes[None, lo:hi], k, w, np, frac=frac)
        sel = np.nonzero(keep[0])[0]
        gpos = sel + lo
        own = (gpos >= start) & (gpos < stop)
        sel, gpos = sel[own], gpos[own]
        return (
            h[0][sel].astype(np.uint32),
            gpos.astype(np.int64),
            s[0][sel].astype(np.uint8),
        )

    starts = list(range(0, n - k + 1, chunk))
    if len(starts) > 1 and workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(workers, len(starts))) as ex:
            parts = list(ex.map(sketch_chunk, starts))
    else:
        parts = [sketch_chunk(s0) for s0 in starts]
    hashes_l = [p[0] for p in parts]
    pos_l = [p[1] for p in parts]
    strand_l = [p[2] for p in parts]
    return (
        np.concatenate(hashes_l) if hashes_l else np.zeros(0, np.uint32),
        np.concatenate(pos_l) if pos_l else np.zeros(0, np.int64),
        np.concatenate(strand_l) if strand_l else np.zeros(0, np.uint8),
    )


# ---------------------------------------------------------------------------
# device-side sketch + sort: the index build runs the SAME sketch math
# as the classify path.  Reference segments are sketched on device
# (mz.sketch_array is xp-generic; integer ops are exact, so the selected
# set is bit-identical to the host path) and the minimizer table is
# sorted on device by (hash, position) via a 2-key lax.sort — replacing
# both the host sketch chain and the single-thread np.argsort that
# dominate a host build.
# ---------------------------------------------------------------------------

_DEV_SEG = 1 << 22  # segment length: one compile, reused for every segment
_DEV_CAP_SHIFT = 2  # per-segment entry capacity = seg >> 2 (~1.4x the
# expected 2/(w+1) winnow density; overflow falls back to the host path)


def _device_sketch_sort(
    codes: np.ndarray, k: int, w: int, frac: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Sketch + sort one packed reference on the default jax device.

    Returns (hash, pos, strand) sorted by (hash, pos) — bit-identical
    to ``sketch_long_sequence`` + stable argsort (equal hashes keep
    position order, which is exactly what a stable sort of a
    position-ascending array produces) — or None when a segment
    overflows the compaction capacity (caller falls back to host).

    Device layout: each overlap-extended segment is sketched and
    compacted to a static capacity (jnp.nonzero with a fill size);
    segments concatenate on device and ONE 2-key lax.sort orders the
    (hash, pos<<1|strand) pairs; pad entries carry (0xFFFFFFFF,
    0xFFFFFFFF) so they sort strictly last (real pos < 2^27).  Two u32
    transfers return the table; u64 keys are avoided (jax x64 is off).
    """
    n = len(codes)
    if n < k:
        e = np.zeros(0)
        return e.astype(np.uint32), e.astype(np.int64), e.astype(np.uint8)
    got = _device_sketch_sort_arrays(codes, k, w, frac)
    if got is None:
        return None
    h_sorted, ps_sorted, total = got
    h_np = np.asarray(h_sorted)[:total]
    ps_np = np.asarray(ps_sorted)[:total]
    return (
        h_np.astype(np.uint32),
        (ps_np >> 1).astype(np.int64),
        (ps_np & 1).astype(np.uint8),
    )


import functools


@functools.lru_cache(maxsize=None)
def _jit_sketch_seg(cap: int, k: int, w: int, frac: float):
    """Jitted per-segment sketch+compact, cached by its static config so
    repeated builds in one process reuse the SAME function object and
    hit jax.jit's trace cache (a per-call closure re-traces every
    build)."""
    import jax
    import jax.numpy as jnp

    pad_val = jnp.uint32(0xFFFFFFFF)

    @jax.jit
    def sketch_seg(chunk, start_in_chunk, own_len, base):
        h, keep, s = mz.sketch_array(chunk[None], k, w, jnp, frac=frac)
        h, keep, s = h[0], keep[0], s[0]
        pos = jnp.arange(keep.shape[0], dtype=jnp.int32)
        own = keep & (pos >= start_in_chunk) & (pos < start_in_chunk + own_len)
        count = jnp.sum(own, dtype=jnp.int32)
        (idx,) = jnp.nonzero(own, size=cap, fill_value=-1)
        valid = idx >= 0
        safe = jnp.maximum(idx, 0)
        gpos = (base - start_in_chunk) + safe
        ps = (gpos.astype(jnp.uint32) << 1) | s[safe].astype(jnp.uint32)
        hh = jnp.where(valid, h[safe], pad_val)
        ps = jnp.where(valid, ps, pad_val)
        return hh, ps, count

    return sketch_seg


@functools.lru_cache(maxsize=None)
def _jit_sort2():
    import jax

    return jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=2))


def _device_sketch_sort_arrays(codes: np.ndarray, k: int, w: int, frac: float):
    """Device variant returning DEVICE arrays: (h_sorted, ps_sorted,
    total) with pads (0xFFFFFFFF, 0xFFFFFFFF) sorted last, or None on
    segment-capacity overflow.  Shares all selection/order semantics
    with :func:`_device_sketch_sort` (which is this + a host fetch)."""
    import jax.numpy as jnp

    n = len(codes)
    if n < k:
        return None
    seg = _DEV_SEG
    cap = seg >> _DEV_CAP_SHIFT
    overlap = 2 * w + k
    sketch_seg = _jit_sketch_seg(cap, k, w, frac)

    chunk_len = seg + 2 * overlap
    parts_h, parts_ps = [], []
    total = 0
    for start in range(0, n - k + 1, seg):
        stop = min(n, start + seg)
        lo = max(0, start - overlap)
        hi = min(n, stop + overlap)
        chunk = np.full(chunk_len, 4, np.uint8)
        chunk[: hi - lo] = codes[lo:hi]
        hh, ps, count = sketch_seg(
            jnp.asarray(chunk), start - lo, stop - start, start
        )
        c = int(count)
        if c > cap:
            return None
        total += c
        parts_h.append(hh)
        parts_ps.append(ps)

    h_all = jnp.concatenate(parts_h)
    ps_all = jnp.concatenate(parts_ps)
    h_sorted, ps_sorted = _jit_sort2()(h_all, ps_all)
    return h_sorted, ps_sorted, total


def _device_hash_table(h_sorted, ps_sorted, total: int, tag_bits: int,
                       occ_cap: int):
    """Build the (2^rbits, ROW_SLOTS) packed lookup table ON DEVICE from
    the device-sorted minimizer arrays — the fully device-resident
    build: nothing but two scalars crosses device->host, so
    build-to-classify does not wait on a ~93 MB minimizer fetch.

    Bit-identical to ``ops.lookup.build_hash_rows`` applied after the
    occ-cap run filter (index/build.py _build_shard): (1) equal-hash
    runs longer than occ_cap are dropped entirely (occ_cap=0 disables
    the filter, matching the host path's ``if occ_cap`` guard); (2)
    surviving entries fill their row — top rbits of the hash — in
    sorted order, truncated at ROW_SLOTS.  Pad entries never merge
    into a real run: run boundaries break on validity changes, so a
    real minimizer whose hash happens to be 0xFFFFFFFF keeps its own
    run length even though pads sort beside it.

    Returns (table_device, n_kept:int).
    """
    from monica_tpu.ops import lookup as lk

    keep, n_kept_dev = _jit_kept_count(int(occ_cap))(
        h_sorted, ps_sorted, total
    )
    n_kept = int(n_kept_dev)  # scalar fetch: sizes the static row count
    rbits = lk.row_bits_for(n_kept)
    table = _jit_table_fill(int(tag_bits), int(rbits))(
        h_sorted, ps_sorted, keep
    )
    return table, n_kept


@functools.lru_cache(maxsize=None)
def _jit_kept_count(occ_cap: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def kept_count(h, ps, total):
        N = h.shape[0]
        idx = jnp.arange(N, dtype=jnp.int32)
        valid = idx < total
        if not occ_cap:
            return valid, jnp.sum(valid, dtype=jnp.int32)
        # run boundaries: hash change OR validity change (pads are one
        # run of their own, never extending a real 0xFFFFFFFF run).
        # lax.cummax/cummin, not associative_scan(jnp.maximum), which
        # expands into a far larger program to compile.
        brk = (h[1:] != h[:-1]) | (valid[1:] != valid[:-1])
        newh = jnp.concatenate([jnp.ones(1, bool), brk])
        run_start = jax.lax.cummax(jnp.where(newh, idx, 0))
        lasth = jnp.concatenate([brk, jnp.ones(1, bool)])
        run_end = jax.lax.cummin(
            jnp.where(lasth, idx, N - 1), reverse=True
        )
        runlen = run_end - run_start + 1
        keep = valid & (runlen <= occ_cap)
        return keep, jnp.sum(keep, dtype=jnp.int32)

    return kept_count


@functools.lru_cache(maxsize=None)
def _jit_table_fill(tag_bits: int, rbits: int):
    import jax
    import jax.numpy as jnp

    from monica_tpu.ops import lookup as lk

    @jax.jit
    def fill(h, ps, keep):
        N = h.shape[0]
        idx = jnp.arange(N, dtype=jnp.int32)
        n_rows = 1 << rbits
        row = (h >> jnp.uint32(32 - rbits)).astype(jnp.int32)
        newrow = jnp.concatenate(
            [jnp.ones(1, bool), row[1:] != row[:-1]]
        )
        row_start = jax.lax.cummax(jnp.where(newrow, idx, 0))
        ckeep = jnp.cumsum(keep.astype(jnp.int32))  # inclusive
        before = jnp.where(
            row_start > 0, ckeep[jnp.maximum(row_start - 1, 0)], 0
        )
        rank = ckeep - 1 - before  # rank among kept entries in the row
        ok = keep & (rank < lk.ROW_SLOTS)
        payload_bits = 32 - tag_bits
        tag = h & jnp.uint32((1 << tag_bits) - 1)
        entries = (tag << jnp.uint32(payload_bits)) | ps
        rowk = jnp.where(ok, row, n_rows)  # dummy overflow row
        rankk = jnp.where(ok, rank, 0)
        table = jnp.zeros((n_rows + 1, lk.ROW_SLOTS), jnp.uint32)
        table = table.at[rowk, rankk].set(jnp.where(ok, entries, 0))
        return table[:n_rows]

    return fill


class LazyDeviceShard:
    """Duck-typed :class:`IndexShard` whose minimizer arrays live on
    device (the device-resident build) and are fetched to host only on
    first access (artifact save, multi-shard stacking) — the fetch
    costs one large D2H transfer, which classification never pays."""

    def __init__(self, ref_codes, seq_starts, seq_lengths,
                 seq_accession_id, pos_accession_id,
                 h_dev, ps_dev, total: int, occ_cap: int):
        self.ref_codes = ref_codes
        self.seq_starts = seq_starts
        self.seq_lengths = seq_lengths
        self.seq_accession_id = seq_accession_id
        self.pos_accession_id = pos_accession_id
        self._h_dev, self._ps_dev = h_dev, ps_dev
        self._total, self._occ_cap = total, occ_cap
        self._host = None

    def _fetch(self):
        if self._host is None:
            h = np.asarray(self._h_dev)[: self._total].astype(np.uint32)
            ps = np.asarray(self._ps_dev)[: self._total]
            if self._occ_cap and len(h):
                starts = np.flatnonzero(
                    np.concatenate([[True], h[1:] != h[:-1]])
                )
                runlen = np.diff(np.concatenate([starts, [len(h)]]))
                keep = np.repeat(runlen <= self._occ_cap, runlen)
                h, ps = h[keep], ps[keep]
            self._host = (
                h,
                (ps >> 1).astype(np.int32),
                (ps & 1).astype(np.uint8),
            )
        return self._host

    @property
    def mz_hash(self):
        return self._fetch()[0]

    @property
    def mz_pos(self):
        return self._fetch()[1]

    @property
    def mz_strand(self):
        return self._fetch()[2]

    @property
    def n_minimizers(self):
        return len(self.mz_hash)


def device_build_enabled() -> bool:
    """Device-side index sketching policy: opt-out env var, and only
    when the default backend is an accelerator (the jax-CPU path has no
    advantage over the threaded numpy sketch)."""
    import os

    flag = os.environ.get("MONICA_TPU_DEVICE_BUILD", "auto")
    if flag in ("0", "off", "false"):
        return False
    if flag in ("1", "on", "true"):
        return True
    try:
        import jax

        return jax.default_backend() not in ("cpu",)
    except Exception:
        return False


# ---------------------------------------------------------------------------
# genome bin-packing across shards (the _genomes_splitter analog)
# ---------------------------------------------------------------------------

def split_genomes(
    sizes: list[int], n_shards: int | None = None, max_shard_bytes: int | None = None
) -> list[list[int]]:
    """Partition genome indices into shards.

    Either a fixed shard count (mesh ``index`` axis size — balanced
    greedy LPT assignment) or a byte budget per shard (streaming greedy,
    the `database.py:70-92` behavior: oversized genome -> own shard).
    """
    if n_shards is not None:
        order = np.argsort(sizes)[::-1]
        loads = [0] * n_shards
        shards: list[list[int]] = [[] for _ in range(n_shards)]
        for i in order:
            j = int(np.argmin(loads))
            shards[j].append(int(i))
            loads[j] += sizes[i]
        return [sorted(s) for s in shards]
    assert max_shard_bytes is not None
    shards = []
    cur: list[int] = []
    cur_size = 0
    for i, size in enumerate(sizes):
        if size > max_shard_bytes:
            if cur:
                shards.append(cur)
                cur, cur_size = [], 0
            shards.append([i])
        elif cur_size + size <= max_shard_bytes:
            cur.append(i)
            cur_size += size
        else:
            shards.append(cur)
            cur, cur_size = [i], size
    if cur:
        shards.append(cur)
    return shards


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _segment_records(
    genome_records: list[list[np.ndarray]],
) -> list[tuple[int, np.ndarray]]:
    """Flatten genomes to (accession_id, codes) units, splitting records
    longer than SEG_LEN so any genome — including multi-hundred-Mb host
    chromosomes — can be bin-packed under the shard cap."""
    units: list[tuple[int, np.ndarray]] = []
    for gi, recs in enumerate(genome_records):
        for r in recs:
            r = np.asarray(r, dtype=np.uint8)
            if len(r) <= SEG_LEN:
                units.append((gi, r))
            else:
                for off in range(0, len(r), SEG_LEN):
                    units.append((gi, r[off : off + SEG_LEN]))
    return units


def _assign_units(
    unit_sizes: list[int], n_shards: int | None, max_shard_bytes: int | None
) -> list[list[int]]:
    """split_genomes over units with the hard SHARD_CAP enforced: the
    shard count is bumped until every packed shard fits the cap."""
    slack = 64 * (len(unit_sizes) + 2)  # guard blocks
    cap = SHARD_CAP - slack
    if max_shard_bytes is not None:
        return split_genomes(unit_sizes, max_shard_bytes=min(max_shard_bytes, cap))
    n = max(n_shards or 1, 1)
    while True:
        assignment = split_genomes(unit_sizes, n_shards=n)
        if all(sum(unit_sizes[i] for i in m) <= cap for m in assignment if m):
            return [m for m in assignment if m]
        n += 1


def _build_shards_threaded(
    assignment, units, k, w, guard, frac, occ_cap
) -> tuple[list, list | None]:
    """Build shards concurrently (the reference's multi_threaded_builder
    analog, database.py:16-33): _build_shard is pure and numpy releases
    the GIL on its large array ops, so a thread per shard overlaps the
    sketch chains of a multi-shard build.

    Returns (shards, device_info): for a single-shard build on an
    accelerator backend the shard is built fully device-resident
    (sketch + sort + hash-table on device, _device_hash_table) and
    device_info carries [(table, tag_bits)]; otherwise device_info is
    None."""
    if len(assignment) == 1 and device_build_enabled():
        out = _build_shard_device(
            assignment[0], units, k, w, guard, frac, occ_cap
        )
        if out is not None:
            shard, table, tag_bits = out
            return [shard], [(table, tag_bits)]
    if len(assignment) <= 1:
        return [
            _build_shard(m, units, k, w, guard, frac, occ_cap)
            for m in assignment
        ], None
    from concurrent.futures import ThreadPoolExecutor

    # shard threads already saturate the cores: the inner chunk-sketch
    # pool would multiply to shard_threads x 4 concurrent numpy jobs
    # (cache thrash + ~4x temporary memory), so it is disabled here
    with ThreadPoolExecutor(max_workers=min(len(assignment), 8)) as ex:
        return list(
            ex.map(
                lambda m: _build_shard(
                    m, units, k, w, guard, frac, occ_cap, sketch_workers=1
                ),
                assignment,
            )
        ), None


def _build_shard_device(
    members, units, k, w, guard, frac, occ_cap
):
    """Device-resident shard build: pack on host, sketch + sort + hash
    table on device.  Returns (LazyDeviceShard, table_device, tag_bits)
    or None to fall back (CPU backend via env, capacity overflow)."""
    from monica_tpu.ops import lookup as lk

    builder = enc.PackedSeqsBuilder(guard=guard)
    for ui in members:
        gi, rec_codes = units[ui]
        builder.add(rec_codes, gi)
    packed = builder.build()
    if len(packed.codes) >= SHARD_CAP:
        raise ValueError(
            "index shard exceeds 64 Mbase; raise n_shards or lower "
            "max_shard_bytes (packed lookup entries need >= 5 tag bits, "
            "ops/lookup.py MIN_TAG_BITS)"
        )
    got = _device_sketch_sort_arrays(packed.codes, k, w, frac)
    if got is None:
        return None
    h_dev, ps_dev, total = got
    tag_bits = lk.tag_bits_for(len(packed.codes))
    table, _n_kept = _device_hash_table(
        h_dev, ps_dev, total, tag_bits, occ_cap
    )
    pos_acc = np.zeros(max(len(packed.codes), 1), dtype=np.uint16)
    for s0, ln, aid in zip(packed.starts, packed.lengths, packed.seq_accession_id):
        pos_acc[s0 : s0 + ln] = aid
    shard = LazyDeviceShard(
        ref_codes=packed.codes,
        seq_starts=packed.starts,
        seq_lengths=packed.lengths,
        seq_accession_id=packed.seq_accession_id,
        pos_accession_id=pos_acc,
        h_dev=h_dev, ps_dev=ps_dev, total=total, occ_cap=occ_cap,
    )
    return shard, table, tag_bits


def _build_shard(
    members: list[int],
    units: list[tuple[int, np.ndarray]],
    k: int,
    w: int,
    guard: int,
    frac: float,
    occ_cap: int = OCC_CAP,
    sketch_workers: int = 4,
) -> IndexShard:
    """Pack the member units, sketch, sort, attribute.

    Shared by :func:`build_index` and :func:`build_index_from_arrays`
    so the shard construction recipe (chunked sketch, stable hash sort,
    occ capping, per-position accession fill) cannot drift between the
    two paths.
    """
    builder = enc.PackedSeqsBuilder(guard=guard)
    for ui in members:
        gi, rec_codes = units[ui]
        builder.add(rec_codes, gi)
    packed = builder.build()
    if len(packed.codes) >= SHARD_CAP:
        raise ValueError(
            "index shard exceeds 64 Mbase; raise n_shards or lower "
            "max_shard_bytes (packed lookup entries need >= 5 tag bits, "
            "ops/lookup.py MIN_TAG_BITS)"
        )
    dev = (
        _device_sketch_sort(packed.codes, k, w, frac)
        if device_build_enabled() and len(packed.codes) >= (1 << 21)
        else None
    )
    if dev is not None:
        h_s, pos_s, strand_s = dev  # already sorted by (hash, pos)
    else:
        h, pos, strand = sketch_long_sequence(
            packed.codes, k, w, frac=frac, workers=sketch_workers
        )
        order = np.argsort(h, kind="stable")
        h_s, pos_s, strand_s = h[order], pos[order], strand[order]
    if occ_cap and len(h_s):
        # run-length per entry of its equal-hash run; drop long runs
        starts = np.flatnonzero(
            np.concatenate([[True], h_s[1:] != h_s[:-1]])
        )
        runlen = np.diff(np.concatenate([starts, [len(h_s)]]))
        keep = np.repeat(runlen <= occ_cap, runlen)
        h_s, pos_s, strand_s = h_s[keep], pos_s[keep], strand_s[keep]
    # per-position accession id for device-side attribution
    pos_acc = np.zeros(max(len(packed.codes), 1), dtype=np.uint16)
    for s0, ln, aid in zip(packed.starts, packed.lengths, packed.seq_accession_id):
        pos_acc[s0 : s0 + ln] = aid
    return IndexShard(
        ref_codes=packed.codes,
        seq_starts=packed.starts,
        seq_lengths=packed.lengths,
        seq_accession_id=packed.seq_accession_id,
        mz_hash=h_s,
        mz_pos=pos_s.astype(np.int32),
        mz_strand=strand_s,
        pos_accession_id=pos_acc,
    )


def build_index(
    genomes: list[tuple[str, list[str]]],
    n_shards: int = 1,
    max_shard_bytes: int | None = None,
    k: int = mz.K_DEFAULT,
    w: int = mz.W_DEFAULT,
    guard: int = 32,
    frac: float = mz.FRAC_DEFAULT,
    occ_cap: int = OCC_CAP,
) -> BuiltIndex:
    """Build a sharded index from genome FASTA files.

    ``genomes``: list of (fasta_path, [species_name, accession]) — the
    exact tuple contract the reference's fetcher hands to its database
    builder (`monica/genomes/fetcher.py:252`).
    """
    if not genomes:
        raise ValueError("build_index: empty genome set (nothing to index)")
    tax_units = [g[1][0] for g in genomes]
    accessions = [g[1][1] for g in genomes]
    genome_lengths = np.zeros(len(genomes), dtype=np.int64)

    # accession-id = position in the genomes list
    all_codes: list[list[np.ndarray]] = []
    for gi, (path, _hdr) in enumerate(genomes):
        recs = [enc.encode_seq(r.seq) for r in seqio.read_fasta(path)]
        all_codes.append(recs)
        genome_lengths[gi] = int(sum(len(r) for r in recs))

    units = _segment_records(all_codes)
    if not units:
        raise ValueError("build_index: genomes contain no sequence records")
    assignment = _assign_units(
        [len(u[1]) for u in units],
        n_shards if max_shard_bytes is None else None,
        max_shard_bytes,
    )
    shards, device = _build_shards_threaded(
        assignment, units, k, w, guard, frac, occ_cap
    )

    meta = IndexMeta(
        tax_units=tax_units,
        accessions=accessions,
        genome_lengths=genome_lengths,
        k=k,
        w=w,
        frac=frac,
        occ_cap=occ_cap,
    )
    return BuiltIndex(meta=meta, shards=shards, device=device)


def build_index_from_arrays(
    seqs: list[np.ndarray],
    tax_units: list[str] | None = None,
    accessions: list[str] | None = None,
    n_shards: int = 1,
    max_shard_bytes: int | None = None,
    k: int = mz.K_DEFAULT,
    w: int = mz.W_DEFAULT,
    guard: int = 32,
    frac: float = mz.FRAC_DEFAULT,
    occ_cap: int = OCC_CAP,
) -> BuiltIndex:
    """Build an index directly from uint8 code arrays (one per genome) —
    the in-memory path used by benchmarks, the evaluation harness, and
    the driver entry (no FASTA round-trip)."""
    if not seqs:
        raise ValueError("build_index_from_arrays: empty genome set")
    n = len(seqs)
    tax_units = tax_units or [f"Species_{i}" for i in range(n)]
    accessions = accessions or [f"ACC{i:04d}.1" for i in range(n)]
    genome_lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    units = _segment_records([[np.asarray(s, dtype=np.uint8)] for s in seqs])
    assignment = _assign_units(
        [len(u[1]) for u in units],
        n_shards if max_shard_bytes is None else None,
        max_shard_bytes,
    )
    shards, device = _build_shards_threaded(
        assignment, units, k, w, guard, frac, occ_cap
    )
    meta = IndexMeta(
        tax_units=tax_units,
        accessions=accessions,
        genome_lengths=genome_lengths,
        k=k,
        w=w,
        frac=frac,
        occ_cap=occ_cap,
    )
    return BuiltIndex(meta=meta, shards=shards, device=device)


def merge_built(parts: list[BuiltIndex]) -> BuiltIndex:
    """Combine independently built/cached index groups (guests, hosts)
    into one searchable index, re-basing accession ids per part.

    The reference reaches the same effect by aligning every read
    against the union of G_/H_ index chunk files (`monica/monica.py:
    226-420` collects indexes_paths across groups); here groups stay
    separately cached artifacts and merge structurally at load time.
    """
    parts = [p for p in parts if p is not None]
    if len(parts) == 1:
        return parts[0]
    k, w, frac = parts[0].meta.k, parts[0].meta.w, parts[0].meta.frac
    for p in parts:
        if (p.meta.k, p.meta.w, p.meta.frac) != (k, w, frac):
            raise ValueError("cannot merge indexes with different k/w/frac")
    tax_units, accessions, lengths, shards = [], [], [], []
    base = 0
    for p in parts:
        tax_units += p.meta.tax_units
        accessions += p.meta.accessions
        lengths.append(p.meta.genome_lengths)
        for sh in p.shards:
            if base + p.meta.n_accessions > np.iinfo(np.uint16).max:
                raise ValueError("merged index exceeds 65535 accessions")
            shards.append(
                IndexShard(
                    ref_codes=sh.ref_codes,
                    seq_starts=sh.seq_starts,
                    seq_lengths=sh.seq_lengths,
                    seq_accession_id=sh.seq_accession_id + base,
                    mz_hash=sh.mz_hash,
                    mz_pos=sh.mz_pos,
                    mz_strand=sh.mz_strand,
                    pos_accession_id=(sh.pos_accession_id.astype(np.int32) + base).astype(
                        np.uint16
                    ),
                )
            )
        base += p.meta.n_accessions
    meta = IndexMeta(
        tax_units=tax_units,
        accessions=accessions,
        genome_lengths=np.concatenate(lengths) if lengths else np.zeros(0, np.int64),
        k=k,
        w=w,
        frac=frac,
        occ_cap=parts[0].meta.occ_cap,
    )
    return BuiltIndex(meta=meta, shards=shards)


def content_key(
    genomes: list[tuple[str, list[str]]], k: int, w: int, n_shards: int,
    frac: float = mz.FRAC_DEFAULT,
) -> str:
    """Content-addressed artifact key (replaces the reference's
    config-encoded folder names, `monica/monica.py:244-245`)."""
    hsh = hashlib.sha256()
    hsh.update(f"k={k},w={w},shards={n_shards},frac={frac}".encode())
    for path, hdr in genomes:
        hsh.update("|".join(hdr).encode())
        try:
            hsh.update(str(os.path.getsize(path)).encode())
        except OSError:
            pass
    return hsh.hexdigest()[:16]
