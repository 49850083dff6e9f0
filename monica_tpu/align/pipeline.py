"""The jit-compiled classification pipeline (the mappy-map replacement).

Reference hot loop being re-designed: per read ``index.map(str(seq))``,
keep primary hits with ``mapq >= 60`` as (ctg, NM, mlen), pick best by
min NM/mlen, exact tie -> ambiguous, then count by mode
(`monica/genomes/aligner.py:179-279,328-339`).

Here a whole read batch moves through sketch -> seed lookup -> diagonal
vote chaining -> (optional banded extension) as one XLA program with
static shapes.  Strings never reach the device: tax units/accessions
are integer ids resolved against IndexMeta on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from monica_tpu.index.build import BuiltIndex, IndexShard
from monica_tpu.index import minimizer as mz
from monica_tpu.ops import lookup as lk
from monica_tpu.ops import chain as ch
from monica_tpu.ops import extend as ex

# read status codes (host routing: mapped/unmapped/ambiguous folders,
# reference aligner.py:209-211,232,243,265)
UNMAPPED = 0
MAPPED = 1
AMBIGUOUS = 2

# count modes (reference aligner.py:247-263)
MODE_BASIC = 0
MODE_QUERY_LENGTH = 1
MODE_MATCHING = 2
COUNT_MODES = {"basic": MODE_BASIC, "query_length": MODE_QUERY_LENGTH, "matching": MODE_MATCHING}


class DeviceIndexShard(NamedTuple):
    """One index shard as device arrays (pytree)."""

    mz_rows: jnp.ndarray  # (2^rbits, ROW_SLOTS) uint32 direct-addressed table
    pos_acc: jnp.ndarray  # (T,) uint16 position -> accession id (2 B/base HBM)
    ref_codes: jnp.ndarray  # (T,) uint8 packed reference


def device_shard(shard: IndexShard) -> tuple[DeviceIndexShard, int]:
    """Device arrays + the static tag width for this shard's table."""
    tag_bits = lk.tag_bits_for(len(shard.ref_codes))
    dev = DeviceIndexShard(
        mz_rows=jnp.asarray(
            lk.build_hash_rows(shard.mz_hash, shard.mz_pos, shard.mz_strand, tag_bits)
        ),
        pos_acc=jnp.asarray(shard.pos_accession_id),
        ref_codes=jnp.asarray(shard.ref_codes),
    )
    return dev, tag_bits


def stack_device_shards(
    shards: list[IndexShard], tag_bits: int | None = None
) -> tuple[DeviceIndexShard, int]:
    """Pad shards to common sizes and stack on a leading axis for
    sharding over the mesh ``index`` axis.  All shards share the widest
    row-index width (a sparser table for small shards costs only
    memory) and the tag width of the largest packed reference, so the
    stacked table is rectangular.  Row padding is all-zeros = the
    empty-slot sentinel.
    Returns (stacked pytree, common tag width over shards)."""
    if not shards:
        raise ValueError("cannot stack an empty shard list")
    T = max(len(s.ref_codes) for s in shards)
    if tag_bits is None:
        tag_bits = lk.tag_bits_for(T)
    rbits = max(lk.row_bits_for(s.n_minimizers) for s in shards)

    def pad(a, n, fill):
        out = np.full((n,), fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    dev = DeviceIndexShard(
        mz_rows=jnp.asarray(
            np.stack(
                [
                    lk.build_hash_rows(
                        s.mz_hash, s.mz_pos, s.mz_strand, tag_bits, rbits
                    )
                    for s in shards
                ]
            )
        ),
        pos_acc=jnp.asarray(
            np.stack([pad(s.pos_accession_id, T, 0) for s in shards])
        ),
        ref_codes=jnp.asarray(np.stack([pad(s.ref_codes, T, 4) for s in shards])),
    )
    return dev, tag_bits


def _size_class(n: int) -> int:
    """Power-of-2 size class for shard grouping."""
    return 1 << max(int(n) - 1, 0).bit_length()


def stack_device_shard_groups(
    shards: list[IndexShard],
) -> tuple[tuple[DeviceIndexShard, ...], int]:
    """Stack shards grouped by power-of-2 size class, so one oversized
    shard (byte-budget packing gives an oversized genome its own shard,
    index/build.py) does not pad every other shard to its size: stacked
    HBM stays within ~1.25× the sum of the true shard sizes even on a
    heavily skewed split, instead of S × max.  The tag width is common
    across groups (sized for the largest packed reference) so one
    static ClassifyParams covers every group.
    Returns (tuple of stacked group pytrees, common tag width)."""
    if not shards:
        raise ValueError("cannot stack an empty shard list")
    T = max(len(s.ref_codes) for s in shards)
    tag_bits = lk.tag_bits_for(T)
    by_class: dict[int, list[IndexShard]] = {}
    for s in shards:
        by_class.setdefault(_size_class(len(s.ref_codes)), []).append(s)
    groups = tuple(
        stack_device_shards(by_class[c], tag_bits=tag_bits)[0]
        for c in sorted(by_class)
    )
    return groups, tag_bits


def _empty_shard() -> IndexShard:
    """A padding shard that can never produce a hit: empty hash table
    (all-zero rows = the empty-slot sentinel) over a 1-base reference.
    Used to even out per-rank shard counts on the mesh ``index`` axis."""
    return IndexShard(
        ref_codes=np.full(1, 4, np.uint8),
        seq_starts=np.zeros(0, np.int64),
        seq_lengths=np.zeros(0, np.int64),
        seq_accession_id=np.zeros(0, np.int32),
        mz_hash=np.zeros(0, np.uint32),
        mz_pos=np.zeros(0, np.int32),
        mz_strand=np.zeros(0, np.uint8),
        pos_accession_id=np.zeros(1, np.uint16),
    )


def stack_mesh_shard_groups(
    shards: list[IndexShard], n_index: int
) -> tuple[tuple[DeviceIndexShard, ...], int]:
    """Stack ANY number of shards for an ``index``-axis of size n_index,
    several shards per device when len(shards) > n_index (the reference
    aligns every read against every chunk however many there are,
    `monica/genomes/aligner.py:91-103`; VERDICT r3 item 2).

    Layout: shards are grouped by power-of-2 size class (so one skewed
    shard does not pad every device's HBM copy to its size — same
    rationale as :func:`stack_device_shard_groups`); within each class
    they are dealt to index ranks balanced by bytes, each rank padded
    to the class's max-per-rank count with inert empty shards, and the
    class is stacked RANK-MAJOR on the leading axis — rows
    ``[r*S_c, (r+1)*S_c)`` belong to rank r, which is exactly how
    ``P(INDEX_AXIS)`` slices a leading axis of length ``n_index*S_c``.
    Per-device HBM is therefore bounded by the HEAVIEST rank's own
    bytes (+ <= 2x class rounding), not by ``ceil(S/n_index) x
    max_shard``: a uniform SPMD program runs identical static shapes on
    every rank, so a size class with fewer members than ranks
    necessarily costs one padded (inert) row on the other ranks — that
    one-copy floor is the price of single-program dispatch, and it
    never multiplies across shards the way global-max rectangular
    stacking did.

    Returns (tuple of stacked group pytrees, common tag width)."""
    if not shards:
        raise ValueError("cannot stack an empty shard list")
    T = max(len(s.ref_codes) for s in shards)
    tag_bits = lk.tag_bits_for(T)
    by_class: dict[int, list[IndexShard]] = {}
    for s in shards:
        by_class.setdefault(_size_class(len(s.ref_codes)), []).append(s)
    groups = []
    for c in sorted(by_class):
        members = sorted(by_class[c], key=lambda s: -len(s.ref_codes))
        ranks: list[list[IndexShard]] = [[] for _ in range(n_index)]
        loads = np.zeros(n_index, np.int64)
        for s in members:  # LPT: largest first onto the lightest rank
            r = int(np.argmin(loads))
            ranks[r].append(s)
            loads[r] += len(s.ref_codes)
        s_c = max(len(r) for r in ranks)
        ordered: list[IndexShard] = []
        for r in ranks:
            ordered += r + [_empty_shard()] * (s_c - len(r))
        groups.append(stack_device_shards(ordered, tag_bits=tag_bits)[0])
    return tuple(groups), tag_bits


def stacked_nbytes(groups) -> int:
    """Total bytes of (a tuple of) stacked shard pytrees."""
    total = 0
    for g in groups if isinstance(groups, tuple) else (groups,):
        total += sum(np.asarray(a).nbytes for a in g)
    return total


class ClassifyParams(NamedTuple):
    """Static pipeline parameters (hashable -> usable as jit static arg)."""

    k: int = mz.K_DEFAULT
    w: int = mz.W_DEFAULT
    # scaled-winnowing fraction — MUST match the index side
    # (IndexMeta.frac; Classifier/evaluate copy it from there so the two
    # sides cannot diverge).  Validated in scripts/concordance.py --sweep.
    frac: float = mz.FRAC_DEFAULT
    n_slots: int = 128  # minimizer slots per read
    mapping_quality: float = 60.0  # reference default (monica aligner.py:65)
    min_votes: int = 3  # noise floor for a callable chain
    tag_bits: int = 8  # packed-entry tag width (device_shard returns it)
    # banded Smith–Waterman extension (ops.extend): refines the
    # anchor-count identity into an alignment NM/mlen, and RESCUES
    # uniquely-placed reads whose vote count alone cannot reach the
    # mapq gate (short reads at high error rates: a 300 bp read at
    # ~11% error has ~8 surviving seeds, and the reference's mappy
    # path simply drops the low tail — extension verifies the locus by
    # alignment instead, so classification is strictly more sensitive
    # than the reference at equal precision).
    extend: bool = True
    # band width in cells.  64 is accuracy-equivalent to 128 (full-size
    # concordance gate 0.9678 for both: nanopore indels are 1-3 bp, the
    # chained diagonal rarely drifts +/-32 in a read) at half the SW
    # cells per read; the CUDA kernel spreads it over one warp, two
    # cells per lane (ops/banded_sw.cu).
    band: int = 64
    # "cuda" (ops/banded_sw.cu) | "jnp" (ops/extend.py banded_sw_jnp) |
    # "auto": the CUDA kernel on a GPU backend, jnp elsewhere
    extend_impl: str = "auto"
    # "full": banded SW on every read (alignment NM/mlen everywhere,
    #   exactly what mappy reports, aligner.py:195).
    # "rescue": banded SW only on a compacted subset of reads that
    #   FAILED the vote gate (the only reads whose status it can
    #   change); vote-passed reads keep the statistical identity.  The
    #   SW cost drops from O(batch) to O(batch * rescue_frac) — on
    #   well-seeded workloads extension all but vanishes from the
    #   profile while sensitivity (the rescue path) is preserved.
    extend_mode: str = "rescue"
    rescue_frac: float = 0.125  # extension slot budget as batch fraction
    # rescue acceptance: alignment NM/mlen at most this, and runner-up
    # locus at most half the best (uniqueness guard; shared-region
    # reads keep failing toward unmapped/ambiguous as they should).
    rescue_nm_rate: float = 0.35
    # rescue acceptance also requires the LOCAL alignment to cover the
    # read: mlen >= rescue_min_cov * read_len.  The banded SW is local
    # (restart-at-zero floor, ops/extend.py) so a decoy locus can show
    # a short high-identity segment with a tiny NM/mlen; mappy kills
    # those via primary/mapq, here the coverage floor does (wrong-call
    # source found in the r5 single-anchor-rescue ablation).
    rescue_min_cov: float = 0.5
    # rescue candidacy: minimum chain votes to seat the extension
    # band.  2 = two co-diagonal anchors (the r4 default); 1 admits
    # single-surviving-seed reads — at r9_old error rates a large
    # fraction of 300-1000 bp reads keep exactly one seed, and the
    # banded-SW identity (<= rescue_nm_rate) plus the uniqueness guard
    # (f2*2 <= f1 forces f2 == 0 when f1 == 1) carry the evidence the
    # vote count cannot.
    rescue_min_votes: int = 1
    # verified anchors kept per seed (< lookup.ROW_SLOTS compacts the
    # per-anchor arrays; chain sort cost scales with this).  2 costs
    # <0.2% worst-gated accuracy vs 4 at full concordance size (default
    # 0.9688 vs 0.9678, precision 1.0 both) while halving every
    # per-anchor array.
    anchors_per_seed: int = 2
    # cross-shard tie tolerance (relative, on the vote-statistical
    # merge cost).  Identical sequence copies in DIFFERENT shards do
    # not produce bit-identical votes — each shard's hash table
    # overflows rows differently, dropping a few of ~40 anchors ≈ 5-8%
    # relative cost noise — so the reference's exact-tie->ambiguous
    # (aligner.py:336-337) becomes a near-tie band here.  10% (≈ ±4 of
    # 40 votes) covers that noise while loci that differ by a unique
    # flank (the discriminative case) sit far outside it; reads
    # equidistant between near-identical strains come out AMBIGUOUS, as
    # they should.  Single-shard tie semantics are untouched (exact
    # f2==f1 inside classify_shard).
    tie_rel_tol: float = 0.10
    # cross-shard tie band in VOTE space: shards tie when their vote
    # counts differ by <= vote_tie_sd * sqrt(best_votes) (the sampling
    # noise of the vote statistic is ~Poisson; measured cross-shard
    # deltas on byte-identical copies are 0-5 votes of ~30 while a 3%-
    # divergent strain sits ~11 votes below the true locus at 1 kb).
    # The cost-space band above is the same test after a 1/(k*f1)
    # amplification that makes low-vote
    # reads escape; the vote-space band closes that tail.  0 disables
    # (exact reference tie semantics, tests/test_reference_golden.py).
    vote_tie_sd: float = 1.0


class ShardHit(NamedTuple):
    """Per-read best candidate within one index shard — the device
    analog of the (ctg, NM, mlen) hit tuples (`aligner.py:195`)."""

    acc_id: jnp.ndarray  # (B,) int32 accession id within the global table
    inv_identity: jnp.ndarray  # (B,) f32 NM/mlen analog (lower = better)
    # cross-shard merge cost: ALWAYS the vote-statistical estimate, even
    # when extension refined inv_identity.  Two shards holding identical
    # copies of a region produce identical sketches -> identical votes ->
    # an EXACT tie here, regardless of whether the rescue path (whose
    # slot budget is per-shard) kicked in on one side only — which is
    # what makes the reference's exact-tie->ambiguous semantics
    # (aligner.py:328-339) hold across shards.
    merge_cost: jnp.ndarray  # (B,) f32
    mlen: jnp.ndarray  # (B,) int32 matching-bases estimate
    mapq: jnp.ndarray  # (B,) f32
    votes: jnp.ndarray  # (B,) int32 chain score f1
    passed: jnp.ndarray  # (B,) bool mapq filter passed
    rc: jnp.ndarray  # (B,) bool
    ref_pos: jnp.ndarray  # (B,) int32 representative anchor target position
    tied: jnp.ndarray  # (B,) bool equal-strength locus on a DIFFERENT
    # accession (the reference's best_hit exact tie -> ambiguous,
    # aligner.py:328-339)


def params_for_bucket(params: ClassifyParams, bucket_len: int) -> ClassifyParams:
    """Per-bucket seed budget: short reads keep every minimizer they
    have (a 300 bp read has ~55 — dropping any costs sensitivity, the
    slots64 sweep row fails the gate at 300 bp only), while long reads
    are heavily oversampled at 128 slots (64 slots at 1000/5000 bp
    scores 0.998/1.0 in the same sweep).  Halving the slot budget for
    buckets > 512 halves the lookup gather count and every chain-stage
    array for the dominant read lengths.  jit specializes per (bucket,
    params) pair anyway, so this adds no extra compilations."""
    if bucket_len > 512 and params.n_slots > 64:
        return params._replace(n_slots=64)
    return params


def sketch_batch(codes, lengths, params: ClassifyParams):
    """Read sketching, shard-independent — hoist it when scoring the
    same batch against multiple index shards."""
    qh, qp, qs, qv = mz.sketch_reads_jax(
        codes, params.n_slots, params.k, params.w, frac=params.frac
    )
    # mask slots beyond the true read length (padding makes fake kmers
    # impossible — PAD_CODE invalidates them — but be explicit)
    qv = qv & (qp < (lengths[:, None] - params.k + 1))
    return qh, qp, qs, qv


def classify_shard(
    index: DeviceIndexShard,
    codes: jnp.ndarray,  # (B, L) uint8
    lengths: jnp.ndarray,  # (B,) int32
    params: ClassifyParams,
    sketch=None,  # optional hoisted sketch_batch result
) -> ShardHit:
    """Best hit of every read against one shard (pure jnp, jit-safe)."""
    B, L = codes.shape

    qh, qp, qs, qv = sketch if sketch is not None else sketch_batch(
        codes, lengths, params
    )

    key, diag, rpos, fpos = lk.lookup_anchors(
        index.mz_rows,
        qh,
        qp,
        qs,
        qv,
        tag_bits=params.tag_bits,
        bucket_len=L,
        anchors_per_seed=params.anchors_per_seed,
    )
    # vote cap = the seed budget: in the 512 bp bucket (n_slots=128) a
    # clean read can legitimately stack >64 votes on one diagonal, and
    # capping there biases statistical identity/mlen low (ADVICE r3)
    res = ch.chain_votes(key, diag, rpos, fpos, max_run=min(128, params.n_slots))
    mapq = ch.mapq_from_votes(res.f1, res.f2)

    # anchor-count identity estimate: a k-mer survives error rate e with
    # prob (1-e)^k, so votes/slots ~ id^k  =>  id ~ (f1/slots)^(1/k).
    # Banded extension (ops.extend) refines this when enabled.
    n_valid = jnp.maximum(jnp.sum(qv, axis=-1), 1).astype(jnp.float32)
    frac = jnp.clip(res.f1.astype(jnp.float32) / n_valid, 1e-6, 1.0)
    identity = jnp.exp(jnp.log(frac) / params.k)
    lf = lengths.astype(jnp.float32)
    mlen = jnp.maximum(identity * lf, 1.0)
    inv_identity = (1.0 - identity) / jnp.maximum(identity, 1e-6)
    stat_cost = inv_identity  # pre-extension estimate, the merge cost

    passed = (
        (mapq >= params.mapping_quality)
        & (res.f1 >= params.min_votes)
        & (lengths > 0)
    )

    if params.extend and params.extend_mode == "full":
        # banded SW at the chained locus: replaces the statistical
        # identity with an alignment-based NM/mlen (the hit.NM/hit.mlen
        # the reference reads off mappy, aligner.py:195)
        ext = ex.extend_hits(
            index.ref_codes,
            codes,
            lengths,
            res.rep_ref_pos,
            res.rep_read_pos,
            res.rc,
            k=params.k,
            p=ex.ExtendParams(band=params.band),
            impl=params.extend_impl,
        )
        mlen = ext.mlen.astype(jnp.float32)
        inv_identity = ext.inv_identity
        # alignment rescue: a unique locus verified by high alignment
        # identity is MAPPED even when too few seeds survived for the
        # vote-based mapq (mappy's own extension plays this role).
        rescued = (
            (res.f1 >= params.rescue_min_votes)  # anchors seat the
            # band; the alignment identity below is the actual evidence
            & (res.f2 * 2 <= res.f1)
            & (ext.inv_identity <= params.rescue_nm_rate)
            & (
                ext.mlen.astype(jnp.float32)
                >= params.rescue_min_cov * lengths.astype(jnp.float32)
            )
            & (lengths > 0)
        )
        passed = passed | rescued
    elif params.extend and params.extend_mode == "rescue":
        # budgeted rescue: SW only on reads extension can still flip —
        # unique-locus reads that FAILED the vote gate.  Candidates are
        # compacted to a fixed slot budget (static shape) and the
        # verdicts scattered back; vote-passed reads keep the
        # statistical identity above.
        cand = (
            ~passed
            & (res.f1 >= params.rescue_min_votes)
            & (res.f2 * 2 <= res.f1)
            & (lengths > 0)
        )

        def with_rescue(n_slots):
            def fn(_):
                order = jnp.argsort(jnp.where(cand, 0, 1), stable=True)
                idx = order[:n_slots]
                take = lambda x: jnp.take(x, idx, axis=0)
                ext = ex.extend_hits(
                    index.ref_codes,
                    take(codes),
                    take(lengths),
                    take(res.rep_ref_pos),
                    take(res.rep_read_pos),
                    take(res.rc),
                    k=params.k,
                    p=ex.ExtendParams(band=params.band),
                    impl=params.extend_impl,
                )
                ok = (
                    take(cand)
                    & (ext.inv_identity <= params.rescue_nm_rate)
                    & (
                        ext.mlen.astype(jnp.float32)
                        >= params.rescue_min_cov
                        * take(lengths).astype(jnp.float32)
                    )
                )
                rescued = jnp.zeros((B,), bool).at[idx].set(ok)
                inv_sc = jnp.zeros((B,), inv_identity.dtype).at[idx].set(
                    jnp.where(ok, ext.inv_identity, 0.0)
                )
                mlen_sc = jnp.zeros((B,), mlen.dtype).at[idx].set(
                    jnp.where(ok, ext.mlen.astype(mlen.dtype), 0.0)
                )
                return rescued, inv_sc, mlen_sc

            return fn

        def without_rescue(_):
            return (
                jnp.zeros((B,), bool),
                jnp.zeros((B,), inv_identity.dtype),
                jnp.zeros((B,), mlen.dtype),
            )

        # ADAPTIVE slot budget (VERDICT r4 next-round item 2): the
        # static B/8 budget saturates at high error rates — at r9_old
        # (18% error) 1 kb, ~1/3 of a batch fails the vote gate with a
        # seedable unique locus, and every read beyond the budget stayed
        # unmapped.  Escalate the
        # compaction width by the actual candidate count: B/8 (clean/
        # mildly-noisy batches, the common case) -> B/2 -> B, so every
        # candidate gets a slot in the worst case while a clean batch
        # still skips SW entirely (lax.cond executes one branch at
        # runtime; the other tiers cost compile time only).
        n_cand = jnp.sum(cand)
        n8 = max(int(B * params.rescue_frac), 1)
        n2 = max(B // 2, 1)
        rescued, inv_sc, mlen_sc = jax.lax.cond(
            n_cand > 0,
            lambda _: jax.lax.cond(
                n_cand <= n8,
                with_rescue(n8),
                lambda __: jax.lax.cond(
                    n_cand <= n2,
                    with_rescue(n2),
                    with_rescue(B),
                    operand=None,
                ),
                operand=None,
            ),
            without_rescue,
            operand=None,
        )
        passed = passed | rescued
        # rescued reads report their alignment identity; everyone else
        # keeps the statistical estimate
        inv_identity = jnp.where(rescued, inv_sc, inv_identity)
        mlen = jnp.where(rescued, mlen_sc, mlen)

    acc_id = index.pos_acc[
        jnp.clip(res.rep_ref_pos, 0, index.pos_acc.shape[0] - 1)
    ].astype(jnp.int32)
    acc2 = index.pos_acc[
        jnp.clip(res.rep2_ref_pos, 0, index.pos_acc.shape[0] - 1)
    ].astype(jnp.int32)
    tied = (
        (res.f2 == res.f1)
        & (res.f1 >= params.min_votes)
        & (acc2 != acc_id)
        & (lengths > 0)
    )
    return ShardHit(
        acc_id=acc_id.astype(jnp.int32),
        inv_identity=inv_identity,
        merge_cost=stat_cost,
        mlen=mlen.astype(jnp.int32),
        mapq=mapq,
        votes=res.f1,
        passed=passed & ~tied,
        rc=res.rc,
        ref_pos=res.rep_ref_pos,
        tied=tied,
    )


class ReadResult(NamedTuple):
    """Final per-read classification (single- or merged multi-shard)."""

    status: jnp.ndarray  # (B,) int32 UNMAPPED/MAPPED/AMBIGUOUS
    acc_id: jnp.ndarray  # (B,) int32 (-1 when not mapped)
    inv_identity: jnp.ndarray  # (B,) f32
    mlen: jnp.ndarray  # (B,) int32
    mapq: jnp.ndarray  # (B,) f32
    rc: jnp.ndarray  # (B,) bool


def finalize_single(hit: ShardHit) -> ReadResult:
    status = jnp.where(hit.passed, MAPPED, jnp.where(hit.tied, AMBIGUOUS, UNMAPPED))
    return ReadResult(
        status=status.astype(jnp.int32),
        acc_id=jnp.where(hit.passed, hit.acc_id, -1),
        inv_identity=hit.inv_identity,
        mlen=jnp.where(hit.passed, hit.mlen, 0),
        mapq=hit.mapq,
        rc=hit.rc,
    )


DEFAULT_TIE_REL_TOL = ClassifyParams().tie_rel_tol


def merge_hits(
    hits: ShardHit,
    tie_rel_tol: float = DEFAULT_TIE_REL_TOL,
    vote_tie_sd: float = ClassifyParams().vote_tie_sd,
) -> ReadResult:
    """Merge per-shard hits stacked on axis 0 — the device analog of
    merging per-chunk ``hits.pkl`` and running ``best_hit``
    (`aligner.py:219-231,328-339`): best = min inv_identity among
    passing shards; an exact tie between two passing shards with
    different accessions -> AMBIGUOUS.  The comparison runs on the
    vote-statistical ``merge_cost`` (see ShardHit.merge_cost: identical
    cross-shard copies tie EXACTLY on it even when extension refined
    only one side); the winner still reports its refined identity.

    Near-ties are recognized in BOTH cost space (``tie_rel_tol``) and
    vote space (``vote_tie_sd`` standard deviations of the ~Poisson
    vote count — see ClassifyParams.vote_tie_sd); set both to 0 for
    the reference's exact-tie-only contract."""
    S, B = hits.passed.shape
    BIG = jnp.float32(1e9)
    cost = jnp.where(hits.passed, hits.merge_cost, BIG)  # (S, B)
    best_s = jnp.argmin(cost, axis=0)  # (B,)
    take = lambda x: jnp.take_along_axis(x, best_s[None], axis=0)[0]
    best_cost = take(cost)
    n_pass = jnp.sum(hits.passed, axis=0)
    any_pass = n_pass > 0

    # tie detection: another passing shard within the near-tie band of
    # the best cost — or within the vote-noise band of the best vote
    # count — AND attributing a DIFFERENT accession (segmented
    # genomes can span shards: equal-cost hits on the same accession
    # are agreement, not ambiguity — matching the within-shard tie
    # check, classify_shard's acc2 != acc_id), or (when nothing
    # passed) any shard reporting an internal tie
    is_best = jnp.arange(S)[:, None] == best_s[None, :]
    band = best_cost * jnp.float32(1.0 + tie_rel_tol) + jnp.float32(1e-6)
    best_acc = take(hits.acc_id)
    near = cost <= band[None, :]
    if vote_tie_sd > 0.0:
        best_votes = take(hits.votes).astype(jnp.float32)
        vband = jnp.float32(vote_tie_sd) * jnp.sqrt(
            jnp.maximum(best_votes, 1.0)
        )
        dv = jnp.abs(
            hits.votes.astype(jnp.float32) - best_votes[None, :]
        )
        near = near | (dv <= vband[None, :])
    tie = jnp.any(
        near
        & ~is_best
        & hits.passed
        & (hits.acc_id != best_acc[None, :]),
        axis=0,
    )
    tied_inside = jnp.any(hits.tied, axis=0)

    status = jnp.where(
        any_pass,
        jnp.where(tie, AMBIGUOUS, MAPPED),
        jnp.where(tied_inside, AMBIGUOUS, UNMAPPED),
    )
    mapped = status == MAPPED
    return ReadResult(
        status=status.astype(jnp.int32),
        acc_id=jnp.where(mapped, take(hits.acc_id), -1),
        inv_identity=take(hits.inv_identity),
        mlen=jnp.where(mapped, take(hits.mlen), 0),
        mapq=take(hits.mapq),
        rc=take(hits.rc),
    )


def count_reads(
    result: ReadResult,
    lengths: jnp.ndarray,
    n_accessions: int,
    count_mode: int,
) -> jnp.ndarray:
    """Per-accession count vector for this batch (int32; the host
    accumulates batches in int64).  Count modes per `aligner.py:247-263`:
    basic=1, query_length=len(read), matching=mlen."""
    value = jnp.where(
        count_mode == MODE_BASIC,
        jnp.ones_like(lengths),
        jnp.where(count_mode == MODE_QUERY_LENGTH, lengths, result.mlen),
    )
    mapped = result.status == MAPPED
    seg = jnp.where(mapped, result.acc_id, n_accessions)  # overflow bucket
    counts = jax.ops.segment_sum(
        jnp.where(mapped, value, 0).astype(jnp.int32),
        seg,
        num_segments=n_accessions + 1,
    )
    return counts[:n_accessions]


@functools.partial(jax.jit, static_argnames=("params", "n_accessions", "count_mode"))
def classify_batch_stacked(
    stacked_index: DeviceIndexShard,  # leaves with leading (S,) shard axis
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    params: ClassifyParams,
    n_accessions: int,
    count_mode: int = MODE_QUERY_LENGTH,
):
    """Single-device multi-shard step: sequentially score every index
    shard (lax.map keeps it one dispatch), then merge — the on-device
    analog of the reference's loop over index chunks + hits.pkl merge
    (`aligner.py:91-103,219-231`).  Sketching is shard-independent and
    hoisted out of the shard loop."""
    sk = sketch_batch(codes, lengths, params)
    hits = jax.lax.map(
        lambda ix: classify_shard(ix, codes, lengths, params, sketch=sk),
        stacked_index,
    )
    result = merge_hits(hits, params.tie_rel_tol, params.vote_tie_sd)
    counts = count_reads(result, lengths, n_accessions, count_mode)
    return result, counts


@functools.partial(jax.jit, static_argnames=("params", "n_accessions", "count_mode"))
def classify_batch_grouped(
    groups: tuple[DeviceIndexShard, ...],  # size-class groups, each with a (S_g,) shard axis
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    params: ClassifyParams,
    n_accessions: int,
    count_mode: int = MODE_QUERY_LENGTH,
):
    """Single-device multi-shard step over size-class groups
    (stack_device_shard_groups): one lax.map per group, hits
    concatenated along the shard axis, then the usual merge.

    A single-shard index should NOT go through here: use
    ``classify_batch`` on the unstacked shard (Classifier does) — a
    1-iteration lax.map dynamic-slices hundreds of MB of index per step
    and in-body squeezes are not reliably hoisted, so squeeze at setup
    time, outside jit."""
    sk = sketch_batch(codes, lengths, params)
    hits = [
        jax.lax.map(
            lambda ix: classify_shard(ix, codes, lengths, params, sketch=sk), g
        )
        for g in groups
    ]
    merged = (
        jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *hits)
        if len(hits) > 1
        else hits[0]
    )
    result = merge_hits(merged, params.tie_rel_tol, params.vote_tie_sd)
    counts = count_reads(result, lengths, n_accessions, count_mode)
    return result, counts


@functools.partial(jax.jit, static_argnames=("params", "n_accessions", "count_mode"))
def classify_batch(
    index: DeviceIndexShard,
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    params: ClassifyParams,
    n_accessions: int,
    count_mode: int = MODE_QUERY_LENGTH,
):
    """Single-shard end-to-end step: reads -> (per-read result, counts)."""
    hit = classify_shard(index, codes, lengths, params)
    result = finalize_single(hit)
    counts = count_reads(result, lengths, n_accessions, count_mode)
    return result, counts


def unpack_codes(packed: jnp.ndarray, read_len: int) -> jnp.ndarray:
    """Device-side inverse of io.encode.pack_codes_2bit: (B, ceil(L/4))
    uint8 wire bytes -> (B, L) uint8 base codes.  Pure elementwise
    shifts/masks — XLA fuses it into the sketch stage's first pass."""
    B, P = packed.shape
    shifts = (jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2))[None, None, :]
    c = (packed[:, :, None] >> shifts) & jnp.uint8(3)
    return c.reshape(B, P * 4)[:, :read_len]


@functools.partial(
    jax.jit, static_argnames=("read_len", "params", "n_accessions", "count_mode")
)
def classify_batch_packed(
    index, packed, lengths, read_len, params, n_accessions,
    count_mode=MODE_QUERY_LENGTH,
):
    """classify_batch on 2-bit packed wire input (4x less transfer)."""
    return classify_batch(
        index, unpack_codes(packed, read_len), lengths, params, n_accessions,
        count_mode,
    )


@functools.partial(
    jax.jit, static_argnames=("read_len", "params", "n_accessions", "count_mode")
)
def classify_batch_grouped_packed(
    groups, packed, lengths, read_len, params, n_accessions,
    count_mode=MODE_QUERY_LENGTH,
):
    """classify_batch_grouped on 2-bit packed wire input."""
    return classify_batch_grouped(
        groups, unpack_codes(packed, read_len), lengths, params, n_accessions,
        count_mode,
    )


@jax.jit
def concat_packed(arrs: tuple) -> jnp.ndarray:
    """Concatenate a whole sample's per-batch pack_results arrays into
    ONE flat int32 vector on device, so the sample costs a single
    device->host transfer (one sync) instead of one per batch.  jit
    caches per batch-shape tuple — a flowcell's bucket plan repeats
    across samples, so this compiles once per workload shape.  Whether
    per-batch async copies serve arrival->table latency better on a GPU
    host is not measured yet."""
    return jnp.concatenate([a.reshape(-1) for a in arrs])


@jax.jit
def pack_results(result: ReadResult, counts: jnp.ndarray) -> jnp.ndarray:
    """Pack everything the streaming host loop consumes into ONE int32
    array so the per-batch device->host fetch is a single transfer
    (each fetch is a sync regardless of size).  Layout: rows [status,
    acc_id, mlen], then
    ceil(counts.size/B) rows of the (flattened, padded) count block —
    ``counts`` may be the (n_acc,) single-device vector or the mesh
    step's (n_data, n_acc) per-rank table."""
    B = result.status.shape[0]
    counts = counts.reshape(-1)
    n_acc = counts.shape[0]
    rows = -(-n_acc // B)
    cpad = jnp.zeros((rows * B,), jnp.int32).at[:n_acc].set(
        counts.astype(jnp.int32)
    )
    return jnp.concatenate(
        [
            result.status[None].astype(jnp.int32),
            result.acc_id[None].astype(jnp.int32),
            result.mlen[None].astype(jnp.int32),
            cpad.reshape(rows, B),
        ],
        axis=0,
    )
