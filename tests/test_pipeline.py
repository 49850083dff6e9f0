import numpy as np
import jax.numpy as jnp
import pytest

from monica_tpu.align import pipeline as pl
from monica_tpu.index.build import build_index
from monica_tpu.io.encode import bucketize_reads
from tests.fixtures import make_fasta_gz, random_genome, sample_reads


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("genomes")
    genomes = []
    seqs = []
    for i in range(5):
        g = random_genome(rng, 50_000)
        seqs.append(g)
        path = tmp / f"g{i}.fna.gz"
        make_fasta_gz(path, [(f"contig{i}", g)])
        genomes.append((str(path), [f"Species_{i}", f"ACC{i:03d}.1"]))
    built = build_index(genomes, n_shards=1)
    return built, seqs


def _classify(built, reads, params=None, count_mode=pl.MODE_BASIC):
    params = params or pl.ClassifyParams()
    batches = bucketize_reads(reads)
    dev, steps = pl.device_shard(built.shards[0])
    params = params._replace(tag_bits=steps)
    n_acc = built.meta.n_accessions
    statuses = np.zeros(len(reads), np.int32)
    accs = np.zeros(len(reads), np.int32)
    total_counts = np.zeros(n_acc, np.int64)
    for b in batches:
        res, counts = pl.classify_batch(
            dev, jnp.asarray(b.codes), jnp.asarray(b.lengths), params, n_acc, count_mode
        )
        statuses[b.idx] = np.asarray(res.status)
        accs[b.idx] = np.asarray(res.acc_id)
        total_counts += np.asarray(counts)
    return statuses, accs, total_counts


def test_perfect_reads_all_assigned(small_index):
    built, seqs = small_index
    rng = np.random.default_rng(8)
    reads, labels = sample_reads(rng, seqs, 40, read_len=800, error=(0, 0, 0))
    statuses, accs, counts = _classify(built, reads)
    assert (statuses == pl.MAPPED).mean() > 0.95
    ok = statuses == pl.MAPPED
    assert (accs[ok] == np.asarray(labels)[ok]).all()
    assert counts.sum() == ok.sum()


def test_noisy_reads_high_accuracy(small_index):
    built, seqs = small_index
    rng = np.random.default_rng(9)
    # nanopore-like 10% error
    reads, labels = sample_reads(rng, seqs, 60, read_len=1500, error=(0.04, 0.03, 0.03))
    statuses, accs, _ = _classify(built, reads)
    mapped = statuses == pl.MAPPED
    assert mapped.mean() > 0.9, f"only {mapped.mean():.0%} mapped"
    acc = (accs[mapped] == np.asarray(labels)[mapped]).mean()
    assert acc > 0.98, f"accuracy {acc:.0%}"


def test_random_reads_unmapped(small_index):
    built, _ = small_index
    rng = np.random.default_rng(10)
    reads = [random_genome(rng, 900) for _ in range(20)]
    statuses, accs, counts = _classify(built, reads)
    assert (statuses == pl.UNMAPPED).mean() > 0.9
    assert counts.sum() <= 2


def test_count_modes(small_index):
    built, seqs = small_index
    rng = np.random.default_rng(11)
    reads, labels = sample_reads(rng, seqs, 20, read_len=700, error=(0.02, 0.01, 0.01))
    s_basic, _, c_basic = _classify(built, reads, count_mode=pl.MODE_BASIC)
    _, _, c_qlen = _classify(built, reads, count_mode=pl.MODE_QUERY_LENGTH)
    _, _, c_match = _classify(built, reads, count_mode=pl.MODE_MATCHING)
    n_mapped = (s_basic == pl.MAPPED).sum()
    assert c_basic.sum() == n_mapped
    # query_length sums read lengths: bounded by n*max_len, >> basic
    assert c_qlen.sum() > c_basic.sum() * 500
    # matching <= query_length per read
    assert c_match.sum() <= c_qlen.sum()
    assert c_match.sum() > 0


def test_identical_genomes_tie_to_ambiguous():
    """Two accessions with the same sequence: every read hits both with
    equal strength -> AMBIGUOUS, never an arbitrary MAPPED pick (the
    reference's best_hit exact-tie semantics, aligner.py:328-339)."""
    from monica_tpu.index.build import build_index_from_arrays
    from monica_tpu.io.encode import encode_seq

    rng = np.random.default_rng(21)
    g = random_genome(rng, 30_000)
    codes = encode_seq(g)
    built = build_index_from_arrays([codes, codes.copy()])
    dev, tb = pl.device_shard(built.shards[0])
    params = pl.ClassifyParams(tag_bits=tb)
    reads, _ = sample_reads(rng, [g], 20, read_len=800, error=(0.01, 0.01, 0.01))
    for b in bucketize_reads(reads):
        res, counts = pl.classify_batch(
            dev, jnp.asarray(b.codes), jnp.asarray(b.lengths),
            params, built.meta.n_accessions, pl.MODE_BASIC,
        )
        st = np.asarray(res.status)[np.asarray(b.idx) >= 0]
        assert (st == pl.AMBIGUOUS).mean() > 0.9, st
        assert int(np.asarray(counts).sum()) <= 2  # ambiguous never counted


def test_multi_shard_merge_matches_single(small_index):
    """Sharding the same genomes must not change assignments (the
    reference aligns every read against every chunk and merges —
    aligner.py:91-103; here the merge is merge_hits)."""
    built1, seqs = small_index
    rng = np.random.default_rng(12)
    reads, labels = sample_reads(rng, seqs, 30, read_len=1000, error=(0.03, 0.02, 0.02))

    # rebuild the same genome set in 2 shards
    import tempfile, os
    from tests.fixtures import make_fasta_gz as mk

    genomes = []
    with tempfile.TemporaryDirectory() as td:
        for i, g in enumerate(seqs):
            p = os.path.join(td, f"g{i}.fna.gz")
            mk(p, [(f"contig{i}", g)])
            genomes.append((p, [f"Species_{i}", f"ACC{i:03d}.1"]))
        built2 = build_index(genomes, n_shards=2)

        params = pl.ClassifyParams()
        batches = bucketize_reads(reads)
        statuses1, accs1, _ = _classify(built1, reads, params)

        import jax

        acc_of_shard = []  # global acc ids are preserved: builder keeps ids global
        n_acc = built2.meta.n_accessions
        statuses2 = np.zeros(len(reads), np.int32)
        accs2 = np.zeros(len(reads), np.int32)
        for b in batches:
            hits = []
            for sh in built2.shards:
                dev, tb = pl.device_shard(sh)
                hits.append(
                    pl.classify_shard(
                        dev, jnp.asarray(b.codes), jnp.asarray(b.lengths),
                        params._replace(tag_bits=tb),
                    )
                )
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *hits)
            res = pl.merge_hits(stacked)
            statuses2[b.idx] = np.asarray(res.status)
            accs2[b.idx] = np.asarray(res.acc_id)

    both_mapped = (statuses1 == pl.MAPPED) & (statuses2 == pl.MAPPED)
    assert both_mapped.mean() > 0.85
    assert (accs1[both_mapped] == accs2[both_mapped]).all()


def test_size_class_grouped_stacking(tmp_path):
    """Grouped stacking keeps HBM near the sum of shard sizes on a
    skewed split (one oversized genome next to many small ones) and is
    classification-equivalent to the flat stacked path (VERDICT r2
    item 6)."""
    rng = np.random.default_rng(61)
    genomes, seqs = [], []
    sizes = [400_000] + [40_000] * 8
    for i, n in enumerate(sizes):
        g = random_genome(rng, n)
        seqs.append(g)
        p = tmp_path / f"g{i}.fna.gz"
        make_fasta_gz(p, [(f"c{i}", g)])
        genomes.append((str(p), [f"Sp_{i}", f"A{i:03d}.1"]))
    built = build_index(genomes, n_shards=1, max_shard_bytes=50_000)
    assert len(built.shards) >= 5  # skewed multi-shard split

    groups, tb = pl.stack_device_shard_groups(built.shards)
    flat, tb2 = pl.stack_device_shards(built.shards)
    assert tb == tb2
    true_sum = sum(
        sum(np.asarray(a).nbytes for a in pl.device_shard(s)[0])
        for s in built.shards
    )
    grouped_bytes = pl.stacked_nbytes(groups)
    flat_bytes = pl.stacked_nbytes(flat)
    assert grouped_bytes <= 1.25 * true_sum, (grouped_bytes, true_sum)
    assert flat_bytes > 2 * grouped_bytes  # the waste being avoided

    reads, labels = sample_reads(rng, seqs, 24, read_len=800, error=(0.03, 0.02, 0.02))
    b = bucketize_reads(reads)[0]
    params = pl.ClassifyParams(tag_bits=tb)
    n_acc = built.meta.n_accessions
    rg, cg = pl.classify_batch_grouped(
        groups, jnp.asarray(b.codes), jnp.asarray(b.lengths), params, n_acc, pl.MODE_BASIC
    )
    rf, cf = pl.classify_batch_stacked(
        flat, jnp.asarray(b.codes), jnp.asarray(b.lengths), params, n_acc, pl.MODE_BASIC
    )
    assert np.array_equal(np.asarray(rg.status), np.asarray(rf.status))
    assert np.array_equal(np.asarray(rg.acc_id), np.asarray(rf.acc_id))
    assert np.array_equal(np.asarray(cg), np.asarray(cf))
    mapped = np.asarray(rg.status) == pl.MAPPED
    assert mapped.mean() > 0.8
    assert (np.asarray(rg.acc_id)[mapped] == np.asarray(labels)[b.idx][mapped]).all()


def test_cross_shard_identical_region_ties_with_extension(tmp_path):
    """Reads from a region present IDENTICALLY in two genomes that live
    in DIFFERENT shards must come out AMBIGUOUS with extension enabled
    — the per-shard rescue budget may refine one side's identity and
    not the other's, so the merge runs on the vote-statistical cost
    where identical copies tie exactly (VERDICT r2 weak #6)."""
    import jax

    rng = np.random.default_rng(71)
    shared = random_genome(rng, 8_000)
    genomes, seqs = [], []
    for i in range(2):
        g = shared + random_genome(rng, 40_000)
        seqs.append(g)
        p = tmp_path / f"g{i}.fna.gz"
        make_fasta_gz(p, [(f"c{i}", g)])
        genomes.append((str(p), [f"Tw_{i}", f"T{i:03d}.1"]))
    built = build_index(genomes, n_shards=2)
    assert len(built.shards) == 2

    # reads wholly inside the shared block, moderate noise
    reads, _ = sample_reads(rng, [shared], 24, read_len=1000, error=(0.04, 0.02, 0.02))
    b = bucketize_reads(reads)[0]

    for mode in ("rescue", "full"):
        params = pl.ClassifyParams(extend=True, extend_mode=mode)
        hits = []
        for sh in built.shards:
            dev, tb = pl.device_shard(sh)
            hits.append(
                pl.classify_shard(
                    dev, jnp.asarray(b.codes), jnp.asarray(b.lengths),
                    params._replace(tag_bits=tb),
                )
            )
        res = pl.merge_hits(jax.tree.map(lambda *xs: jnp.stack(xs), *hits))
        status = np.asarray(res.status)
        # no read may be silently assigned to one of the twins
        assert not (status == pl.MAPPED).any(), (mode, status)
        assert (status == pl.AMBIGUOUS).mean() > 0.8, (mode, status)


def test_giant_record_segmented_across_shards(monkeypatch):
    """A single record larger than the shard cap (host chromosomes) is
    segmented into units, packed across shards, and its reads still
    classify MAPPED to the one accession — same-accession cross-shard
    near-ties are agreement, not ambiguity."""
    import jax

    from monica_tpu.index import build as ib

    monkeypatch.setattr(ib, "SEG_LEN", 40_000)
    monkeypatch.setattr(ib, "SHARD_CAP", 120_000)

    rng = np.random.default_rng(81)
    big = rng.integers(0, 4, 150_000).astype(np.uint8)  # 4 segments
    small = rng.integers(0, 4, 30_000).astype(np.uint8)
    built = ib.build_index_from_arrays(
        [big, small], tax_units=["Big_one", "Small_one"],
        accessions=["BIG.1", "SML.1"], n_shards=1,
    )
    assert len(built.shards) >= 2  # cap forced a split
    with_big = sum(1 for sh in built.shards if (sh.seq_accession_id == 0).any())
    assert with_big >= 2  # accession 0 spans shards

    reads = []
    labels = []
    for start in (5_000, 45_000, 85_000, 125_000):  # one per segment
        reads.append("".join("ACGT"[c] for c in big[start : start + 800]))
        labels.append(0)
    reads.append("".join("ACGT"[c] for c in small[2_000 : 2_800]))
    labels.append(1)

    b = bucketize_reads(reads)[0]
    groups, tb = pl.stack_device_shard_groups(built.shards)
    res, counts = pl.classify_batch_grouped(
        groups, jnp.asarray(b.codes), jnp.asarray(b.lengths),
        pl.ClassifyParams(tag_bits=tb), built.meta.n_accessions, pl.MODE_BASIC,
    )
    status = np.asarray(res.status)[np.argsort(b.idx)]
    accs = np.asarray(res.acc_id)[np.argsort(b.idx)]
    assert (status == pl.MAPPED).all(), status
    assert (accs == np.asarray(labels)).all(), accs


def test_packed_wire_format_matches_raw():
    """2-bit packed transfer (pack_codes_2bit -> unpack_codes) is
    bit-exact for ACGT reads and classify_batch_packed == classify_batch
    (the wire format quarters host->device traffic)."""
    import numpy as np
    import jax.numpy as jnp
    from monica_tpu.io import encode as enc
    from monica_tpu.align import pipeline as pl
    from tests.fixtures import random_genome
    from monica_tpu.index.build import build_index_from_arrays

    rng = np.random.default_rng(21)
    for L in (7, 64, 1001):
        codes = rng.integers(0, 4, (3, L)).astype(np.uint8)
        codes[0, -1] = 4  # an N / PAD position -> 'A' on the wire
        packed = enc.pack_codes_2bit(codes)
        assert packed.shape == (3, -(-L // 4))
        back = np.asarray(pl.unpack_codes(jnp.asarray(packed), L))
        want = np.where(codes < 4, codes, 0)
        assert np.array_equal(back, want)

    seqs = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(3)]
    built = build_index_from_arrays(seqs, n_shards=1)
    dev, tb = pl.device_shard(built.shards[0])
    params = pl.ClassifyParams(tag_bits=tb)
    reads = np.stack([seqs[i % 3][200 : 200 + 512] for i in range(8)]).astype(np.uint8)
    lengths = np.full(8, 512, np.int32)
    res_raw, c_raw = pl.classify_batch(
        dev, jnp.asarray(reads), jnp.asarray(lengths), params,
        built.meta.n_accessions, pl.MODE_BASIC,
    )
    res_pk, c_pk = pl.classify_batch_packed(
        dev, jnp.asarray(enc.pack_codes_2bit(reads)), jnp.asarray(lengths),
        512, params, built.meta.n_accessions, pl.MODE_BASIC,
    )
    assert np.array_equal(np.asarray(res_raw.status), np.asarray(res_pk.status))
    assert np.array_equal(np.asarray(res_raw.acc_id), np.asarray(res_pk.acc_id))
    assert np.array_equal(np.asarray(c_raw), np.asarray(c_pk))

    arr = np.asarray(pl.pack_results(res_pk, c_pk))
    assert np.array_equal(arr[0], np.asarray(res_pk.status))
    assert np.array_equal(arr[1], np.asarray(res_pk.acc_id))
    assert np.array_equal(
        arr[3:].reshape(-1)[: built.meta.n_accessions], np.asarray(c_pk)
    )


def test_classifier_grouped_packed_dispatch(tmp_path):
    """The product Classifier on a skewed MULTI-GROUP index (no mesh):
    dispatches classify_batch_grouped_packed (2-bit wire) and matches
    the raw grouped pipeline exactly."""
    from monica_tpu.align import runtime as rt

    rng = np.random.default_rng(62)
    genomes, seqs = [], []
    for i, n in enumerate([400_000] + [40_000] * 4):
        g = random_genome(rng, n)
        seqs.append(g)
        p = tmp_path / f"g{i}.fna.gz"
        make_fasta_gz(p, [(f"c{i}", g)])
        genomes.append((str(p), [f"Sp_{i}", f"A{i:03d}.1"]))
    built = build_index(genomes, n_shards=1, max_shard_bytes=50_000)
    assert len(built.shards) >= 3

    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="basic")
    assert not isinstance(clf.index, pl.DeviceIndexShard)  # grouped
    assert len(clf.index) >= 2  # multiple size classes

    reads, labels = sample_reads(rng, seqs, 16, read_len=800, error=(0.03, 0.02, 0.02))
    b = bucketize_reads(reads)[0]
    res, counts = clf.classify(b.codes, b.lengths)

    raw, craw = pl.classify_batch_grouped(
        clf.index, jnp.asarray(b.codes), jnp.asarray(b.lengths),
        pl.params_for_bucket(clf.params, b.codes.shape[1]),
        built.meta.n_accessions, pl.MODE_BASIC,
    )
    assert np.array_equal(np.asarray(res.status), np.asarray(raw.status))
    assert np.array_equal(np.asarray(res.acc_id), np.asarray(raw.acc_id))
    assert np.array_equal(np.asarray(counts), np.asarray(craw))
    mapped = np.asarray(res.status) == pl.MAPPED
    assert mapped.mean() > 0.8
    assert (np.asarray(res.acc_id)[mapped] == np.asarray(labels)[b.idx][mapped]).all()
