"""Streaming runtime: routing, accumulation, consume-and-delete,
sentinels — the `multi_threaded_aligner` behavioral contract."""

import numpy as np
import pytest

from monica_tpu.align import pipeline as pl
from monica_tpu.align import runtime as rt
from monica_tpu.index.build import build_index
from monica_tpu.io import seq as seqio
from monica_tpu.stats.abundance import AbundanceState, export_tables
from tests.fixtures import make_fasta_gz, make_fastq, random_genome, sample_reads


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("genomes")
    genomes, seqs = [], []
    for i in range(3):
        g = random_genome(rng, 30_000)
        seqs.append(g)
        p = tmp / f"g{i}.fna.gz"
        make_fasta_gz(p, [(f"c{i}", g)])
        genomes.append((str(p), [f"Species_{i}", f"ACC{i:03d}.1"]))
    built = build_index(genomes, n_shards=2)
    clf = rt.Classifier(built, pl.ClassifyParams(n_slots=64), count_mode="basic")
    clf.built = built  # handed to tests that construct mesh variants
    return clf, seqs


def test_run_once_routes_counts_and_deletes(classifier, tmp_path):
    clf, seqs = classifier
    rng = np.random.default_rng(22)
    q = tmp_path / "query"
    out = tmp_path / "out"
    q.mkdir()
    reads, labels = sample_reads(rng, seqs, 30, read_len=600, error=(0.03, 0.01, 0.01))
    make_fastq(q / "s1.fastq", reads)
    # random junk reads -> unmapped
    junk = [random_genome(rng, 500) for _ in range(5)]
    make_fastq(q / "s2.fastq", junk)

    reports = rt.run_once(
        clf, q, out, focus_taxa=frozenset({"Species_0"}), delete=True
    )
    by = {r.sample: r for r in reports}
    assert by["s1"].n_reads == 30 and by["s1"].n_mapped >= 25
    assert by["s2"].n_unmapped >= 4

    # consumed inputs deleted, routed files exist, sentinel written
    assert not (q / "s1.fastq").exists() and not (q / "s2.fastq").exists()
    assert (q / rt.S_GOING_TO_ALIGN).exists()
    mapped = list(seqio.read_fastq(q / "mapped" / "s1.fastq"))
    assert len(mapped) == by["s1"].n_mapped
    # read ids rewritten to tax units
    assert all(r.id.startswith("Species_") for r in mapped)
    # focus copy holds only Species_0 reads with ORIGINAL ids
    focus = list(seqio.read_fastq(q / "focus" / "s1.fastq"))
    assert len(focus) == by["s1"].n_focus > 0
    assert all(r.id.startswith("read") for r in focus)

    # accumulator persisted; counts equal mapped reads (basic mode)
    state = AbundanceState.load(out, clf.meta.n_accessions)
    assert state.samples["s1"].sum() == by["s1"].n_mapped

    # second invocation with new data accumulates monotonically
    make_fastq(q / "s1.fastq", reads[:10])
    rt.run_once(clf, q, out, delete=True)
    state2 = AbundanceState.load(out, clf.meta.n_accessions)
    assert state2.samples["s1"].sum() >= state.samples["s1"].sum()

    # tables export round-trips the MultiIndex schema
    norm, raw = export_tables(state2, clf.meta, out)
    assert (out / "monica.dataframe").exists()
    header = (out / "raw_monica.dataframe").read_text().splitlines()[0]
    assert header == ",".join(["tax_unit", "accession", *raw.samples])
    assert "s1" in raw.samples and set(raw.tax_units) <= set(clf.meta.tax_units)


def test_classifier_mesh_matches_single_device(classifier, tmp_path):
    """The product-path multi-chip branch: Classifier(mesh=...) through
    process_sample/run_once must produce bit-identical routing, counts
    and accumulator state to the single-device stacked path."""
    from monica_tpu.parallel import mesh as pm

    clf, seqs = classifier
    mesh = pm.make_mesh(n_data=4, n_index=2)
    mclf = rt.Classifier(
        clf.built, pl.ClassifyParams(n_slots=64), count_mode="basic", mesh=mesh,
    )
    assert mclf.batch_row_multiple() == 4

    rng = np.random.default_rng(23)
    reads, labels = sample_reads(rng, seqs, 30, read_len=600, error=(0.03, 0.01, 0.01))
    outs = {}
    for name, c in [("single", clf), ("mesh", mclf)]:
        q = tmp_path / f"q_{name}"
        out = tmp_path / f"o_{name}"
        q.mkdir()
        make_fastq(q / "s1.fastq", reads)
        reports = rt.run_once(c, q, out, focus_taxa=frozenset({"Species_0"}))
        state = AbundanceState.load(out, c.meta.n_accessions)
        outs[name] = (reports[0], state.samples["s1"].copy(),
                      (q / "mapped" / "s1.fastq").read_bytes())
    r_s, counts_s, mapped_s = outs["single"]
    r_m, counts_m, mapped_m = outs["mesh"]
    assert r_s.n_mapped == r_m.n_mapped >= 25
    assert (r_s.n_unmapped, r_s.n_ambiguous, r_s.n_focus) == (
        r_m.n_unmapped, r_m.n_ambiguous, r_m.n_focus)
    assert np.array_equal(counts_s, counts_m)
    assert mapped_s == mapped_m


def test_watch_stops_after_idle(classifier, tmp_path):
    clf, seqs = classifier
    q = tmp_path / "query"
    out = tmp_path / "out"
    q.mkdir()
    reports = rt.watch(clf, q, out, poll_s=0.01, max_idle_polls=2)
    assert reports == []


def test_ultra_long_read_chunk_and_merge(tmp_path):
    """A 200 kb read (>> the 32 kb max bucket) is split into windows,
    classified per window, and merged back to ONE correct whole-read
    assignment with whole-read count semantics; a chimera whose windows
    map to different genomes is AMBIGUOUS (VERDICT r2 item 5)."""
    from monica_tpu.io import encode as enc

    rng = np.random.default_rng(25)
    tmp = tmp_path / "genomes"
    tmp.mkdir()
    genomes, seqs = [], []
    for i in range(2):
        g = random_genome(rng, 220_000)
        seqs.append(g)
        p = tmp / f"g{i}.fna.gz"
        make_fasta_gz(p, [(f"c{i}", g)])
        genomes.append((str(p), [f"Long_{i}", f"LACC{i:03d}.1"]))
    built = build_index(genomes, n_shards=1)
    clf = rt.Classifier(built, pl.ClassifyParams(n_slots=64), count_mode="query_length")

    long_read = seqs[0][5_000:205_000]  # 200 kb, genome 0
    chimera = seqs[0][:40_000] + seqs[1][:40_000]  # half-and-half
    short = seqs[1][1_000:2_000]

    # window planning: 200 kb -> ceil(200k/32768)=7 windows, shared idx
    plan = enc.window_plan([len(long_read)])
    rows = [r for _, batch in plan for r in batch]
    assert len(rows) == 7 and all(i == 0 for i, _, _ in rows)

    q = tmp_path / "query"
    out = tmp_path / "out"
    q.mkdir()
    make_fastq(q / "s.fastq", [long_read, chimera, short])
    reports = rt.run_once(clf, q, out)
    rep = reports[0]
    assert rep.n_reads == 3
    assert rep.n_mapped == 2  # long read + short read
    assert rep.n_ambiguous == 1  # chimera

    # the merged long read counts ONCE with its full length
    state = AbundanceState.load(out, clf.meta.n_accessions)
    counts = state.samples["s"]
    assert counts[0] == len(long_read)  # accession 0
    assert counts[1] == len(short)
    # routed outputs: one mapped record is the full-length read
    mapped = list(seqio.read_fastq(q / "mapped" / "s.fastq"))
    assert sorted(len(r.seq) for r in mapped) == [1_000, 200_000]
    assert all(r.id.startswith("Long_") for r in mapped)
    amb = list(seqio.read_fastq(q / "ambiguous" / "s.fastq"))
    assert len(amb) == 1 and len(amb[0].seq) == 80_000


def test_malformed_sample_is_quarantined(classifier, tmp_path):
    """A garbage .fastq must not stop the run: it is moved to failed/
    and the remaining samples still classify (VERDICT r2 item 10)."""
    clf, seqs = classifier
    rng = np.random.default_rng(24)
    q = tmp_path / "query"
    out = tmp_path / "out"
    q.mkdir()
    (q / "bad.fastq").write_text("this is not\na fastq file\n>>>\n")
    reads, _ = sample_reads(rng, seqs, 10, read_len=600, error=(0.02, 0.01, 0.01))
    make_fastq(q / "good.fastq", reads)

    reports = rt.watch(clf, q, out, poll_s=0.01, max_idle_polls=1)
    by = {r.sample: r for r in reports}
    assert "good" in by and by["good"].n_mapped > 0
    assert "bad" not in by
    assert (q / rt.FAILED_DIR / "bad.fastq").exists()
    assert not (q / "bad.fastq").exists()


def test_pipelined_run_once_matches_serial(classifier, tmp_path):
    """run_once's cross-sample 3-stage pipeline (VERDICT r3 item 4)
    must be bit-identical to serial process_sample calls: same routed
    files, same accumulator, every input consumed."""
    clf, seqs = classifier
    rng = np.random.default_rng(29)
    all_reads = {}
    for k in range(4):
        reads, _ = sample_reads(rng, seqs, 15 + 3 * k, read_len=600,
                                error=(0.03, 0.01, 0.01))
        all_reads[f"fc{k}"] = reads

    outs = {}
    for mode in ("serial", "pipelined"):
        q = tmp_path / f"q_{mode}"
        out = tmp_path / f"o_{mode}"
        q.mkdir()
        for name, reads in all_reads.items():
            make_fastq(q / f"{name}.fastq", reads)
        if mode == "pipelined":
            reports = rt.run_once(clf, q, out)  # >1 sample -> pipelined
        else:
            folders = rt.RouteFolders.create(q, with_focus=False)
            state = AbundanceState.load(out, clf.meta.n_accessions)
            out.mkdir(parents=True, exist_ok=True)
            reports = [
                rt.process_sample(clf, p, folders, state)
                for p in sorted(q.glob("*.fastq"))
            ]
            state.save(out)
        assert not list(q.glob("*.fastq"))  # all consumed
        state = AbundanceState.load(out, clf.meta.n_accessions)
        routed = {
            p.relative_to(q).as_posix(): p.read_bytes()
            for sub in ("mapped", "unmapped", "ambiguous")
            for p in sorted((q / sub).glob("*.fastq"))
        }
        outs[mode] = (
            {r.sample: (r.n_mapped, r.n_unmapped, r.n_ambiguous) for r in reports},
            {k: v.copy() for k, v in state.samples.items()},
            routed,
        )
    rep_s, st_s, rt_s = outs["serial"]
    rep_p, st_p, rt_p = outs["pipelined"]
    assert rep_s == rep_p
    assert set(st_s) == set(st_p)
    for k in st_s:
        assert np.array_equal(st_s[k], st_p[k]), k
    assert rt_s == rt_p


def test_combined_fetch_roundtrips_per_batch_fetch(classifier):
    """The whole-sample combined transfer (dispatch_pack ->
    combine_packed -> split_combined) must reproduce the per-batch
    fetch exactly (r5 streaming redesign)."""
    from monica_tpu.io.encode import encode_seq

    clf, seqs = classifier
    genomes = [encode_seq(g) for g in seqs]
    rng = np.random.default_rng(33)
    handles, golden = [], []
    for blen in (256, 256, 512):
        B = 32
        codes = np.full((B, blen), 4, np.uint8)
        lens = np.zeros(B, np.int32)
        for i in range(B):
            g = genomes[int(rng.integers(0, len(genomes)))]
            s = int(rng.integers(0, len(g) - blen))
            L = int(rng.integers(blen // 2, blen))
            codes[i, :L] = g[s : s + L]
            lens[i] = L
        res, counts = clf.classify(codes, lens)
        golden.append(clf.fetch(res, counts))
        handles.append(clf.dispatch_pack(*clf.classify(codes, lens)))
    combined = clf.combine_packed(handles)
    assert combined is not None
    split = clf.split_combined(combined, handles)
    assert len(split) == len(golden)
    for got, want in zip(split, golden):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # degenerate cases: single batch -> no combine; tuples pass through
    assert clf.combine_packed(handles[:1]) is None
    assert clf.combine_packed([(1, 2), handles[0]]) is None
