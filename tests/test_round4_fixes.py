"""Regression tests for the round-4 fixes (VERDICT r3 items 5-7 and
ADVICE r3 findings): repeat-policy reconciliation, chain vote cap,
non-power-of-two compaction widths, artifact re-save hygiene, barplot
palette/auto_open parity, plot_only raw-table warning, empty-genome
errors, and matching-mode alignment mlen.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from monica_tpu.align import pipeline as pl
from monica_tpu.index.build import (
    OCC_CAP,
    build_index_from_arrays,
)
from monica_tpu.ops.lookup import ROW_SLOTS
from tests.fixtures import make_fastq, random_genome, sample_reads


def test_occ_cap_equals_row_slots_and_runs_fit_rows():
    """The per-seed occurrence budget (ADVICE r3 / VERDICT weak #2):
    OCC_CAP == ROW_SLOTS, so every hash run KEPT in the table fits its
    hash row in full — build_hash_rows never silently truncates a kept
    run — and a minimizer repeated more than ROW_SLOTS times is dropped
    wholesale (the repetitive-seed cut)."""
    assert OCC_CAP == ROW_SLOTS

    rng = np.random.default_rng(40)
    # a 500 bp unit tandem-repeated 12x inside a random genome: its
    # minimizers occur ~12 times each
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    genome = np.concatenate(
        [rng.integers(0, 4, 20_000).astype(np.uint8)]
        + [unit] * 12
        + [rng.integers(0, 4, 20_000).astype(np.uint8)]
    )

    def max_run(shard):
        if not len(shard.mz_hash):
            return 0
        h = shard.mz_hash  # sorted ascending by construction
        starts = np.flatnonzero(np.concatenate([[True], h[1:] != h[:-1]]))
        return int(np.diff(np.concatenate([starts, [len(h)]])).max())

    built = build_index_from_arrays([genome])  # default occ policy
    assert max_run(built.shards[0]) <= OCC_CAP

    unfiltered = build_index_from_arrays([genome], occ_cap=0)
    assert max_run(unfiltered.shards[0]) > ROW_SLOTS, (
        "fixture failed to produce a hyper-repeated minimizer"
    )


def test_chain_vote_cap_follows_slot_budget():
    """A clean ~500 bp read in the 512-bucket (n_slots=128) can stack
    >64 co-diagonal votes; the cap must not saturate them (ADVICE r3:
    saturation biased statistical identity/mlen low)."""
    from monica_tpu.ops.chain import chain_votes
    from monica_tpu.ops.lookup import INVALID_KEY

    A = 128
    key = np.full((1, A), INVALID_KEY, np.int32)
    key[0, :90] = 7  # 90 anchors at one diagonal bin
    diag = np.full((1, A), 7 << 8, np.int32)
    rp = np.arange(A, dtype=np.int32)[None]
    fp = rp + (7 << 8)
    res = chain_votes(
        jnp.asarray(key), jnp.asarray(diag), jnp.asarray(rp), jnp.asarray(fp),
        max_run=128,
    )
    assert int(res.f1[0]) == 90
    capped = chain_votes(
        jnp.asarray(key), jnp.asarray(diag), jnp.asarray(rp), jnp.asarray(fp),
        max_run=64,
    )
    assert int(capped.f1[0]) == 64  # what the old default would report


def test_lookup_compaction_non_power_of_two_width():
    """Hash-row compaction takes any seed-slot count (n_slots=96 -> a
    768-wide row of 8-slot groups once raised at trace time)."""
    from monica_tpu.ops.lookup import compact_rows

    rng = np.random.default_rng(41)
    x = rng.integers(0, 2**32, (3, 96, 8), dtype=np.uint64).astype(np.uint32)
    x[rng.random(x.shape) < 0.5] = 0
    got = np.asarray(compact_rows(jnp.asarray(x), 2))
    ref = np.sort(x, axis=-1)[..., ::-1][..., :2]
    assert np.array_equal(got, ref)


def test_artifact_resave_removes_stale_shards(tmp_path):
    """Re-saving a narrower index into an existing folder must not
    leave the previous save's shard files behind (ADVICE r3)."""
    from monica_tpu.index import artifact

    rng = np.random.default_rng(42)
    seqs = [rng.integers(0, 4, 5000).astype(np.uint8) for _ in range(4)]
    wide = build_index_from_arrays(seqs, n_shards=3)
    assert len(wide.shards) == 3
    folder = tmp_path / "idx"
    artifact.save_index(wide, folder)
    narrow = build_index_from_arrays(seqs, n_shards=1)
    artifact.save_index(narrow, folder)
    leftovers = [p.name for p in folder.glob("shard*") if "shard0." not in p.name]
    assert leftovers == [], leftovers
    loaded = artifact.load_index(folder)
    assert len(loaded.shards) == 1


def test_barplot_palette_and_auto_open(tmp_path, monkeypatch):
    """`palette` maps onto a matplotlib cmap and `auto_open` opens the
    file (reference barplot.py:43-53,118; VERDICT r3 missing #5)."""
    from monica_tpu.plots import barplot
    from monica_tpu.stats.abundance import AbundanceTable

    df = AbundanceTable(["A", "B"], ["a1", "b1"], ["s1"], np.array([[0.6], [0.4]]))

    opened = []
    monkeypatch.setattr(
        "webbrowser.open", lambda url, **kw: opened.append(url) or True
    )
    out_default = barplot.plotter(df, df, tmp_path / "d", reads_threshold=0)
    out_jet = barplot.plotter(
        df, df, tmp_path / "j", palette="jet", reads_threshold=0, auto_open=True
    )
    assert opened and opened[0].startswith("file://")
    html_default = out_default.read_text()
    html_jet = out_jet.read_text()
    assert html_default != html_jet  # jet colors actually applied
    assert "#2a78d6" in html_default and "#2a78d6" not in html_jet

    # unknown palettes fall back to the validated default
    out_unknown = barplot.plotter(
        df, df, tmp_path / "u", palette="no_such_cmap", reads_threshold=0
    )
    assert "#2a78d6" in out_unknown.read_text()


def test_plot_only_warns_on_missing_raw_dataframe(tmp_path, capsys):
    """plot_only silently substituting the normalized table as raw
    changes -R semantics; it must warn (VERDICT r3 weak #7)."""
    from monica_tpu import cli
    from monica_tpu.stats.abundance import AbundanceTable

    norm = tmp_path / "monica.dataframe"
    AbundanceTable(["A"], ["a1"], ["s1"], np.array([[0.9]])).to_csv(norm)
    rc = cli.main(["plot_only", "-d", str(norm), "--root", str(tmp_path / "root")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "raw_monica.dataframe" in err and "NORMALIZED" in err


def test_empty_genome_set_raises_cleanly():
    """Library-level builds fail with a clear error, not a bare max()
    crash (VERDICT r3 weak #6)."""
    from monica_tpu.index.build import build_index

    with pytest.raises(ValueError, match="empty genome set"):
        build_index_from_arrays([])
    with pytest.raises(ValueError, match="empty genome set"):
        build_index([])
    with pytest.raises(ValueError, match="empty shard list"):
        pl.stack_device_shard_groups([])


def test_matching_mode_uses_alignment_mlen(tmp_path):
    """-a matching must count alignment mlen like the reference
    (`aligner.py:195,258-260`), not the statistical estimate: the
    Classifier switches rescue -> full extension, and under noise the
    matching counts land strictly below query_length counts while
    staying above half of them (VERDICT r3 missing #4)."""
    from monica_tpu.align import runtime as rt
    from monica_tpu.io.encode import encode_seq

    rng = np.random.default_rng(43)
    genomes = [random_genome(rng, 30_000) for _ in range(2)]
    built = build_index_from_arrays([encode_seq(g) for g in genomes])

    clf_match = rt.Classifier(built, count_mode="matching")
    assert clf_match.params.extend_mode == "full"
    clf_qlen = rt.Classifier(built, count_mode="query_length")
    assert clf_qlen.params.extend_mode == "rescue"  # default untouched

    reads, _ = sample_reads(
        rng, genomes, 24, read_len=900, error=(0.05, 0.03, 0.03)
    )
    qdir_m = tmp_path / "qm"
    qdir_q = tmp_path / "qq"
    for qdir in (qdir_m, qdir_q):
        qdir.mkdir()
        make_fastq(qdir / "s.fastq", reads)
    rep_m = rt.run_once(clf_match, qdir_m, tmp_path / "om")
    rep_q = rt.run_once(clf_qlen, qdir_q, tmp_path / "oq")
    assert rep_m[0].n_mapped > 0 and rep_q[0].n_mapped > 0

    from monica_tpu.stats.abundance import AbundanceState

    cm = AbundanceState.load(tmp_path / "om", built.meta.n_accessions)
    cq = AbundanceState.load(tmp_path / "oq", built.meta.n_accessions)
    total_m = sum(v.sum() for v in cm.samples.values())
    total_q = sum(v.sum() for v in cq.samples.values())
    # ~10% error: matching bases < query length, but well over half
    assert total_m < total_q
    assert total_m > total_q * 0.5


def test_n_containing_reads_packed_vs_raw_divergence_pinned():
    """ADVICE r3: the 2-bit wire maps interior N to 'A', so an
    N-spanning k-mer is a valid-looking seed on the packed path while
    the raw (mesh Classifier) path sees code 4 and invalidates it.
    This pins the accepted divergence: (a) at realistic N rates the
    CLASSIFICATION (status + accession) of N-bearing reads agrees
    between paths; (b) the documented mechanism is real — the packed
    path keeps at least as many valid sketch slots as the raw path."""
    import jax.numpy as jnp

    from monica_tpu.align import pipeline as pl
    from monica_tpu.io import encode as enc

    rng = np.random.default_rng(44)
    seqs = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(3)]
    built = build_index_from_arrays(seqs)
    dev, tb = pl.device_shard(built.shards[0])
    params = pl.ClassifyParams(tag_bits=tb)

    # reads with ~1% interior N (far above real nanopore N output)
    reads = np.stack(
        [seqs[i % 3][300 : 300 + 512].copy() for i in range(16)]
    ).astype(np.uint8)
    n_pos = rng.random(reads.shape) < 0.01
    reads[n_pos] = enc.N_CODE
    lengths = np.full(16, 512, np.int32)

    res_raw, _ = pl.classify_batch(
        dev, jnp.asarray(reads), jnp.asarray(lengths), params,
        built.meta.n_accessions, pl.MODE_BASIC,
    )
    res_pk, _ = pl.classify_batch_packed(
        dev, jnp.asarray(enc.pack_codes_2bit(reads)), jnp.asarray(lengths),
        512, params, built.meta.n_accessions, pl.MODE_BASIC,
    )
    assert np.array_equal(np.asarray(res_raw.status), np.asarray(res_pk.status))
    assert np.array_equal(np.asarray(res_raw.acc_id), np.asarray(res_pk.acc_id))

    # mechanism check: N->A creates (false-but-plausible) seeds, so the
    # packed sketch can only have >= the raw path's valid slots
    unpacked = pl.unpack_codes(jnp.asarray(enc.pack_codes_2bit(reads)), 512)
    _, _, _, qv_pk = pl.sketch_batch(unpacked, jnp.asarray(lengths), params)
    _, _, _, qv_raw = pl.sketch_batch(
        jnp.asarray(reads), jnp.asarray(lengths), params
    )
    assert int(qv_pk.sum()) >= int(qv_raw.sum())
    assert int(qv_raw.sum()) > 0
