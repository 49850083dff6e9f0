import numpy as np
import pytest

from monica_tpu.index.build import IndexMeta
from monica_tpu.stats import abundance as ab


def _meta():
    return IndexMeta(
        tax_units=["Escherichia_coli", "Escherichia_coli", "Bacillus_subtilis"],
        accessions=["AC1.1", "AC2.1", "AC3.1"],
        genome_lengths=np.array([5_000_000, 4_800_000, 4_200_000], dtype=np.int64),
    )


def golden_normalizer(alignment: dict, genomes_length: dict) -> dict:
    """Pure-python mirror of the reference normalizer semantics
    (`monica/genomes/aligner.py:305-319`): BPB = count/length,
    BPM = BPB / sample_total."""
    out = {}
    for sample, taxa in alignment.items():
        bpb = {
            tu: {acc: c / genomes_length[acc] for acc, c in counter.items()}
            for tu, counter in taxa.items()
        }
        total = sum(v for tu in bpb.values() for v in tu.values())
        out[sample] = {
            tu: {acc: v / total for acc, v in counter.items()}
            for tu, counter in bpb.items()
        }
    return out


def test_normalize_matches_reference_semantics():
    meta = _meta()
    state = ab.AbundanceState(3)
    state.update("s1", np.array([100, 0, 50]))
    state.update("s2", np.array([0, 30, 10]))

    got = ab.normalize(state, meta.genome_lengths)

    alignment = {
        "s1": {"Escherichia_coli": {"AC1.1": 100}, "Bacillus_subtilis": {"AC3.1": 50}},
        "s2": {"Escherichia_coli": {"AC2.1": 30}, "Bacillus_subtilis": {"AC3.1": 10}},
    }
    lengths = dict(zip(meta.accessions, meta.genome_lengths.tolist()))
    want = golden_normalizer(alignment, lengths)

    assert got["s1"][0] == pytest.approx(want["s1"]["Escherichia_coli"]["AC1.1"])
    assert got["s1"][2] == pytest.approx(want["s1"]["Bacillus_subtilis"]["AC3.1"])
    assert got["s2"][1] == pytest.approx(want["s2"]["Escherichia_coli"]["AC2.1"])
    # per-sample normalized sums are 1
    assert got["s1"].sum() == pytest.approx(1.0)
    assert got["s2"].sum() == pytest.approx(1.0)


def test_accumulator_is_monotone_and_persistent(tmp_path):
    state = ab.AbundanceState(3)
    state.update("s1", np.array([1, 2, 3]))
    state.update("s1", np.array([10, 0, 0]))  # second batch, same sample
    assert state.samples["s1"].tolist() == [11, 2, 3]
    state.save(tmp_path)
    again = ab.AbundanceState.load(tmp_path, 3)
    assert again.samples["s1"].tolist() == [11, 2, 3]
    ab.AbundanceState.clear(tmp_path)  # helpers.initializer analog
    fresh = ab.AbundanceState.load(tmp_path, 3)
    assert fresh.samples == {}


def test_dataframe_schema_roundtrip(tmp_path):
    """CSV schema parity: MultiIndex (tax_unit, accession) x samples,
    read back with index_col=(0,1) (monica.py:784-785)."""
    meta = _meta()
    state = ab.AbundanceState(3)
    state.update("sampleA", np.array([100, 0, 50]))
    state.update("sampleB", np.array([5, 30, 0]))
    norm, raw = ab.export_tables(state, meta, tmp_path)

    back = ab.read_dataframe(tmp_path / ab.DATAFRAME_FILENAME)
    assert back.samples == ["sampleA", "sampleB"]
    rows = list(zip(back.tax_units, back.accessions))
    assert rows == [("Escherichia_coli", "AC1.1"), ("Escherichia_coli", "AC2.1"),
                    ("Bacillus_subtilis", "AC3.1")]
    # absent pair is NaN, not 0 (sparse Counter semantics)
    assert np.isnan(back.values[2, 1])
    raw_back = ab.read_dataframe(tmp_path / ab.RAW_DATAFRAME_FILENAME)
    assert raw_back.values[0, 0] == 100
    # the written values read back bit for bit
    np.testing.assert_array_equal(back.values, norm.values)


def test_barplot_renders(tmp_path):
    from monica_tpu.plots import barplot as bp

    meta = _meta()
    state = ab.AbundanceState(3)
    state.update("s1", np.array([100, 20, 50]))
    state.update("s2", np.array([3, 30, 10]))
    norm, raw = ab.export_tables(state, meta, tmp_path)
    out = bp.plotter(norm, raw, tmp_path, reads_threshold=0, hosts=["Bacillus_subtilis"], guests=["Escherichia_coli"], mode="basic")
    text = out.read_text()
    assert "Escherichia_coli" in text
    assert "Bacillus_subtilis_(host)" in text
    assert "svg" in text


def test_barplot_low_reads_filter(tmp_path):
    from monica_tpu.plots import barplot as bp

    meta = _meta()
    state = ab.AbundanceState(3)
    state.update("s1", np.array([100, 0, 2]))  # taxon 3 raw <= 15 everywhere
    norm, raw = ab.export_tables(state, meta, tmp_path)
    out = bp.plotter(norm, raw, tmp_path, reads_threshold=15)
    text = out.read_text()
    assert "Bacillus_subtilis" not in text


def test_by_taxunit_sums_accessions():
    from monica_tpu.plots import barplot as bp

    df = ab.AbundanceTable(["E", "E", "B"], ["A1", "A2", "A3"], ["s"],
                           np.array([[0.1], [0.2], [np.nan]]))
    t = bp.by_taxunit(df)
    assert t.taxa == ["E", "B"]  # first-appearance order
    assert t.values[0, 0] == pytest.approx(0.3)
    assert t.values[1, 0] == pytest.approx(0.0)


def _pandas_frame(per_sample, meta, overnight=False):
    """The former pandas export (MultiIndex frame, NaN for absent pairs)."""
    pd = pytest.importorskip("pandas")
    samples = sorted(per_sample)
    mask = np.zeros(meta.n_accessions, bool)
    for s in samples:
        mask |= per_sample[s] != 0
    idx = np.nonzero(mask)[0]
    tax = [meta.tax_units[i].split("_")[0] if overnight else meta.tax_units[i] for i in idx]
    index = pd.MultiIndex.from_arrays([tax, [meta.accessions[i] for i in idx]],
                                      names=["tax_unit", "accession"])
    data = {}
    for s in samples:
        col = per_sample[s][idx].astype(np.float64)
        data[s] = np.where(col != 0, col, np.nan)
    return pd.DataFrame(data, index=index)


def pandas_csvs(state, meta, overnight=False):
    """(monica.dataframe, raw_monica.dataframe) text as pandas wrote them."""
    raw = _pandas_frame({s: c.astype(np.float64) for s, c in state.samples.items()}, meta, overnight)
    norm = _pandas_frame(ab.normalize(state, meta.genome_lengths), meta, overnight)
    return norm.to_csv(), raw.to_csv()


@pytest.mark.parametrize("overnight", [False, True])
def test_tables_byte_identical_to_pandas(tmp_path, overnight):
    """The numpy CSV writer reproduces pandas' to_csv byte for byte:
    shortest round-trip floats, empty NaN cells, quoting, sample order."""
    rng = np.random.default_rng(7)
    n = 30
    meta = IndexMeta(
        tax_units=[f"G{i % 7}_sp{i % 3}" + (",x" if i == 4 else "") for i in range(n)],
        accessions=[f"AC{i}.1" for i in range(n)],
        genome_lengths=rng.integers(10**5, 10**7, n),
    )
    state = ab.AbundanceState(n)
    for s in ("zeta", "alpha", "mid sample"):
        state.update(s, rng.integers(0, 5000, n) * (rng.random(n) < 0.6))
    ab.export_tables(state, meta, tmp_path, overnight=overnight)
    want_norm, want_raw = pandas_csvs(state, meta, overnight)
    assert (tmp_path / ab.DATAFRAME_FILENAME).read_text() == want_norm
    assert (tmp_path / ab.RAW_DATAFRAME_FILENAME).read_text() == want_raw


def test_barplot_sums_and_ranking_match_pandas():
    """by_taxunit equals pandas' groupby(level=0, sort=False).sum() bit
    for bit, and the taxon ranking and "Other" fold equal pandas'
    sort_values / sum — so the HTML carries the same numbers."""
    pd = pytest.importorskip("pandas")
    from monica_tpu.plots import barplot as bp

    rng = np.random.default_rng(3)
    for trial in range(20):
        n = int(rng.integers(2, 40))
        tu = [f"T{int(k)}" for k in rng.integers(0, 15, n)]
        vals = rng.random((n, 3)) * (rng.random((n, 3)) < 0.7)
        if trial % 4 == 0:
            vals = np.round(vals, 1)  # ties in the ranking
        vals[vals == 0] = np.nan
        table = ab.AbundanceTable(tu, [f"A{i}" for i in range(n)], ["s1", "s2", "s3"], vals)
        got = bp.by_taxunit(table)
        want = table.to_pandas().fillna(0).groupby(level=0, sort=False).sum()
        assert got.taxa == list(want.index)
        np.testing.assert_array_equal(got.values, want.to_numpy())
        order = [got.taxa[i] for i in bp._rank_descending(got.values.max(axis=1))]
        assert order == want.max(axis=1).sort_values(ascending=False).index.tolist()
        rest = order[8:]
        if rest:
            ranked = bp._rank_descending(got.values.max(axis=1))
            np.testing.assert_array_equal(
                got.values[ranked[8:]].T.sum(axis=1), want.loc[rest].sum(axis=0).to_numpy()
            )
