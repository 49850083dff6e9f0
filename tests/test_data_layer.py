"""Data layer: tables cache, taxonomy queries, 4 selection modes,
genome fetch/cache/eviction — all hermetic (fixture transport)."""

import gzip
import time

import pytest

from monica_tpu.data import fetcher as fx
from monica_tpu.data import tables as tb
from monica_tpu.data.taxonomy import Taxonomy, descendants_taxid_finder


@pytest.fixture()
def taxonomy():
    # 1 root -> 2 Bacteria -> 10 Escherichia -> 11 E. coli -> 111/112 strains
    #                      -> 20 Salmonella  -> 21 S. enterica
    #        -> 10239 Viruses -> 30 Coolvirus
    edges = [
        (2, 1), (10, 2), (11, 10), (111, 11), (112, 11),
        (20, 2), (21, 20), (10239, 1), (30, 10239),
    ]
    names = {
        1: "root", 2: "Bacteria", 10: "Escherichia",
        11: "Escherichia coli", 111: "Escherichia coli K12",
        112: "Escherichia coli O157", 20: "Salmonella",
        21: "Salmonella enterica", 10239: "Viruses", 30: "Coolvirus X",
    }
    return Taxonomy.from_edges(edges, names)


def _summary_rows():
    def row(acc, taxid, sp_taxid, org, strain="na"):
        return {
            "# assembly_accession": acc,
            "taxid": taxid,
            "species_taxid": sp_taxid,
            "organism_name": org,
            "infraspecific_name": strain,
            "ftp_path": f"https://x/genomes/{acc}_sub",
        }

    return [
        row("GCF_000000001.1", "111", "11", "Escherichia coli K12", "strain=K12"),
        row("GCF_000000002.1", "112", "11", "Escherichia coli O157", "strain=O157"),
        row("GCF_000000003.1", "21", "21", "Salmonella enterica"),
        row("GCF_000000004.1", "30", "30", "Coolvirus X"),
    ]


@pytest.fixture()
def tables_dir(tmp_path):
    fixture = tmp_path / "summary.tsv"
    tb.write_fixture_summary(fixture, _summary_rows())
    dl = tb.fixture_downloader(
        {tb.REFSEQ_SUMMARY_URL: str(fixture), tb.GENBANK_SUMMARY_URL: str(fixture)}
    )
    return tmp_path / "tables", dl


def test_taxonomy_queries(taxonomy):
    assert taxonomy.name_to_taxids("escherichia COLI") == [11]
    assert sorted(taxonomy.descendants(10)) == [11, 111, 112]
    assert taxonomy.lineage(111) == [1, 2, 10, 11, 111]
    assert taxonomy.is_virus("Coolvirus X")
    assert not taxonomy.is_virus("Salmonella enterica")
    df = descendants_taxid_finder(taxonomy, ["Escherichia coli"])
    assert set(df["taxid"]) == {"11", "111", "112"}


def test_taxonomy_cache_roundtrip(taxonomy, tmp_path):
    taxonomy.save(tmp_path)
    t2 = Taxonomy.load(tmp_path)
    assert t2.lineage(111) == taxonomy.lineage(111)
    assert Taxonomy.cache_fresh(tmp_path)


def test_taxonomy_lifecycle_refresh_and_fallback(taxonomy, tmp_path):
    """Stale cache triggers a TAXDUMP_URL refresh through the injected
    transport; a failing transport falls back to the stale cache
    (reference 14-day refresh, fetcher.py:298-307)."""
    import os
    import tarfile

    from monica_tpu.data.taxonomy import TAXDUMP_URL

    cache = tmp_path / "taxcache"
    taxonomy.save(cache)
    # a fresh cache is returned untouched even with a transport present
    boom = lambda url, out: (_ for _ in ()).throw(RuntimeError("no network"))
    assert Taxonomy.ensure(cache, downloader=boom).names[11] == "Escherichia coli"

    # make the cache stale
    old = time.time() - 30 * 86400
    os.utime(cache / "taxonomy.npz", (old, old))
    assert not Taxonomy.cache_fresh(cache)

    # failing transport -> stale cache still served
    t = Taxonomy.ensure(cache, downloader=boom)
    assert t is not None and t.names[11] == "Escherichia coli"

    # working transport -> refreshed from the tarball payload
    dump = tmp_path / "dump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text("1\t|\t1\t|\tr\t|\n5\t|\t1\t|\tr\t|\n")
    (dump / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "5\t|\tNovus organismus\t|\t\t|\tscientific name\t|\n"
    )
    tarball = tmp_path / "taxdump.tar.gz"
    with tarfile.open(tarball, "w:gz") as tar:
        tar.add(dump / "nodes.dmp", arcname="nodes.dmp")
        tar.add(dump / "names.dmp", arcname="names.dmp")

    def dl(url, out):
        assert url == TAXDUMP_URL
        import shutil

        shutil.copyfile(tarball, out)

    t2 = Taxonomy.ensure(cache, downloader=dl)
    assert t2.names[5] == "Novus organismus"
    assert Taxonomy.cache_fresh(cache)  # refreshed cache persisted
    assert Taxonomy.load(cache).names[5] == "Novus organismus"


def test_tables_importer_and_ttl(tables_dir):
    tdir, dl = tables_dir
    df = tb.importer(tdir, "refseq", dl)
    assert all(list(r) == tb.COLUMNS for r in df)
    assert len(df) == 4
    assert df[2]["infraspecific_name"] == "na" and df[0]["taxid"] == "111"
    # cached: poisoned downloader must NOT be called while fresh
    def boom(url, out):
        raise AssertionError("fetched despite fresh cache")
    tb.importer(tdir, "refseq", boom)
    # expired cache triggers refetch
    with pytest.raises(AssertionError):
        tb.importer(tdir, "refseq", boom, ttl_days=0)


def test_selector_single_dedups_species_and_splits_viruses(taxonomy, tables_dir):
    tdir, dl = tables_dir
    sel = fx.ftp_selector("single", ["Escherichia coli", "Coolvirus X"], taxonomy, tdir, dl)
    names = {r["species_name"] for r in sel}
    # two E. coli strains collapse to one species-level entry; virus kept
    assert names == {"Escherichia_coli", "Coolvirus_X"}
    assert all(r["ftp_path"].endswith("_genomic.fna.gz") for r in sel)


def test_selector_all_keeps_everything(taxonomy, tables_dir):
    tdir, dl = tables_dir
    sel = fx.ftp_selector("all", ["Escherichia coli"], taxonomy, tdir, dl)
    assert len(sel) == 2  # both strains


def test_selector_focus_strain_names(taxonomy, tables_dir):
    tdir, dl = tables_dir
    sel = fx.ftp_selector("focus", ["Escherichia coli"], taxonomy, tdir, dl)
    assert len(sel) == 2
    assert {r["species_name"] for r in sel} == {
        "Escherichia_coli_K12", "Escherichia_coli_O157"
    }


def test_selector_requires_species(taxonomy, tables_dir):
    tdir, dl = tables_dir
    with pytest.raises(ValueError):
        fx.ftp_selector("single", [], taxonomy, tdir, dl)


def _genome_downloader(tmp_path):
    """Serves tiny gzipped FASTAs for any URL; counts calls."""
    calls = []

    def dl(url, out):
        calls.append(url)
        with gzip.open(out, "wt") as fh:
            fh.write(">ctg\nACGTACGTACGT\n")

    return dl, calls


def test_fetcher_cache_reuse_and_version_eviction(taxonomy, tables_dir, tmp_path):
    tdir, dl = tables_dir
    sel = fx.ftp_selector("single", ["Escherichia coli", "Salmonella enterica"], taxonomy, tdir, dl)
    gdl, calls = _genome_downloader(tmp_path)
    gdir = tmp_path / "genomes"

    genomes, updated = fx.fetcher(sel, gdir, downloader=gdl)
    assert updated and len(genomes) == 2 and len(calls) == 2
    assert all(p.endswith(".fna.gz") for p, _ in genomes)
    # header contract: (path, [species_name, accession_suffix])
    headers = {tuple(h) for _, h in genomes}
    assert ("Escherichia_coli", "000000002.1") in headers

    # second run: everything cached, no downloads, updated False
    genomes2, updated2 = fx.fetcher(sel, gdir, downloader=gdl)
    assert not updated2 and len(calls) == 2
    assert {g[0] for g in genomes2} == {g[0] for g in genomes}

    # version bump: new version downloaded, old evicted
    sel3 = [dict(r) for r in sel]
    for r in sel3:
        if r["# assembly_accession"] == "GCF_000000003.1":
            r["# assembly_accession"] = "GCF_000000003.2"
    genomes3, updated3 = fx.fetcher(sel3, gdir, downloader=gdl)
    assert updated3
    names = {p.rsplit("/", 1)[-1] for p, _ in genomes3}
    assert "Salmonella_enterica_000000003.2.fna.gz" in names
    leftover = {p.name for p in (gdir / "oldies").iterdir()}
    assert "Salmonella_enterica_000000003.1.fna.gz" not in leftover


def test_fetcher_retries_then_skips(taxonomy, tables_dir, tmp_path):
    tdir, dl = tables_dir
    sel = fx.ftp_selector("single", ["Salmonella enterica"], taxonomy, tdir, dl)
    attempts = []

    def flaky(url, out):
        attempts.append(url)
        raise OSError("transient")

    genomes, updated = fx.fetcher(
        sel, tmp_path / "g2", downloader=flaky, retries=2, backoff_s=0
    )
    assert genomes == [] and not updated
    assert len(attempts) == 3  # initial + 2 retries


def test_focus_fetcher_species_level_cache_names(taxonomy, tables_dir, tmp_path):
    tdir, dl = tables_dir
    sel = fx.ftp_selector("focus", ["Escherichia coli"], taxonomy, tdir, dl)
    gdl, _ = _genome_downloader(tmp_path)
    genomes, _ = fx.focus_fetcher(sel, tmp_path / "g3", downloader=gdl)
    files = {p.rsplit("/", 1)[-1] for p, _ in genomes}
    # cache filenames keyed species-level, headers keep strain names
    assert files == {
        "Escherichia_coli_000000001.1.fna.gz",
        "Escherichia_coli_000000002.1.fna.gz",
    }
    assert {h[0] for _, h in genomes} == {
        "Escherichia_coli_K12", "Escherichia_coli_O157"
    }


def test_selection_rows_follow_pandas_merge_and_dedup(tmp_path):
    """The row-dict selection reproduces the former pandas steps:
    read_csv(dtype=str) NA cells, inner merge in left order with right
    duplicates, and drop_duplicates(keep="last")."""
    pd = pytest.importorskip("pandas")
    rows = [
        {"# assembly_accession": f"GCF_{i:09d}.1", "taxid": str(t), "species_taxid": str(t),
         "organism_name": org, "infraspecific_name": strain, "ftp_path": f"https://x/{i}"}
        for i, (t, org, strain) in enumerate([
            (5, "Alpha beta", "strain=A"), (6, "Alpha beta", ""), (5, "Gamma sp. Z1", "NA"),
            (7, "Delta eps", "na"), (6, "Alpha beta", "strain=B"),
        ])
    ]
    path = tmp_path / "s.tsv"
    tb.write_fixture_summary(path, rows)
    dl = tb.fixture_downloader({tb.REFSEQ_SUMMARY_URL: str(path)})
    got = tb.importer(tmp_path / "t", "refseq", dl)
    want = pd.read_csv(path, header=tb.HEADER_LINE, dtype="str", sep="\t", usecols=tb.USE_COLS)
    want.columns = tb.COLUMNS
    assert [[None if pd.isna(v) else v for v in r] for r in want.itertuples(index=False)] == [
        [r[c] for c in tb.COLUMNS] for r in got
    ]
    keys = {"taxid": ["6", "5", "6"]}
    merged = fx._merge(got, keys)
    want_m = want.merge(pd.DataFrame(keys), on="taxid")
    assert [r["# assembly_accession"] for r in merged] == list(want_m["# assembly_accession"])
    dedup = fx._dedup_keep_last(merged, "organism_name")
    want_d = want_m.drop_duplicates(subset=["organism_name"], keep="last")
    assert [r["# assembly_accession"] for r in dedup] == list(want_d["# assembly_accession"])
