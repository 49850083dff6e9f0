"""CLI end-to-end, fully offline: initialize -> build_index ->
analysis run (guests + host + focus second pass) -> list_indexes ->
plot_only."""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest

from monica_tpu import cli
from monica_tpu.data import tables as tb
from tests.fixtures import make_fastq, random_genome, sample_reads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny offline NCBI: taxonomy dmp files, summary TSVs, genome
    files served over a fixture transport, plus query reads."""
    tmp = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(31)

    # taxonomy: root(1) -> Bacteria(2) -> {Aquickia(10)->A. prima(11),
    # Bcoolia(20)->B. secunda(21)}; host Hostus(30)->H. major(31)
    taxdump = tmp / "taxdump"
    taxdump.mkdir()
    nodes = [(1, 1), (2, 1), (10, 2), (11, 10), (20, 2), (21, 20), (30, 2), (31, 30)]
    names = {
        1: "root", 2: "Bacteria", 10: "Aquickia", 11: "Aquickia prima",
        20: "Bcoolia", 21: "Bcoolia secunda", 30: "Hostus", 31: "Hostus major",
    }
    (taxdump / "nodes.dmp").write_text(
        "".join(f"{c}\t|\t{p}\t|\trank\t|\n" for c, p in nodes)
    )
    (taxdump / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for t, n in names.items())
    )

    # genomes
    genomes = {}
    seqs = {}
    for tid, acc, org in [
        (11, "GCF_000000011.1", "Aquickia prima"),
        (21, "GCF_000000021.1", "Bcoolia secunda"),
        (31, "GCF_000000031.1", "Hostus major"),
    ]:
        g = random_genome(rng, 30_000)
        seqs[org] = g
        gdir = tmp / "genome_files"
        gdir.mkdir(exist_ok=True)
        path = gdir / f"{acc}_sub_genomic.fna.gz"
        with gzip.open(path, "wt") as fh:
            fh.write(f">chr\n{g}\n")
        genomes[f"https://x/g/{acc}_sub/{acc}_sub_genomic.fna.gz"] = str(path)

    # assembly summary
    rows = []
    for tid, acc, org in [
        (11, "GCF_000000011.1", "Aquickia prima"),
        (21, "GCF_000000021.1", "Bcoolia secunda"),
        (31, "GCF_000000031.1", "Hostus major"),
    ]:
        rows.append(
            {
                "# assembly_accession": acc,
                "taxid": str(tid),
                "species_taxid": str(tid),
                "organism_name": org,
                "infraspecific_name": "strain=S1",
                "ftp_path": f"https://x/g/{acc}_sub",
            }
        )
    summary = tmp / "summary.tsv"
    tb.write_fixture_summary(summary, rows)
    return tmp, taxdump, summary, tmp / "genome_files", seqs


def test_cli_full_analysis(world, tmp_path):
    tmp, taxdump, summary, genome_dir, seqs = world
    root = tmp_path / "root"
    q = tmp_path / "query"
    q.mkdir()
    rng = np.random.default_rng(32)
    reads, labels = sample_reads(
        rng, [seqs["Aquickia prima"], seqs["Bcoolia secunda"], seqs["Hostus major"]],
        36, read_len=700, error=(0.03, 0.01, 0.01),
    )
    make_fastq(q / "run1.fastq", reads)

    rc = cli.main(
        [
            "--root", str(root),
            "--taxdump", str(taxdump),
            "--offline_tables", str(summary), str(summary),
            "--offline_genomes", str(genome_dir),
            "-q", str(q),
            "-G", "Aquickia prima", "Bcoolia secunda",
            "-H", "Hostus_major",
            "-F", "Aquickia prima",
            "-m", "single",
            "--not_auto_open_plot",
        ]
    )
    assert rc == 0
    out = q / "monica_output"
    assert (out / "monica.dataframe").exists()
    assert (out / "raw_monica.dataframe").exists()
    assert (out / "monica.barplot.html").exists()
    assert (out / "metrics.json").exists()
    assert (q / "mapped" / "run1.fastq").exists()
    # focus second pass consumed its input and produced its own output
    # tree (the focus copy is processed-and-deleted like any sample)
    assert not (q / "focus" / "run1.fastq").exists()
    assert (q / "focus" / "mapped" / "run1.fastq").exists()
    assert (out / "focus" / "monica.dataframe").exists()
    # raw counts cover all three tax units
    from monica_tpu.stats.abundance import read_dataframe

    raw = read_dataframe(out / "raw_monica.dataframe")
    taxa = set(raw.tax_units)
    assert {"Aquickia_prima", "Bcoolia_secunda", "Hostus_major"} <= taxa
    # params dump exists (reference monica.params)
    assert (root / "monica.params").exists()


def test_cli_mesh_run_matches_single_device(world, tmp_path):
    """`--n_data 4 -n 2` classifies on a 4×2 mesh (8 CPU devices,
    conftest) with outputs identical to the default single-device run
    (VERDICT r2 item 1: multi-device execution from the product
    surface)."""
    tmp, taxdump, summary, genome_dir, seqs = world
    rng = np.random.default_rng(34)
    reads, _ = sample_reads(
        rng, [seqs["Aquickia prima"], seqs["Bcoolia secunda"]],
        24, read_len=700, error=(0.03, 0.01, 0.01),
    )
    raws = {}
    for name, extra in [("single", []), ("mesh", ["--n_data", "4"])]:
        root = tmp_path / f"root_{name}"
        q = tmp_path / f"q_{name}"
        q.mkdir()
        make_fastq(q / "run1.fastq", reads)
        rc = cli.main(
            [
                "--root", str(root),
                "--taxdump", str(taxdump),
                "--offline_tables", str(summary), str(summary),
                "--offline_genomes", str(genome_dir),
                "-q", str(q),
                "-G", "Aquickia prima", "Bcoolia secunda",
                "-n", "2",
                "--not_auto_open_plot",
                *extra,
            ]
        )
        assert rc == 0
        out = q / "monica_output"
        raws[name] = (
            (out / "raw_monica.dataframe").read_bytes(),
            (q / "mapped" / "run1.fastq").read_bytes(),
        )
    assert raws["single"] == raws["mesh"]


def test_cli_build_and_list_and_plot(world, tmp_path, capsys):
    tmp, taxdump, summary, genome_dir, seqs = world
    root = tmp_path / "root2"

    rc = cli.main(
        [
            "build_index",
            "--root", str(root),
            "--taxdump", str(taxdump),
            "--offline_tables", str(summary), str(summary),
            "--offline_genomes", str(genome_dir),
            "-G", "Aquickia prima",
        ]
    )
    assert rc == 0
    built = capsys.readouterr().out.strip().splitlines()[-1]
    assert Path(built).exists()

    rc = cli.main(["--root", str(root), "list_indexes"])
    assert rc == 0
    listed = capsys.readouterr().out
    assert "G_Aquickia prima" in listed or "G_Aquickia" in listed

    # plot_only from a previous run's dataframes
    q = tmp_path / "q2"
    q.mkdir()
    rng = np.random.default_rng(33)
    reads, _ = sample_reads(rng, [seqs["Aquickia prima"]], 10, read_len=600, error=(0, 0, 0))
    make_fastq(q / "s.fastq", reads)
    rc = cli.main(
        [
            "--root", str(root),
            "--taxdump", str(taxdump),
            "--offline_tables", str(summary), str(summary),
            "--offline_genomes", str(genome_dir),
            "-q", str(q), "-G", "Aquickia prima", "--not_auto_open_plot",
        ]
    )
    assert rc == 0
    df = q / "monica_output" / "monica.dataframe"
    (df.parent / "monica.barplot.html").unlink()
    rc = cli.main(["--root", str(root), "plot_only", "-d", str(df)])
    assert rc == 0
    assert (df.parent / "monica.barplot.html").exists()


def test_cli_initialize(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    rc = cli.main(["initialize", "-r", str(tmp_path / "elsewhere")])
    assert rc == 0
    assert (tmp_path / ".monica_tpu" / ".root").read_text().strip() == str(
        tmp_path / "elsewhere"
    )


def test_cli_version_and_help():
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"])
    assert e.value.code == 0


def test_cli_main_path_runs_without_pandas(world, tmp_path):
    """The CLI main path (cli -> orchestrate -> runtime -> stats ->
    plots -> data) runs with pandas unimportable, and its tables are
    byte-identical to what the former pandas export wrote."""
    import os
    import subprocess
    import sys

    from monica_tpu.index import artifact
    from monica_tpu.index.build import merge_built
    from monica_tpu.stats.abundance import AbundanceState
    from monica_tpu.utils import root as rootutil
    from tests.test_stats import pandas_csvs

    tmp, taxdump, summary, genome_dir, seqs = world
    root, q = tmp_path / "root", tmp_path / "query"
    q.mkdir()
    rng = np.random.default_rng(35)
    reads, _ = sample_reads(
        rng, [seqs["Aquickia prima"], seqs["Bcoolia secunda"], seqs["Hostus major"]],
        30, read_len=800, error=(0.03, 0.01, 0.01),
    )
    make_fastq(q / "run1.fastq", reads)
    argv = [
        "--root", str(root), "--taxdump", str(taxdump),
        "--offline_tables", str(summary), str(summary),
        "--offline_genomes", str(genome_dir), "-q", str(q),
        "-G", "Aquickia prima", "Bcoolia secunda", "-H", "Hostus_major",
        "--not_auto_open_plot",
    ]
    repo = str(Path(__file__).resolve().parents[1])
    code = (
        "import sys; sys.modules['pandas'] = None; "
        f"sys.path.insert(0, {repo!r}); "
        "from monica_tpu import cli; "
        f"rc = cli.main({argv!r}); "
        "assert 'pandas' not in sys.modules or sys.modules['pandas'] is None; "
        "sys.exit(rc)"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    out = q / "monica_output"
    parts = {p.name[0]: artifact.load_index(p)
             for p in artifact.list_indexes(rootutil.indexes_dir(root), root)}
    meta = merge_built([parts["G"], parts["H"]]).meta
    state = AbundanceState.load(out, meta.n_accessions)
    assert state.samples, "nothing was counted"
    want_norm, want_raw = pandas_csvs(state, meta)
    assert (out / "monica.dataframe").read_text() == want_norm
    assert (out / "raw_monica.dataframe").read_text() == want_raw
    assert (out / "monica.barplot.html").exists()
