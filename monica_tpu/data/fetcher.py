"""Genome selection (4 modes) + download with a persistent cache.

Re-designs `monica/genomes/fetcher.py` (reference):

* ``ftp_selector`` — joins species (and all their taxonomic
  descendants) against the NCBI assembly summaries and derives
  ``species_name`` per mode (`fetcher.py:46-136`):
  - ``overnight``: all PARENTS kingdoms from RefSeq, one assembly per
    **genus** (`:52-66`);
  - ``all``: GenBank, every assembly, full organism name (`:69-77`);
  - ``single``: RefSeq, one assembly per species ("Genus species",
    ``sp.`` gets the strain token appended), viruses matched on full
    name and deduped separately (`:79-108`);
  - ``focus``: GenBank joined on ``species_taxid``, strain-level names
    from ``infraspecific_name`` (`:110-128`);
  all modes rewrite ``ftp_path`` to the ``*_genomic.fna.gz`` file
  (`:131-134`).
* ``fetcher``/``focus_fetcher`` — download each genome once into an
  ``oldies/`` cache named ``<species_name>_<accession-version>.fna.gz``,
  reuse cached copies, accept pre-downloaded files (``format_genomes``),
  evict superseded assembly versions (`:139-318`), and return
  ``(genomes, updated)`` where genomes are ``(path, [species_name,
  accession])`` tuples — the exact contract the index builder consumes.

Differences (deliberate): transport is injectable for offline use,
failures retry with backoff before skipping (the reference only
skip-and-prints, SURVEY.md §5 failure handling), and eviction compares
parsed accession versions instead of filename-split position.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from monica_tpu.data import tables
from monica_tpu.data.taxonomy import Taxonomy, descendants_taxid_finder

PARENTS = [
    "Fungi", "Oomycota", "Bacteria", "Archaea", "Viruses",
    "Nematodes", "Rhizaria", "Alveolata", "Heterokonta",
]


def _genomic_fna_urls(rows: tables.Rows) -> tables.Rows:
    return [
        {**r, "ftp_path": f"{r['ftp_path']}/{str(r['ftp_path']).rsplit('/', 1)[-1]}_genomic.fna.gz"}
        for r in rows
    ]


def _merge(rows: tables.Rows, keys: dict[str, list[str]]) -> tables.Rows:
    """Inner join on the one column of ``keys`` (the reference's
    ``DataFrame.merge(on=...)``): left order, one row per matching key."""
    (col, values), = keys.items()
    mult: dict[str, int] = {}
    for v in values:
        mult[v] = mult.get(v, 0) + 1
    return [dict(r) for r in rows for _ in range(mult.get(r[col], 0))]


def _dedup_keep_last(rows: tables.Rows, col: str) -> tables.Rows:
    """``drop_duplicates(subset=[col], keep="last")``."""
    last = {r[col]: i for i, r in enumerate(rows)}
    return [r for i, r in enumerate(rows) if last[r[col]] == i]


def _species_name_single(name: str) -> str:
    parts = name.split(" ")
    if len(parts) >= 3 and parts[1] == "sp.":
        return "_".join(parts[0:2]) + parts[2]
    return "_".join(parts[0:2])


def _species_name_focus(name: str, strain) -> str:
    if isinstance(strain, str) and "=" in strain:
        strain_val = strain.split("=", 1)[1]
        if not name.endswith(strain_val):
            name = name.replace(".", "") + " " + strain_val
        else:
            name = name.replace(strain_val, "").replace(".", "") + strain_val
    return name.replace(" ", "_")


def ftp_selector(
    mode: str,
    species: list[str],
    taxonomy: Taxonomy,
    tables_dir: str | os.PathLike,
    downloader: tables.Downloader = tables.urllib_downloader,
) -> tables.Rows:
    """Selection rows with ``species_name`` and downloadable
    ``ftp_path`` per assembly (reference `ftp_selector`)."""
    if mode == "overnight":
        taxids = descendants_taxid_finder(taxonomy, PARENTS)
        merged = _merge(tables.importer(tables_dir, "refseq", downloader), taxids)
        for r in merged:
            parts = r["organism_name"].split(" ")
            r["genera"] = parts[0]
            r["species_name"] = "_".join(parts[0:2])
        merged = _dedup_keep_last(merged, "genera")

    elif not species:
        raise ValueError(
            "no species specified — did you mean overnight mode?"
        )

    elif mode == "all":
        taxids = descendants_taxid_finder(taxonomy, species)
        merged = _merge(tables.importer(tables_dir, "genbank", downloader), taxids)
        for r in merged:
            r["species_name"] = "_".join(r["organism_name"].split(" "))

    elif mode == "single":
        vir = [s for s in species if taxonomy.is_virus(s)]
        cell = [s for s in species if not taxonomy.is_virus(s)]
        table = tables.importer(tables_dir, "refseq", downloader)
        merged = _merge(table, descendants_taxid_finder(taxonomy, cell))
        for r in merged:
            r["species_name"] = _species_name_single(r["organism_name"])
        merged = _dedup_keep_last(merged, "species_name")
        if vir:
            vmerged = _merge(table, descendants_taxid_finder(taxonomy, vir))
            for r in vmerged:
                r["species_name"] = "_".join(r["organism_name"].split(" "))
            merged += _dedup_keep_last(vmerged, "species_name")

    elif mode == "focus":
        taxids = descendants_taxid_finder(taxonomy, species, focus=True)
        merged = _merge(tables.importer(tables_dir, "genbank", downloader), taxids)
        for r in merged:
            r["species_name"] = _species_name_focus(
                r["organism_name"], r["infraspecific_name"]
            )
        merged = _dedup_keep_last(merged, "species_name")

    else:
        raise ValueError(f"unknown selection mode: {mode!r}")

    return _genomic_fna_urls(merged)


# ---------------------------------------------------------------------------
# genome download + cache
# ---------------------------------------------------------------------------

def _accession_suffix(accession: str) -> str:
    """'GCF_000005845.2' -> '000005845.2' (reference filename scheme)."""
    return accession.split("_", 1)[-1]


def _strip_version(stem: str) -> str:
    """cache-file stem without the trailing assembly version."""
    return stem.rsplit(".", 1)[0] if "." in stem else stem


def _download_with_retry(downloader, url, out, retries: int, backoff_s: float) -> bool:
    for attempt in range(retries + 1):
        try:
            downloader(url, out)
            return True
        except Exception as e:  # noqa: BLE001 — any transport failure: retry then skip
            if attempt == retries:
                print(f"[monica_tpu] {url} failed download ({e})")
                return False
            time.sleep(backoff_s * (2**attempt))
    return False


def fetcher(
    table: tables.Rows,
    genomes_dir: str | os.PathLike,
    keep_genomes: bool = True,
    format_genomes: str | os.PathLike | None = None,
    downloader: tables.Downloader = tables.urllib_downloader,
    retries: int = 2,
    backoff_s: float = 1.0,
    species_name_for_file=None,
):
    """Materialize every selected genome locally.

    Returns (genomes, updated): genomes = [(path, [species_name,
    accession_suffix])], updated = True iff anything new was fetched
    (drives index-rebuild decisions, reference monica.py:255-303).
    """
    genomes_dir = Path(genomes_dir)
    oldies = genomes_dir / "oldies"
    oldies.mkdir(parents=True, exist_ok=True)
    preformatted = {}
    if format_genomes:
        preformatted = {
            p.name: p for p in Path(format_genomes).iterdir() if p.name.endswith("fna.gz")
        }

    old = {p.name for p in oldies.iterdir() if p.name.endswith("fna.gz")}
    genomes, new_stems = [], []
    updated = False

    for row in table:
        url = row["ftp_path"]
        sp_name = row["species_name"]
        if species_name_for_file is not None:
            sp_name_file = species_name_for_file(sp_name)
        else:
            sp_name_file = sp_name
        acc = _accession_suffix(row["# assembly_accession"])
        header = [sp_name, acc]
        fname = f"{sp_name_file}_{acc}.fna.gz"

        if fname in old:
            genomes.append((str(oldies / fname), header))
            old.discard(fname)
            continue
        src_name = url.rsplit("/", 1)[-1]
        if src_name in preformatted:
            genomes.append((str(preformatted[src_name]), header))
            continue
        dest = (oldies if keep_genomes else genomes_dir) / fname
        if _download_with_retry(downloader, url, str(dest), retries, backoff_s):
            genomes.append((str(dest), header))
            new_stems.append(_strip_version(fname[: -len(".fna.gz")]))
            updated = True

    oldies_cleaner(new_stems, old, oldies)
    return genomes, updated


def focus_fetcher(
    table: tables.Rows,
    genomes_dir: str | os.PathLike,
    keep_genomes: bool = True,
    downloader: tables.Downloader = tables.urllib_downloader,
    retries: int = 2,
):
    """Strain-level fetch for the focus second pass: cache files are
    keyed by the species-level name ("Genus_species_<acc>") while
    headers keep the full strain name (reference fetcher.py:255-295)."""
    return fetcher(
        table,
        genomes_dir,
        keep_genomes=keep_genomes,
        downloader=downloader,
        retries=retries,
        species_name_for_file=lambda sp: "_".join(sp.split("_")[0:2]),
    )


def oldies_cleaner(new_stems: list[str], leftover_old: set[str], oldies: Path) -> None:
    """Evict cached genomes superseded by a new assembly version
    (reference fetcher.py:310-318)."""
    for fname in leftover_old:
        stem = _strip_version(fname[: -len(".fna.gz")])
        if stem in new_stems:
            (oldies / fname).unlink(missing_ok=True)
            print(f"[monica_tpu] removing {fname}, new version found")
