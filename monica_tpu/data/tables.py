"""NCBI assembly-summary tables: fetch, TTL cache, import.

Re-designs `monica/genomes/tables.py` (reference): RefSeq + GenBank
``assembly_summary`` TSVs downloaded by wget with a 2-day cache keyed
by a ``log`` date file (`tables.py:18-56`), loaded with columns
[0,5,6,7,8,9,19] (`tables.py:15`).

Differences (deliberate): the transport is injectable (``downloader``)
so tests and air-gapped deployments run on fixture TSVs, and cache
freshness is per-file mtime rather than a single shared date file.
"""

from __future__ import annotations

import csv
import os
import time
import urllib.request
from pathlib import Path
from typing import Callable

REFSEQ_SUMMARY_URL = (
    "https://ftp.ncbi.nlm.nih.gov/genomes/refseq/assembly_summary_refseq.txt"
)
GENBANK_SUMMARY_URL = (
    "https://ftp.ncbi.nlm.nih.gov/genomes/genbank/assembly_summary_genbank.txt"
)
URLS = {"refseq": REFSEQ_SUMMARY_URL, "genbank": GENBANK_SUMMARY_URL}

# columns [0,5,6,7,8,9,19] of the NCBI summary schema (reference tables.py:15)
USE_COLS = [0, 5, 6, 7, 8, 9, 19]
COLUMNS = [
    "# assembly_accession",
    "taxid",
    "species_taxid",
    "organism_name",
    "infraspecific_name",
    "isolate",
    "ftp_path",
]
HEADER_LINE = 1  # summaries carry a '##' comment line before the header
TTL_DAYS = 2.0

Downloader = Callable[[str, str], None]
Rows = list[dict[str, "str | None"]]  # one dict per assembly, keyed by COLUMNS

# cells read as missing (pandas' default NA spellings), like the
# reference's pd.read_csv(dtype=str) load
_NA = {
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
}


def urllib_downloader(url: str, out: str) -> None:
    """Default transport (the wget.download analog)."""
    urllib.request.urlretrieve(url, out)


def table_path(tables_dir: str | os.PathLike, which: str) -> Path:
    return Path(tables_dir) / URLS[which].rsplit("/", 1)[-1]


def is_fresh(path: Path, ttl_days: float = TTL_DAYS) -> bool:
    return path.exists() and (time.time() - path.stat().st_mtime) < ttl_days * 86400


def fetch(
    tables_dir: str | os.PathLike,
    which: str,
    downloader: Downloader = urllib_downloader,
    ttl_days: float = TTL_DAYS,
) -> Path:
    """Ensure the summary TSV is present and fresh; return its path."""
    tables_dir = Path(tables_dir)
    tables_dir.mkdir(parents=True, exist_ok=True)
    path = table_path(tables_dir, which)
    if not is_fresh(path, ttl_days):
        tmp = path.with_suffix(".part")
        downloader(URLS[which], str(tmp))
        os.replace(tmp, path)
    return path


def importer(
    tables_dir: str | os.PathLike,
    which: str,
    downloader: Downloader = urllib_downloader,
    ttl_days: float = TTL_DAYS,
) -> Rows:
    """Load one summary as string rows with the 7 columns the pipeline
    consumes (reference `tables.importer`, tables.py:32-43); missing
    cells are None."""
    path = fetch(tables_dir, which, downloader, ttl_days)
    with open(path, newline="", encoding="utf-8") as fh:
        lines = csv.reader(fh, delimiter="\t")
        for _ in range(HEADER_LINE + 1):  # preamble + header
            next(lines, None)
        return [
            {c: (None if r[i] in _NA else r[i]) for i, c in zip(USE_COLS, COLUMNS)}
            for r in lines
            if len(r) > max(USE_COLS)
        ]


def write_fixture_summary(path: str | os.PathLike, rows: list[dict]) -> None:
    """Write a syntactically faithful mini assembly-summary TSV (22
    columns, '##' preamble) for offline tests/deployments."""
    n_cols = 22
    names = [f"col{i}" for i in range(n_cols)]
    for i, c in zip(USE_COLS, COLUMNS):
        names[i] = c
    with open(path, "w") as fh:
        fh.write("## auto-generated fixture assembly summary\n")
        fh.write("\t".join(names) + "\n")
        for row in rows:
            cells = ["na"] * n_cols
            for i, c in zip(USE_COLS, COLUMNS):
                cells[i] = str(row.get(c, "na"))
            fh.write("\t".join(cells) + "\n")


def fixture_downloader(mapping: dict[str, str]) -> Downloader:
    """Downloader serving local files keyed by URL (offline mode)."""
    import shutil

    def dl(url: str, out: str) -> None:
        if url not in mapping:
            raise FileNotFoundError(url)
        shutil.copyfile(mapping[url], out)

    return dl
