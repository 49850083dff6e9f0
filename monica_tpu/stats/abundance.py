"""Abundance accumulation, normalization, and table export.

Re-designs the reference's pickle-based accumulator and nested-dict
normalizer with flat per-accession vectors (device-friendly):

* cross-batch accumulator  <- `alignment_update` merging Counters into
  ``alignment.pkl`` (`monica/genomes/aligner.py:282-302`);
* BPB/BPM normalization    <- `normalizer` (`aligner.py:305-319`):
  BPB = count / genome_length[accession];  BPM = BPB / sample_total;
* MultiIndex (tax_unit, accession) x samples CSV schema  <-
  `alignment_to_data_frame` (`aligner.py:322-325`), public API used by
  ``plot_only`` (`monica/monica.py:784-785`).  The table is a small
  numpy structure written with :mod:`csv` byte for byte as pandas'
  ``DataFrame.to_csv`` writes that MultiIndex frame.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from monica_tpu.index.build import IndexMeta

DATAFRAME_FILENAME = "monica.dataframe"
RAW_DATAFRAME_FILENAME = "raw_monica.dataframe"
STATE_FILENAME = "alignment.npz"  # the alignment.pkl analog


@dataclass
class AbundanceState:
    """Per-sample per-accession count accumulator (int64 on host).

    The monotone cross-batch state that makes re-invocation idempotent
    (SURVEY.md §3.4's real-time contract).
    """

    n_accessions: int
    samples: dict[str, np.ndarray] = field(default_factory=dict)

    def update(self, sample: str, batch_counts: np.ndarray) -> None:
        if sample not in self.samples:
            self.samples[sample] = np.zeros(self.n_accessions, dtype=np.int64)
        self.samples[sample] += batch_counts.astype(np.int64)

    # -- persistence (cleared at fresh-run start, reference helpers.py:30-32)
    def save(self, folder: str | os.PathLike) -> None:
        names = sorted(self.samples)
        np.savez_compressed(
            Path(folder) / STATE_FILENAME,
            names=np.asarray(names, dtype=object),
            counts=np.stack([self.samples[n] for n in names])
            if names
            else np.zeros((0, self.n_accessions), np.int64),
            n_accessions=np.int64(self.n_accessions),
        )

    @classmethod
    def load(cls, folder: str | os.PathLike, n_accessions: int) -> "AbundanceState":
        path = Path(folder) / STATE_FILENAME
        state = cls(n_accessions)
        if path.exists():
            z = np.load(path, allow_pickle=True)
            if int(z["n_accessions"]) == n_accessions:
                for name, row in zip(z["names"], z["counts"]):
                    state.samples[str(name)] = row.astype(np.int64)
        return state

    @staticmethod
    def clear(folder: str | os.PathLike) -> None:
        path = Path(folder) / STATE_FILENAME
        if path.exists():
            path.unlink()


def normalize(state: AbundanceState, genome_lengths: np.ndarray) -> dict[str, np.ndarray]:
    """BPB/BPM two-pass normalization (`aligner.py:305-319`).

    Returns per-sample float64 vectors; entries for absent accessions
    are 0 (exported as NaN/missing, matching the reference's sparse
    Counter semantics).
    """
    out = {}
    gl = np.maximum(genome_lengths.astype(np.float64), 1.0)
    for sample, counts in state.samples.items():
        bpb = counts.astype(np.float64) / gl
        total = bpb.sum()
        out[sample] = bpb / total if total > 0 else bpb
    return out


@dataclass
class AbundanceTable:
    """Rows = (tax_unit, accession) pairs; columns = samples; NaN marks
    an absent pair — the reference's MultiIndex DataFrame
    (`aligner.py:322-325`) without pandas."""

    tax_units: list[str]
    accessions: list[str]
    samples: list[str]
    values: np.ndarray  # (rows, samples) float64

    INDEX_NAMES = ("tax_unit", "accession")

    def to_csv(self, path: str | os.PathLike) -> None:
        """pandas ``to_csv`` layout: header row of index names + samples,
        shortest round-trip floats, empty field for NaN, minimal quoting."""
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow([*self.INDEX_NAMES, *self.samples])
            for t, a, row in zip(self.tax_units, self.accessions, self.values):
                w.writerow([t, a, *("" if np.isnan(v) else repr(float(v)) for v in row)])

    @classmethod
    def read_csv(cls, path: str | os.PathLike) -> "AbundanceTable":
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh))
        samples = rows[0][2:]
        body = rows[1:]
        values = np.array(
            [[float(v) if v else np.nan for v in r[2:]] for r in body], np.float64
        ).reshape(len(body), len(samples))
        return cls([r[0] for r in body], [r[1] for r in body], samples, values)

    def to_pandas(self):
        """The same table as a pandas DataFrame (parity tooling only)."""
        import pandas as pd

        index = pd.MultiIndex.from_arrays(
            [self.tax_units, self.accessions], names=list(self.INDEX_NAMES)
        )
        return pd.DataFrame(
            {s: self.values[:, j] for j, s in enumerate(self.samples)}, index=index
        )


def to_table(
    per_sample: dict[str, np.ndarray], meta: IndexMeta, overnight: bool = False
) -> AbundanceTable:
    """Rows = (tax_unit, accession) with any nonzero sample; columns =
    samples, sorted.

    Zero entries become NaN — in the reference a (tax_unit, accession)
    appears in a sample's Counter only if it received >=1 read, and
    missing cells surface as NaN after the unstack/concat
    (`aligner.py:322-325`).

    ``overnight`` collapses the tax_unit level to the genus (the first
    ``_``-separated token), matching the reference's overnight counting
    where ``sample_alignment`` is keyed by the genus-collapsed tax unit
    (`aligner.py:237-239,247-263`) — accessions stay distinct, so two
    species of one genus become two rows under one genus key, exactly
    the shape the reference's dict unstacks to.  Counting per accession
    and collapsing at export is equivalent to the reference's
    collapse-before-count because the accession->tax mapping is static.
    """
    samples = sorted(per_sample)
    rows_mask = np.zeros(meta.n_accessions, dtype=bool)
    for s in samples:
        rows_mask |= per_sample[s] != 0
    idx = np.nonzero(rows_mask)[0]

    def tax(i: int) -> str:
        t = meta.tax_units[i]
        return t.split("_")[0] if overnight else t

    values = np.zeros((len(idx), len(samples)), np.float64)
    for j, s in enumerate(samples):
        col = per_sample[s][idx].astype(np.float64)
        values[:, j] = np.where(col != 0, col, np.nan)
    return AbundanceTable(
        [tax(int(i)) for i in idx], [meta.accessions[i] for i in idx], samples, values
    )


def export_tables(
    state: AbundanceState,
    meta: IndexMeta,
    output_folder: str | os.PathLike,
    overnight: bool = False,
) -> tuple[AbundanceTable, AbundanceTable]:
    """Write ``monica.dataframe`` (normalized) and ``raw_monica.dataframe``
    (raw counts) CSVs — the on-disk public API (`monica/monica.py:443-448`).
    ``overnight`` exports genus-collapsed tax units (see to_table)."""
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    raw = to_table(
        {s: c.astype(np.float64) for s, c in state.samples.items()}, meta,
        overnight=overnight,
    )
    norm = to_table(normalize(state, meta.genome_lengths), meta, overnight=overnight)
    norm.to_csv(output_folder / DATAFRAME_FILENAME)
    raw.to_csv(output_folder / RAW_DATAFRAME_FILENAME)
    return norm, raw


def read_dataframe(path: str | os.PathLike) -> AbundanceTable:
    """Read a monica dataframe CSV back (plot_only path, monica.py:784-785)."""
    return AbundanceTable.read_csv(path)
