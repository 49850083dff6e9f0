"""Base encoding, padding, and read-length bucketing (host side, numpy).

Device data layout: sequences become flat ``uint8`` code arrays
(A,C,G,T -> 0..3; anything else -> 4) so the device pipeline works on
static-shape integer tensors.  Reads are padded into power-of-two
length buckets to bound XLA recompilation (the reference processes one
Python string at a time through mappy, `monica/genomes/aligner.py:193`;
here a batch of reads is one device array).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Code for any non-ACGT base and for padding. Kept distinct from real
# bases so k-mers covering it can be masked out.
N_CODE = 4
PAD_CODE = 4

_LUT = np.full(256, N_CODE, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    _LUT[ord(b)] = i
    _LUT[ord(b.lower())] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode one sequence to uint8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    return _DECODE[np.minimum(codes, N_CODE)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (A<->T, C<->G; N stays N)."""
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return comp[::-1]


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """(B, L) uint8 codes -> (B, ceil(L/4)) uint8 wire format: 4 bases
    per byte, base i in bits 2*(i % 4) of byte i//4.

    2 bits/base quarters the host->device transfer, and the
    device-side unpack (pipeline.unpack_codes) fuses into the sketch
    stage.

    Non-ACGT codes (N, PAD) map to 0 ('A').  Row padding past each
    read's true length is re-masked on device by position
    (sketch_batch / extend_hits), so only *interior* Ns change
    meaning: an N-spanning seed becomes a valid-looking hash instead
    of an invalid one (minimap2 skips such seeds).  A false seed still
    needs co-diagonal support to influence chaining, so at nanopore N
    rates the effect is below the error-noise floor.
    """
    B, L = codes.shape
    P4 = -(-L // 4) * 4
    c = np.zeros((B, P4), np.uint8)
    np.copyto(c[:, :L], np.where(codes < 4, codes, 0))
    c = c.reshape(B, P4 // 4, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


@dataclass
class ReadBatch:
    """A padded batch of reads ready for device transfer.

    codes:   (n, L) uint8, PAD_CODE beyond each read's length
    lengths: (n,) int32 true lengths (clipped to L)
    idx:     (n,) int32 indices into the originating read list
    """

    codes: np.ndarray
    lengths: np.ndarray
    idx: np.ndarray

    @property
    def bucket_len(self) -> int:
        return self.codes.shape[1]

    def __len__(self) -> int:
        return self.codes.shape[0]


DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)

# Trailing window shorter than this is dropped when chunking an
# ultra-long read (too few seeds to be informative on its own).
MIN_TAIL = 256


def bucket_for_length(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def window_plan(
    lengths,
    buckets=DEFAULT_BUCKETS,
    max_batch: int | None = None,
) -> list[tuple[int, list[tuple[int, int, int]]]]:
    """Plan device rows for a set of read lengths.

    Returns ``[(bucket_len, [(read_idx, offset, wlen), ...]), ...]``
    batches.  Reads that fit a bucket get one row; reads longer than
    the largest bucket are SPLIT into bucket-sized windows sharing the
    same read_idx (chunk-and-merge — the reference maps full-length
    ultra-long nanopore reads through minimap2, `monica/genomes/
    aligner.py:193`; static XLA shapes make windows + a host-side vote
    merge the batched equivalent).  The runtime merges per-window
    results per read (:func:`monica_tpu.align.runtime.process_sample`).
    """
    B = buckets[-1]
    per: dict[int, list[tuple[int, int, int]]] = {}
    for i, n in enumerate(lengths):
        n = int(n)
        if n <= B:
            per.setdefault(bucket_for_length(n, buckets), []).append((i, 0, n))
            continue
        off = 0
        while off < n:
            w = min(B, n - off)
            if w < MIN_TAIL:
                break
            per.setdefault(bucket_for_length(w, buckets), []).append((i, off, w))
            off += w
    out = []
    for blen in sorted(per):
        rows = per[blen]
        step = max_batch or len(rows)
        for s in range(0, len(rows), step):
            out.append((blen, rows[s : s + step]))
    return out


def bucketize_reads(
    seqs: list[str],
    buckets=DEFAULT_BUCKETS,
    max_batch: int | None = None,
) -> list[ReadBatch]:
    """Group reads into per-bucket padded batches (ultra-long reads
    become multiple window rows with a shared idx; see window_plan)."""
    out: list[ReadBatch] = []
    for blen, rows in window_plan([len(s) for s in seqs], buckets, max_batch):
        codes = np.full((len(rows), blen), PAD_CODE, dtype=np.uint8)
        lengths = np.zeros(len(rows), dtype=np.int32)
        idx = np.zeros(len(rows), dtype=np.int32)
        for row, (i, off, w) in enumerate(rows):
            enc = encode_seq(seqs[i][off : off + w])
            codes[row, : len(enc)] = enc
            lengths[row] = len(enc)
            idx[row] = i
        out.append(ReadBatch(codes, lengths, idx))
    return out


def pad_rows(batch: ReadBatch, multiple: int = 1, target: int | None = None) -> ReadBatch:
    """Pad the batch row count up to a multiple (for even mesh sharding)
    or to an exact ``target`` row count (multi-host lockstep schedules).

    Padded rows have length 0 and idx -1; the pipeline masks them out.
    """
    n = len(batch)
    if target is None:
        target = -(-n // multiple) * multiple
    if target == n:
        return batch
    codes = np.full((target, batch.bucket_len), PAD_CODE, dtype=np.uint8)
    codes[:n] = batch.codes
    lengths = np.zeros(target, dtype=np.int32)
    lengths[:n] = batch.lengths
    idx = np.full(target, -1, dtype=np.int32)
    idx[:n] = batch.idx
    return ReadBatch(codes, lengths, idx)


@dataclass
class PackedSeqs:
    """Concatenated reference sequences as one flat code array.

    The device-side "database": all genome sequences end-to-end with a
    separator run of N_CODE between records so seeds/alignments cannot
    bridge two sequences.  ``seq_accession_id`` maps each record to its
    accession (multiple contigs per accession).
    """

    codes: np.ndarray  # (total,) uint8
    starts: np.ndarray  # (n_seqs,) int64 start offset of each record
    lengths: np.ndarray  # (n_seqs,) int64
    seq_accession_id: np.ndarray  # (n_seqs,) int32

    guard: int = 32  # separator length between records

    def locate(self, pos: np.ndarray) -> np.ndarray:
        """Map global positions to record indices (host-side helper)."""
        return np.searchsorted(self.starts, pos, side="right") - 1


class PackedSeqsBuilder:
    def __init__(self, guard: int = 32):
        self.guard = guard
        # leading guard: position 0 can then never host a minimizer,
        # which lets the packed hash-table rows use payload==0 as the
        # empty-slot sentinel (monica_tpu/ops/lookup.py)
        self._chunks: list[np.ndarray] = (
            [np.full(guard, N_CODE, dtype=np.uint8)] if guard else []
        )
        self._starts: list[int] = []
        self._lengths: list[int] = []
        self._acc_ids: list[int] = []
        self._off = guard

    def add(self, codes: np.ndarray, accession_id: int) -> None:
        self._starts.append(self._off)
        self._lengths.append(len(codes))
        self._acc_ids.append(accession_id)
        self._chunks.append(codes)
        self._chunks.append(np.full(self.guard, N_CODE, dtype=np.uint8))
        self._off += len(codes) + self.guard

    def build(self) -> PackedSeqs:
        codes = (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros(0, dtype=np.uint8)
        )
        return PackedSeqs(
            codes=codes,
            starts=np.asarray(self._starts, dtype=np.int64),
            lengths=np.asarray(self._lengths, dtype=np.int64),
            seq_accession_id=np.asarray(self._acc_ids, dtype=np.int32),
            guard=self.guard,
        )
