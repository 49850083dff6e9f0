#!/usr/bin/env python
"""Measured max-RSS bound for chunked FASTQ ingest (VERDICT r4 item 6's
"documented max-RSS bound", made a measurement).

Generates a large synthetic FASTQ, then parses it in a FRESH subprocess
two ways and records each subprocess's peak RSS (resource.ru_maxrss):

* whole-file (io.native.parse_fastq_file)   -> RSS ~ O(file)
* chunked (io.native.iter_fastq_file_views) -> RSS ~ O(chunk)

The parse subprocesses stay on the host: they never import JAX (the
worker asserts it), so no second process opens the card.

Usage: python scripts/ingest_rss.py [--mb 256] [--chunk_mb 32] [--out FILE]
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import resource, sys
sys.path.insert(0, {repo!r})
from monica_tpu.io import native
mode, path, chunk = sys.argv[1], sys.argv[2], int(sys.argv[3])
n = 0
if mode == "baseline":
    native.available()  # import/load cost only
elif mode == "whole":
    v = native.parse_fastq_file(path)
    n = len(v)
else:
    for v in native.iter_fastq_file_views(path, chunk_bytes=chunk):
        n += len(v)
assert "jax" not in sys.modules, "the ingest worker must stay off JAX"
peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(n, peak_kb)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--chunk_mb", type=int, default=32)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()

    import numpy as np

    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "big.fastq"
        rng = np.random.default_rng(5)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        per_rec = 1000
        n_recs = args.mb * (1 << 20) // (2 * per_rec + 40)
        with open(path, "w") as fh:
            q = "I" * per_rec
            for i in range(n_recs):
                s = lut[rng.integers(0, 4, per_rec)].tobytes().decode()
                fh.write(f"@read{i} rss\n{s}\n+\n{q}\n")
        fsize = path.stat().st_size
        worker = WORKER.format(repo=str(REPO))

        def run(mode):
            out = subprocess.run(
                [sys.executable, "-c", worker, mode, str(path),
                 str(args.chunk_mb << 20)],
                capture_output=True, text=True, check=True,
            ).stdout.split()
            return int(out[0]), int(out[1]) * 1024  # records, bytes

        _, rss_base = run("baseline")
        n_whole, rss_whole = run("whole")
        n_chunk, rss_chunk = run("chunked")
        assert n_whole == n_chunk == n_recs

    payload = dict(
        file_mb=round(fsize / 1e6, 1),
        records=n_recs,
        chunk_mb=args.chunk_mb,
        interpreter_baseline_rss_mb=round(rss_base / 1e6, 1),
        whole_file_peak_rss_mb=round(rss_whole / 1e6, 1),
        chunked_peak_rss_mb=round(rss_chunk / 1e6, 1),
        whole_delta_mb=round((rss_whole - rss_base) / 1e6, 1),
        chunked_delta_mb=round((rss_chunk - rss_base) / 1e6, 1),
        chunked_delta_over_chunk=round(
            (rss_chunk - rss_base) / (args.chunk_mb << 20), 2
        ),
        bound=(
            "ingest cost above the interpreter baseline: whole-file "
            "tracks the file size; chunked stays within a few chunk "
            "sizes regardless of file size (measured flat across "
            "64-256 MB files)"
        ),
    )
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)


if __name__ == "__main__":
    main()
