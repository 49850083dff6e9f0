#!/usr/bin/env python
"""End-to-end streaming-runtime benchmark ON THE PRODUCT PATH.

bench.py times the device program alone; this script times what a user
gets: `run_once` over a real FASTQ folder — native C parse, length
bucketing + encode, async device dispatch, per-batch result fetches,
chunk-merge, count accumulation, and routed FASTQ writes — against the
Zymo-scale 64 Mbase index on the GPU (it refuses to run without one).
A run ends when the routed files and counts are written, so these are
host-clock times of the served path; the card's name and power limit
are printed beside them.

Usage: python scripts/bench_stream.py [--reads N] [--out FILE]
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, ".")

import numpy as np

from monica_tpu.utils.device import card_line, require_gpu
from monica_tpu.utils.jaxcache import enable_compilation_cache

require_gpu(what="bench_stream.py")
CARD = card_line()
enable_compilation_cache()
import jax

BASES = "ACGT"


def write_fastq(path: Path, codes: np.ndarray):
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * codes.shape[1]
    with open(path, "w") as fh:
        for i, row in enumerate(codes):
            fh.write(
                f"@read{i}\n{lut[row].tobytes().decode()}\n+\n{qual}\n"
            )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--read_len", type=int, default=1000)
    ap.add_argument("--samples", type=int, default=8,
                    help="flowcell files for the run_once overlap measurement")
    ap.add_argument("--out")
    args = ap.parse_args()

    from bench import make_reads
    import bench as bench_mod

    from monica_tpu.align import pipeline as pl
    from monica_tpu.align import runtime as rt
    from monica_tpu.evaluation import zymo_community
    from monica_tpu.index.build import build_index_from_arrays
    from monica_tpu.stats.abundance import AbundanceState
    from monica_tpu.utils.metrics import Metrics

    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    seqs = zymo_community(rng)
    built = build_index_from_arrays(seqs, n_shards=1)
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="query_length")
    jax.block_until_ready(clf.index)
    build_s = time.perf_counter() - t0

    bench_mod.READ_LEN = args.read_len
    scratch = Path(tempfile.mkdtemp(prefix="bench_stream_"))
    qdir = scratch / "query"
    for sub in ("", "mapped", "unmapped", "ambiguous"):
        (qdir / sub).mkdir(parents=True, exist_ok=True)
    for f in qdir.glob("*.fastq"):
        f.unlink()
    codes = make_reads(seqs, rng, args.reads)
    write_fastq(qdir / "flowcell0.fastq", codes)
    out = scratch / "out"
    out.mkdir(exist_ok=True)

    # warm the compile caches with a SAME-SHAPE sample so the timed run
    # measures steady-state streaming (the watcher's situation: a
    # flowcell size repeats, so its batch plan — and the whole-sample
    # combined-fetch program keyed on it — compiles once; the
    # persistent compilation cache carries it across runs too)
    warm = qdir / "warm.fastq"
    write_fastq(warm, codes)
    folders = rt.RouteFolders.create(qdir, with_focus=False)
    state = AbundanceState(built.meta.n_accessions)
    rt.process_sample(clf, warm, folders, state, delete=True)

    # 3 timed reps: headline is the median, the best kept as a labeled
    # secondary
    single_reps = []
    rep = None
    metrics = Metrics(verbose=False)
    for _ in range(3):
        m = Metrics(verbose=False)
        t0 = time.perf_counter()
        rep = rt.process_sample(
            clf, qdir / "flowcell0.fastq", folders, state, delete=False,
            metrics=m,
        )
        single_reps.append(rep.n_reads / (time.perf_counter() - t0))
        metrics = m
    reads_per_s = float(np.median(single_reps))

    stages = {
        k: round(v.items / v.seconds)
        for k, v in metrics.stages.items()
        if v.items and v.seconds > 0
    }

    # --- cross-sample overlap (VERDICT r3 item 4): run_once pipelines
    # parse(i+1) / dispatch(i) / route(i-1) across samples on worker
    # threads; measure it against a strictly serial process_sample loop
    # over the same files.
    per_sample = max(args.reads // args.samples, 4096)
    sample_codes = [
        make_reads(seqs, rng, per_sample) for _ in range(args.samples)
    ]

    def write_all(folder: Path):
        for sub in ("", "mapped", "unmapped", "ambiguous"):
            (folder / sub).mkdir(parents=True, exist_ok=True)
        for f in folder.glob("*.fastq"):
            f.unlink()
        for i, c in enumerate(sample_codes):
            write_fastq(folder / f"fc{i}.fastq", c)

    total = per_sample * args.samples
    qs = scratch / "serial"
    write_all(qs)
    sfolders = rt.RouteFolders.create(qs, with_focus=False)
    t0 = time.perf_counter()
    for i in range(args.samples):
        rt.process_sample(clf, qs / f"fc{i}.fastq", sfolders, state, delete=True)
    serial_s = time.perf_counter() - t0

    pipe_reps = []
    for _ in range(3):
        qp = scratch / "pipe"
        write_all(qp)
        op = scratch / "pipe_out"
        op.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        reports = rt.run_once(clf, qp, op)
        pipe_s = time.perf_counter() - t0
        assert sum(r.n_reads for r in reports) == total
        pipe_reps.append(total / pipe_s)
    overlap = {
        "samples": args.samples,
        "reads_per_sample": per_sample,
        "serial_reads_per_s": round(total / serial_s, 1),
        "pipelined_reads_per_s": round(float(np.median(pipe_reps)), 1),
        "pipelined_reps": [round(r, 1) for r in pipe_reps],
        "pipelined_best": round(max(pipe_reps), 1),
        "overlap_speedup": round(
            float(np.median(pipe_reps)) * serial_s / total, 3
        ),
    }
    payload = {
        "metric": "end_to_end_stream_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "workload": f"{args.reads} x {args.read_len} bp reads, 64 Mbase index, "
                    "run through process_sample (parse/encode/classify/route/count)",
        "device": str(jax.devices()[0].device_kind),
        "stat": "median_of_3",
        "single_sample_reps": [round(r, 1) for r in single_reps],
        "single_sample_best": round(max(single_reps), 1),
        "n_mapped": rep.n_mapped,
        "n_unmapped": rep.n_unmapped,
        "n_ambiguous": rep.n_ambiguous,
        "index_build_s": round(build_s, 1),
        "stage_reads_per_s": stages,
        "cross_sample_overlap": overlap,
        "card": CARD,
    }
    shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)


if __name__ == "__main__":
    main()
