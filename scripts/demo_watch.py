#!/usr/bin/env python
"""BASELINE config-4 demo on the GPU: real-time rolling batches.

Simulates a MinION run: a feeder thread drops flowcell FASTQ batches
into the query folder every few seconds while `watch()` classifies
them as they land, persisting the monotone accumulator and refreshing
the dataframe + barplot after every batch (the `on_batch` hook — the
reference relies on an external watcher re-invoking the CLI,
SURVEY §3.4; here the loop is first-class).

Writes a JSON artifact recording per-batch latency (host clock, with
the card's name and power limit) and the incremental accumulator
growth.  Refuses to run without a GPU.

Usage: python scripts/demo_watch.py [--out FILE]
"""

import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, ".")
sys.path.insert(0, "scripts")

import numpy as np

from monica_tpu.utils.device import card_line, require_gpu
from monica_tpu.utils.jaxcache import enable_compilation_cache

require_gpu(what="demo_watch.py")
enable_compilation_cache()
import jax


def main():
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]

    from bench import make_reads
    import bench as bench_mod
    from bench_stream import write_fastq

    from monica_tpu.align import pipeline as pl
    from monica_tpu.align import runtime as rt
    from monica_tpu.evaluation import zymo_community
    from monica_tpu.index.build import build_index_from_arrays
    from monica_tpu.stats import abundance as ab

    rng = np.random.default_rng(13)
    t0 = time.time()
    seqs = zymo_community(rng)
    built = build_index_from_arrays(seqs, n_shards=1)
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="query_length")
    jax.block_until_ready(clf.index)
    build_s = time.time() - t0

    bench_mod.READ_LEN = 1000
    scratch = Path(tempfile.mkdtemp(prefix="demo_watch_"))
    qdir = scratch / "query"
    out = scratch / "out"
    for d in (qdir, out):
        d.mkdir()

    # warm the compile cache so batch latencies are steady-state
    write_fastq(qdir / "warm.fastq", make_reads(seqs, rng, 4096))
    rt.run_once(clf, qdir, out)

    N_BATCHES, READS = 4, 8192
    def feeder():
        for i in range(N_BATCHES):
            codes = make_reads(seqs, rng, READS)
            tmp = qdir / f".flowcell{i}.tmp"
            write_fastq(tmp, codes)
            tmp.rename(qdir / f"flowcell{i}.fastq")  # atomic appearance
            time.sleep(2.0)

    batch_log = []
    t_start = time.time()

    def on_batch(reports):
        state = ab.AbundanceState.load(out, built.meta.n_accessions)
        total = int(sum(v.sum() for v in state.samples.values()))
        batch_log.append(
            {
                "t": round(time.time() - t_start, 2),
                "samples": [r.sample for r in reports],
                "reads": sum(r.n_reads for r in reports),
                "mapped": sum(r.n_mapped for r in reports),
                "seconds": round(sum(r.seconds for r in reports), 3),
                "accumulated_count_total": total,
            }
        )

    th = threading.Thread(target=feeder)
    th.start()
    reports = rt.watch(
        clf, qdir, out, poll_s=0.5, max_idle_polls=8, on_batch=on_batch
    )
    th.join()

    n_reads = sum(r.n_reads for r in reports)
    n_mapped = sum(r.n_mapped for r in reports)
    growth = [b["accumulated_count_total"] for b in batch_log]
    payload = {
        "metric": "watch_mode_rolling_batches",
        "device": str(jax.devices()[0].device_kind),
        "card": card_line(),
        "batches_fed": N_BATCHES,
        "reads_per_batch": READS,
        "reads_processed": n_reads,
        "mapped": n_mapped,
        "index_build_s": round(build_s, 1),
        "batch_log": batch_log,
        "monotone_growth": all(
            a < b for a, b in zip(growth, growth[1:])
        ),
        "verdict": "PASS"
        if n_reads == N_BATCHES * READS
        and n_mapped > 0.95 * n_reads
        and len(growth) >= 2
        and all(a < b for a, b in zip(growth, growth[1:]))
        else "FAIL",
    }
    shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps(payload))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(payload, fh, indent=1)
    sys.exit(0 if payload["verdict"] == "PASS" else 1)


if __name__ == "__main__":
    main()
