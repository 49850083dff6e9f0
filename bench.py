#!/usr/bin/env python
"""Headline benchmark: classification reads/s on one chip at a
REALISTIC index size.

Workload mirrors BASELINE.json config 2 (ZymoBIOMICS mock community):
8 bacterial (~5 Mb) + 2 yeast (~12 Mb) genomes ≈ 64 Mbase of reference
in 1 index shard, 1 kb nanopore-like reads (5% substitutions).
``--small`` runs the config-1 workload (5 × 1 Mb, 1 shard).

Baseline denominator: the reference pipeline (mappy/minimap2 map-ont,
3 threads, `monica/monica.py:92-94`) at ~2,000 reads/s — an ASSUMPTION
whose derivation, citation and sensitivity table live in BASELINE.md
§"Assumed CPU baseline" (mappy is not installable here, so it cannot
be measured in-environment).

Methodology: the classify loop runs on device via lax.scan over
resident batches (one dispatch), every timing ends in
``block_until_ready``, and the script refuses to run without a GPU.
This is a device-only rate, not the served path (``run_once``).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "card"}.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

# ASSUMED baseline — see BASELINE.md §"Assumed CPU baseline"
BASELINE_READS_PER_S = 2000.0

READ_LEN = 1024
BATCH = 2048
N_BATCHES = 16  # resident batches per timed dispatch
SUB_RATE = 0.05


def make_reads(seqs, rng, n_reads):
    """Reads sampled position-uniformly over the community (big genomes
    contribute proportionally more reads, like real sequencing)."""
    sizes = np.array([len(s) for s in seqs], dtype=np.float64)
    gsel = rng.choice(len(seqs), size=n_reads, p=sizes / sizes.sum())
    codes = np.empty((n_reads, READ_LEN), dtype=np.uint8)
    for i, g in enumerate(gsel):
        s = rng.integers(0, len(seqs[g]) - READ_LEN)
        codes[i] = seqs[g][s : s + READ_LEN]
    m = rng.random(codes.shape) < SUB_RATE
    codes[m] = rng.integers(0, 4, int(m.sum()))
    return codes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="config-1 workload (5 x 1 Mb, 1 shard)")
    ap.add_argument("--gut", action="store_true",
                    help="config-3 workload: 200 x 1.5 Mb genomes = 300 Mbase, "
                         "sharded at the 2^26-base cap (grouped multi-shard path)")
    ap.add_argument("--no-extend", dest="extend", action="store_false",
                    help="A/B: vote-only pipeline (attributes the extension stage cost)")
    ap.add_argument("--anchors", type=int, default=None,
                    help="A/B: anchors_per_seed override (default: ClassifyParams)")
    args = ap.parse_args()

    from monica_tpu.utils.device import card_line, require_gpu
    from monica_tpu.utils.jaxcache import enable_compilation_cache

    require_gpu(what="bench.py")
    card = card_line()
    print(f"card: {card}", flush=True)
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from monica_tpu.align import pipeline as pl
    from monica_tpu.evaluation import zymo_community
    from monica_tpu.index.build import build_index_from_arrays

    rng = np.random.default_rng(3)
    t0 = time.time()
    if args.small:
        seqs = [rng.integers(0, 4, 1_000_000).astype(np.uint8) for _ in range(5)]
        n_shards = 1
    elif args.gut:
        # BASELINE.json config 3: gut-microbiome vs ~200-genome RefSeq
        # subset — 300 Mbase forces a real multi-shard index (cap 2^26
        # bases/shard, ops/lookup.py) through the grouped stacked path
        seqs = [rng.integers(0, 4, 1_500_000).astype(np.uint8) for _ in range(200)]
        n_shards = 5
    else:
        # 64 Mbase fits ONE shard (cap 2^26 bases, ops/lookup.py): a
        # single hash table means one gather pass, one chain sort and
        # one extension per read — half the per-read work of a 2-shard
        # split.  Sharding is for indexes beyond the cap (config 3+)
        # or for spreading HBM across a mesh.
        seqs = zymo_community(rng)
        n_shards = 1
    built = build_index_from_arrays(seqs, n_shards=n_shards)
    if len(built.shards) == 1:
        # single-shard fast path, exactly as Classifier dispatches it
        if built.device:
            # device build: table already on device
            table, steps = built.device[0]
            index = pl.DeviceIndexShard(
                mz_rows=table,
                pos_acc=jnp.asarray(built.shards[0].pos_accession_id),
                ref_codes=jnp.asarray(built.shards[0].ref_codes),
            )
        else:
            index, steps = pl.device_shard(built.shards[0])
        step_fn = pl.classify_batch
    else:
        index, steps = pl.stack_device_shard_groups(built.shards)
        step_fn = pl.classify_batch_grouped
    jax.block_until_ready(index)
    build_s = time.time() - t0

    codes = make_reads(seqs, rng, BATCH * N_BATCHES)
    codes = codes.reshape(N_BATCHES, BATCH, READ_LEN)
    lengths = np.full((N_BATCHES, BATCH), READ_LEN, np.int32)

    params = pl.params_for_bucket(
        pl.ClassifyParams(tag_bits=steps, extend=args.extend), READ_LEN
    )
    if args.anchors is not None:
        params = params._replace(anchors_per_seed=args.anchors)
    n_acc = built.meta.n_accessions

    @jax.jit
    def run_all(index, codes, lengths):
        def body(carry, batch):
            c, l = batch
            res, counts = step_fn(
                index, c, l, params, n_acc, pl.MODE_QUERY_LENGTH
            )
            # return the FULL per-read result, exactly what the
            # streaming runtime fetches per batch (routing consumes
            # status+acc_id, the stats layer identity/mlen/mapq).
            # Returning a strict subset lets XLA prune outputs, which
            # reschedules the program measurably differently from the
            # product path.
            return carry + counts, res

        return jax.lax.scan(body, jnp.zeros(n_acc, jnp.int32), (codes, lengths))

    cd, ld = jnp.asarray(codes), jnp.asarray(lengths)
    total, results = run_all(index, cd, ld)
    jax.block_until_ready(run_all(index, cd, ld))  # compile

    # 5 timed repetitions; the headline value is the MEDIAN rep, with
    # the best and worst reported beside it
    dts = []
    for _ in range(5):
        t0 = time.perf_counter()
        total, results = jax.block_until_ready(run_all(index, cd, ld))
        dts.append(time.perf_counter() - t0)
    statuses_h = np.asarray(results.status)

    n = BATCH * N_BATCHES
    reads_per_s = n / float(np.median(dts))
    best = n / min(dts)
    floor = n / max(dts)
    mapped = float((statuses_h == pl.MAPPED).mean())
    ref_mb = sum(len(s) for s in seqs) / 1e6
    sys.stderr.write(
        f"[bench] index={ref_mb:.0f}Mbase/{n_shards}shard build={build_s:.1f}s "
        f"classify_median={np.median(dts):.3f}s reps={[round(d,3) for d in dts]} "
        f"mapped_frac={mapped:.3f} device={jax.devices()[0].device_kind} | {card}\n"
    )
    print(
        json.dumps(
            {
                "metric": "classification_reads_per_s_per_chip",
                "value": round(reads_per_s, 1),
                "unit": "reads/s",
                "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 2),
                "stat": "median_of_5",
                "quiet_best": round(best, 1),
                "loaded_floor": round(floor, 1),
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
