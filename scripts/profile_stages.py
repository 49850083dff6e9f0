#!/usr/bin/env python
"""Per-stage timing of the classification pipeline on the GPU.

Mirrors bench.py EXACTLY (64 Mbase Zymo-like index, 1 shard, 2048x8
batches of 1 kb reads, params_for_bucket seed budget, rescue-mode
extension) and attributes wall-clock by progressively enabling stages:
sketch / +lookup / +chain / full-no-extend / full.  Each variant runs
as one lax.scan dispatch over the resident batches and ends in
block_until_ready; the card's name and power limit are printed beside
the numbers, and the script refuses to run without a GPU.

The index is passed as a jit ARGUMENT everywhere: closing over the
device table would embed ~0.5 GB in the program as an HLO constant.

Every variant returns a live sum of EVERY stage output: XLA's
dead-code pruning of partial outputs triggers pathologically different
schedules (measured 30x on CPU), which would mis-attribute stage cost.
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from monica_tpu.utils.device import card_line, require_gpu
from monica_tpu.utils.jaxcache import enable_compilation_cache

require_gpu(what="profile_stages.py")
CARD = card_line()
enable_compilation_cache()
import jax
import jax.numpy as jnp

from monica_tpu.align import pipeline as pl
from monica_tpu.ops import lookup as lk
from monica_tpu.ops import chain as ch

READ_LEN = 1024
BATCH = 2048
N_BATCHES = 8


def live(out):
    """Sum every leaf so no stage output is dead code."""
    return sum(
        x.astype(jnp.float32).sum() for x in jax.tree_util.tree_leaves(out)
    )


def main():
    small = "--small" in sys.argv
    rng = np.random.default_rng(3)
    from bench import make_reads

    t0 = time.time()
    if small:
        seqs = [rng.integers(0, 4, 1_000_000).astype(np.uint8) for _ in range(5)]
    else:
        from monica_tpu.evaluation import zymo_community

        seqs = zymo_community(rng)
    from monica_tpu.index.build import build_index_from_arrays

    built = build_index_from_arrays(seqs, n_shards=1)
    dev, tb = pl.device_shard(built.shards[0])
    jax.block_until_ready(dev)
    print(f"build {time.time()-t0:.1f}s rows={dev.mz_rows.shape} | {CARD}", flush=True)

    codes = make_reads(seqs, rng, BATCH * N_BATCHES).reshape(
        N_BATCHES, BATCH, READ_LEN
    )
    lengths = np.full((N_BATCHES, BATCH), READ_LEN, np.int32)
    cd, ld = jnp.asarray(codes), jnp.asarray(lengths)

    # EXACT bench params (per-bucket seed budget -> n_slots=64 at 1 kb)
    params = pl.params_for_bucket(pl.ClassifyParams(tag_bits=tb), READ_LEN)
    params_noext = params._replace(extend=False)
    n_acc = built.meta.n_accessions
    print(
        f"device={jax.devices()[0].device_kind} "
        f"index={sum(len(s) for s in seqs)/1e6:.0f}Mbase B={BATCH}x{N_BATCHES} "
        f"L={READ_LEN} n_slots={params.n_slots} a={params.anchors_per_seed} "
        f"extend_mode={params.extend_mode}",
        flush=True,
    )

    def scan_over(stage):
        @jax.jit
        def run(index, codes, lengths):
            def body(c, b):
                return c + live(stage(index, b[0], b[1])), None

            return jax.lax.scan(body, jnp.float32(0), (codes, lengths))[0]

        return run

    def stage_sketch(index, c, l):
        return pl.sketch_batch(c, l, params)

    def stage_lookup(index, c, l):
        sk = pl.sketch_batch(c, l, params)
        return lk.lookup_anchors(
            index.mz_rows, *sk, tag_bits=params.tag_bits, bucket_len=READ_LEN,
            anchors_per_seed=params.anchors_per_seed,
        )

    def stage_chain(index, c, l):
        sk = pl.sketch_batch(c, l, params)
        key, diag, rpos, fpos = lk.lookup_anchors(
            index.mz_rows, *sk, tag_bits=params.tag_bits, bucket_len=READ_LEN,
            anchors_per_seed=params.anchors_per_seed,
        )
        return ch.chain_votes(key, diag, rpos, fpos)

    def stage_noext(index, c, l):
        return pl.classify_batch(index, c, l, params_noext, n_acc)

    def stage_full(index, c, l):
        return pl.classify_batch(index, c, l, params, n_acc)

    results = {}

    def timed(name, stage):
        fn = scan_over(stage)
        jax.block_until_ready(fn(dev, cd, ld))  # compile
        t0 = time.perf_counter()
        jax.block_until_ready(fn(dev, cd, ld))
        dt = time.perf_counter() - t0
        n = BATCH * N_BATCHES
        ms = dt / N_BATCHES * 1000.0
        results[name] = round(ms, 2)
        print(f"{name:22s} {ms:8.2f} ms/batch  {n/dt:10.0f} reads/s | {CARD}", flush=True)

    timed("sketch", stage_sketch)
    timed("+lookup", stage_lookup)
    timed("+chain", stage_chain)
    timed("full(noext)", stage_noext)
    timed("full(rescue)", stage_full)
    print(json.dumps({"ms_per_batch_2048": results, "card": CARD}), flush=True)


if __name__ == "__main__":
    main()
