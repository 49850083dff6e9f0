#!/usr/bin/env python
"""(n_slots, frac, extend) grid timing of the classify step on the
GPU (refuses to run without one): one lax.scan dispatch over R DISTINCT
resident batches (loop-invariant bodies can be hoisted by XLA, which
silently divides the apparent time by R), ended in block_until_ready,
with the card's name and power limit beside every number.

Accuracy for any candidate default must separately pass
scripts/concordance.py at full size."""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

R = 8
GENOME_LEN = 1_000_000
N_GENOMES = 5
READ_LEN = 1024
BATCH = 2048


def main():
    from monica_tpu.utils.device import card_line, require_gpu

    require_gpu(what="exp_knobs.py")
    card = card_line()
    import jax
    import jax.numpy as jnp

    from monica_tpu.align import pipeline as pl
    from monica_tpu.index.build import build_index_from_arrays

    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8) for _ in range(N_GENOMES)]

    r2 = np.random.default_rng(3)
    codes = np.stack(
        [
            seqs[r2.integers(0, N_GENOMES)][s : s + READ_LEN]
            for s in r2.integers(0, GENOME_LEN - READ_LEN, BATCH * R)
        ]
    ).astype(np.uint8)
    m = r2.random(codes.shape) < 0.05
    codes[m] = r2.integers(0, 4, int(m.sum()))
    cd = jnp.asarray(codes.reshape(R, BATCH, READ_LEN))
    ld = jnp.asarray(np.full((R, BATCH), READ_LEN, np.int32))

    def timed(name, stage):
        @jax.jit
        def fn():
            def body(c, xs):
                out = stage(xs[0], xs[1])
                leaf = jax.tree_util.tree_leaves(out)[0]
                return c + leaf.astype(jnp.float32).sum(), None

            tot, _ = jax.lax.scan(body, jnp.float32(0), (cd, ld))
            return tot

        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ms = (time.perf_counter() - t0) / R * 1000.0
        print(f"{name:34s}: {ms:7.2f} ms/batch  ({BATCH/ms*1000:,.0f} reads/s) | {card}", flush=True)

    for frac in (1.0, 0.5):
        built = build_index_from_arrays(seqs, frac=frac)
        dev, tb = pl.device_shard(built.shards[0])
        print(f"--- frac={frac} rows={dev.mz_rows.shape[0]:,}x{dev.mz_rows.shape[1]}", flush=True)
        for S in (128, 96, 64):
            for ext in (False, True):
                p = pl.ClassifyParams(n_slots=S, tag_bits=tb, frac=frac, extend=ext)
                timed(
                    f"S={S} frac={frac} ext={int(ext)}",
                    lambda c, l, p=p: pl.classify_shard(dev, c, l, p),
                )


if __name__ == "__main__":
    main()
