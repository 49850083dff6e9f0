"""High-error-rate (R9-era) sensitivity closure
(VERDICT r4 missing #2 / next-round item 2).

Measures, per error profile and read length:
* rescue-slot demand vs the static r4 budget (the saturation that made
  r9_old collapse: candidates beyond B/8 never got an extension slot);
* which adaptive tier (B/8, B/2, B) the batch escalates to;
* accuracy/precision of the default pipeline, plus ablations:
  - rescue_min_votes=2 (the r4 candidacy — no single-anchor rescue),
  - rescue_min_cov=0 (no coverage floor — shows the wrong-call source
    the floor removes: short high-identity local decoy segments).

Targets (gated here and in scripts/concordance.py): r9_old (8/5/5%)
accuracy >= 0.85 at 1 kb with precision >= 0.995.

Usage: python scripts/sensitivity_r9.py [--quick] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

PROFILES = [
    ("r10_sup", (0.01, 0.005, 0.005)),
    ("r10_fast", (0.03, 0.02, 0.02)),
    ("r9_hac", (0.05, 0.03, 0.03)),
    ("r9_old", (0.08, 0.05, 0.05)),
]


def measure_saturation(built, seqs, params, error, read_len, n_reads, batch):
    """Host-side mirror of the rescue candidacy (pipeline.classify_shard)
    to report slot demand per batch."""
    import jax.numpy as jnp

    from monica_tpu import evaluation as ev
    from monica_tpu.align import pipeline as pl
    from monica_tpu.ops import chain as ch, lookup as lk

    rng = np.random.default_rng(5)
    sub, ins, dele = error
    labels = rng.integers(0, len(seqs), n_reads)
    rcs = rng.random(n_reads) < 0.5
    codes = np.full((n_reads, read_len), 4, np.uint8)
    lens = np.zeros(n_reads, np.int32)
    for i in range(n_reads):
        r = ev.simulate_read_codes(
            rng, seqs[labels[i]], read_len, sub, ins, dele, rcs[i]
        )
        codes[i, : len(r)] = r
        lens[i] = len(r)

    dev, tb = pl.device_shard(built.shards[0])
    p = pl.params_for_bucket(
        params._replace(
            tag_bits=tb, k=built.meta.k, w=built.meta.w, frac=built.meta.frac
        ),
        read_len,
    )
    tiers = {"skip": 0, "b8": 0, "b2": 0, "full": 0}
    n_cand_total = 0
    sat_static = 0  # candidates beyond the r4 static budget
    for s0 in range(0, n_reads, batch):
        sl = slice(s0, min(s0 + batch, n_reads))
        cj, lj = jnp.asarray(codes[sl]), jnp.asarray(lens[sl])
        sk = pl.sketch_batch(cj, lj, p)
        qh, qp, qs, qv = sk
        key, diag, rpos, fpos = lk.lookup_anchors(
            dev.mz_rows, qh, qp, qs, qv, tag_bits=p.tag_bits,
            bucket_len=read_len, anchors_per_seed=p.anchors_per_seed,
        )
        res = ch.chain_votes(key, diag, rpos, fpos, max_run=min(128, p.n_slots))
        mapq = ch.mapq_from_votes(res.f1, res.f2)
        passed = np.asarray(
            (mapq >= p.mapping_quality) & (res.f1 >= p.min_votes) & (lj > 0)
        )
        f1, f2 = np.asarray(res.f1), np.asarray(res.f2)
        cand = (
            ~passed & (f1 >= p.rescue_min_votes) & (f2 * 2 <= f1)
            & (np.asarray(lj) > 0)
        )
        n_cand = int(cand.sum())
        B = cj.shape[0]
        n8 = max(int(B * p.rescue_frac), 1)
        n_cand_total += n_cand
        sat_static += max(n_cand - n8, 0)
        if n_cand == 0:
            tiers["skip"] += 1
        elif n_cand <= n8:
            tiers["b8"] += 1
        elif n_cand <= B // 2:
            tiers["b2"] += 1
        else:
            tiers["full"] += 1
    return dict(
        candidates=n_cand_total,
        static_budget_overflow=sat_static,
        tier_usage=tiers,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="sensitivity_r9.json")
    ap.add_argument("--n_genomes", type=int, default=8)
    ap.add_argument("--glen", type=int, default=500_000)
    ap.add_argument("--n_reads", type=int, default=1024)
    args = ap.parse_args()
    if args.quick:
        args.n_genomes, args.glen, args.n_reads = 4, 120_000, 512

    from monica_tpu import evaluation as ev
    from monica_tpu.align import pipeline as pl
    from monica_tpu.index.build import build_index_from_arrays

    rng = np.random.default_rng(11)
    seqs = ev.mock_community(rng, args.n_genomes, args.glen)
    built = build_index_from_arrays(seqs)
    read_lens = [300, 1000] if args.quick else [300, 1000, 5000]

    settings = [
        ("default", pl.ClassifyParams()),
        ("no_single_anchor(mv2)", pl.ClassifyParams(rescue_min_votes=2)),
        ("no_coverage_floor", pl.ClassifyParams(rescue_min_cov=0.0)),
    ]
    rows, sat_rows = [], []
    for pname, error in PROFILES:
        for L in read_lens:
            sat = measure_saturation(
                built, seqs, pl.ClassifyParams(), error, L, args.n_reads, 512
            )
            sat["profile"], sat["read_len"] = pname, L
            sat_rows.append(sat)
            print(json.dumps(sat), flush=True)
            for sname, params in settings:
                t0 = time.time()
                r = ev.evaluate(
                    built, seqs, params, np.random.default_rng(5),
                    n_reads=args.n_reads, read_len=L, error=error,
                )
                r.settings = dict(setting=sname, profile=pname, read_len=L)
                row = r.row()
                row["seconds"] = round(time.time() - t0, 1)
                rows.append(row)
                print(json.dumps(row), flush=True)

    r9 = [
        r for r in rows
        if r["setting"] == "default" and r["profile"] == "r9_old"
        and r["read_len"] >= 1000
    ]
    gate = all(
        r["accuracy"] >= 0.85
        and (r["precision"] is None or r["precision"] >= 0.995)
        for r in r9
    )
    artifact = dict(
        round=5,
        what=(
            "R9-era sensitivity closure: adaptive rescue tiers (B/8 -> "
            "B/2 -> B by candidate count), single-anchor candidacy "
            "(rescue_min_votes=1), and a local-alignment coverage floor "
            "(rescue_min_cov=0.5).  r4 baseline (static B/8 budget, "
            "mv=2): r9_old accuracy 0.32/0.49/0.53 at 300/1000/5000 bp."
        ),
        gate=dict(profile="r9_old", read_len=">=1000",
                  acc=0.85, precision=0.995, passed=gate),
        config=dict(n_genomes=args.n_genomes, glen=args.glen,
                    n_reads=args.n_reads, quick=args.quick),
        saturation=sat_rows,
        rows=rows,
    )
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(json.dumps(dict(gate_pass=gate, out=args.out)))
    sys.exit(0 if gate else 1)


if __name__ == "__main__":
    main()
