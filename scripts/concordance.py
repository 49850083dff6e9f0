#!/usr/bin/env python
"""Accuracy harness driver: classification accuracy vs ground truth
over error rates / read lengths / pipeline settings.

The BASELINE.md concordance target (>=95% read-assignment concordance)
is measured here as ground-truth assignment accuracy on a mock
community with conserved shared blocks (see monica_tpu/evaluation.py).

Gating: exits 1 when the worst-case accuracy of the DEFAULT settings
over the supported error profiles (<= r9_hac) falls below 0.95, or
when r9_old (8/5/5% legacy chemistry) falls below 0.85 accuracy /
0.995 precision at read lengths >= 1 kb (VERDICT r4 item 2: adaptive
+ single-anchor rescue with a coverage floor closed the r9-era gap).
Sweep rows (deliberately degraded knobs) are reported but never gate.

Usage: python scripts/concordance.py [--quick] [--sweep]
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

import numpy as np

TARGET = 0.95
GATED_PROFILES = ("r10_sup", "r10_fast", "r9_hac")
R9_OLD_ACC_TARGET = 0.85     # at read_len >= 1000
R9_OLD_PREC_TARGET = 0.995


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small sizes (CPU-friendly)")
    ap.add_argument("--sweep", action="store_true", help="sweep pipeline knobs")
    ap.add_argument("--n_genomes", type=int, default=8)
    ap.add_argument("--glen", type=int, default=500_000)
    ap.add_argument("--n_reads", type=int, default=1024)
    ap.add_argument("--out", help="write a JSON artifact (rows + verdict) here")
    args = ap.parse_args()

    from monica_tpu import evaluation as ev
    from monica_tpu.align import pipeline as pl
    from monica_tpu.index.build import build_index_from_arrays

    if args.quick:
        args.n_genomes, args.glen, args.n_reads = 4, 60_000, 192

    rng = np.random.default_rng(11)
    seqs = ev.mock_community(rng, args.n_genomes, args.glen)

    # one index per distinct frac (frac is an index-side property;
    # evaluate() copies IndexMeta.frac into the query params)
    indexes: dict[float, object] = {}

    def index_for(frac: float):
        if frac not in indexes:
            indexes[frac] = build_index_from_arrays(seqs, frac=frac)
        return indexes[frac]

    # nanopore-like error profiles: (sub, ins, del) roughly R9 -> R10.4
    profiles = [
        ("r10_sup", (0.01, 0.005, 0.005)),
        ("r10_fast", (0.03, 0.02, 0.02)),
        ("r9_hac", (0.05, 0.03, 0.03)),
        ("r9_old", (0.08, 0.05, 0.05)),
    ]
    read_lens = [300, 1000] if args.quick else [300, 1000, 5000]

    # (name, params, frac)
    settings = [("default", pl.ClassifyParams(), 1.0)]
    if args.sweep:
        settings += [
            ("slots64", pl.ClassifyParams(n_slots=64), 1.0),
            ("slots96", pl.ClassifyParams(n_slots=96), 1.0),
            ("slots64_a2", pl.ClassifyParams(n_slots=64, anchors_per_seed=2), 1.0),
            ("slots96_a2", pl.ClassifyParams(n_slots=96, anchors_per_seed=2), 1.0),
            # throughput knob: fewer anchors per seed; watch the
            # precision column — a1 trades it
            ("a1", pl.ClassifyParams(anchors_per_seed=1), 1.0),
            ("slots64_a1", pl.ClassifyParams(n_slots=64, anchors_per_seed=1), 1.0),
            ("frac0.5", pl.ClassifyParams(), 0.5),
            ("frac0.5_slots64", pl.ClassifyParams(n_slots=64), 0.5),
            ("frac0.25", pl.ClassifyParams(), 0.25),
            ("frac0.25_slots64", pl.ClassifyParams(n_slots=64), 0.25),
        ]

    rows = []
    for sname, params, frac in settings:
        built = index_for(frac)
        for pname, error in profiles:
            for L in read_lens:
                r = ev.evaluate(
                    built,
                    seqs,
                    params,
                    np.random.default_rng(5),
                    n_reads=args.n_reads,
                    read_len=L,
                    error=error,
                )
                r.settings = dict(setting=sname, profile=pname, read_len=L)
                rows.append(r.row())
                print(json.dumps(rows[-1]))

    # --- strain-level discrimination + hard-community rows (VERDICT r3
    # item 3): sibling genomes at an ANI sweep, homopolymer-biased
    # errors, repeat-bearing community.  Gates: (a) precision >= 0.995
    # for every strain row at ANI <= 99% (wrong calls are the failure
    # mode the tie/ambiguity machinery exists for); (b) at ANI > 99.5%
    # wrong calls stay <= 1% of reads (near-identical pairs must route
    # to AMBIGUOUS/unmapped, not guess — reference aligner.py:328-339).
    strain_rows = []
    sg = 120_000 if args.quick else 1_000_000
    sr = 128 if args.quick else 512
    for div in (0.05, 0.03, 0.01, 0.005, 0.002):
        r = ev.strain_pair_eval(
            np.random.default_rng(17), pl.ClassifyParams(),
            genome_len=sg, divergence=div, n_reads=sr,
            error=(0.05, 0.03, 0.03),
        )
        strain_rows.append(r.row())
        print(json.dumps(strain_rows[-1]))
    # homopolymer-biased + repeat-rich community (the hard instance)
    hard_seqs = ev.mock_community(
        np.random.default_rng(19), args.n_genomes, args.glen,
        tandem_repeats=2, dispersed_repeats=2,
    )
    from monica_tpu.index.build import build_index_from_arrays as _bi
    hard_built = _bi(hard_seqs)
    for pname, error in [("r10_fast", (0.03, 0.02, 0.02)), ("r9_hac", (0.05, 0.03, 0.03))]:
        r = ev.evaluate(
            hard_built, hard_seqs, pl.ClassifyParams(),
            np.random.default_rng(5), n_reads=args.n_reads, read_len=1000,
            error=error, hp_bias=4.0,
        )
        r.settings = dict(
            setting="default", kind="hard_community", profile=pname,
            read_len=1000, hp_bias=4.0, repeats=True,
        )
        strain_rows.append(r.row())
        print(json.dumps(strain_rows[-1]))

    PRECISION_TARGET = 0.995
    strain_ok = True
    for r in strain_rows:
        ani = r.get("ani")
        if ani is not None and ani <= 0.97:
            # discriminable regime: a meaningful fraction MUST map
            # (guards against the gate passing vacuously because a
            # regression routed everything to ambiguous/unmapped:
            # precision=None would otherwise skip every check), and
            # what maps must be right
            strain_ok &= r["mapped"] >= r["reads"] * 0.25
            strain_ok &= (
                r["precision"] is not None
                and r["precision"] >= PRECISION_TARGET
            )
        elif ani is not None and ani <= 0.99 and r["precision"] is not None:
            strain_ok &= r["precision"] >= PRECISION_TARGET
        if ani is not None and ani > 0.995:
            strain_ok &= r["wrong"] <= max(r["reads"] * 0.01, 1)
        if (
            r.get("kind") == "hard_community"
            and r["precision"] is not None
            and not args.quick
            # quick mode's 60 kb genomes put ~20% of bases in shared
            # blocks, so a single noisy shared-block read already dips
            # below the gate — full size (1.6% shared) is what's gated
        ):
            strain_ok &= r["precision"] >= PRECISION_TARGET

    gated = [
        r["accuracy"]
        for r in rows
        if r["setting"] == "default" and r["profile"] in GATED_PROFILES
    ]
    worst = min(gated)
    r9_rows = [
        r for r in rows
        if r["setting"] == "default" and r["profile"] == "r9_old"
        and r["read_len"] >= 1000
    ]
    r9_ok = all(
        r["accuracy"] >= R9_OLD_ACC_TARGET
        and (r["precision"] is None or r["precision"] >= R9_OLD_PREC_TARGET)
        for r in r9_rows
    )
    ok = worst >= TARGET and strain_ok and r9_ok
    if args.quick:
        # quick mode's tiny genomes put ~7% of reads inside the mock
        # community's conserved shared blocks (genuinely unmappable),
        # capping accuracy below the full-size target — so quick mode
        # has no meaningful gate and says so explicitly.
        verdict = "CEILING-LIMITED (quick mode: shared-block ceiling ~0.93, not gated)"
    else:
        verdict = "PASS" if ok else "FAIL"
    print(
        f"\nworst-case DEFAULT accuracy (profiles <= r9_hac): {worst:.4f} "
        f"(target >= {TARGET}); r9_old gate (acc >= {R9_OLD_ACC_TARGET}, "
        f"prec >= {R9_OLD_PREC_TARGET} at >= 1 kb): "
        f"{'PASS' if r9_ok else 'FAIL'}; strain/hard-instance precision "
        f"gate (>= {PRECISION_TARGET} at ANI <= 99%, no guessing above): "
        f"{'PASS' if strain_ok else 'FAIL'} -> {verdict}"
    )
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(
                {
                    "target": TARGET,
                    "gated_profiles": list(GATED_PROFILES),
                    "worst_gated_accuracy": worst,
                    "r9_old_gate": {
                        "acc_target": R9_OLD_ACC_TARGET,
                        "prec_target": R9_OLD_PREC_TARGET,
                        "pass": r9_ok,
                    },
                    "precision_target": PRECISION_TARGET,
                    "strain_gate": "PASS" if strain_ok else "FAIL",
                    "verdict": verdict,
                    "config": {
                        "n_genomes": args.n_genomes, "glen": args.glen,
                        "n_reads": args.n_reads, "quick": args.quick,
                    },
                    "rows": rows,
                    "strain_rows": strain_rows,
                    "notes": [
                        "Query-side sketch fast path (seg >= w, frac >= 1): "
                        "tail segments shorter than w can select a "
                        "non-winnowed k-mer, deviating from exact index/"
                        "query winnowed-set parity there (ADVICE r4 item 3; "
                        "monica_tpu/index/minimizer.py fast-path comment). "
                        "Effect is sub-seed-level — such a seed just misses "
                        "in the index — and is included in every accuracy "
                        "number in this artifact."
                    ],
                },
                fh,
                indent=1,
            )
        print(f"artifact written to {args.out}")
    sys.exit(0 if ((ok or args.quick) and strain_ok and (r9_ok or args.quick)) else 1)


if __name__ == "__main__":
    main()
