"""Produce parity.json — measured parity against the REFERENCE'S OWN
pipeline code (VERDICT r4 missing #1 / next-round item 1).

Runs the reference's real aligner()/multi_threaded_aligner/
alignment_update/normalizer/alignment_to_data_frame (exec'd from
/root/reference with a scripted-hit mappy stub; monica_tpu/parity.py)
and this repo's product path over identical FASTQs for every count
mode + overnight, and records per-read route agreement, count-dict
parity, and table parity.

Usage: JAX_PLATFORMS=cpu python scripts/parity_artifact.py
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from monica_tpu import parity  # noqa: E402


def route_breakdown(fixture, ref_routes, our_routes):
    """Agreement per designed read category."""
    kind_of = {
        r.rid: r.kind
        for batch in fixture.passes
        for reads in batch.values()
        for r in reads
    }
    per = {}
    for sample, rr in ref_routes.routes.items():
        ours = our_routes.routes.get(sample, {})
        for rid, (r_route, r_tax) in rr.items():
            o_route, o_tax = ours.get(rid, ("missing", None))
            same = r_route == o_route and (
                r_route != "mapped" or r_tax == o_tax
            )
            k = kind_of[rid]
            a = per.setdefault(k, Counter())
            a["n"] += 1
            a["agree"] += same
    return {
        k: dict(n=int(v["n"]), agree=int(v["agree"]),
                agreement=round(v["agree"] / v["n"], 4))
        for k, v in sorted(per.items())
    }


def run_mode(fixture, mode: str, overnight: bool, tmp: Path) -> dict:
    t0 = time.time()
    tag = f"{mode}{'_overnight' if overnight else ''}"
    with parity.reference_aligner(tmp / f"sb_{tag}") as mod:
        ref_routes, ref_alignment, glens = parity.run_reference(
            mod, fixture, tmp / f"ref_{tag}", mode=mode, overnight=overnight
        )
    our_routes, state, built = parity.run_ours(
        fixture, tmp / f"our_{tag}", mode=mode, overnight=overnight
    )
    d = parity.diff_routes(ref_routes, our_routes)
    out = dict(
        mode=mode,
        overnight=overnight,
        n_reads=d["n_reads"],
        route_agreement=round(d["agreement"], 4),
        disagreements=d["disagreements"],
        focus_jaccard=round(
            d["focus_intersection"] / max(d["focus_union"], 1), 4
        ),
        by_kind=route_breakdown(fixture, ref_routes, our_routes),
        seconds=round(time.time() - t0, 1),
    )

    # count parity under reference rules (reconstructable modes only)
    if mode in ("basic", "query_length") and not overnight:
        exp_ref = parity.expected_alignment_from_routes(
            ref_routes, fixture, mode=mode, overnight=False
        )
        out["ref_dict_matches_own_routes"] = parity.diff_alignment_dicts(
            exp_ref, ref_alignment
        )["equal"]
        exp_our = parity.expected_alignment_from_routes(
            our_routes, fixture, mode=mode, overnight=False
        )
        ours_dict = parity.state_to_alignment(state, built.meta)
        out["our_counts_match_reference_rules"] = parity.diff_alignment_dicts(
            exp_our, ours_dict
        )["equal"]
    if overnight:
        ours_dict = parity.state_to_alignment(state, built.meta, overnight=True)
        dd = parity.diff_alignment_dicts(ref_alignment, ours_dict)
        n_disagree = d["n_reads"] - d["n_agree"]
        out["overnight_count_mismatches"] = dd["n_mismatches"]
        out["overnight_bounded_by_disagreements"] = (
            dd["n_mismatches"] <= 2 * n_disagree
        )

    # table parity: reference's normalizer+dataframe code on OUR counts
    # vs our exported CSVs (exact cellwise)
    from monica_tpu.stats.abundance import export_tables, read_dataframe

    meta = built.meta
    ours_dict = parity.state_to_alignment(state, meta, overnight=overnight)
    glens2 = {
        meta.accessions[i]: int(meta.genome_lengths[i])
        for i in range(meta.n_accessions)
    }
    with parity.reference_aligner(tmp / f"sb2_{tag}") as mod:
        ref_norm, ref_raw = parity.reference_tables(
            mod, ours_dict, glens2, tmp / f"rt_{tag}"
        )
    export_tables(state, meta, tmp / f"ot_{tag}", overnight=overnight)
    our_norm = read_dataframe(tmp / f"ot_{tag}" / "monica.dataframe")
    our_raw = read_dataframe(tmp / f"ot_{tag}" / "raw_monica.dataframe")
    dr = parity.diff_tables(ref_raw, our_raw)
    dn = parity.diff_tables(ref_norm, our_norm)
    if mode == "matching":
        # matching counts use each side's own mlen (ours: banded-SW
        # alignment mlen; reference: scripted) — schema parity only
        out["raw_table_schema_equal"] = dr["same_rows"] and dr["same_cols"]
        out["norm_table_schema_equal"] = dn["same_rows"] and dn["same_cols"]
    else:
        out["raw_table_equal"] = dr["cells_equal"]
        out["norm_table_equal"] = dn["cells_equal"]
        out["norm_table_max_rel_err"] = dn["max_rel_err"]
    return out


def main() -> None:
    if not parity.reference_available():
        print(json.dumps({"error": "reference tree not present"}))
        return
    results = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        fixture = parity.make_fixture(seed=7)
        for mode in ("basic", "query_length", "matching"):
            results.append(run_mode(fixture, mode, False, tmp))
            print(f"[parity] {mode}: agreement="
                  f"{results[-1]['route_agreement']}", flush=True)
        fx_on = parity.make_fixture(seed=11)
        results.append(run_mode(fx_on, "basic", True, tmp))
        print(f"[parity] basic+overnight: agreement="
              f"{results[-1]['route_agreement']}", flush=True)

    worst = min(r["route_agreement"] for r in results)
    artifact = dict(
        round=5,
        what=(
            "Measured end-to-end parity against the reference's own "
            "aligner()/alignment_update/normalizer/alignment_to_data_frame "
            "code, executed offline with a scripted-hit mappy stub "
            "(monica_tpu/parity.py).  Gate: >=95% per-read route "
            "agreement (BASELINE.json north star)."
        ),
        gate=0.95,
        worst_route_agreement=worst,
        gate_pass=worst >= 0.95,
        runs=results,
        notes=[
            "Scripted hits encode truthful aligner evidence: clean reads "
            "one primary hit (NM ~= injected error count), conserved-"
            "block reads byte-identical hits on both carriers (exact tie "
            "-> ambiguous), random reads no hits; decoys exercise "
            "best_hit ordering and the mapq>=60 filter.",
            "matching mode compares table SCHEMA only: each side counts "
            "its own mlen (ours from banded SW, reference from the "
            "script).",
            "Cross-shard exact-tie tail: identical copies in different "
            "index shards tie on vote statistics within "
            "ClassifyParams.tie_rel_tol; a few % can escape the band "
            "(see tests/test_parity_reference_exec.py)."
        ],
    )
    (REPO / "parity.json").write_text(json.dumps(artifact, indent=1))
    print(json.dumps(dict(
        worst_route_agreement=worst, gate_pass=artifact["gate_pass"]
    )))


if __name__ == "__main__":
    main()
