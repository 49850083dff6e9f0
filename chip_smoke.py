#!/usr/bin/env python3
"""End-to-end bring-up check of the classifier on one NVIDIA GPU.

    python chip_smoke.py           # every phase, one card
    python chip_smoke.py --four    # only the (data=2, index=2) mesh on four cards

Phases (one process; all data is generated from ``--seed``):

1. device gate: a GPU or exit nonzero; print the card, JAX, the native
   ingest library and the compile-cache directory;
2. kernels: banded Smith–Waterman as the program runs it against the
   plain ``banded_sw_jnp`` (on the card) and a numpy DP (subsample), and
   the row sorts of lookup compaction and chain voting against numpy,
   each timed beside its plain XLA version;
3. build: the Zymo-scale index through the device build path, checked
   bit for bit against the host table;
4. main path: three 4,000-read FASTQ files through ``monica_tpu.cli.main``
   in ``query_length`` and then ``matching`` count mode;
5. reference: a subsample of every bucket classified again on the CPU
   backend with the jnp DP, routes and counts compared read for read;
6. multi-shard: a 5-shard index through Classifier -> run_once;
7. steady state: new files of the same shapes, counting compilations,
   then the ``matching`` pass timed with the program's SW and with
   ``banded_sw_jnp``.

The last line of standard output is one JSON object; any failure exits
nonzero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

SW_BAND = 64
SW_LENGTHS = (1024, 8192, 16384, 32768)
SW_BATCHES = (256, 1024, 2048)  # rescue tiers of a 2048-read batch
SW_GOLD_READS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, runs: int = 5) -> float:
    """Median wall seconds of ``runs`` calls after one warm call; every
    call ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# banded Smith–Waterman: numpy DP and the kernel phase
# ---------------------------------------------------------------------------

def gold_banded_sw(q, refwin, lengths, p, packed: bool):
    """Plain numpy DP over a few reads, written from the recurrence (not
    from the jnp code): row i aligns read base i to refwin[i + d].

    Cell values are (score, mlen) pairs.  ``packed`` (reads up to
    ``packed_mbits``' limit) takes the lexicographic maximum everywhere;
    otherwise the diagonal wins vertical ties, the nearest cell wins
    horizontal ties, and the best is the first row whose maximum beats
    all earlier rows, with the largest mlen among that row's maxima."""
    n, L = q.shape
    W = p.band
    reach = W if p.max_gap <= 0 else min(p.max_gap, W)
    big = 1 << 20
    lane = np.arange(W, dtype=np.int64)
    qq = q.astype(np.int64)
    rr = refwin.astype(np.int64)
    H = np.zeros((n, W), np.int64)
    M = np.zeros((n, W), np.int64)
    best = np.zeros(n, np.int64)
    bm = np.zeros(n, np.int64)
    neg = -(1 << 40)
    for i in range(int(lengths.max(initial=0))):
        active = i < lengths
        qi = qq[:, i : i + 1]
        is_m = (qi == rr[:, i : i + W]) & (qi < 4)
        cd, md = H + np.where(is_m, p.match, -p.mismatch), M + is_m
        cu = np.concatenate([H[:, 1:], np.full((n, 1), neg)], 1) - p.gap
        mu = np.concatenate([M[:, 1:], np.zeros((n, 1), np.int64)], 1)
        up = (cu * big + mu > cd * big + md) if packed else (cu > cd)
        t, mt = np.where(up, cu, cd), np.where(up, mu, md)
        mt = np.where(t < 0, 0, mt)
        t = np.maximum(t, 0)
        # horizontal: max over k in (d - reach, d] of t[k] - (d - k)·gap
        u = np.concatenate([np.full((n, reach - 1), neg), t + lane * p.gap], 1)
        m = np.concatenate([np.zeros((n, reach - 1), np.int64), mt], 1)
        win_u = np.lib.stride_tricks.sliding_window_view(u, reach, axis=1)
        win_m = np.lib.stride_tricks.sliding_window_view(m, reach, axis=1)
        if packed:
            j = np.argmax(win_u * big + win_m, axis=2)
        else:
            j = reach - 1 - np.argmax(win_u[..., ::-1], axis=2)  # nearest
        H = np.take_along_axis(win_u, j[..., None], 2)[..., 0] - lane * p.gap
        M = np.take_along_axis(win_m, j[..., None], 2)[..., 0]
        if packed:
            key = (H * big + M).max(axis=1)
            better = active & (key > best * big + bm)
            best = np.where(better, key // big, best)
            bm = np.where(better, key % big, bm)
        else:
            rb = H.max(axis=1)
            rm = np.where(H == rb[:, None], M, 0).max(axis=1)
            better = active & (rb > best)
            best = np.where(better, rb, best)
            bm = np.where(better, rm, bm)
    return best.astype(np.int32), bm.astype(np.int32)


def sw_inputs(rng, B: int, L: int, band: int):
    """B forward reads with r9-like errors from a random reference, each
    between L/2 and L bases, and their band windows (host arrays)."""
    from monica_tpu.evaluation import simulate_read_codes

    ref = rng.integers(0, 4, size=4 * L + 4 * band).astype(np.uint8)
    q = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    starts = rng.integers(band, len(ref) - 2 * L - band, size=B)
    for b in range(B):
        n = int(rng.integers(L // 2 + 1, L + 1))
        # a slice of exactly the simulator's fragment length starts the
        # read at starts[b], where the band below is centred (as a
        # chained seed would seat it)
        frag = ref[starts[b] : starts[b] + n + int(n * 0.03 * 2) + 16]
        r = simulate_read_codes(rng, frag, n, 0.05, 0.03, 0.03, rc=False)
        q[b, : len(r)] = r
        lengths[b] = len(r)
    idx = starts[:, None] - band // 2 + np.arange(L + band)[None, :]
    refwin = ref[np.clip(idx, 0, len(ref) - 1)]
    return q, refwin, lengths


def phase_kernels(rng, lengths=SW_LENGTHS, batches=SW_BATCHES, band=SW_BAND,
                  gold_reads=SW_GOLD_READS, runs=5, card="") -> list[dict]:
    """Banded SW as the program runs it vs banded_sw_jnp (exact, whole
    batch) and vs the numpy DP (exact, ``gold_reads`` reads), with both
    timed on the card."""
    import jax
    import jax.numpy as jnp

    from monica_tpu.ops import extend as ex

    p = ex.ExtendParams(band=band)
    impl = ex.resolve_impl("auto", band)
    f_prog = jax.jit(lambda q, r, n: ex.banded_sw(q, r, n, p, impl=impl))
    f_jnp = jax.jit(lambda q, r, n: ex.banded_sw_jnp(q, r, n, p))
    rows = []
    for L in lengths:
        q, refwin, lens = sw_inputs(rng, max(batches), L, band)
        packed = bool(ex.packed_mbits(L, p))
        gs, gm = gold_banded_sw(q[:gold_reads], refwin[:gold_reads], lens[:gold_reads], p, packed)
        for B in batches:
            args = tuple(jnp.asarray(a[:B]) for a in (q, refwin, lens))
            s1, m1 = (np.asarray(x) for x in f_prog(*args))
            s0, m0 = (np.asarray(x) for x in f_jnp(*args))
            vs_jnp = bool((s1 == s0).all() and (m1 == m0).all())
            vs_gold = bool((s1[:gold_reads] == gs).all() and (m1[:gold_reads] == gm).all())
            row = dict(
                L=L, B=B, band=band, impl=impl, dp="packed" if packed else "pair",
                exact_vs_jnp=vs_jnp, exact_vs_numpy=vs_gold,
                prog_ms=timed(f_prog, *args, runs=runs) * 1e3,
                jnp_ms=timed(f_jnp, *args, runs=runs) * 1e3,
                cells=int(lens[:B].sum()) * band,
            )
            row["speedup"] = row["jnp_ms"] / row["prog_ms"]
            log(
                f"sw L={L} B={B} {row['dp']} impl={impl} exact_vs_jnp={vs_jnp} "
                f"exact_vs_numpy={vs_gold} {impl}_ms={row['prog_ms']:.3f} "
                f"jnp_ms={row['jnp_ms']:.3f} x{row['speedup']:.1f} "
                f"GCUPS={row['cells'] / row['prog_ms'] / 1e6:.1f} | {card}"
            )
            if not (vs_jnp and vs_gold):
                bad = np.flatnonzero((s1 != s0) | (m1 != m0))[:5]
                raise AssertionError(
                    f"banded SW mismatch at L={L} B={B}: rows {bad.tolist()} "
                    f"prog={list(zip(s1[bad], m1[bad]))} jnp={list(zip(s0[bad], m0[bad]))} "
                    f"numpy={list(zip(gs, gm))} prog[:n]={list(zip(s1[:gold_reads], m1[:gold_reads]))}"
                )
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# row sorts (lookup compaction, chain voting)
# ---------------------------------------------------------------------------

def phase_sorts(rng, B: int = 2048, runs: int = 5, card="") -> list[dict]:
    """The two row sorts of the classify step at their real shapes,
    checked against numpy and timed on the card."""
    import jax
    import jax.numpy as jnp

    from monica_tpu.ops import chain as ch
    from monica_tpu.ops import lookup as lk

    rows = []
    # lookup compaction: (B, n_slots, ROW_SLOTS) u32 rows -> the
    # anchors_per_seed largest, descending; beside XLA's sort of the rows
    A = 2
    f = jax.jit(lambda x: lk.compact_rows(x, A))
    f_sort = jax.jit(lambda x: jnp.flip(jnp.sort(x, axis=-1), axis=-1)[..., :A])
    for S in (128, 64, 96):
        x = rng.integers(1, 1 << 32, size=(B, S, lk.ROW_SLOTS), dtype=np.uint64).astype(np.uint32)
        x[rng.random(x.shape) < 0.8] = 0
        got = np.asarray(f(jnp.asarray(x)))
        ok = bool((got == -np.sort(-x.astype(np.int64), axis=-1)[..., :A]).all())
        ms = timed(f, jnp.asarray(x), runs=runs) * 1e3
        sort_ms = timed(f_sort, jnp.asarray(x), runs=runs) * 1e3
        log(
            f"sort lookup-compaction B={B} n_slots={S} top{A}_of_{lk.ROW_SLOTS} exact={ok} "
            f"prog_ms={ms:.3f} xla_sort_ms={sort_ms:.3f} | {card}"
        )
        rows.append(dict(kind="lookup", B=B, width=S * lk.ROW_SLOTS, exact=ok, ms=ms, sort_ms=sort_ms))
        if not ok:
            raise AssertionError(f"lookup compaction differs from numpy at n_slots={S}")
    # chain voting: (B, n_slots * anchors_per_seed) int32 keys
    for A in (256, 128):
        k = rng.integers(0, 1 << 25, size=(B, A)).astype(np.int32)
        k[rng.random(k.shape) < 0.5] = lk.INVALID_KEY
        f = jax.jit(ch.sort_keys)
        got = np.asarray(f(jnp.asarray(k)))
        ok = bool((got == np.sort(k, axis=-1)).all())
        ms = timed(f, jnp.asarray(k), runs=runs) * 1e3
        log(f"sort chain-votes B={B} A={A} exact={ok} ms={ms:.3f} | {card}")
        rows.append(dict(kind="chain", B=B, width=A, exact=ok, ms=ms))
        if not ok:
            raise AssertionError(f"chain key sort differs from numpy at A={A}")
    return rows


# ---------------------------------------------------------------------------
# the data: a Zymo-like community, its offline NCBI, simulated flowcells
# ---------------------------------------------------------------------------

# ZymoBIOMICS Microbial Community Standard (D6300): 8 bacteria + 2 yeasts,
# in evaluation.zymo_community's order (8 × 5 Mb, then 2 × 12 Mb)
ZYMO = (
    "Pseudomonas aeruginosa", "Escherichia coli", "Salmonella enterica",
    "Lactobacillus fermentum", "Enterococcus faecalis", "Staphylococcus aureus",
    "Listeria monocytogenes", "Bacillus subtilis", "Saccharomyces cerevisiae",
    "Cryptococcus neoformans",
)
# (substitution, insertion, deletion) rates per basecaller profile
PROFILES = {
    "r10_sup": (0.01, 0.005, 0.005),
    "r10_fast": (0.03, 0.02, 0.02),
    "r9_hac": (0.05, 0.03, 0.03),
    "r9_old": (0.08, 0.05, 0.05),
}
SAMPLES = (("r10", "r10_fast"), ("r9old", "r9_old"), ("mixed", None))
READS_PER_FILE = 4000  # MinKNOW's default reads per FASTQ file (assumed)
MIN_LEN, MAX_LEN = 300, 40_000
# mapped-read precision floor (correct / mapped) per sample; the
# community has no shared sequence, so a wrong call is a real fault
PRECISION_FLOOR = 0.98
MIN_MAPPED = 0.5  # mapped / reads per sample, a liveness floor
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def to_str(codes: np.ndarray) -> str:
    return BASES[codes].tobytes().decode()


def read_lengths(rng, n: int, max_len: int = MAX_LEN) -> np.ndarray:
    """Log-normal read lengths (median 3 kb) clipped to [300, max_len]:
    every bucket of io/encode.py and the ultra-long window split."""
    x = np.exp(rng.normal(np.log(3000.0), 1.0, size=n))
    return np.clip(x, MIN_LEN, max_len).astype(np.int64)


def simulate_sample(rng, seqs, lengths, profile: str | None):
    """Reads of exactly ``lengths`` from random genomes (size-weighted)
    and strands; ``profile=None`` draws a profile per read."""
    from monica_tpu.evaluation import simulate_read_codes

    sizes = np.array([len(s) for s in seqs], np.float64)
    labels = rng.choice(len(seqs), size=len(lengths), p=sizes / sizes.sum())
    names = list(PROFILES)
    reads = []
    for n, g in zip(lengths, labels):
        err = PROFILES[profile or names[rng.integers(0, len(names))]]
        r = np.zeros(0, np.uint8)
        while len(r) != n:  # a fragment at a genome end can come out short
            r = simulate_read_codes(rng, seqs[g], int(n), *err, rc=bool(rng.random() < 0.5))
        reads.append(r)
    return reads, labels


def write_fastq(path, reads, labels, tag: str) -> None:
    with open(path, "w") as fh:
        for i, (r, g) in enumerate(zip(reads, labels)):
            s = to_str(r)
            fh.write(f"@{tag}_{i}_g{g}\n{s}\n+\n{'5' * len(s)}\n")


def write_world(folder, seqs, species) -> dict:
    """An offline NCBI for ``species``: taxdump, one assembly summary
    (used as both RefSeq and GenBank) and gzipped genome FASTAs served
    by URL basename — the hermetic layout of tests/test_cli.py."""
    import gzip
    from pathlib import Path

    from monica_tpu.data import tables as tb

    folder = Path(folder)
    taxdump = folder / "taxdump"
    gdir = folder / "genome_files"
    taxdump.mkdir(parents=True)
    gdir.mkdir()
    nodes, names, rows = [(1, 1), (2, 1)], {1: "root", 2: "cellular organisms"}, []
    for i, (sp, seq) in enumerate(zip(species, seqs)):
        genus_id, sp_id = 100 + 2 * i, 101 + 2 * i
        nodes += [(genus_id, 2), (sp_id, genus_id)]
        names[genus_id], names[sp_id] = sp.split(" ")[0], sp
        acc = f"GCF_{sp_id:09d}.1"
        with gzip.open(gdir / f"{acc}_x_genomic.fna.gz", "wt", compresslevel=1) as fh:
            fh.write(f">chr{i}\n{to_str(seq)}\n")
        rows.append({
            "# assembly_accession": acc, "taxid": str(sp_id), "species_taxid": str(sp_id),
            "organism_name": sp, "infraspecific_name": "strain=S1",
            "ftp_path": f"https://example.invalid/g/{acc}_x",
        })
    (taxdump / "nodes.dmp").write_text("".join(f"{c}\t|\t{p}\t|\trank\t|\n" for c, p in nodes))
    (taxdump / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for t, n in names.items())
    )
    summary = folder / "summary.tsv"
    tb.write_fixture_summary(summary, rows)
    return dict(taxdump=taxdump, summary=summary, genomes=gdir)


def routed_precision(query, species) -> dict:
    """Per sample: reads routed to mapped/ whose tax unit is the read's
    true species (the label travels in the original read id)."""
    from pathlib import Path

    out = {}
    for p in sorted((Path(query) / "mapped").glob("*.fastq")):
        n = ok = 0
        with open(p) as fh:
            for i, line in enumerate(fh):
                if i % 4:
                    continue
                tax, rid = line[1:].split()[:2]
                n += 1
                ok += tax == "_".join(species[int(rid.rsplit("_g", 1)[1])].split(" ")[:2])
        out[p.stem] = (ok, n)
    return out


# ---------------------------------------------------------------------------
# phases 3-7
# ---------------------------------------------------------------------------

def compile_counter():
    """Count backend compilations from now on: returns (count_fn, stop_fn)."""
    from jax._src import dispatch
    from jax import monitoring

    n = [0]

    def listener(event, duration, **kw):
        if event == dispatch.BACKEND_COMPILE_EVENT:
            n[0] += 1

    monitoring.register_event_duration_secs_listener(listener)
    return (lambda: n[0]), (lambda: monitoring.unregister_event_duration_listener(listener))


def phase_build(seqs, card="") -> dict:
    """Device build of one shard, checked bit for bit against the host
    build; returns the built index and the set-up times."""
    from monica_tpu.index import build as ib
    from monica_tpu.ops import lookup as lk

    t0 = time.perf_counter()
    built = ib.build_index_from_arrays(seqs, tax_units=[s.replace(" ", "_") for s in ZYMO[: len(seqs)]])
    build_s = time.perf_counter() - t0
    if not built.device:
        raise AssertionError("the single-shard build did not take the device path")
    table, tag_bits = built.device[0]
    saved = os.environ.get("MONICA_TPU_DEVICE_BUILD")
    os.environ["MONICA_TPU_DEVICE_BUILD"] = "0"
    try:
        host = ib.build_index_from_arrays(seqs)
    finally:
        if saved is None:
            del os.environ["MONICA_TPU_DEVICE_BUILD"]
        else:
            os.environ["MONICA_TPU_DEVICE_BUILD"] = saved
    h = host.shards[0]
    want = lk.build_hash_rows(h.mz_hash, h.mz_pos, h.mz_strand, tag_bits)
    same = bool(np.array_equal(np.asarray(table), want)) and bool(
        np.array_equal(built.shards[0].ref_codes, h.ref_codes)
        and np.array_equal(built.shards[0].pos_accession_id, h.pos_accession_id)
    )
    mbase = sum(len(s) for s in seqs) / 1e6
    log(f"build {mbase:.1f} Mbase 1 shard on device: {build_s:.2f}s, table {table.shape} "
        f"bit-identical to host build_hash_rows: {same} | {card}")
    if not same:
        raise AssertionError("device index table differs from the host build")
    return dict(built=built, build_s=build_s)


def phase_main(work, world, samples, species, card="") -> dict:
    """The CLI on the three flowcell files, once per count mode; checks
    the outputs and the routed reads' precision."""
    import shutil
    from pathlib import Path

    from monica_tpu import cli

    times = {}
    for mode in ("query_length", "matching"):
        q = Path(work) / f"query_{mode}"
        q.mkdir(parents=True)
        for name, (reads, labels) in samples.items():
            write_fastq(q / f"{name}.fastq", reads, labels, name)
        t0 = time.perf_counter()
        rc = cli.main([
            "--root", str(Path(work) / "root"),
            "--taxdump", str(world["taxdump"]),
            "--offline_tables", str(world["summary"]), str(world["summary"]),
            "--offline_genomes", str(world["genomes"]),
            "-q", str(q), "-G", *species, "-a", mode, "--not_auto_open_plot",
        ])
        times[mode] = time.perf_counter() - t0
        out = q / "monica_output"
        missing = [
            f for f in ("monica.dataframe", "raw_monica.dataframe", "monica.barplot.html", "metrics.json")
            if not (out / f).exists()
        ] + [d for d in ("mapped", "unmapped", "ambiguous") if not (q / d).is_dir()]
        prec = routed_precision(q, species)
        n_reads = {k: len(v[0]) for k, v in samples.items()}
        for name, (ok, n) in prec.items():
            log(f"cli -a {mode} sample {name}: mapped {n}/{n_reads[name]}, correct {ok} "
                f"(precision {ok / max(n, 1):.4f}, floor {PRECISION_FLOOR})")
        log(f"cli -a {mode}: {times[mode]:.1f}s for {sum(n_reads.values())} reads (cold, build and compile included) | {card}")
        if rc != 0 or missing:
            raise AssertionError(f"cli -a {mode}: rc={rc}, missing outputs {missing}")
        if sorted(prec) != sorted(samples):
            raise AssertionError(f"cli -a {mode}: mapped files for {sorted(prec)}, expected {sorted(samples)}")
        for name, (ok, n) in prec.items():
            if n < MIN_MAPPED * n_reads[name] or ok < PRECISION_FLOOR * n:
                raise AssertionError(f"cli -a {mode} sample {name}: {ok}/{n} correct of {n_reads[name]}")
        shutil.rmtree(q)
    return times


def bucket_batches(reads, max_batch: int = 4096):
    """The batches run_once dispatches for one sample (same plan)."""
    from monica_tpu.io import encode as enc

    return enc.bucketize_reads([to_str(r) for r in reads], max_batch=max_batch)


def _fetch(res) -> dict:
    return {k: np.asarray(getattr(res, k)) for k in ("status", "acc_id", "mlen", "mapq", "inv_identity")}


def phase_reference(clf, samples, per_bucket: int = 8, card="") -> dict:
    """Rows of every bucket classified on the CPU backend with the jnp
    DP beside the program's own result on the default device; status,
    accession and count vectors must agree read for read, except reads
    whose float32 mapq or alignment identity sits within 1e-5 of a gate.

    There is no matrix product in the pipeline, so TF32 cannot enter;
    only log/exp in mapq and identity may round differently."""
    import jax

    from monica_tpu.align import pipeline as pl
    from monica_tpu.io import encode as enc

    cpu = jax.devices("cpu")[0]
    idx_cpu = jax.device_put(clf.index, cpu)
    by_bucket: dict[int, list] = {}
    for reads, _ in samples.values():
        for b in bucket_batches(reads):
            got = _fetch(clf.classify(b.codes, b.lengths)[0])
            take = np.arange(min(per_bucket, len(b)))
            by_bucket.setdefault(b.bucket_len, []).append(
                (b.codes[take], b.lengths[take], {k: v[take] for k, v in got.items()})
            )
    mode = clf.count_mode
    n_rows = n_same = 0
    near_gate = []
    for L, parts in sorted(by_bucket.items()):
        codes = np.concatenate([p[0] for p in parts])
        lengths = np.concatenate([p[1] for p in parts])
        dev = {k: np.concatenate([p[2][k] for p in parts]) for k in parts[0][2]}
        params = pl.params_for_bucket(clf.params, L)._replace(extend_impl="jnp")
        with jax.default_device(cpu):
            res, _ = pl.classify_batch_packed(
                idx_cpu, jax.device_put(enc.pack_codes_2bit(codes), cpu),
                jax.device_put(lengths, cpu), L, params, clf.meta.n_accessions, mode,
            )
        ref = _fetch(res)
        diff = (dev["status"] != ref["status"]) | (dev["acc_id"] != ref["acc_id"]) | (dev["mlen"] != ref["mlen"])
        gate = np.zeros(len(lengths), bool)
        for key, limit in (("mapq", params.mapping_quality), ("inv_identity", params.rescue_nm_rate)):
            for side in (dev, ref):
                gate |= np.abs(side[key] - limit) <= 1e-5
        for i in np.flatnonzero(diff):
            log(f"  reference differs L={L} row {i}: device {[(k, dev[k][i]) for k in dev]} "
                f"cpu {[(k, ref[k][i]) for k in ref]} near_gate={bool(gate[i])}")
            if gate[i]:
                near_gate.append((L, int(i)))
        bad = diff & ~gate
        value = np.ones_like(lengths) if mode == pl.MODE_BASIC else lengths if mode == pl.MODE_QUERY_LENGTH else None

        def counts(r):
            v = value if value is not None else r["mlen"]
            c = np.zeros(clf.meta.n_accessions, np.int64)
            m = (r["status"] == pl.MAPPED) & ~gate
            np.add.at(c, r["acc_id"][m], v[m])
            return c

        same_counts = bool(np.array_equal(counts(dev), counts(ref)))
        log(f"reference L={L} rows={len(lengths)} identical={int((~diff).sum())} near_gate={int((diff & gate).sum())} "
            f"counts_identical={same_counts} mapped={int((dev['status'] == pl.MAPPED).sum())}")
        if bad.any() or not same_counts:
            raise AssertionError(f"device and CPU reference disagree in bucket {L}")
        n_rows += len(lengths)
        n_same += int((~diff).sum())
    mode_name = {v: k for k, v in pl.COUNT_MODES.items()}[mode]
    log(f"reference ({mode_name}): "
        f"{n_same}/{n_rows} rows identical to the CPU jnp reference, {len(near_gate)} within 1e-5 of a gate | {card}")
    return dict(rows=n_rows, identical=n_same, near_gate=near_gate)


def gut_community(rng, n_genomes: int = 200, size: int = 1_500_000):
    """bench.py --gut: 200 × 1.5 Mb = 300 Mbase, 5 shards at the cap."""
    return [rng.integers(0, 4, size=size).astype(np.uint8) for _ in range(n_genomes)]


def multishard_samples(rng, seqs, n_reads: int, n_files: int = 1):
    lengths = read_lengths(rng, n_reads, max_len=4096)
    lengths = np.maximum(lengths, 1025)  # buckets 2048 and 4096: two shapes
    return {f"gut{i}": simulate_sample(rng, seqs, lengths, "r10_fast") for i in range(n_files)}


def run_samples(clf, work, name, samples):
    """run_once on freshly written files; returns (reports, count state,
    query dir, seconds)."""
    from pathlib import Path

    from monica_tpu.align import runtime as rt
    from monica_tpu.stats.abundance import AbundanceState

    q = Path(work) / name
    q.mkdir(parents=True)
    for s, (reads, labels) in samples.items():
        write_fastq(q / f"{s}.fastq", reads, labels, s)
    t0 = time.perf_counter()
    reports = rt.run_once(clf, q, q / "out")
    dt = time.perf_counter() - t0
    return reports, AbundanceState.load(q / "out", clf.meta.n_accessions), q, dt


def phase_multishard(rng, work, seqs, n_reads: int, card="") -> dict:
    from monica_tpu.align import runtime as rt
    from monica_tpu.index.build import build_index_from_arrays

    t0 = time.perf_counter()
    built = build_index_from_arrays(seqs, n_shards=5)
    build_s = time.perf_counter() - t0
    clf = rt.Classifier(built)
    if not isinstance(clf.index, tuple):
        raise AssertionError("a multi-shard index must take the grouped path")
    samples = multishard_samples(rng, seqs, n_reads)
    reports, state, q, dt = run_samples(clf, work, "gut_query", samples)
    (ok, m), = routed_precision(q, built.meta.tax_units).values()
    n = sum(r.n_reads for r in reports)
    log(f"multi-shard: {sum(len(s) for s in seqs) / 1e6:.0f} Mbase in {len(built.shards)} shards "
        f"({len(clf.index)} size groups), build {build_s:.1f}s; run_once {n} reads, {m} mapped, "
        f"{ok} correct, {dt:.1f}s (cold) | {card}")
    if len(built.shards) < 3 or m < MIN_MAPPED * n or ok < PRECISION_FLOOR * m:
        raise AssertionError("multi-shard phase: too few shards, mapped or correct reads")
    return dict(built=built, clf=clf, samples=samples)


def phase_steady(clf, work, samples, card="") -> dict:
    """run_once on new files of the same shapes, counting compilations."""
    import jax

    count, stop = compile_counter()
    try:
        reports, _, _, dt = run_samples(clf, work, "steady_query", samples)
    finally:
        stop()
    n = sum(r.n_reads for r in reports)
    bases = sum(int(sum(len(r) for r in reads)) for reads, _ in samples.values())
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"steady state: run_once {n} reads, {bases} bases in {dt:.2f}s ({n / dt:.0f} reads/s, host clock, "
        f"unprofiled); compilations in window: {count()}; peak_bytes_in_use {peak} | {card}")
    if count() != 0:
        raise AssertionError(f"{count()} compilations in the steady-state window")
    return dict(seconds=dt, reads=n, compiles=count(), peak_bytes=peak)


def phase_matching_ab(built, work, samples, reps: int = 2, card="") -> dict:
    """The ``matching`` pass (SW on every read) end to end through
    run_once with the program's SW and with banded_sw_jnp: warm both,
    then time them in turns; routes and counts must agree."""
    from monica_tpu.align import pipeline as pl
    from monica_tpu.align import runtime as rt
    from monica_tpu.ops import extend as ex

    impls = (ex.resolve_impl("auto", pl.ClassifyParams().band), "jnp")
    if impls[0] == "jnp":
        log("matching pass: the program's SW is banded_sw_jnp here; nothing to compare")
        return {}
    clfs = {i: rt.Classifier(built, pl.ClassifyParams(extend_impl=i), count_mode="matching") for i in impls}
    runs = {i: [run_samples(clfs[i], work, f"ab_warm_{i}", samples)] for i in impls}
    times = {i: [] for i in impls}
    for r in range(reps):
        for i in impls:
            got = run_samples(clfs[i], work, f"ab_{i}_{r}", samples)
            times[i].append(got[3])
            runs[i].append(got)
    routes, counts = compare_runs(runs[impls[0]][-1], runs[impls[1]][-1])
    med = {i: statistics.median(t) for i, t in times.items()}
    n = sum(len(r[0]) for r in samples.values())
    log(f"matching pass, warm, {n} reads: {impls[0]} {med[impls[0]]:.3f}s ({times[impls[0]]}) vs "
        f"jnp {med['jnp']:.3f}s ({times['jnp']}), x{med['jnp'] / med[impls[0]]:.2f}; routes identical: "
        f"{routes}, counts identical: {counts} | {card}")
    if not (routes and counts):
        raise AssertionError("the matching pass differs between SW implementations")
    return med


def compare_runs(a, b) -> tuple[bool, bool]:
    """(routed files identical, count state identical) for two
    run_samples results over the same input files."""
    _, sa, qa, _ = a
    _, sb, qb, _ = b
    routes = all(
        (qa / d / f.name).read_bytes() == (qb / d / f.name).read_bytes()
        for d in ("mapped", "unmapped", "ambiguous")
        for f in sorted((qa / d).glob("*.fastq"))
    ) and all(
        sorted(p.name for p in (qa / d).glob("*.fastq")) == sorted(p.name for p in (qb / d).glob("*.fastq"))
        for d in ("mapped", "unmapped", "ambiguous")
    )
    counts = sorted(sa.samples) == sorted(sb.samples) and all(
        np.array_equal(sa.samples[k], sb.samples[k]) for k in sa.samples
    )
    return routes, counts


def run_four(rng, work, seqs, n_reads: int, card="") -> None:
    """The 5-shard index on a (data=2, index=2) mesh over four cards,
    beside the same samples on one card: routes and counts must match."""
    import jax

    from monica_tpu.align import runtime as rt
    from monica_tpu.index.build import build_index_from_arrays
    from monica_tpu.parallel import mesh as pm

    built = build_index_from_arrays(seqs, n_shards=5)
    samples = multishard_samples(rng, seqs, n_reads, n_files=2)
    mesh = pm.make_mesh(n_data=2, n_index=2, devices=jax.devices()[:4])
    one = run_samples(rt.Classifier(built), work, "one_card", samples)
    four = run_samples(rt.Classifier(built, mesh=mesh), work, "four_cards", samples)
    routes, counts = compare_runs(one, four)
    n = sum(r.n_reads for r in four[0])
    m = sum(r.n_mapped for r in four[0])
    log(f"four cards: mesh {dict(mesh.shape)}, {len(built.shards)} shards; {n} reads, {m} mapped; "
        f"one card {one[3]:.1f}s, four cards {four[3]:.1f}s (cold); per-read routes identical: {routes}, "
        f"counts identical: {counts} | {card}")
    if not (routes and counts) or m < MIN_MAPPED * n:
        raise AssertionError("the four-card mesh run differs from the one-card run")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

# full size; tests and CPU rehearsals pass smaller values
SIZES = dict(
    zymo_scale=1.0, reads_per_file=READS_PER_FILE, max_len=MAX_LEN,
    sw_lengths=SW_LENGTHS, sw_batches=SW_BATCHES, sort_batch=2048,
    gut_genomes=200, gut_size=1_500_000, gut_reads=2000, reference_rows=8,
)


def run_one_card(rng, work, card="", sizes=SIZES) -> None:
    """Phases 2-7 in order (see the module docstring)."""
    from monica_tpu.align import runtime as rt
    from monica_tpu.evaluation import zymo_community

    phase_kernels(rng, lengths=sizes["sw_lengths"], batches=sizes["sw_batches"], card=card)
    phase_sorts(rng, B=sizes["sort_batch"], card=card)

    seqs = zymo_community(rng, scale=sizes["zymo_scale"])
    built = phase_build(seqs, card=card)["built"]
    t0 = time.perf_counter()
    clf = rt.Classifier(built, count_mode="query_length")
    lengths = read_lengths(rng, sizes["reads_per_file"], max_len=sizes["max_len"])
    first = bucket_batches(simulate_sample(rng, seqs, lengths[:64], "r10_fast")[0])[0]
    clf.fetch(*clf.classify(first.codes, first.lengths))
    log(f"set-up: {time.perf_counter() - t0:.2f}s from the built index to the first classified batch "
        f"(Classifier, compile and fetch of one {first.bucket_len} bp batch) | {card}")

    samples = {name: simulate_sample(rng, seqs, lengths, prof) for name, prof in SAMPLES}
    world = write_world(os.path.join(work, "world"), seqs, ZYMO)
    phase_main(work, world, samples, list(ZYMO), card=card)
    phase_reference(clf, samples, per_bucket=sizes["reference_rows"], card=card)
    phase_reference(rt.Classifier(built, count_mode="matching"), samples,
                    per_bucket=sizes["reference_rows"], card=card)
    phase_multishard(rng, work, gut_community(rng, sizes["gut_genomes"], sizes["gut_size"]),
                     n_reads=sizes["gut_reads"], card=card)
    steady = {name: simulate_sample(rng, seqs, lengths, prof) for name, prof in SAMPLES}
    phase_steady(clf, work, steady, card=card)
    phase_matching_ab(built, work, steady, card=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every generated genome and read")
    ap.add_argument("--four", action="store_true",
                    help="run only the (data=2, index=2) four-card mesh phase and its one-card comparison")
    args = ap.parse_args(argv)

    from monica_tpu.utils.device import card_line, require_gpu

    card = card_line()
    devs = require_gpu(4 if args.four else 1, what="chip_smoke")
    import shutil
    import tempfile

    import jax

    from monica_tpu.io import native
    from monica_tpu.utils.jaxcache import enable_compilation_cache

    cache = enable_compilation_cache()
    log(f"card: {card}")
    log(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}; jax {jax.__version__}")
    log(f"native ingest library loaded: {native.available()}")
    log(f"compile cache: {cache}")
    log("no phase runs a matrix product, so TF32 cannot change a result")

    rng = np.random.default_rng(args.seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    try:
        if args.four:
            run_four(rng, work, gut_community(rng), n_reads=SIZES["gut_reads"], card=card)
        else:
            run_one_card(rng, work, card=card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.0f}s | {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if args.four else 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
