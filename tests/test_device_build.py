"""Device-side index sketch+sort (VERDICT r4 item 4).

``build._device_sketch_sort`` must be BIT-IDENTICAL to the host path
(chunked numpy sketch + stable argsort): same selected minimizer set,
same (hash, position, strand) triples, same order.  Run here on the
jax-CPU backend — integer ops are exact on every backend, so CPU
equality transfers to the GPU.
"""

import numpy as np
import pytest

from monica_tpu.index import build as ib
from monica_tpu.index import minimizer as mz


def _host_sorted(codes, k, w, frac):
    h, pos, strand = ib.sketch_long_sequence(codes, k, w, frac=frac)
    order = np.argsort(h, kind="stable")
    return h[order], pos[order], strand[order]


@pytest.mark.parametrize("n", [ib._DEV_SEG // 2, ib._DEV_SEG + 12_345])
def test_device_sketch_sort_bit_identical(n):
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    k, w, frac = mz.K_DEFAULT, mz.W_DEFAULT, mz.FRAC_DEFAULT
    dev = ib._device_sketch_sort(codes, k, w, frac)
    assert dev is not None
    hh, pp, ss = dev
    gh, gp, gs = _host_sorted(codes, k, w, frac)
    assert len(hh) == len(gh)
    np.testing.assert_array_equal(hh, gh)
    np.testing.assert_array_equal(pp, gp)
    np.testing.assert_array_equal(ss, gs)


def test_device_build_shard_matches_host(monkeypatch):
    """Whole-shard equality through _build_shard with the device path
    forced on (env override), including the occ-cap filter."""
    rng = np.random.default_rng(22)
    seqs = [rng.integers(0, 4, 1 << 21).astype(np.uint8) for _ in range(2)]
    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "1")
    a = ib.build_index_from_arrays(seqs)
    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "0")
    b = ib.build_index_from_arrays(seqs)
    for sa, sb in zip(a.shards, b.shards):
        np.testing.assert_array_equal(sa.mz_hash, sb.mz_hash)
        np.testing.assert_array_equal(sa.mz_pos, sb.mz_pos)
        np.testing.assert_array_equal(sa.mz_strand, sb.mz_strand)
        np.testing.assert_array_equal(sa.ref_codes, sb.ref_codes)


def test_device_hash_table_bit_identical():
    """The fully device-resident table (_device_hash_table: occ-cap run
    filter + row fill on device) equals the host pipeline
    (occ filter -> ops.lookup.build_hash_rows) bit for bit."""
    from monica_tpu.ops import lookup as lk

    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, (1 << 21) + 777).astype(np.uint8)
    k, w, frac = mz.K_DEFAULT, mz.W_DEFAULT, mz.FRAC_DEFAULT
    occ_cap = ib.OCC_CAP

    got = ib._device_sketch_sort_arrays(codes, k, w, frac)
    assert got is not None
    h_dev, ps_dev, total = got
    tag_bits = lk.tag_bits_for(len(codes))
    table_dev, n_kept = ib._device_hash_table(
        h_dev, ps_dev, total, tag_bits, occ_cap
    )

    h, p, s = _host_sorted(codes, k, w, frac)
    starts = np.flatnonzero(np.concatenate([[True], h[1:] != h[:-1]]))
    runlen = np.diff(np.concatenate([starts, [len(h)]]))
    keep = np.repeat(runlen <= occ_cap, runlen)
    h, p, s = h[keep], p[keep], s[keep]
    assert n_kept == len(h)
    table_host = lk.build_hash_rows(h, p.astype(np.int32), s, tag_bits)
    np.testing.assert_array_equal(np.asarray(table_dev), table_host)


def test_classifier_on_device_build_matches_host_build(monkeypatch):
    """End to end: classification through a device-resident build equals
    classification through the host build (runtime.Classifier picks the
    device table when BuiltIndex.device is set)."""
    import jax.numpy as jnp

    from monica_tpu.align import pipeline as pl, runtime as rt
    from monica_tpu.evaluation import simulate_read_codes

    rng = np.random.default_rng(24)
    seqs = [rng.integers(0, 4, 1 << 21).astype(np.uint8) for _ in range(2)]
    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "1")
    dev_built = ib.build_index_from_arrays(seqs)
    assert dev_built.device is not None
    monkeypatch.setenv("MONICA_TPU_DEVICE_BUILD", "0")
    host_built = ib.build_index_from_arrays(seqs)
    assert host_built.device is None

    n, L = 128, 800
    codes = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        r = simulate_read_codes(
            rng, seqs[i % 2], L, 0.03, 0.02, 0.02, bool(i % 4 == 0)
        )
        codes[i, : len(r)] = r
        lens[i] = len(r)
    outs = []
    for built in (dev_built, host_built):
        clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="basic")
        res, counts = clf.classify(codes, lens)
        outs.append(clf.fetch(res, counts))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_table_occ_cap_zero_disables_filter():
    """occ_cap=0 means 'filter disabled' (host path's `if occ_cap`
    guard) — the device table must keep every minimizer, not drop all
    of them (r5 review finding)."""
    import jax.numpy as jnp

    from monica_tpu.ops import lookup as lk

    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, 1 << 18).astype(np.uint8)
    got = ib._device_sketch_sort_arrays(
        codes, mz.K_DEFAULT, mz.W_DEFAULT, mz.FRAC_DEFAULT
    )
    h_dev, ps_dev, total = got
    tag_bits = lk.tag_bits_for(len(codes))
    table, n_kept = ib._device_hash_table(h_dev, ps_dev, total, tag_bits, 0)
    assert n_kept == total
    assert int((np.asarray(table) != 0).sum()) > 0


def test_device_table_pad_does_not_merge_max_hash_run():
    """A real minimizer whose hash is exactly 0xFFFFFFFF sorts beside
    the pad entries; the run-length filter must not merge them and drop
    the real entry (r5 review finding)."""
    import jax.numpy as jnp

    # handcrafted sorted arrays: 3 real entries (last hash = max), 5 pads
    h = jnp.asarray(
        np.array([10, 20, 0xFFFFFFFF] + [0xFFFFFFFF] * 5, np.uint32)
    )
    ps = jnp.asarray(
        np.array([2, 4, 6] + [0xFFFFFFFF] * 5, np.uint32)
    )
    keep, n_kept = ib._jit_kept_count(4)(h, ps, 3)
    assert int(n_kept) == 3, np.asarray(keep)


def test_full_mode_single_anchor_rescue_matches_rescue_mode():
    """matching mode (extend_mode='full') must apply the same
    rescue_min_votes candidacy as the budgeted rescue path, so routes
    agree across count modes (r5 review finding)."""
    from monica_tpu.align import pipeline as pl, runtime as rt
    from monica_tpu.evaluation import simulate_read_codes

    rng = np.random.default_rng(41)
    seqs = [rng.integers(0, 4, 120_000).astype(np.uint8) for _ in range(2)]
    built = ib.build_index_from_arrays(seqs)
    n, L = 256, 400
    codes = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        r = simulate_read_codes(
            rng, seqs[i % 2], L, 0.08, 0.05, 0.05, bool(i % 3 == 0)
        )
        codes[i, : len(r)] = r
        lens[i] = len(r)
    statuses = {}
    for mode in ("basic", "matching"):
        clf = rt.Classifier(built, pl.ClassifyParams(), count_mode=mode)
        res, counts = clf.classify(codes, lens)
        st, ac, _, _ = clf.fetch(res, counts)
        statuses[mode] = (st.copy(), ac.copy())
    # identical routing decisions between the rescue and full paths at
    # r9_old error rates, where single-anchor rescue carries the load
    np.testing.assert_array_equal(statuses["basic"][0], statuses["matching"][0])
    np.testing.assert_array_equal(statuses["basic"][1], statuses["matching"][1])


def test_gz_size_estimate_triggers_chunking(tmp_path):
    """A small-on-disk gzipped file whose decompressed size exceeds the
    residency budget must take the chunked path (r5 review finding)."""
    import gzip

    from monica_tpu.align import pipeline as pl, runtime as rt
    from monica_tpu.io import native
    from monica_tpu.stats.abundance import AbundanceState

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(42)
    seqs = [rng.integers(0, 4, 40_000).astype(np.uint8)]
    built = ib.build_index_from_arrays(seqs, tax_units=["Only_sp"])
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode="basic")
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    lines = []
    for i in range(60):
        s = int(rng.integers(0, 39_000))
        seq = lut[seqs[0][s : s + 600]].tobytes().decode()
        lines.append(f"@r{i} z\n{seq}\n+\n{'I'*600}\n")
    raw = "".join(lines).encode()
    gz = tmp_path / "s.fastq.gz"
    gz.write_bytes(gzip.compress(raw))
    folders = rt.RouteFolders.create(tmp_path, with_focus=False)
    state = AbundanceState(built.meta.n_accessions)
    # budget between compressed size and 6x-estimated size -> only the
    # gz multiplier can trigger chunking
    budget = gz.stat().st_size * 3
    rep = rt.process_sample(
        clf, gz, folders, state, delete=True,
        max_resident_bytes=budget, chunk_bytes=1 << 13,
    )
    assert rep.n_reads == 60 and rep.n_mapped == 60


def test_homopolymer_overflow_falls_back():
    """An adversarial all-ties reference overflows the per-segment
    compaction capacity; _device_sketch_sort must signal fallback
    (None), never truncate silently."""
    codes = np.zeros(1 << 22, np.uint8)  # one giant homopolymer
    out = ib._device_sketch_sort(
        codes, mz.K_DEFAULT, mz.W_DEFAULT, mz.FRAC_DEFAULT
    )
    assert out is None
