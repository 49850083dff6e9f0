import numpy as np
import pytest

from monica_tpu.io.encode import encode_seq, revcomp_codes
from monica_tpu.index import minimizer as mz
from tests.fixtures import random_genome, revcomp


def brute_force_winnow(h: np.ndarray, w: int) -> set[int]:
    """Positions that are the min of at least one full-or-partial window."""
    m = len(h)
    sel = set()
    for j in range(m):  # window start (allow partial tail windows, as impl does)
        window = h[j : j + w]
        lo = window.min()
        if lo == mz.INVALID_HASH:
            continue
        for off in np.nonzero(window == lo)[0]:
            sel.add(j + int(off))
    return sel


def test_kmer_hashes_strand_canonical():
    rng = np.random.default_rng(0)
    seq = random_genome(rng, 300)
    codes = encode_seq(seq)
    codes_rc = encode_seq(revcomp(seq))
    h, _ = mz.kmer_hashes(codes[None], k=15, xp=np)
    h_rc, _ = mz.kmer_hashes(codes_rc[None], k=15, xp=np)
    # canonical hashing: the multiset of hashes is strand-invariant,
    # position i on fwd == position m-1-i on rc
    assert np.array_equal(h[0], h_rc[0][::-1])


def test_kmer_hashes_masks_N():
    seq = "ACGT" * 10 + "N" + "ACGT" * 10
    codes = encode_seq(seq)
    h, _ = mz.kmer_hashes(codes[None], k=15, xp=np)
    n_pos = 40
    for i in range(len(h[0])):
        covers_n = i <= n_pos <= i + 14
        if covers_n:
            assert h[0][i] == mz.INVALID_HASH


def test_select_minimizers_matches_bruteforce():
    rng = np.random.default_rng(1)
    for trial in range(5):
        seq = random_genome(rng, 500)
        codes = encode_seq(seq)
        h, _ = mz.kmer_hashes(codes[None], k=15, xp=np)
        keep = mz.select_minimizers(h, w=10, xp=np)
        got = set(np.nonzero(keep[0])[0].tolist())
        want = brute_force_winnow(h[0], 10)
        assert got == want


def test_sketch_density():
    # expected winnowing density ~ 2/(w+1)
    rng = np.random.default_rng(2)
    seq = random_genome(rng, 20000)
    hashes, pos, strand = mz.sketch_sequence_np(encode_seq(seq))
    density = len(pos) / len(seq)
    assert 0.1 < density < 0.3


def test_index_and_read_sketches_agree():
    """Minimizers of an exact substring must appear in the genome sketch."""
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 5000)
    g_hashes, g_pos, g_strand = mz.sketch_sequence_np(encode_seq(genome))
    read = genome[1000:2000]
    r_hashes, r_pos, r_strand = mz.sketch_sequence_np(encode_seq(read))
    genome_set = set(g_hashes.tolist())
    in_genome = sum(1 for h in r_hashes.tolist() if h in genome_set)
    # interior minimizers of the read are minimizers of the genome too;
    # only boundary-window effects may differ
    assert in_genome / len(r_hashes) > 0.85


def test_jax_matches_numpy():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    seqs = [random_genome(rng, 256) for _ in range(4)]
    codes = np.stack([encode_seq(s) for s in seqs])
    h_np, keep_np, s_np = mz.sketch_array(codes, xp=np)
    h_j, keep_j, s_j = mz.sketch_array(jnp.asarray(codes), xp=jnp)
    assert np.array_equal(h_np, np.asarray(h_j))
    assert np.array_equal(keep_np, np.asarray(keep_j))
    assert np.array_equal(s_np, np.asarray(s_j))


def test_sketch_reads_jax_slots():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    seqs = [random_genome(rng, 512) for _ in range(3)]
    codes = np.stack([encode_seq(s) for s in seqs])
    n_slots = 64  # segment length ~ 8 kmers
    hh, pos, ss, valid = mz.sketch_reads_jax(jnp.asarray(codes), n_slots)
    assert hh.shape == (3, n_slots)
    h_np, keep_np, s_np = mz.sketch_array(codes, xp=np)
    m = h_np.shape[1]
    seg = -(-m // n_slots)
    n_valid = 0
    for b in range(3):
        for j in range(n_slots):
            if not bool(valid[b, j]):
                continue
            n_valid += 1
            p = int(pos[b, j])
            # slot holds a true minimizer of its own segment, with the
            # segment-minimal hash
            assert j * seg <= p < (j + 1) * seg
            assert keep_np[b, p]
            assert h_np[b, p] == int(np.asarray(hh)[b, j])
            seg_keys = np.where(
                keep_np[b, j * seg : (j + 1) * seg],
                h_np[b, j * seg : (j + 1) * seg],
                mz.INVALID_HASH,
            )
            assert int(np.asarray(hh)[b, j]) == int(seg_keys.min())
            assert bool(ss[b, j]) == bool(s_np[b, p])
    # winnowing guarantees most segments populated
    assert n_valid > 3 * n_slots * 0.6


def test_segment_min_selection_equals_winnow_path():
    """sketch_reads_jax's fast path (seg >= w: skip the winnowing mask)
    must select BIT-IDENTICAL slots to the winnow-then-argmin path —
    the segment argmin is provably a w-window minimum."""
    import jax.numpy as jnp

    from monica_tpu.index import minimizer as mz

    rng = np.random.default_rng(50)
    for L, n_slots in [(1024, 64), (2048, 64), (4096, 64)]:
        codes = rng.integers(0, 4, (16, L)).astype(np.uint8)
        codes[0, 100:130] = 4  # an N stretch
        codes[1, -40:] = 4     # padded tail
        h, keep, s = mz.sketch_array(codes, mz.K_DEFAULT, mz.W_DEFAULT, jnp)
        B, m = h.shape
        seg = -(-m // n_slots)
        assert seg >= mz.W_DEFAULT  # fast path engaged

        # reference: the explicit winnow-mask path
        key = jnp.where(keep, h, jnp.uint32(mz.INVALID_HASH))
        pad = seg * n_slots - m
        if pad:
            key = jnp.concatenate(
                [key, jnp.full((B, pad), mz.INVALID_HASH, key.dtype)], axis=-1
            )
        key3 = key.reshape(B, n_slots, seg)
        ref_h = np.asarray(jnp.min(key3, axis=-1))
        ref_off = np.asarray(jnp.argmin(key3, axis=-1))
        ref_pos = np.minimum(
            ref_off + np.arange(n_slots)[None, :] * seg, m - 1
        )

        hh, pos, ss, valid = mz.sketch_reads_jax(codes, n_slots)
        got_h = np.asarray(hh)
        got_valid = np.asarray(valid)
        ref_valid = ref_h != mz.INVALID_HASH
        assert np.array_equal(got_valid, ref_valid)
        assert np.array_equal(got_h[got_valid], ref_h[ref_valid])
        assert np.array_equal(np.asarray(pos)[got_valid], ref_pos[ref_valid])


def test_sketch_long_sequence_short_inputs():
    """Sequences barely longer than k (m < w) must sketch, not crash:
    _shift_fill past the array width now yields an all-fill array
    (review r4 finding; previously a numpy broadcast ValueError)."""
    from monica_tpu.index.build import sketch_long_sequence

    rng = np.random.default_rng(60)
    for n in (15, 16, 18, 20, 24, 40):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        h, p, s = sketch_long_sequence(codes, 15, 10)
        assert len(h) == len(p) == len(s)
        if n >= 15:
            assert len(h) >= 1  # at least one window minimum survives
