"""Seed lookup (hash-row compaction) and chain voting against plain
numpy references: duplicates, empty-slot and invalid-hash sentinels,
and seed-slot counts that are not powers of two."""

import numpy as np
import pytest

import jax.numpy as jnp

from monica_tpu.index.minimizer import INVALID_HASH
from monica_tpu.ops import chain as ch
from monica_tpu.ops import lookup as lk


@pytest.mark.parametrize("S,keep", [(128, 2), (64, 1), (96, 4)])
def test_compact_rows_is_descending_sort_prefix(S, keep):
    rng = np.random.default_rng(S)
    x = rng.integers(1, 2**32, (5, S, lk.ROW_SLOTS), dtype=np.uint64).astype(np.uint32)
    x[rng.random(x.shape) < 0.6] = 0
    x[0, 0] = 7  # a row of duplicates
    got = np.asarray(lk.compact_rows(jnp.asarray(x), keep))
    np.testing.assert_array_equal(got, np.sort(x, axis=-1)[..., ::-1][..., :keep])


def _np_lookup(rows, qh, qp, qs, qv, tag_bits, L, A):
    B, S = qh.shape
    rbits = int(np.log2(rows.shape[0]))
    pb = 32 - tag_bits
    pmask = (1 << pb) - 1
    width = A if 0 < A < lk.ROW_SLOTS else lk.ROW_SLOTS
    out = [np.zeros((B, S, width), np.int64) for _ in range(4)]
    for b in range(B):
        for s in range(S):
            h = int(qh[b, s])
            e = [int(v) for v in rows[h >> (32 - rbits)]]
            ok = bool(qv[b, s]) and h != int(INVALID_HASH)
            hit = [ok and (v >> pb) == (h & ((1 << tag_bits) - 1)) and (v & pmask) != 0 for v in e]
            if width < lk.ROW_SLOTS:  # compaction: the A largest hits, descending
                e = sorted((v for v, k in zip(e, hit) if k), reverse=True)
                e = (e + [0] * width)[:width]
                hit = [v != 0 for v in e]
            for a in range(width):
                ps = e[a] & pmask  # a non-hit keeps its raw payload (0 once compacted)
                rc = bool(qs[b, s]) ^ bool(ps & 1)
                d = (ps >> 1) + int(qp[b, s]) if rc else (ps >> 1) - int(qp[b, s])
                out[0][b, s, a] = ((int(rc) << 24) | ((d + L) >> lk.DIAG_SHIFT)) if hit[a] else int(lk.INVALID_KEY)
                out[1][b, s, a] = d
                out[2][b, s, a] = qp[b, s]
                out[3][b, s, a] = ps >> 1
    return [o.reshape(B, S * width) for o in out]


@pytest.mark.parametrize("A", [2, 0])
def test_lookup_anchors_matches_numpy(A):
    rng = np.random.default_rng(11 + A)
    tag_bits, rbits, B, S, L = 6, 6, 3, 96, 1024
    rows = rng.integers(1, 2**32, (1 << rbits, lk.ROW_SLOTS), dtype=np.uint64).astype(np.uint32)
    rows[rng.random(rows.shape) < 0.3] = 0  # empty slots
    qh = rng.integers(0, 2**32, (B, S), dtype=np.uint64).astype(np.uint32)
    # half the seeds hit: copy a stored entry's tag into the query hash
    for b in range(B):
        for s in range(0, S, 2):
            r = int(qh[b, s]) >> (32 - rbits)
            v = int(rows[r, s % lk.ROW_SLOTS])
            tag = v >> (32 - tag_bits)
            qh[b, s] = (r << (32 - rbits)) | tag
            rows[r, (s + 3) % lk.ROW_SLOTS] = v  # a duplicate entry in the row
    qh[0, :4] = INVALID_HASH
    qp = rng.integers(0, L - 15, (B, S)).astype(np.int32)
    qs = rng.random((B, S)) < 0.5
    qv = rng.random((B, S)) < 0.9
    got = lk.lookup_anchors(jnp.asarray(rows), jnp.asarray(qh), jnp.asarray(qp), jnp.asarray(qs),
                            jnp.asarray(qv), tag_bits=tag_bits, bucket_len=L, anchors_per_seed=A)
    want = _np_lookup(rows, qh, qp, qs, qv, tag_bits, L, A)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w)
    assert (np.asarray(got[0]) != lk.INVALID_KEY).sum() > B  # anchors were found


def _np_chain(key, diag, rpos, fpos, max_run):
    B, A = key.shape
    out = {k: np.zeros(B, np.int64) for k in ("f1", "f2", "best_key", "rep_diag", "rep_read_pos", "rep_ref_pos", "rep2_ref_pos")}
    for b in range(B):
        sk = np.sort(key[b]).astype(np.int64)
        valid = sk != int(lk.INVALID_KEY)
        merged = np.zeros(A, np.int64)
        for i in range(A):
            n = 1
            while n < min(max_run, A) and i + n < A and sk[i + n] in (sk[i], sk[i] + 1):
                n += 1
            merged[i] = n if valid[i] else 0
        bi = int(np.argmax(merged))
        bk = sk[bi]
        f2m = np.where(valid & (np.abs(sk - bk) > 1), merged, 0)
        si = int(np.argmax(f2m))

        def rep(k):
            loc = (key[b] == k) | (key[b] == k + 1)
            i = int(np.argmin(np.where(loc, rpos[b], 1 << 30)))
            return diag[b, i], rpos[b, i], fpos[b, i]

        out["f1"][b], out["f2"][b], out["best_key"][b] = merged[bi], f2m[si], bk
        out["rep_diag"][b], out["rep_read_pos"][b], out["rep_ref_pos"][b] = rep(bk)
        out["rep2_ref_pos"][b] = rep(sk[si])[2]
    out["rc"] = (out["best_key"] >> 24) > 0
    return out


@pytest.mark.parametrize("A,max_run", [(256, 64), (96, 128)])
def test_chain_votes_matches_numpy(A, max_run):
    rng = np.random.default_rng(A)
    B = 6
    key = rng.integers(0, 40, (B, A)).astype(np.int32)  # dense bins: long runs, ties
    key[1] = rng.integers(0, 3, A) | (1 << 24)  # one rc locus, runs past max_run
    key[2, :] = lk.INVALID_KEY  # no anchors at all
    key[rng.random((B, A)) < 0.3] = lk.INVALID_KEY
    diag = rng.integers(-5000, 5000, (B, A)).astype(np.int32)
    rpos = rng.integers(0, 1000, (B, A)).astype(np.int32)
    fpos = rng.integers(0, 10**6, (B, A)).astype(np.int32)
    got = ch.chain_votes(*(jnp.asarray(x) for x in (key, diag, rpos, fpos)), max_run=max_run)
    want = _np_chain(key, diag, rpos, fpos, max_run)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(getattr(got, k)).astype(np.int64), w.astype(np.int64), err_msg=k)
