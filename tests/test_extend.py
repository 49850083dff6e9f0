"""Banded Smith–Waterman extension: the jnp DP vs straightforward numpy
DP oracles, the dispatch between it and the CUDA kernel, and the kernel
itself against the jnp DP (on a GPU only)."""

import numpy as np
import pytest

import jax.numpy as jnp

from monica_tpu.ops import extend as ex


def gold_banded_sw(q, ref, diag, band, p: ex.ExtendParams):
    """O(L·W) scalar DP, same band geometry as the kernel: cell (i, d)
    aligns read base i to ref[diag - band//2 + i + d]."""
    L = len(q)
    W = band
    base = diag - W // 2
    H = np.zeros(W, np.int64)
    M = np.zeros(W, np.int64)
    best, bm = 0, 0
    for i in range(L):
        nh = np.zeros(W, np.int64)
        nm = np.zeros(W, np.int64)
        for d in range(W):
            j = base + i + d
            r = ref[j] if 0 <= j < len(ref) else 4
            is_m = q[i] == r and q[i] < 4
            sub = p.match if is_m else -p.mismatch
            cd, md = H[d] + sub, M[d] + (1 if is_m else 0)
            cu = (H[d + 1] - p.gap, M[d + 1]) if d + 1 < W else (-(1 << 30), 0)
            t, mt = (cu if cu[0] > cd else (cd, md))
            if t < 0:
                t, mt = 0, 0
            if d > 0 and nh[d - 1] - p.gap > t:
                t, mt = nh[d - 1] - p.gap, nm[d - 1]
            nh[d], nm[d] = t, mt
        H, M = nh, nm
        rb = H.max()
        if rb > best:
            best, bm = int(rb), int(M[H.argmax()])
    return best, bm


def _mutate(rng, seq, sub, ins, dele):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if r < dele + ins + sub:
            out.append((c + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(c)
    return np.asarray(out, np.uint8)


@pytest.mark.parametrize("impl", ["jnp"])
def test_banded_sw_matches_gold(impl):
    rng = np.random.default_rng(0)
    W, L = 32, 96
    p = ex.ExtendParams(band=W)
    B = 5
    ref = rng.integers(0, 4, 4000).astype(np.uint8)
    qs, diags, lens = [], [], []
    for b in range(B):
        start = int(rng.integers(0, 3000))
        ln = int(rng.integers(60, L))
        q = _mutate(rng, ref[start : start + ln], 0.05, 0.02, 0.02)[:L]
        qs.append(np.pad(q, (0, L - len(q)), constant_values=4))
        lens.append(len(q))
        diags.append(start)
    q = np.stack(qs)
    lens = np.asarray(lens, np.int32)
    diags = np.asarray(diags, np.int32)

    refwin = ex.extract_ref_windows(jnp.asarray(ref), jnp.asarray(diags), L, W)
    score, mlen = ex.banded_sw(jnp.asarray(q), refwin, jnp.asarray(lens), p, impl=impl)
    score, mlen = np.asarray(score), np.asarray(mlen)

    for b in range(B):
        gs, gm = gold_banded_sw(q[b][: lens[b]], ref, int(diags[b]), W, p)
        assert score[b] == gs, f"read {b}: score {score[b]} != gold {gs}"
        assert mlen[b] == gm, f"read {b}: mlen {mlen[b]} != gold {gm}"


def test_orient_reads_revcomp():
    codes = np.array([[0, 1, 2, 3, 4, 4]], np.uint8)  # ACGT--
    out = ex.orient_reads(jnp.asarray(codes), jnp.asarray([4]), jnp.asarray([True]))
    # revcomp(ACGT) = ACGT
    np.testing.assert_array_equal(np.asarray(out)[0, :4], [0, 1, 2, 3])
    assert np.all(np.asarray(out)[0, 4:] == 4)


def test_extend_hits_identity_perfect_vs_noisy():
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 4, 8000).astype(np.uint8)
    L, W = 128, 32
    p = ex.ExtendParams(band=W)
    start = 1000
    clean = ref[start : start + L].copy()
    noisy = _mutate(rng, clean, 0.10, 0.0, 0.0)[:L]
    q = np.stack([clean, np.pad(noisy, (0, L - len(noisy)), constant_values=4)])
    lens = np.asarray([L, len(noisy)], np.int32)
    res = ex.extend_hits(
        jnp.asarray(ref),
        jnp.asarray(q),
        jnp.asarray(lens),
        rep_ref_pos=jnp.asarray([start + 10, start + 10]),
        rep_read_pos=jnp.asarray([10, 10]),
        rc=jnp.asarray([False, False]),
        k=15,
        p=p,
        impl="jnp",
    )
    inv = np.asarray(res.inv_identity)
    assert inv[0] == 0.0  # perfect read: NM = 0
    assert inv[1] > 0.05  # 10% substitutions detected
    assert int(res.mlen[0]) == L


def _band_inputs(rng, B, L, W, short_first=True):
    """B reads of length L (the first one short) from a random reference,
    10% substitutions, with their band windows."""
    ref = rng.integers(0, 4, 50_000 + L).astype(np.uint8)
    starts = rng.integers(0, len(ref) - L - W, B)
    q = np.stack([ref[s : s + L] for s in starts])
    m = rng.random(q.shape) < 0.1
    q[m] = rng.integers(0, 4, int(m.sum()))
    lengths = np.full(B, L, np.int32)
    if short_first:
        lengths[0] = L // 3
        q[0, L // 3 :] = 4
    refwin = np.asarray(
        ex.extract_ref_windows(jnp.asarray(ref), jnp.asarray(starts.astype(np.int32)), L, W)
    )
    return q, refwin, lengths


# (B, L, band, scoring): the kernel's real shapes, odd B, short reads,
# and the pair DP — past packed_mbits at 32 kb, or at a short length by
# a match score too large for the packed int32 state
SW_CASES = [
    (7, 300, 64, {}),
    (16, 1000, 64, {}),
    (5, 64, 32, {}),
    (3, 200, 128, {"max_gap": 0}),
    (3, 300, 64, {"match": 1 << 14}),
    (2, 32768, 64, {}),
]


@pytest.mark.parametrize("B,L,W,kw", SW_CASES)
def test_banded_sw_jnp_matches_numpy_dp(B, L, W, kw):
    """banded_sw_jnp == the vectorized numpy DP of chip_smoke (packed
    and pair tie rules) at the CUDA kernel's shapes."""
    import chip_smoke

    rng = np.random.default_rng(B * L)
    p = ex.ExtendParams(band=W, **kw)
    q, refwin, lengths = _band_inputs(rng, B, L, W)
    packed = bool(ex.packed_mbits(L, p))
    assert packed == (L <= 16384 and "match" not in kw)
    s1, m1 = ex.banded_sw_jnp(jnp.asarray(q), jnp.asarray(refwin), jnp.asarray(lengths), p)
    gs, gm = chip_smoke.gold_banded_sw(q, refwin, lengths, p, packed)
    np.testing.assert_array_equal(np.asarray(s1), gs)
    np.testing.assert_array_equal(np.asarray(m1), gm)
    assert (gs[1:] > 0).all()  # the reads really align in their bands


def test_banded_sw_dispatch_by_backend(monkeypatch):
    """"auto" takes the CUDA kernel only on a GPU backend and only for
    the bands it was built for; never an interpret mode."""
    from monica_tpu.ops import sw_cuda

    assert ex.resolve_impl("auto", 64) == "jnp"  # CPU here
    assert ex.resolve_impl("jnp", 64) == "jnp"
    assert ex.resolve_impl("cuda", 64) == "cuda"
    with pytest.raises(ValueError):
        ex.resolve_impl("pallas", 64)
    monkeypatch.setattr(ex.jax, "default_backend", lambda: "gpu")
    assert ex.resolve_impl("auto", 64) == "cuda"
    assert ex.resolve_impl("auto", 48) == "jnp"
    assert all(ex.resolve_impl("auto", w) == "cuda" for w in sw_cuda.BANDS)
    # the pipeline's knob reaches the dispatch unchanged
    from monica_tpu.align import pipeline as pl

    assert pl.ClassifyParams().extend_impl == "auto"


def test_banded_sw_cuda_wrapper_contract(monkeypatch):
    """What the CUDA wrapper hands the kernel, checked without a GPU:
    pass counts, the DP choice, the band guard, and the nvcc command."""
    from monica_tpu.ops import sw_cuda

    assert [ex.prefix_passes(ex.ExtendParams(band=64, max_gap=g)) for g in (1, 2, 16, 17, 0)] == [0, 1, 4, 5, 6]
    p = ex.ExtendParams(band=64)
    assert ex.packed_mbits(16384, p) == 15 and ex.packed_mbits(32768, p) == 0
    with pytest.raises(ValueError):
        sw_cuda.banded_sw_cuda(jnp.zeros((2, 8), jnp.uint8), jnp.zeros((2, 56), jnp.uint8),
                               jnp.zeros(2, jnp.int32), ex.ExtendParams(band=48), 4, 4)
    monkeypatch.setattr(sw_cuda, "_nvcc", lambda: "nvcc")
    cmd = sw_cuda._command(sw_cuda.library_path())
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd and ex.jax.ffi.include_dir() in cmd
    assert sw_cuda.library_path().name.startswith("_libbanded_sw-")
    assert sw_cuda.library_path().suffix == ".so"  # git-ignored build output


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,W,kw", SW_CASES)
def test_banded_sw_cuda_matches_jnp(gpu_device, B, L, W, kw):
    """The CUDA kernel computes the jnp DP's integers exactly."""
    import jax

    rng = np.random.default_rng(B + L)
    p = ex.ExtendParams(band=W, **kw)
    q, refwin, lengths = _band_inputs(rng, B, L, W)
    args = [jax.device_put(a, gpu_device) for a in (q, refwin, lengths)]
    s1, m1 = ex.banded_sw(*args, p, impl="cuda")
    s0, m0 = ex.banded_sw_jnp(*[jnp.asarray(a) for a in (q, refwin, lengths)], p)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m0))
