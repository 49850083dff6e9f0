// Banded Smith–Waterman for NVIDIA Hopper, called from JAX through the
// XLA FFI (monica_tpu/ops/sw_cuda.py builds and registers it).
//
// Same recurrence, scoring and tie rules as ops/extend.py banded_sw_jnp,
// which is the reference this kernel is tested against:
//
// * one warp per read; the W-cell band (W = 32 * CPT) is spread over the
//   warp's lanes, CPT consecutive cells per lane;
// * the whole row loop runs inside the kernel with the DP state in
//   registers — nothing is carried between blocks;
// * the vertical shift (cell d reads d+1 of the previous row) and the
//   windowed horizontal prefix max (NPASS doubling passes) are warp
//   shuffles;
// * read and reference-window bytes are staged through shared memory in
//   chunks of kChunk rows;
// * rows stop at each read's own length (rows past it never raise the
//   best cell), so a bucket's padding costs nothing.
//
// Two state layouts, chosen by the caller exactly as banded_sw_jnp does:
// packed (score << mbits | mlen in one int32, reads up to ~16 kb) and the
// (score, mlen) pair DP beyond.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 20);  // ops/extend.py NEG
constexpr int kChunk = 256;       // rows staged in shared memory per refill
constexpr int kWarps = 4;         // reads per block

struct Scoring {
  int match, mismatch, gap, mbits;
};

// y[d] = x[d - S], `fill` where d < S.  Cell d lives in lane d / CPT,
// register d % CPT.
template <int CPT, int S>
__device__ __forceinline__ void shift_right(const int (&x)[CPT], int (&y)[CPT],
                                            int fill, int lane) {
  if constexpr (S < CPT) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (j >= S) {
        y[j] = x[(j - S + CPT) % CPT];
      } else {
        int v = __shfl_up_sync(kFull, x[(j - S + CPT) % CPT], 1);
        y[j] = lane >= 1 ? v : fill;
      }
    }
  } else {
    constexpr int D = S / CPT;  // both powers of two
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      int v = __shfl_up_sync(kFull, x[j], D);
      y[j] = lane >= D ? v : fill;
    }
  }
}

// y[d] = x[d + 1], `fill` at d = W - 1.
template <int CPT>
__device__ __forceinline__ void shift_left1(const int (&x)[CPT], int (&y)[CPT],
                                            int fill, int lane) {
  int v = __shfl_down_sync(kFull, x[0], 1);
#pragma unroll
  for (int j = 0; j + 1 < CPT; ++j) y[j] = x[j + 1];
  y[CPT - 1] = lane < 31 ? v : fill;
}

// Windowed prefix max of packed values: passes s = 1, 2, ..., 2^(NPASS-1).
template <int CPT, int P, int NPASS>
__device__ __forceinline__ void prefix_max(int (&u)[CPT], int lane) {
  if constexpr (P < NPASS) {
    int pu[CPT];
    shift_right<CPT, (1 << P)>(u, pu, kNeg, lane);
#pragma unroll
    for (int j = 0; j < CPT; ++j) u[j] = max(u[j], pu[j]);
    prefix_max<CPT, P + 1, NPASS>(u, lane);
  }
}

// Pair version: the value moves with its argmax; ties keep the nearer cell.
template <int CPT, int P, int NPASS>
__device__ __forceinline__ void prefix_max_pair(int (&u)[CPT], int (&m)[CPT],
                                                int lane) {
  if constexpr (P < NPASS) {
    int pu[CPT], pm[CPT];
    shift_right<CPT, (1 << P)>(u, pu, kNeg, lane);
    shift_right<CPT, (1 << P)>(m, pm, 0, lane);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      bool take = pu[j] > u[j];
      u[j] = take ? pu[j] : u[j];
      m[j] = take ? pm[j] : m[j];
    }
    prefix_max_pair<CPT, P + 1, NPASS>(u, m, lane);
  }
}

// Stage rows [c0, c0 + kChunk) of the read and the matching reference
// window bytes; PAD (4) past the ends.
template <int W>
__device__ __forceinline__ void stage(uint8_t* sq, uint8_t* sr, const uint8_t* q,
                                      const uint8_t* r, int c0, int L, int lane) {
  __syncwarp();
  for (int t = lane; t < kChunk; t += 32) sq[t] = c0 + t < L ? q[c0 + t] : 4;
  for (int t = lane; t < kChunk + W; t += 32) sr[t] = c0 + t < L + W ? r[c0 + t] : 4;
  __syncwarp();
}

template <int CPT, int NPASS>
__global__ void __launch_bounds__(32 * kWarps)
sw_packed(const uint8_t* __restrict__ q, const uint8_t* __restrict__ refwin,
          const int* __restrict__ lengths, int B, int L, Scoring sc,
          int* __restrict__ out_score, int* __restrict__ out_mlen) {
  constexpr int W = 32 * CPT;
  __shared__ uint8_t sq_all[kWarps][kChunk];
  __shared__ uint8_t sr_all[kWarps][kChunk + W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int read = blockIdx.x * kWarps + warp;
  if (read >= B) return;  // uniform per warp; the kernel never syncs the block
  uint8_t* sq = sq_all[warp];
  uint8_t* sr = sr_all[warp];
  const uint8_t* qr = q + static_cast<size_t>(read) * L;
  const uint8_t* rr = refwin + static_cast<size_t>(read) * (L + W);
  const int n = min(max(lengths[read], 0), L);

  const int scale = 1 << sc.mbits;
  const int sub_match = sc.match * scale + 1;
  const int sub_mismatch = -sc.mismatch * scale;
  const int gp = sc.gap * scale;
  int P[CPT], best[CPT], lg[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    P[j] = 0;
    best[j] = 0;
    lg[j] = (lane * CPT + j) * gp;
  }
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    stage<W>(sq, sr, qr, rr, c0, L, lane);
    const int rows = min(kChunk, n - c0);
    for (int i = 0; i < rows; ++i) {
      const int qb = sq[i];
      int up[CPT], u[CPT], t[CPT];
      shift_left1<CPT>(P, up, kNeg, lane);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int rb = sr[i + lane * CPT + j];
        const int cd = P[j] + ((qb == rb && qb < 4) ? sub_match : sub_mismatch);
        t[j] = max(max(up[j] - gp, cd), 0);
        u[j] = t[j] + lg[j];
      }
      prefix_max<CPT, 0, NPASS>(u, lane);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        P[j] = max(u[j] - lg[j], t[j]);
        best[j] = max(best[j], P[j]);
      }
    }
  }
  int b = best[0];
#pragma unroll
  for (int j = 1; j < CPT; ++j) b = max(b, best[j]);
#pragma unroll
  for (int o = 16; o; o >>= 1) b = max(b, __shfl_xor_sync(kFull, b, o));
  if (lane == 0) {
    out_score[read] = b >> sc.mbits;
    out_mlen[read] = b & (scale - 1);
  }
}

template <int CPT, int NPASS>
__global__ void __launch_bounds__(32 * kWarps)
sw_pair(const uint8_t* __restrict__ q, const uint8_t* __restrict__ refwin,
        const int* __restrict__ lengths, int B, int L, Scoring sc,
        int* __restrict__ out_score, int* __restrict__ out_mlen) {
  constexpr int W = 32 * CPT;
  __shared__ uint8_t sq_all[kWarps][kChunk];
  __shared__ uint8_t sr_all[kWarps][kChunk + W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int read = blockIdx.x * kWarps + warp;
  if (read >= B) return;
  uint8_t* sq = sq_all[warp];
  uint8_t* sr = sr_all[warp];
  const uint8_t* qr = q + static_cast<size_t>(read) * L;
  const uint8_t* rr = refwin + static_cast<size_t>(read) * (L + W);
  const int n = min(max(lengths[read], 0), L);

  // Per-cell lazy best: the first row at which the cell reached its own
  // maximum, and its mlen there.  The reference keeps the first row whose
  // row maximum beats every earlier row, with the largest mlen among that
  // row's maximal cells; the reduction below recovers exactly that.
  int H[CPT], M[CPT], lg[CPT], bh[CPT], brow[CPT], bm[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    H[j] = M[j] = bh[j] = bm[j] = 0;
    brow[j] = 0x7fffffff;
    lg[j] = (lane * CPT + j) * sc.gap;
  }
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    stage<W>(sq, sr, qr, rr, c0, L, lane);
    const int rows = min(kChunk, n - c0);
    for (int i = 0; i < rows; ++i) {
      const int qb = sq[i];
      int hu[CPT], mu[CPT], t[CPT], mt[CPT], u[CPT], mh[CPT];
      shift_left1<CPT>(H, hu, kNeg, lane);
      shift_left1<CPT>(M, mu, 0, lane);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int rb = sr[i + lane * CPT + j];
        const bool is_match = qb == rb && qb < 4;
        const int cd = H[j] + (is_match ? sc.match : -sc.mismatch);
        const int md = M[j] + (is_match ? 1 : 0);
        const int cu = hu[j] - sc.gap;
        const bool up = cu > cd;
        t[j] = up ? cu : cd;
        mt[j] = up ? mu[j] : md;
        if (t[j] < 0) {
          t[j] = 0;
          mt[j] = 0;
        }
        u[j] = t[j] + lg[j];
        mh[j] = mt[j];
      }
      prefix_max_pair<CPT, 0, NPASS>(u, mh, lane);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int hz = u[j] - lg[j];
        const bool hor = hz > t[j];
        H[j] = hor ? hz : t[j];
        M[j] = hor ? mh[j] : mt[j];
        if (H[j] > bh[j]) {
          bh[j] = H[j];
          brow[j] = c0 + i;
          bm[j] = M[j];
        }
      }
    }
  }
  int g = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) g = max(g, bh[j]);
#pragma unroll
  for (int o = 16; o; o >>= 1) g = max(g, __shfl_xor_sync(kFull, g, o));
  int r = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < CPT; ++j) r = bh[j] == g ? min(r, brow[j]) : r;
#pragma unroll
  for (int o = 16; o; o >>= 1) r = min(r, __shfl_xor_sync(kFull, r, o));
  int m = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) m = (bh[j] == g && brow[j] == r) ? max(m, bm[j]) : m;
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) {
    out_score[read] = g;
    out_mlen[read] = g > 0 ? m : 0;
  }
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int*, int, int,
                        Scoring, int*, int*);

template <int CPT, int NPASS>
Kernel pick_npass(bool packed, int npass) {
  if constexpr (NPASS > 0) {
    if (npass < NPASS) return pick_npass<CPT, NPASS - 1>(packed, npass);
  }
  return packed ? sw_packed<CPT, NPASS> : sw_pair<CPT, NPASS>;
}

// npass <= log2(W): the reach never exceeds the band.
Kernel pick(int cpt, bool packed, int npass) {
  switch (cpt) {
    case 1: return npass <= 5 ? pick_npass<1, 5>(packed, npass) : nullptr;
    case 2: return npass <= 6 ? pick_npass<2, 6>(packed, npass) : nullptr;
    case 4: return npass <= 7 ? pick_npass<4, 7>(packed, npass) : nullptr;
    default: return nullptr;
  }
}

ffi::Error BandedSwImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                        ffi::Buffer<ffi::U8> refwin, ffi::Buffer<ffi::S32> lengths,
                        ffi::ResultBuffer<ffi::S32> score,
                        ffi::ResultBuffer<ffi::S32> mlen, int32_t match,
                        int32_t mismatch, int32_t gap, int32_t npass,
                        int32_t mbits) {
  const auto qd = q.dimensions();
  const auto rd = refwin.dimensions();
  if (qd.size() < 1 || rd.size() != qd.size())
    return ffi::Error::InvalidArgument("banded_sw: q and refwin ranks differ");
  const int64_t L = qd.back();
  const int64_t W = rd.back() - L;
  const int64_t B = lengths.element_count();
  if (L <= 0 || B * L != static_cast<int64_t>(q.element_count()) ||
      B * (L + W) != static_cast<int64_t>(refwin.element_count()))
    return ffi::Error::InvalidArgument("banded_sw: inconsistent shapes");
  if (W % 32 != 0)
    return ffi::Error::InvalidArgument("banded_sw: band must be a multiple of 32");
  Kernel k = pick(static_cast<int>(W / 32), mbits > 0, npass);
  if (k == nullptr)
    return ffi::Error::InvalidArgument("banded_sw: unsupported band or reach");
  if (B == 0) return ffi::Error::Success();
  const Scoring sc{match, mismatch, gap, mbits};
  const int blocks = static_cast<int>((B + kWarps - 1) / kWarps);
  k<<<blocks, 32 * kWarps, 0, stream>>>(q.typed_data(), refwin.typed_data(),
                                         lengths.typed_data(), static_cast<int>(B),
                                         static_cast<int>(L), sc,
                                         score->typed_data(), mlen->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BandedSw, BandedSwImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap")
                                  .Attr<int32_t>("npass")
                                  .Attr<int32_t>("mbits"));
