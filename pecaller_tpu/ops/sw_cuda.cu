// Batched glocal Smith-Waterman scorer for NVIDIA Hopper (sm_90a), called
// from JAX through the XLA FFI.  Same contract as ops/sw2.sw_align_x: for
// every alignment, the best score (x36 exact integers) in the read's last
// column, its plane k and reference row i, and whether >= 2 last-column
// cells attain that final best (the tie flag).
//
// Layout: one warp per alignment.  Lane l owns DP columns
// [CPL*l, CPL*l + CPL) of the three planes (s0 diagonal, s1 vertical gap,
// s2 horizontal gap) and keeps them in registers for the whole row loop,
// so device memory sees only the inputs and four int32 outputs.  Per row:
//   c0[j] = max(s0, s1, s2)[j-1] + bump(j)     diagonal: one shfl_up
//   c1[j] = max(s0[j] - OPEN, s1[j] - EXT)     local
//   c2[j] = cummax_{j'<=j}(c0[j'-1] - OPEN + j') - j
//                                              one shfl_up + a 5-step
//                                              warp prefix max
// which is the recurrence of ops/sw.py _step_core, so every cell equals
// the XLA scan's int32 value exactly.  The lane owning column rlens keeps
// the best/bk/bi/tie bookkeeping.  Reference recurrences:
// pemapper.c:1694-1748.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kMatch = 36;
constexpr int32_t kMismatch = -12;
constexpr int32_t kOpen = 72;
constexpr int32_t kExt = 1;
constexpr int32_t kNeg = -(1 << 30);
constexpr int32_t kXN = 4;          // xcode of the N wildcard
constexpr int kWarpsPerBlock = 8;   // alignments per thread block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t bump(int32_t rb, int32_t rd,
                                        bool bisulfite) {
  bool m = (rb == rd) | (rb == kXN) | (rd == kXN);
  if (bisulfite) m = m | ((rb == 1) & (rd == 3));
  return m ? kMatch : kMismatch;
}

template <int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_align_kernel(const uint8_t* __restrict__ refs,
                const int32_t* __restrict__ blens,
                const uint8_t* __restrict__ reads,
                const int32_t* __restrict__ rlens, int64_t n_align,
                int32_t N, int32_t M, int32_t n_rows, bool bisulfite,
                int32_t* __restrict__ out) {
  extern __shared__ uint8_t sref_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (b >= n_align) return;               // whole warp leaves together

  const int32_t W = M + 1;
  const int32_t blen = blens[b];
  const int32_t rlen = rlens[b];
  const int32_t n_eff = max(0, min(n_rows, blen));

  // this warp's reference window, staged once in shared memory
  uint8_t* sref = sref_all + warp * N;
  const uint8_t* ref_b = refs + b * N;
  for (int32_t r = lane; r < n_eff; r += 32) sref[r] = ref_b[r];

  // read base consumed by column j's diagonal step is read[j-1]
  const uint8_t* read_b = reads + b * M;
  int32_t rd[CPL];
  int32_t s0[CPL], s1[CPL], s2[CPL];
  const int32_t j0 = CPL * lane;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int32_t j = j0 + t;
    rd[t] = (j >= 1 && j <= M) ? static_cast<int32_t>(read_b[j - 1]) : 0;
    const int32_t b0 = -(kOpen + (j - 1) * kExt);
    s0[t] = (j == 0) ? 0 : b0;
    s1[t] = s0[t];
    s2[t] = (j == 0) ? -kOpen : b0;
  }
  __syncwarp();

  // last-column bookkeeping: only the owner lane's copy is written out
  const bool col_ok = (rlen >= 0) & (rlen < W);
  const int owner = col_ok ? rlen / CPL : 0;
  const int t_own = col_ok ? rlen % CPL : 0;
  auto at_col = [&](const int32_t (&x)[CPL]) {
    int32_t v = kNeg;
#pragma unroll
    for (int t = 0; t < CPL; ++t) v = (t == t_own) ? x[t] : v;
    return col_ok ? v : kNeg;
  };
  int32_t best = at_col(s0);
  int32_t bk = 0, bi = 0, n_at = 1;

  for (int32_t i = 1; i <= n_eff; ++i) {
    const int32_t rb = sref[i - 1];
    int32_t prev3[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) prev3[t] = max(max(s0[t], s1[t]), s2[t]);
    const int32_t p_left = __shfl_up_sync(kFull, prev3[CPL - 1], 1);

    int32_t c0[CPL], c1[CPL], z[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int32_t j = j0 + t;
      const int32_t pv = (t == 0) ? p_left : prev3[t - 1];
      c0[t] = (j == 0) ? 0 : pv + bump(rb, rd[t], bisulfite);
      c1[t] = (j == 0) ? 0 : max(s0[t] - kOpen, s1[t] - kExt);
    }
    const int32_t c0_left = __shfl_up_sync(kFull, c0[CPL - 1], 1);
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int32_t j = j0 + t;
      const int32_t cv = (t == 0) ? c0_left : c0[t - 1];
      const int32_t a = (j == 0) ? -kOpen : cv - kOpen + j;
      z[t] = (t == 0) ? a : max(z[t - 1], a);
    }
    // warp-wide inclusive prefix max of the lane totals, then carry in
    // the exclusive prefix from the lanes to the left
    int32_t run = z[CPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, run, d);
      if (lane >= d) run = max(run, y);
    }
    int32_t carry = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) carry = kNeg;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int32_t j = j0 + t;
      s2[t] = max(z[t], carry) - j;
      s0[t] = c0[t];
      s1[t] = c1[t];
    }

    const int32_t v0 = at_col(s0), v1 = at_col(s1), v2 = at_col(s2);
    const int32_t vs[3] = {v0, v1, v2};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int32_t v = vs[k];
      if (v > best) {
        best = v;
        bk = k;
        bi = i;
        n_at = 1;
      } else if (v == best) {
        ++n_at;
      }
    }
  }

  if (lane == owner) {
    out[b] = best;
    out[n_align + b] = bk;
    out[2 * n_align + b] = bi;
    out[3 * n_align + b] = n_at >= 2 ? 1 : 0;
  }
}

template <int CPL>
cudaError_t launch(cudaStream_t stream, const uint8_t* refs,
                   const int32_t* blens, const uint8_t* reads,
                   const int32_t* rlens, int64_t n_align, int32_t N,
                   int32_t M, int32_t n_rows, bool bisulfite, int32_t* out) {
  const int64_t blocks = (n_align + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * N;
  sw_align_kernel<CPL><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      refs, blens, reads, rlens, n_align, N, M, n_rows, bisulfite, out);
  return cudaGetLastError();
}

ffi::Error SwAlignXImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> refs,
                        ffi::Buffer<ffi::S32> blens,
                        ffi::Buffer<ffi::U8> reads,
                        ffi::Buffer<ffi::S32> rlens, int32_t bisulfite,
                        int32_t n_rows, ffi::ResultBuffer<ffi::S32> out) {
  const auto rdims = refs.dimensions();
  const auto qdims = reads.dimensions();
  if (rdims.size() != 2 || qdims.size() != 2 || rdims[0] != qdims[0])
    return ffi::Error::InvalidArgument("sw_align_x: refs (B, N), reads (B, M)");
  const int64_t n_align = rdims[0];
  const int32_t N = static_cast<int32_t>(rdims[1]);
  const int32_t M = static_cast<int32_t>(qdims[1]);
  if (n_rows < 0 || n_rows > N)
    return ffi::Error::InvalidArgument("sw_align_x: n_rows outside [0, N]");
  if (n_align == 0) return ffi::Error::Success();
  const int32_t W = M + 1;
  cudaError_t err;
  const bool bis = bisulfite != 0;
  if (W <= 4 * 32) {
    err = launch<4>(stream, refs.typed_data(), blens.typed_data(),
                    reads.typed_data(), rlens.typed_data(), n_align, N, M,
                    n_rows, bis, out->typed_data());
  } else if (W <= 8 * 32) {
    err = launch<8>(stream, refs.typed_data(), blens.typed_data(),
                    reads.typed_data(), rlens.typed_data(), n_align, N, M,
                    n_rows, bis, out->typed_data());
  } else if (W <= 12 * 32) {
    err = launch<12>(stream, refs.typed_data(), blens.typed_data(),
                     reads.typed_data(), rlens.typed_data(), n_align, N, M,
                     n_rows, bis, out->typed_data());
  } else {
    return ffi::Error::InvalidArgument("sw_align_x: reads wider than 383");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PecallerSwAlignX, SwAlignXImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("bisulfite")
                                  .Attr<int32_t>("n_rows")
                                  .Ret<ffi::Buffer<ffi::S32>>());
