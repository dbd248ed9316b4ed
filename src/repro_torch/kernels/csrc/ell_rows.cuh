// The gather-combine body both ELL pull kernels share: one warp per
// output row. Lanes stride over the row's d_ell slots, each keeps a
// register accumulator, and a shuffle reduce combines the 32 partials.
// A CTA of 8 warps walks rows_per_block consecutive output rows (the
// tuner's block_n / block_r), each warp taking every 8th of them.
//
//   out[r] = combine_{j < d_ell} msg(x[idx[v, j]], w[v, j])
//   v = rows ? rows[r] : r
//
// An index outside [0, num_sources) is the identity wherever it sits in
// the row (not only in the padded tail); a row id outside
// [0, row_limit) yields the identity row.
#pragma once

#include "common.cuh"

namespace rk {

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads

struct EllArgs {
  const void* x;        // [num_sources + 1 (, B)] payload, sentinel row last
  const int32_t* idx;   // [n, d_ell]
  const float* w;       // [n, d_ell]
  const int32_t* rows;  // [R] row ids, or null for rows 0..R-1
  void* out;            // [R (, B)]
  long long R, d_ell, num_sources, row_limit, B, rows_per_block;
  cudaStream_t stream;
};

template <typename T, typename M, typename O, int C, int MSG>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ell_rows_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                const float* __restrict__ w,
                const int32_t* __restrict__ rows, O* __restrict__ out,
                long long R, long long d_ell, long long num_sources,
                long long row_limit, long long B, long long rows_per_block) {
  using A = typename AccType<M, C>::type;
  const long long r_lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r_hi = r_lo + rows_per_block < R ? r_lo + rows_per_block : R;
  const int lane = threadIdx.x & 31;
  // r is uniform across the warp
  for (long long r = r_lo + threadIdx.x / 32; r < r_hi; r += kRowsPerBlock) {
    const long long v = rows ? static_cast<long long>(rows[r]) : r;
    const bool live = v >= 0 && v < row_limit;
    const int32_t* ri = idx + (live ? v : 0) * d_ell;
    const float* rw = w + (live ? v : 0) * d_ell;
    for (long long c = 0; c < B; ++c) {
      A acc = identity<A, C>();
      if (live) {
        for (long long j = lane; j < d_ell; j += 32) {
          const int32_t s = ri[j];
          if (s >= 0 && s < num_sources)
            acc = combine<A, C>(
                acc, to_acc<A, M>(message<T, M, MSG>(x[s * B + c], rw[j])));
        }
      }
      acc = warp_reduce<A, C>(acc);
      if (lane == 0) out[r * B + c] = from_acc<O, A>(acc);
    }
  }
}

// output type of a pull: M, except that an int32 sum widens to int64
template <typename M, int C> struct PullOut { using type = M; };
template <> struct PullOut<int32_t, SUM> { using type = int64_t; };

struct EllLauncher {
  using Args = EllArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    using O = typename PullOut<M, C>::type;
    const long long rpb = a.rows_per_block < 1 ? 1 : a.rows_per_block;
    const long long blocks = (a.R + rpb - 1) / rpb;
    ell_rows_kernel<T, M, O, C, MSG>
        <<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0, a.stream>>>(
            static_cast<const T*>(a.x), a.idx, a.w, a.rows,
            static_cast<O*>(a.out), a.R, a.d_ell, a.num_sources, a.row_limit,
            a.B, rpb);
    return cudaGetLastError();
  }
};

}  // namespace rk
