// Binned push: every destination combines msg(x[src], w) over its
// in-edges whose source is active. Destinations are grouped in bins of
// bin_n consecutive ids; the plan holds bin b's (dst-sorted) edges in row
// b of [nb, cap] arrays and a within-bin CSR pointer ptr[nb, bin_n + 1].
//
// Replaces: src/repro/kernels/coo_push.py, coo_push_pallas with
// strategy="scan" (the Pallas TPU kernel that runs destination bins in
// parallel, streams edge blocks, and reduces each bin into a private
// accumulator block).
//
// What bounds it on the H100: device-memory bytes, 8 B per edge of the
// plan (int32 source + f32 weight) plus the active flag and payload of
// each edge's source, read at random. The frontier does not shrink the
// plan scan: an inactive source is still read to be skipped, which is
// why the backend charges a push m reads for binning.
//
// Design: one CTA per (bin, tile of up to 8 payload columns), so each
// bin's results are private to one CTA, as in the TPU design. The CTA
// stages the bin's edges in chunks of block_e slots (at most kScanStage)
// in shared memory: the source, or -1 where it is inactive, and the
// weight. A thread owns one destination and walks its run ptr[b, j]:
// ptr[b, j+1] through each chunk, combining the tile's columns in
// registers (the payload row of a source is read once per tile, not once
// per column): no atomics and a deterministic result (float sums in f64,
// rounded once). Bins wider than the CTA run in passes of 256
// destinations, each staging only its own slice of the edges. Hub
// destinations make this uneven: on a power-law graph one thread of a
// bin may walk ~10k edges while its neighbours walk ~30, so the CTA
// waits on its hub (the "mxu" strategy, coo_push_mxu.cu, has no such
// imbalance).
#include "common.cuh"

namespace rk {

constexpr int kScanThreads = 256;
constexpr int kScanStage = 4096;  // slots staged per chunk (32 KB)
constexpr int kColTile = 8;       // payload columns per CTA

struct PushArgs {
  const void* x;          // [n (, B)]
  const uint8_t* active;  // [n] bool
  const int32_t* src;     // [nb, cap]
  const float* w;         // [nb, cap]
  const int32_t* ptr;     // [nb, bin_n + 1]
  void* out;              // [n (, B)]
  long long n, nb, bin_n, cap, B, block_e;
  cudaStream_t stream;
};

template <typename T, typename M, int C, int MSG>
__global__ void __launch_bounds__(kScanThreads)
coo_push_kernel(const T* __restrict__ x, const uint8_t* __restrict__ active,
                const int32_t* __restrict__ src, const float* __restrict__ w,
                const int32_t* __restrict__ ptr, M* __restrict__ out,
                long long n, long long bin_n, long long cap, long long B,
                long long stage) {
  using A = typename AccType<M, C>::type;
  __shared__ int32_t s_src[kScanStage];
  __shared__ float s_w[kScanStage];
  const long long b = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * kColTile;
  const long long ct = B - c0 < kColTile ? B - c0 : kColTile;
  const int32_t* bp = ptr + b * (bin_n + 1);
  const int32_t* bs = src + b * cap;
  const float* bw = w + b * cap;
  for (long long j0 = 0; j0 < bin_n; j0 += blockDim.x) {
    const long long jend =
        j0 + blockDim.x < bin_n ? j0 + blockDim.x : bin_n;
    const long long j = j0 + threadIdx.x;
    const long long v = b * bin_n + j;
    const bool live = j < jend && v < n;
    const long long lo = live ? bp[j] : 0, hi = live ? bp[j + 1] : 0;
    A acc[kColTile];
#pragma unroll
    for (int c = 0; c < kColTile; ++c) acc[c] = identity<A, C>();
    // this pass's destinations own one contiguous slice of the row
    const long long p_lo = bp[j0], p_hi = bp[jend];
    for (long long base = p_lo; base < p_hi; base += stage) {
      const long long len = p_hi - base < stage ? p_hi - base : stage;
      __syncthreads();  // the previous chunk is consumed
      for (long long s = threadIdx.x; s < len; s += blockDim.x) {
        const int32_t u = bs[base + s];
        s_src[s] = (u >= 0 && u < n && active[u]) ? u : -1;
        s_w[s] = bw[base + s];
      }
      __syncthreads();
      const long long a = (lo > base ? lo : base) - base;
      const long long e = (hi < base + len ? hi : base + len) - base;
      for (long long s = a; s < e; ++s) {
        const int32_t u = s_src[s];
        if (u < 0) continue;
        const float wv = s_w[s];
        const T* xu = x + static_cast<long long>(u) * B + c0;
#pragma unroll
        for (int c = 0; c < kColTile; ++c)
          if (c < ct)
            acc[c] = combine<A, C>(
                acc[c], to_acc<A, M>(message<T, M, MSG>(xu[c], wv)));
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < kColTile; ++c)
        if (c < ct) out[v * B + c0 + c] = from_acc<M, A>(acc[c]);
    }
  }
}

struct PushLauncher {
  using Args = PushArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    const long long stage =
        a.block_e < 1 ? 1 : (a.block_e > kScanStage ? kScanStage : a.block_e);
    const dim3 grid(static_cast<unsigned>(a.nb),
                    static_cast<unsigned>((a.B + kColTile - 1) / kColTile));
    coo_push_kernel<T, M, C, MSG><<<grid, kScanThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.active, a.src, a.w, a.ptr,
        static_cast<M*>(a.out), a.n, a.bin_n, a.cap, a.B, stage);
    return cudaGetLastError();
  }
};

}  // namespace rk

extern "C" int repro_coo_push(const void* x, int dtype, const void* active,
                              const void* src, const void* w,
                              const void* ptr, void* out, long long n,
                              long long nb, long long bin_n, long long cap,
                              long long B, long long block_e, int combine,
                              int msg, void* stream) {
  rk::PushArgs a{x, static_cast<const uint8_t*>(active),
                 static_cast<const int32_t*>(src),
                 static_cast<const float*>(w),
                 static_cast<const int32_t*>(ptr), out, n, nb, bin_n, cap, B,
                 block_e, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::PushLauncher>(dtype, combine, msg,
                                                          a));
}
