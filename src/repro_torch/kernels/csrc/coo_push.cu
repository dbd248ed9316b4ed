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
// Design: one CTA per bin, so each bin's results are private to one CTA,
// as in the TPU design. A thread owns one destination and walks its run
// ptr[b, j]:ptr[b, j+1] in plan order, combining in a register: no
// atomics, no shared memory, and a deterministic result (float sums in
// f64, rounded once). Hub destinations make this uneven: on a power-law
// graph one thread of a bin may walk ~10k edges while its neighbours
// walk ~30, so the CTA waits on its hub. That is left for a later PR.
#include "common.cuh"

namespace rk {

struct PushArgs {
  const void* x;          // [n (, B)]
  const uint8_t* active;  // [n] bool
  const int32_t* src;     // [nb, cap]
  const float* w;         // [nb, cap]
  const int32_t* ptr;     // [nb, bin_n + 1]
  void* out;              // [n (, B)]
  long long n, nb, bin_n, cap, B;
  cudaStream_t stream;
};

template <typename T, typename M, int C, int MSG>
__global__ void coo_push_kernel(const T* __restrict__ x,
                                const uint8_t* __restrict__ active,
                                const int32_t* __restrict__ src,
                                const float* __restrict__ w,
                                const int32_t* __restrict__ ptr,
                                M* __restrict__ out, long long n,
                                long long bin_n, long long cap, long long B) {
  using A = typename AccType<M, C>::type;
  const long long b = blockIdx.x;
  const int32_t* bp = ptr + b * (bin_n + 1);
  const int32_t* bs = src + b * cap;
  const float* bw = w + b * cap;
  for (long long j = threadIdx.x; j < bin_n; j += blockDim.x) {
    const long long v = b * bin_n + j;
    if (v >= n) break;
    const int32_t lo = bp[j], hi = bp[j + 1];
    for (long long c = 0; c < B; ++c) {
      A acc = identity<A, C>();
      for (int32_t s = lo; s < hi; ++s) {
        const int32_t u = bs[s];
        if (u >= 0 && u < n && active[u])
          acc = combine<A, C>(
              acc, to_acc<A, M>(message<T, M, MSG>(x[u * B + c], bw[s])));
      }
      out[v * B + c] = from_acc<M, A>(acc);
    }
  }
}

struct PushLauncher {
  using Args = PushArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    const int threads = static_cast<int>(a.bin_n < 256 ? a.bin_n : 256);
    coo_push_kernel<T, M, C, MSG>
        <<<static_cast<unsigned>(a.nb), threads, 0, a.stream>>>(
            static_cast<const T*>(a.x), a.active, a.src, a.w, a.ptr,
            static_cast<M*>(a.out), a.n, a.bin_n, a.cap, a.B);
    return cudaGetLastError();
  }
};

}  // namespace rk

extern "C" int repro_coo_push(const void* x, int dtype, const void* active,
                              const void* src, const void* w,
                              const void* ptr, void* out, long long n,
                              long long nb, long long bin_n, long long cap,
                              long long B, int combine, int msg,
                              void* stream) {
  rk::PushArgs a{x, static_cast<const uint8_t*>(active),
                 static_cast<const int32_t*>(src),
                 static_cast<const float*>(w),
                 static_cast<const int32_t*>(ptr), out, n, nb, bin_n, cap, B,
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::PushLauncher>(dtype, combine, msg,
                                                          a));
}
