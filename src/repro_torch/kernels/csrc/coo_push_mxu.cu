// Binned push, one-hot strategy: every destination combines
// msg(x[src], w) over its in-edges whose source is active, over the same
// bin plan as coo_push.cu (row b of [nb, cap] holds bin b's dst-sorted
// edges; ptr[b, bin_n] is the bin's edge count).
//
// Replaces: src/repro/kernels/coo_push.py, coo_push_pallas with
// strategy="mxu" (the Pallas TPU kernel whose float sums are the one-hot
// matmul onehot[bin_n, block_e] @ msgs[block_e, B] on the MXU, and whose
// min, max and integer sums are a masked window reduce).
//
// What bounds it on the H100: the function's bytes are those of the scan
// (8 B per plan slot plus the gathered payload rows, ~0.03 ms per push on
// the graphs of this repo). The one-hot design's own floor is its
// multiply-adds, nb x bin_n x cap x B, which at B = 32 on Kronecker scale
// 16 is 4.3e10, about 0.35 ms at the 495 TFLOP/s TF32 rate for the two
// products that float32 needs.
//
// Design: one CTA per (bin, tile of 8 payload columns); it walks the
// bin's edges in chunks of block_e slots staged in shared memory as the
// bin-relative destination (bin_n for a padded or inactive slot, so it
// matches no row) and the messages of the tile. The tensor-core path
// stages at most 256 slots (17 KB, so many CTAs share an SM), the window
// reduce at most 1,024 (its per-slot scan favours long chunks).
//   * float32 sums: the product runs on the tensor cores with warp-level
//     mma.sync m16n8k8 TF32. The one-hot operand is exact in TF32; each
//     message is split as hi = tf32(m), lo = tf32(m - hi), and the two
//     products keep ~22 bits of the message (one TF32 product keeps
//     ~11). Each k-step's product (at most 8 messages per destination) is
//     added to f64 registers rather than carried in the mma's f32
//     accumulator, so a hub's thousands of terms do not compound f32
//     rounding (as the scan, the kernel rounds once at the end). Four
//     warps own the bin's 16-row tiles; a tile that none of a k-step's 8
//     edges hits is skipped after a warp vote, so on dst-sorted edges
//     most of the one-hot's zeros are never multiplied. Payload tiles
//     narrower than 8 columns are padded with zeros.
//   * min, max, integer and float64 sums: the masked window reduce on
//     CUDA cores. A thread owns one destination and scans every staged
//     slot for its own id; integer sums wrap like the plain version's
//     cast (64-bit unsigned accumulation, truncated), float64 sums add in
//     f64.
// A hub costs this design nothing extra: its edges are spread over the
// product's K dimension, not walked by one thread.
#include "common.cuh"

namespace rk {

constexpr int kMmaStage = 256;   // slots staged per chunk, float32 sums
constexpr int kWinStage = 1024;  // slots staged per chunk, window reduce
constexpr int kTile = 8;         // payload columns per CTA (the mma's n)
constexpr int kMmaThreads = 128; // 4 warps x 4 row tiles of 16 = 256 rows
constexpr int kWinThreads = 256; // one destination per thread
constexpr int kMaxBin = 256;

struct MxuArgs {
  const void* x;          // [n (, B)]
  const uint8_t* active;  // [n] bool
  const int32_t* src;     // [nb, cap]
  const int32_t* dst;     // [nb, cap]
  const float* w;         // [nb, cap]
  const int32_t* ptr;     // [nb, bin_n + 1]
  void* out;              // [n (, B)]
  long long n, nb, bin_n, cap, B, block_e;
  cudaStream_t stream;
};

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rel of slot s of bin b: its bin-relative destination when the slot is a
// real edge whose source is active, else bin_n
__device__ __forceinline__ int slot_rel(const int32_t* bs, const int32_t* bd,
                                        const uint8_t* active, long long s,
                                        long long b, long long n,
                                        long long bin_n, int32_t* u_out) {
  const int32_t u = bs[s], d = bd[s];
  *u_out = u;
  if (u < 0 || u >= n || d < 0 || d >= n || !active[u])
    return static_cast<int>(bin_n);
  return static_cast<int>(d - b * bin_n);
}

// float32 sums: onehot[bin_n, chunk] @ msgs[chunk, 8] on the tensor cores
template <typename T, int MSG>
__global__ void __launch_bounds__(kMmaThreads)
mxu_sum_tf32(const T* __restrict__ x, const uint8_t* __restrict__ active,
             const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const float* __restrict__ w, const int32_t* __restrict__ ptr,
             float* __restrict__ out, long long n, long long bin_n,
             long long cap, long long B, long long stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_hi = reinterpret_cast<uint32_t*>(smem);  // [stage][8]
  uint32_t* s_lo = s_hi + stage * kTile;               // [stage][8]
  int32_t* s_rel = reinterpret_cast<int32_t*>(s_lo + stage * kTile);
  const long long b = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long ct = B - c0 < kTile ? B - c0 : kTile;
  const int32_t* bs = src + b * cap;
  const int32_t* bd = dst + b * cap;
  const float* bw = w + b * cap;
  const long long edges = ptr[b * (bin_n + 1) + bin_n];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = static_cast<int>((bin_n + 15) / 16);
  const uint32_t one = 0x3f800000u;  // 1.0f, exact in TF32
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0;

  for (long long base = 0; base < edges; base += stage) {
    const long long len = edges - base < stage ? edges - base : stage;
    const long long len8 = (len + 7) & ~7LL;
    __syncthreads();  // the previous chunk is consumed
    for (long long s = threadIdx.x; s < len8; s += blockDim.x) {
      int rel = static_cast<int>(bin_n);
      float mv[kTile];
#pragma unroll
      for (int c = 0; c < kTile; ++c) mv[c] = 0.f;
      if (s < len) {
        int32_t u;
        rel = slot_rel(bs, bd, active, base + s, b, n, bin_n, &u);
        if (rel < bin_n) {
          const float wv = bw[base + s];
          const T* xu = x + static_cast<long long>(u) * B + c0;
#pragma unroll
          for (int c = 0; c < kTile; ++c)
            if (c < ct) mv[c] = message<T, float, MSG>(xu[c], wv);
        }
      }
      s_rel[s] = rel;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const uint32_t hi = to_tf32(mv[c]);
        s_hi[s * kTile + c] = hi;
        s_lo[s * kTile + c] = to_tf32(mv[c] - __uint_as_float(hi));
      }
    }
    __syncthreads();
    for (long long k = 0; k < len8; k += 8) {
      // A fragment rows g, g+8 x cols t, t+4; B fragment rows t, t+4 x
      // col g (PTX ISA, mma.m16n8k8 .tf32 layouts)
      const int r0 = s_rel[k + t], r1 = s_rel[k + t + 4];
      const uint32_t bh0 = s_hi[(k + t) * kTile + g];
      const uint32_t bh1 = s_hi[(k + t + 4) * kTile + g];
      const uint32_t bl0 = s_lo[(k + t) * kTile + g];
      const uint32_t bl1 = s_lo[(k + t + 4) * kTile + g];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = warp + 4 * i;
        if (mt >= mtiles) break;  // uniform across the warp
        const int m0 = mt * 16;
        const bool hit = static_cast<unsigned>(r0 - m0) < 16u ||
                         static_cast<unsigned>(r1 - m0) < 16u;
        if (!__any_sync(0xffffffffu, hit)) continue;
        const uint32_t a0 = r0 == m0 + g ? one : 0u;
        const uint32_t a1 = r0 == m0 + g + 8 ? one : 0u;
        const uint32_t a2 = r1 == m0 + g ? one : 0u;
        const uint32_t a3 = r1 == m0 + g + 8 ? one : 0u;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, a0, a1, a2, a3, bh0, bh1);
        mma_tf32(d, a0, a1, a2, a3, bl0, bl1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += d[q];
      }
    }
  }
  // C fragment: rows g (c0, c1) and g+8 (c2, c3), cols 2t and 2t+1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mt = warp + 4 * i;
    if (mt >= mtiles) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = mt * 16 + g + (k >= 2 ? 8 : 0);
      const long long col = 2 * t + (k & 1);
      const long long v = b * bin_n + j;
      if (j < bin_n && v < n && col < ct)
        out[v * B + c0 + col] = static_cast<float>(acc[i][k]);
    }
  }
}

// min, max, integer and float64 sums: the masked window reduce
template <typename T, typename M, int C, int MSG>
__global__ void __launch_bounds__(kWinThreads)
mxu_window(const T* __restrict__ x, const uint8_t* __restrict__ active,
           const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
           const float* __restrict__ w, const int32_t* __restrict__ ptr,
           M* __restrict__ out, long long n, long long bin_n, long long cap,
           long long B, long long stage) {
  using A = typename AccType<M, C>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  M* s_msg = reinterpret_cast<M*>(smem);                  // [stage][8]
  int32_t* s_rel = reinterpret_cast<int32_t*>(s_msg + stage * kTile);
  const long long b = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long ct = B - c0 < kTile ? B - c0 : kTile;
  const int32_t* bs = src + b * cap;
  const int32_t* bd = dst + b * cap;
  const float* bw = w + b * cap;
  const long long edges = ptr[b * (bin_n + 1) + bin_n];
  const int j = threadIdx.x;
  const long long v = b * bin_n + j;
  const bool live = j < bin_n && v < n;
  A acc[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) acc[c] = identity<A, C>();

  for (long long base = 0; base < edges; base += stage) {
    const long long len = edges - base < stage ? edges - base : stage;
    __syncthreads();
    for (long long s = threadIdx.x; s < len; s += blockDim.x) {
      int32_t u;
      const int rel = slot_rel(bs, bd, active, base + s, b, n, bin_n, &u);
      s_rel[s] = rel;
      if (rel < bin_n) {
        const float wv = bw[base + s];
        const T* xu = x + static_cast<long long>(u) * B + c0;
#pragma unroll
        for (int c = 0; c < kTile; ++c)
          if (c < ct) s_msg[s * kTile + c] = message<T, M, MSG>(xu[c], wv);
      }
    }
    __syncthreads();
    if (live) {
      for (long long s = 0; s < len; ++s) {
        if (s_rel[s] != j) continue;
#pragma unroll
        for (int c = 0; c < kTile; ++c)
          if (c < ct)
            acc[c] = combine<A, C>(acc[c],
                                   to_acc<A, M>(s_msg[s * kTile + c]));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (c < ct) out[v * B + c0 + c] = from_acc<M, A>(acc[c]);
  }
}

struct MxuLauncher {
  using Args = MxuArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    if (a.bin_n < 1 || a.bin_n > kMaxBin) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(a.nb),
                    static_cast<unsigned>((a.B + kTile - 1) / kTile));
    if constexpr (C == SUM && std::is_same<M, float>::value) {
      // k-steps take 8 slots: the chunk is a multiple of 8
      long long stage = a.block_e > kMmaStage ? kMmaStage : a.block_e;
      stage = stage < 8 ? 8 : stage & ~7LL;
      const size_t per_slot = 2 * kTile * sizeof(uint32_t) + sizeof(int32_t);
      mxu_sum_tf32<T, MSG><<<grid, kMmaThreads, stage * per_slot, a.stream>>>(
          static_cast<const T*>(a.x), a.active, a.src, a.dst, a.w, a.ptr,
          static_cast<float*>(a.out), a.n, a.bin_n, a.cap, a.B, stage);
    } else {
      const long long stage =
          a.block_e < 1 ? 1 : (a.block_e > kWinStage ? kWinStage : a.block_e);
      const size_t per_slot = kTile * sizeof(M) + sizeof(int32_t);
      // above 48 KB a kernel must opt in to dynamic shared memory: once per
      // instantiation (the static is per (T, C, MSG))
      static const cudaError_t err = cudaFuncSetAttribute(
          mxu_window<T, M, C, MSG>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kWinStage * per_slot));
      if (err != cudaSuccess) return err;
      mxu_window<T, M, C, MSG>
          <<<grid, kWinThreads, stage * per_slot, a.stream>>>(
              static_cast<const T*>(a.x), a.active, a.src, a.dst, a.w,
              a.ptr, static_cast<M*>(a.out), a.n, a.bin_n, a.cap, a.B,
              stage);
    }
    return cudaGetLastError();
  }
};

}  // namespace rk

extern "C" int repro_coo_push_mxu(const void* x, int dtype,
                                  const void* active, const void* src,
                                  const void* dst, const void* w,
                                  const void* ptr, void* out, long long n,
                                  long long nb, long long bin_n,
                                  long long cap, long long B,
                                  long long block_e, int combine, int msg,
                                  void* stream) {
  rk::MxuArgs a{x, static_cast<const uint8_t*>(active),
                static_cast<const int32_t*>(src),
                static_cast<const int32_t*>(dst),
                static_cast<const float*>(w),
                static_cast<const int32_t*>(ptr), out, n, nb, bin_n, cap, B,
                block_e, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::MxuLauncher>(dtype, combine, msg,
                                                          a));
}
