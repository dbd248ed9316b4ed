// One xDeepFM CIN layer (Compressed Interaction Network, xDeepFM eq. 6):
//
//   out[b, h, d] = sum_{i < Hp, j < F} w[h, i, j] * xk[b, i, d] * x0[b, j, d]
//
// xk: [B, Hp, D], x0: [B, F, D], out: [B, H, D], contiguous, f32 or bf16
// (out in the inputs' type); w as kernel_weights (kernels/cin.py) packs
// it; sums in f32.
//
// Replaces: src/repro/kernels/cin.py, cin_layer_pallas (the Pallas TPU
// kernel that fuses the outer product z[b, i, j, d] with the [H, Hp*F]
// compression matmul in VMEM).
//
// What bounds it on the H100: operations. At Hp = 200, F = 39, H = 200,
// D = 10 a batch of 512 rows is 2 * B * H * Hp * F * D = 1.6e10 FLOP:
// 0.24 ms at the 67 TFLOP/s f32 rate of the CUDA cores. This kernel runs
// on the TF32 tensor cores (495 TFLOP/s) in three products per term,
// which keeps about f32's accuracy: its own floor is 3x the padded
// products (F padded to 40) at the TF32 rate, ~0.1 ms; the bytes (~5 us)
// do not bound it. z itself would be 82 GB at B = 262,144 and never
// exists.
//
// Design: the layer is one GEMM, out^T[c, h] = Z^T[c, k] W^T[k, h] over
// the columns c = b * D + d of the whole batch and K = (i, j), i major,
// j padded to Fp (a multiple of 8) with zero weights, so that one k-step
// of 8 holds eight j of a single i.
//   * wgmma m64nNk8 .tf32: M = 64 columns per consumer warpgroup (two
//     warpgroups, 128 columns a CTA), N = H itself where the kernel has
//     that width (N = 200 for H = 200: no padded rows), else tiles of the
//     general width N = 64 over a grid dimension.
//   * A = Z never leaves registers: each thread forms its fragment's four
//     z = xk[c, i] * x0[c, j] in f32 (x0 of the CTA's columns staged in
//     shared memory once, xk read from global memory an i ahead) and
//     splits each into TF32 hi and lo parts. The 12 products of a K tile
//     are one wgmma group; wgmma reads its register A until its group
//     completes, so the fragments of two tiles are held (reg_fence), one
//     tile's built while the other's products run. (One group per k-step
//     of 8, with the fragments of two k-steps, made ptxas serialize the
//     products, and was slower.)
//   * B = W arrives pre-split (hi and lo, the layout of the wgmma B
//     operand in 8 x 4 core matrices, K-major), packed once per weight
//     tensor by the wrapper, so a stage of 32 k is one contiguous block
//     that one thread of a producer warpgroup (its registers given to the
//     consumers by setmaxnreg) loads with one bulk copy per part into a
//     ring of 2-4 stages; producer and consumers meet on mbarriers.
//   * Three products per k-step into one f32 accumulator: hi * hi,
//     hi * lo and lo * hi (the lo * lo term is below f32's rounding).
//   * Few columns (serve_p99: 5,120, 40 CTAs) split K into ranges, one
//     CTA each, so that the grid fills the card; each CTA of a split tile
//     writes its partial and the last to arrive (a counter per tile,
//     reset by that CTA) sums them in range order: the result does not
//     depend on the order the CTAs finish.
// W (6.2 MB at full width, 12.8 MB split) is read through L2 once per
// column tile: ~512 MB a layer at serve_p99. Sharing each stage between
// the two CTAs of a cluster (one bulk copy of each part, multicast) halves
// that traffic, and was slower: the pair's stages are released in
// lockstep.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                  // warpgroups of 64 columns
constexpr int kTileC = 64 * kConsumers;        // columns c per CTA
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;   // + a producer warpgroup
constexpr int kProducerRegs = 24;              // setmaxnreg budgets (x 128
constexpr int kConsumerRegs = 240;             // threads, 24 + 2 x 240 <= 512)
constexpr int kKT = 32;                        // k per stage
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;               // an H100 CTA's opt-in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

struct CinArgs {
  long long cols;       // B * D
  int Hp, F, Fp, H, D;
  int k_tiles;          // K tiles of the packed weight
  int splits;           // K ranges (blockIdx.z)
  int stages;
};

// xk[c, :] of column c = b * D + d: xk + b * Hp * D + d, i at i * D
// apart (null past the batch)
template <typename T>
__device__ __forceinline__ const T* xk_column(const T* xk, long long c,
                                              const CinArgs& a) {
  return c < a.cols ? xk + c / a.D * a.Hp * a.D + c % a.D : nullptr;
}
// xk[c, i] of a column (0 past the batch or past Hp)
template <typename T>
__device__ __forceinline__ float xk_at(const T* col, int i,
                                       const CinArgs& a) {
  return col && i < a.Hp ? to_f32(col[static_cast<long long>(i) * a.D])
                         : 0.f;
}

// z = xa * x0 for the thread's four A entries, split into TF32 hi and lo
__device__ __forceinline__ void split_z(float z, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(z);
  lo = __float_as_uint(__fsub_rn(z, __uint_as_float(hi)));
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
cin_tc(const T* __restrict__ xk, const T* __restrict__ x0,
       const float* __restrict__ wp, T* __restrict__ out,
       float* __restrict__ partial, int32_t* __restrict__ counters,
       CinArgs a) {
  constexpr int kPart = NB * kKT;                // floats of one part
  constexpr uint32_t kStageBytes = 2 * kPart * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  const int ld = a.Fp + 4;                       // x0 row stride: 32 banks
  float* x0s = stages + a.stages * 2 * kPart;    // [kTileC][ld]
  uint64_t* full = reinterpret_cast<uint64_t*>(x0s + kTileC * ld);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTileC;
  const int ht = blockIdx.y, split = blockIdx.z;
  const int kt0 = static_cast<int>(
      static_cast<long long>(split) * a.k_tiles / a.splits);
  const int kt1 = static_cast<int>(
      static_cast<long long>(split + 1) * a.k_tiles / a.splits);
  const int nk = kt1 - kt0;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 4 * kConsumers);   // one arrival a warp
    }
    hop::mbar_init_fence();
  }
  {
    // x0 of the tile's columns: thread tid takes column tid % kTileC and
    // every kThreads / kTileC-th j (one division for its column, and a
    // warp reads neighbouring columns: contiguous d)
    const int cl = tid % kTileC;
    const long long c = c0 + cl;
    const T* col = c < a.cols ? x0 + c / a.D * a.F * a.D + c % a.D : nullptr;
    for (int j = tid / kTileC; j < a.Fp; j += kThreads / kTileC)
      x0s[cl * ld + j] =
          col && j < a.F ? to_f32(col[static_cast<long long>(j) * a.D]) : 0.f;
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: stage i of the ring holds K tile kt0 + i; one thread
    // of the warpgroup issues the copies
    hop::regs_release<kProducerRegs>();
    if (tid == kConsumerThreads) {
      const float* src = wp + (static_cast<long long>(ht) * a.k_tiles + kt0) *
                                  2 * kPart;
      for (int i = 0; i < nk; ++i) {
        const int s = i % a.stages;
        if (i >= a.stages) hop::mbar_wait(empty + s, (i / a.stages - 1) & 1);
        hop::mbar_expect_tx(full + s, kStageBytes);
        float* dst = stages + s * 2 * kPart;
        const float* from = src + static_cast<long long>(i) * 2 * kPart;
        hop::bulk_load(dst, from, kPart * 4, full + s);
        hop::bulk_load(dst + kPart, from + kPart, kPart * 4, full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns columns wg * 64 .. + 63 of the tile;
  // thread (warp wl, lane 4 g + t) holds A rows ra = 16 wl + g and
  // rb = ra + 8, k columns t and t + 4 of each k-step
  hop::regs_claim<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int ra = wg * 64 + wl * 16 + g, rb = ra + 8;
  const long long ca = c0 + ra, cb = c0 + rb;
  const float* x0a = x0s + ra * ld;
  const float* x0b = x0s + rb * ld;

  hop::Acc<NB> acc;    // the first product overwrites it (scale_d = 0)

  // the next k-step's (i, j0), and xk of that i and of the next (loaded
  // an i ahead)
  const T* xka = xk_column(xk, ca, a);
  const T* xkb = xk_column(xk, cb, a);
  int i_cur = (kt0 * kKT) / a.Fp, j_cur = kt0 * kKT - i_cur * a.Fp;
  float xa = xk_at(xka, i_cur, a), xb = xk_at(xkb, i_cur, a);
  float xa_n = xk_at(xka, i_cur + 1, a), xb_n = xk_at(xkb, i_cur + 1, a);

  // the A fragments of a K tile (4 k-steps, hi and lo parts) for two
  // tiles: one tile's are built while the other's products run, and
  // neither is rewritten before the products that read it are done
  uint32_t h0[kKT / 8][4], l0[kKT / 8][4], h1[kKT / 8][4], l1[kKT / 8][4];
  auto build = [&](uint32_t (&h)[kKT / 8][4], uint32_t (&l)[kKT / 8][4]) {
#pragma unroll
    for (int q = 0; q < kKT / 8; ++q) {
      const int j0 = j_cur;
      split_z(xa * x0a[j0 + t], h[q][0], l[q][0]);
      split_z(xb * x0b[j0 + t], h[q][1], l[q][1]);
      split_z(xa * x0a[j0 + t + 4], h[q][2], l[q][2]);
      split_z(xb * x0b[j0 + t + 4], h[q][3], l[q][3]);
      j_cur += 8;
      if (j_cur == a.Fp) {             // uniform: a k-step holds one i
        j_cur = 0;
        ++i_cur;
        xa = xa_n;
        xb = xb_n;
        xa_n = xk_at(xka, i_cur + 1, a);
        xb_n = xk_at(xkb, i_cur + 1, a);
      }
    }
  };
  // K tile it's products, one group: B core matrices (n / 8, k / 4) at
  // ((n / 8) * kKT / 4 + k / 4) * 128 bytes, so 128 bytes between K
  // neighbours and kKT * 32 between groups of 8 rows n; k-step q starts
  // 2 q core matrices in
  auto issue = [&](int it, const uint32_t (&h)[kKT / 8][4],
                   const uint32_t (&l)[kKT / 8][4]) {
    const int s = it % a.stages;
    hop::mbar_wait(full + s, (it / a.stages) & 1);
    const float* bhi = stages + s * 2 * kPart;
    const float* blo = bhi + kPart;
    hop::wgmma_fence();
#pragma unroll
    for (int q = 0; q < kKT / 8; ++q) {
      const uint64_t dhi = hop::make_desc(bhi + q * 64, 128, kKT * 32,
                                          hop::kNoSwizzle);
      const uint64_t dlo = hop::make_desc(blo + q * 64, 128, kKT * 32,
                                          hop::kNoSwizzle);
      hop::wgmma_tf32_rs(acc, h[q], dhi, it > 0 || q > 0);
      hop::wgmma_tf32_rs(acc, h[q], dlo, 1);
      hop::wgmma_tf32_rs(acc, l[q], dhi, 1);
    }
    hop::wgmma_commit();
  };
  // once the products of K tile it are done, its stage goes back to the
  // producer (one arrival a warp)
  auto release = [&](int it) {
    if (lane == 0) hop::mbar_arrive(empty + it % a.stages);
  };
  for (int it = 0; it < nk; it += 2) {
    if (it > 0) {
      hop::wgmma_wait<1>();            // tile it - 2 is done
      hop::reg_fence(h0);
      hop::reg_fence(l0);
      release(it - 2);
    }
    build(h0, l0);
    issue(it, h0, l0);
    if (it + 1 < nk) {
      if (it > 0) {
        hop::wgmma_wait<1>();          // tile it - 1 is done
        hop::reg_fence(h1);
        hop::reg_fence(l1);
        release(it - 1);
      }
      build(h1, l1);
      issue(it + 1, h1, l1);
    }
  }
  hop::wgmma_wait<0>();
  hop::reg_fence(h0);
  hop::reg_fence(l0);
  hop::reg_fence(h1);
  hop::reg_fence(l1);
  hop::reg_fence(acc);

  if (a.splits > 1) {
    // each range's partial, then the last CTA of the tile to arrive sums
    // them in range order, every range's loads issued together
    __shared__ int s_last;
    const long long tile = static_cast<long long>(blockIdx.x) * gridDim.y + ht;
    float* rec = partial + tile * a.splits * (NB / 2) * kConsumerThreads + tid;
#pragma unroll
    for (int e = 0; e < NB / 2; ++e)
      rec[(static_cast<long long>(split) * (NB / 2) + e) * kConsumerThreads] =
          acc[e];
    __threadfence();
    consumers_sync();
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == a.splits - 1;
    consumers_sync();
    if (!s_last) return;
    __threadfence();
    for (int q = 0; q < a.splits; ++q) {
      const float* part = rec + static_cast<long long>(q) * (NB / 2) *
                                    kConsumerThreads;
#pragma unroll
      for (int e = 0; e < NB / 2; ++e) {   // past L1: other SMs wrote it
        const float v = __ldcg(part + e * kConsumerThreads);
        acc[e] = q == 0 ? v : acc[e] + v;
      }
    }
    if (tid == 0) counters[tile] = 0;    // ready for the next launch
  }

  // ---- out[b, h, d]: accumulator entry 4 m + e is row (e < 2 ? ra : rb),
  // n = 8 m + 2 t + e % 2; out + (b H + h) D + d for c = b D + d
  T* out_c[2] = {nullptr, nullptr};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long c = r == 0 ? ca : cb;
    if (c < a.cols)
      out_c[r] = out + (c / a.D * a.H + ht * NB) * a.D + c % a.D;
  }
  const int h_end = a.H - ht * NB;       // rows n of this tile in [0, H)
#pragma unroll
  for (int m = 0; m < NB / 8; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * m + 2 * t + e % 2;
      if (out_c[e / 2] && n < h_end)
        out_c[e / 2][static_cast<long long>(n) * a.D] =
            from_f32<T>(acc[4 * m + e]);
    }
  }
}

size_t smem_bytes(int nb, int stages, int Fp) {
  return static_cast<size_t>(stages) * 2 * nb * kKT * 4 +
         static_cast<size_t>(kTileC) * (Fp + 4) * 4 + 2 * kMaxStages * 8;
}

// Each instance opts in to the dynamic shared memory it needs (the
// attribute belongs to the instantiated function).
template <typename T, int NB>
cudaError_t run(const void* xk, const void* x0, const void* wp, void* out,
                void* partial, void* counters, CinArgs a, int h_tiles,
                cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  a.stages = kMaxStages;
  while (a.stages > 2 && smem_bytes(NB, a.stages, a.Fp) > kSmemMax)
    --a.stages;
  const size_t smem = smem_bytes(NB, a.stages, a.Fp);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        cin_tc<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const long long tiles = (a.cols + kTileC - 1) / kTileC;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(h_tiles),
                  static_cast<unsigned>(a.splits));
  cin_tc<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xk), static_cast<const T*>(x0),
      static_cast<const float*>(wp), static_cast<T*>(out),
      static_cast<float*>(partial), static_cast<int32_t*>(counters), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int nb, const void* xk, const void* x0, const void* wp,
                     void* out, void* partial, void* counters, CinArgs a,
                     int h_tiles, cudaStream_t s) {
  if (nb == 200)
    return run<T, 200>(xk, x0, wp, out, partial, counters, a, h_tiles, s);
  if (nb == 64)
    return run<T, 64>(xk, x0, wp, out, partial, counters, a, h_tiles, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of xk, x0 and out): 0 = f32, 1 = bf16. wp is w packed by
// kernel_weights for product width nb (200 or 64): [ceil(H / nb)]
// [k_tiles][2][nb / 8][8][8][4] f32. partial holds splits * 128 * nb
// floats per (column tile, h tile) when splits > 1; counters one int per
// (column tile, h tile), zero.
extern "C" int repro_cin_layer(const void* xk, const void* x0,
                               const void* wp, void* out, int dtype,
                               long long B, int Hp, int F, int H, int nb,
                               int D, int k_tiles, int splits, void* partial,
                               void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Fp = (F + 7) / 8 * 8;
  const int h_tiles = nb > 0 ? (H + nb - 1) / nb : 0;
  if (B <= 0 || Hp <= 0 || F <= 0 || H <= 0 || D <= 0 || nb <= 0 ||
      k_tiles != (Hp * Fp + kKT - 1) / kKT || splits < 1 ||
      splits > k_tiles || (splits > 1 && (!partial || !counters)) ||
      (B * D + kTileC - 1) / kTileC > 0x7fffffffLL || h_tiles > 65535 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CinArgs a{B * D, Hp, F, Fp, H, D, k_tiles, splits, kMaxStages};
  if (dtype == 0)
    return static_cast<int>(
        by_width<float>(nb, xk, x0, wp, out, partial, counters, a, h_tiles,
                        s));
  if (dtype == 1)
    return static_cast<int>(by_width<__nv_bfloat16>(
        nb, xk, x0, wp, out, partial, counters, a, h_tiles, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
