// The gradient of one xDeepFM CIN layer (cin.cu's function
//
//   out[b, h, d] = sum_{i < Hp, j < F} w[h, i, j] * xk[b, i, d] * x0[b, j, d])
//
// with respect to w and x0, from the output's gradient g [B, H, D]:
//
//   dw[h, i, j]  = sum_{b, d} g[b, h, d] * xk[b, i, d] * x0[b, j, d]
//   dx0[b, j, d] = sum_i xk[b, i, d] * u_i[b, j, d],
//                  u_i[b, j, d] = sum_h g[b, h, d] * w[h, i, j]
//
// g, xk, x0 contiguous, f32 or bf16 (one type); dw in f32 [H, Hp, F]; dx0
// in the inputs' type [B, F, D]; w as dx0_weights (kernels/cin.py) packs
// it; sums in f32. (dxk is a launch of cin.cu's layer on w.permute(1, 0,
// 2), which is that kernel's own shape.)
//
// Replaces: no Pallas kernel. The JAX package differentiates cin_apply's
// einsums (src/repro/models/recsys.py) in XLA; the port's plain versions
// are cin_weight_grad_plain and cin_dx0_plain (kernels/cin.py), which
// these kernels are held against. They take the place of the chunked f32
// GEMM over a materialised outer product (dw) and of a launch of cin.cu
// on the general width N = 64 with K = H * Hp (dx0).
//
// What bounds them on the H100: operations, 2 * B * H * Hp * F * D FLOP
// each (1.0e13 at train_batch's B = 65,536, Hp = H = 200, F = 39, D = 10:
// 153 ms at the 67 TFLOP/s f32 rate of the CUDA cores). Both run on the
// TF32 tensor cores in three products per term (hi * hi, hi * lo, lo *
// hi, as cin.cu), which keeps about f32's accuracy: their own floor is 3x
// the products at 495 TFLOP/s, 12.7 ms each at train_batch (F padded to
// 40); the bytes (~1.3 GB, 0.4 ms) do not bound them.
//
// Design, shared: warp-specialized as cin.cu. A producer warpgroup (its
// registers given away by setmaxnreg) has one thread issue bulk copies
// into an mbarrier ring; two consumer warpgroups of 64 rows each run
// m64n200k8 (or m64n64k8) TF32 wgmma. A pre-pass of the same launch packs
// the operands that the tensor cores read (K-major 8 x 4 core matrices,
// split into TF32 hi and lo) into scratch the wrapper allocates.
//
// dw: the product dw^T[(i, j), h] = sum_c z^T[(i, j), c] g[c, h] over the
// columns c = b * D + d.
//   * M = (i, j): a warpgroup's 64 rows are 8 i by 8 j (row r: i = r / 8,
//     j = r % 8), a CTA's 16 i by 8 j; Hp is padded to 16, F to 8. A
//     thread's two A rows (ra, ra + 8) then share j and take i, i + 1.
//   * A = z^T never reaches memory: each thread forms its fragment's four
//     z = xk[c, i] * x0[c, j] in f32 from the stage's xk (16 i) and x0 (8
//     j) columns and splits each into hi and lo, as cin.cu forms z; the
//     fragments of two K tiles are held (reg_fence), one tile's built
//     while the other's products run.
//   * B = g, N = H: the pre-pass writes g^T [H, cols] split, in the layout
//     of cin.cu's packed weight (N = 200 where H = 200, else tiles of 64),
//     so that a K tile of 32 columns is one contiguous block; the packed
//     xk [K tiles][Hp / 16][32][16] and x0 [K tiles][Fp / 8][32][8] give
//     the CTA its columns in two more bulk copies of the same stage.
//   * K (the columns, 655,360 at train_batch) is split into ranges of at
//     most 256 tiles, one CTA each, so that the tensor cores' f32
//     accumulation runs no longer than the forward's longest K, and so
//     that a few columns still fill the card; within a range the
//     accumulator is added into an f32 carry (the CTA's partial slot)
//     every 64 tiles: at train_batch's Hp = 200 layer that cut the error
//     from 5.3e-5 to 1.3e-5 of the largest entry, for 1.3 ms (18.0
//     against 16.6 ms, one call, H100 at 700 W). Each CTA writes its
//     partial and the last to arrive (a counter per tile, reset by that
//     CTA) sums them in range order. No atomics on values: two runs give
//     the same bits.
// dx0: for each i, u_i = G W_i with G the CTA's [128 c, H] block of g.
//   * M = c (64 per warpgroup), K = h, N = 200 = (i, j) over a group of
//     200 / Fq values of i, F padded to Fq (40 or 200: 40 for F = 39,
//     five i a product). F above 200 runs in blocks of 200 fields
//     (blockIdx.z), each with its own packed w; g's pre-pass serves all.
//   * A = G is read, not formed: the pre-pass writes it split into hi and
//     lo in chunks of 40 h (H padded to them); a chunk (40 KB) arrives in
//     shared memory (two chunk buffers, so the next one loads while the
//     last is in use), and each thread loads its fragment of the chunk
//     (5 k-steps, hi and lo: 40 registers) once for all the chunk's
//     groups of i; the products take A from registers, as cin.cu's (A
//     read by each product from shared memory took 22.4 ms at
//     train_batch's Hp = 200 layer, from registers 18.2-18.5, one call,
//     H100 at 700 W; registers for A and both accumulators do not fit at
//     Fq = 200, whose instance spills ~400 bytes). One i a product (N =
//     Fq = 40) would spend a product of 64 x 40 on each A fragment; N =
//     200 spends five times as much.
//   * B = w packed per (chunk, group, k-step of 8 h): 12.8 KB stages in a
//     ring of up to 11.
//   * The epilogue of a (chunk, group) scales u by xk[c, i] (loaded while
//     the products run) and adds it into the dx0 accumulator in
//     registers. (Making the two warpgroups take turns on the tensor
//     cores, so that one's epilogue ran under the other's products, was
//     slower: 25.9 against 22.4 ms with A in shared memory.) No [B, Hp,
//     F, D] tensor and no product of width 64 with 25 padded columns: the
//     work is the forward's.
//   * Few columns (serve_p99: 40 tiles) split the (chunk, group) units
//     over CTAs, summed as dw's ranges.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;   // + a producer warpgroup
constexpr int kProducerRegs = 24;              // setmaxnreg budgets (x 128
constexpr int kConsumerRegs = 240;             // threads, 24 + 2 x 240 <= 512)
constexpr int kSmemMax = 232448;               // an H100 CTA's opt-in
constexpr int kPackThreads = 256;

// dw
constexpr int kKT = 32;                        // columns c per K tile
constexpr int kIB = 16;                        // i of a CTA tile (8 a wg)
constexpr int kJB = 8;                         // j of a CTA tile
constexpr int kDwMaxStages = 4;
// the tensor cores' f32 accumulation loses more the longer it runs: every
// kFold K tiles (2,048 columns) the accumulator is added into the CTA's
// f32 carry and starts again
constexpr int kFold = 64;

// dx0
constexpr int kTileC = 64 * kConsumers;        // columns c per CTA
constexpr int kN = 200;                        // (i, j) of a product
constexpr int kChunk = 40;                     // h per chunk of A
constexpr int kChunkSteps = kChunk / 8;
constexpr int kAPart = kTileC * kChunk;        // floats of one part
constexpr int kBStage = 2 * kN * 8;            // floats of a k-step's B
constexpr int kDx0MaxStages = 11;

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

// z split into TF32 hi and lo (lo exact: z - hi)
__device__ __forceinline__ void split_z(float z, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(z);
  lo = __float_as_uint(__fsub_rn(z, __uint_as_float(hi)));
}

// the packers' split, bit for bit as kernels/cin.py tf32_split: hi
// rounded to nearest (ties away from zero) with its low 13 bits clear
__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & ~0x1FFFu);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// ---- pre-pass: the K-major split packing of a matrix M[r, k] read from
// g [B, H, D] (r = h, k = c for dw's B; r = c, k = h for dx0's A), as
// kernels/cin.py _tile_kmajor lays it out: [r tiles][k tiles][2][nb / 8]
// [kt / 4][8][4], zeros past H and past the columns
template <typename T>
__global__ void pack_kmajor(const T* __restrict__ g, float* __restrict__ out,
                            long long cols, int H, int D, int nb, int kt,
                            long long k_tiles, bool rows_are_c,
                            long long total) {
  const long long block = static_cast<long long>(nb) * kt;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long x = e;
    const int kr = static_cast<int>(x % 4); x /= 4;
    const int nr = static_cast<int>(x % 8); x /= 8;
    const int k4 = static_cast<int>(x % (kt / 4)); x /= kt / 4;
    const int n8 = static_cast<int>(x % (nb / 8)); x /= nb / 8;
    const long long kti = x % k_tiles, rti = x / k_tiles;
    const long long r = rti * nb + n8 * 8 + nr;
    const long long k = kti * kt + k4 * 4 + kr;
    const long long c = rows_are_c ? r : k;
    const long long h = rows_are_c ? k : r;
    const float v = c < cols && h < H
                        ? to_f32(g[(c / D * H + h) * D + c % D])
                        : 0.f;
    const float hi = tf32_hi(v);
    float* dst = out + (rti * k_tiles + kti) * 2 * block + e % block;
    dst[0] = hi;
    dst[block] = v - hi;
  }
}

// ---- pre-pass: dw's A columns, src [B, R, D] as [K tiles][R / RB][kKT]
// [RB] in f32 (zeros past R and past the columns)
template <typename T>
__global__ void pack_columns(const T* __restrict__ src,
                             float* __restrict__ out, long long cols, int R,
                             int D, int rb, int blocks, long long total) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long x = e;
    const int rr = static_cast<int>(x % rb); x /= rb;
    const int k = static_cast<int>(x % kKT); x /= kKT;
    const int bi = static_cast<int>(x % blocks);
    const long long c = x / blocks * kKT + k;
    const int r = bi * rb + rr;
    out[e] = c < cols && r < R
                 ? to_f32(src[(c / D * R + r) * D + c % D])
                 : 0.f;
  }
}

template <typename K, typename... Args>
cudaError_t launch_pack(K kernel, long long total, cudaStream_t s,
                        Args... args) {
  if (total <= 0) return cudaSuccess;
  const long long want = (total + kPackThreads - 1) / kPackThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  kernel<<<blocks, kPackThreads, 0, s>>>(args..., total);
  return cudaGetLastError();
}

// ---- dw ------------------------------------------------------------------
struct DwArgs {
  long long cols;       // B * D
  int Hp, F, H;
  int i_blocks, j_blocks;   // ceil(Hp / 16), ceil(F / 8)
  int k_tiles;          // K tiles of 32 columns
  int splits;           // K ranges (blockIdx.z)
  int stages;
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
cin_dw_tc(const float* __restrict__ gp, const float* __restrict__ xkp,
          const float* __restrict__ x0p, float* __restrict__ dw,
          float* __restrict__ partial, int32_t* __restrict__ counters,
          DwArgs a) {
  constexpr int kPart = NB * kKT;                // floats of one g part
  constexpr int kXs = kKT * kIB;                 // floats of xk columns
  constexpr int kYs = kKT * kJB;                 // floats of x0 columns
  constexpr int kStage = 2 * kPart + kXs + kYs;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + a.stages * kStage);
  uint64_t* empty = full + kDwMaxStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = blockIdx.x;
  const int ib = mt / a.j_blocks, jb = mt % a.j_blocks;
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
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: stage i of the ring holds K tile kt0 + i (its g block
    // and the CTA's xk and x0 columns); one thread issues the copies
    hop::regs_release<kProducerRegs>();
    if (tid == kConsumerThreads) {
      const float* src = gp + (static_cast<long long>(ht) * a.k_tiles + kt0) *
                                  2 * kPart;
      for (int i = 0; i < nk; ++i) {
        const int s = i % a.stages;
        if (i >= a.stages) hop::mbar_wait(empty + s, (i / a.stages - 1) & 1);
        hop::mbar_expect_tx(full + s, kStage * 4);
        float* dst = stages + s * kStage;
        const float* from = src + static_cast<long long>(i) * 2 * kPart;
        const long long kt = kt0 + i;
        hop::bulk_load(dst, from, kPart * 4, full + s);
        hop::bulk_load(dst + kPart, from + kPart, kPart * 4, full + s);
        hop::bulk_load(dst + 2 * kPart, xkp + (kt * a.i_blocks + ib) * kXs,
                       kXs * 4, full + s);
        hop::bulk_load(dst + 2 * kPart + kXs,
                       x0p + (kt * a.j_blocks + jb) * kYs, kYs * 4,
                       full + s);
      }
    }
    return;
  }

  // ---- consumers: thread (warp wl of warpgroup wg, lane 4 g + t) holds A
  // rows ra = 16 wl + g (i = 16 ib + 8 wg + 2 wl, j = 8 jb + g) and ra + 8
  // (i + 1, the same j), k columns t and t + 4 of each k-step
  hop::regs_claim<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int il = wg * 8 + 2 * wl;                // the stage's xk column

  hop::Acc<NB> acc;    // the first product overwrites it (scale_d = 0)

  // the A fragments of a K tile (4 k-steps, hi and lo parts) for two
  // tiles: one tile's are built while the other's products run, and
  // neither is rewritten before the products that read it are done
  uint32_t h0[kKT / 8][4], l0[kKT / 8][4], h1[kKT / 8][4], l1[kKT / 8][4];
  auto build = [&](int it, uint32_t (&h)[kKT / 8][4],
                   uint32_t (&l)[kKT / 8][4]) {
    const int s = it % a.stages;
    hop::mbar_wait(full + s, (it / a.stages) & 1);
    const float* xs = stages + s * kStage + 2 * kPart;   // [kKT][kIB]
    const float* ys = xs + kXs;                          // [kKT][kJB]
#pragma unroll
    for (int q = 0; q < kKT / 8; ++q) {
      const int k0 = 8 * q + t, k1 = k0 + 4;
      const float2 xa = *reinterpret_cast<const float2*>(xs + k0 * kIB + il);
      const float2 xb = *reinterpret_cast<const float2*>(xs + k1 * kIB + il);
      const float y0 = ys[k0 * kJB + g], y1 = ys[k1 * kJB + g];
      split_z(xa.x * y0, h[q][0], l[q][0]);
      split_z(xa.y * y0, h[q][1], l[q][1]);
      split_z(xb.x * y1, h[q][2], l[q][2]);
      split_z(xb.y * y1, h[q][3], l[q][3]);
    }
  };
  // K tile it's products, one group: B core matrices (n / 8, k / 4) at
  // ((n / 8) * kKT / 4 + k / 4) * 128 bytes; k-step q starts 2 q core
  // matrices in
  auto issue = [&](int it, const uint32_t (&h)[kKT / 8][4],
                   const uint32_t (&l)[kKT / 8][4], bool accumulate) {
    const float* bhi = stages + (it % a.stages) * kStage;
    const float* blo = bhi + kPart;
    hop::wgmma_fence();
#pragma unroll
    for (int q = 0; q < kKT / 8; ++q) {
      const uint64_t dhi = hop::make_desc(bhi + q * 64, 128, kKT * 32,
                                          hop::kNoSwizzle);
      const uint64_t dlo = hop::make_desc(blo + q * 64, 128, kKT * 32,
                                          hop::kNoSwizzle);
      hop::wgmma_tf32_rs(acc, h[q], dhi, accumulate || q > 0);
      hop::wgmma_tf32_rs(acc, h[q], dlo, 1);
      hop::wgmma_tf32_rs(acc, l[q], dhi, 1);
    }
    hop::wgmma_commit();
  };
  auto release = [&](int it) {
    if (lane == 0) hop::mbar_arrive(empty + it % a.stages);
  };
  // the CTA's partial slot: its f32 carry of the accumulator, added in
  // every kFold K tiles (where the range has more), then its partial
  auto slot = [&]() {
    const long long tile = static_cast<long long>(mt) * gridDim.y + ht;
    return partial + (tile * a.splits + split) * (NB / 2) * kConsumerThreads +
           tid;
  };
  for (int it = 0; it < nk; it += 2) {
    const bool fold = it > 0 && it % kFold == 0;
    if (fold) {
      hop::wgmma_wait<0>();            // tiles it - 2 and it - 1 are done
      hop::reg_fence(h0);
      hop::reg_fence(l0);
      hop::reg_fence(h1);
      hop::reg_fence(l1);
      hop::reg_fence(acc);
      release(it - 2);
      release(it - 1);
      float* c = slot();
#pragma unroll
      for (int e = 0; e < NB / 2; ++e)
        c[e * kConsumerThreads] =
            it == kFold ? acc[e] : c[e * kConsumerThreads] + acc[e];
    } else if (it > 0) {
      hop::wgmma_wait<1>();            // tile it - 2 is done
      hop::reg_fence(h0);
      hop::reg_fence(l0);
      release(it - 2);
    }
    build(it, h0, l0);
    issue(it, h0, l0, it % kFold != 0);
    if (it + 1 < nk) {
      if (it > 0 && !fold) {
        hop::wgmma_wait<1>();          // tile it - 1 is done
        hop::reg_fence(h1);
        hop::reg_fence(l1);
        release(it - 1);
      }
      build(it + 1, h1, l1);
      issue(it + 1, h1, l1, true);
    }
  }
  hop::wgmma_wait<0>();
  hop::reg_fence(h0);
  hop::reg_fence(l0);
  hop::reg_fence(h1);
  hop::reg_fence(l1);
  hop::reg_fence(acc);
  if (nk > kFold) {
    const float* c = slot();
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) acc[e] += c[e * kConsumerThreads];
  }

  if (a.splits > 1) {
    // each range's partial, then the last CTA of the tile to arrive sums
    // them in range order
    __shared__ int s_last;
    const long long tile = static_cast<long long>(mt) * gridDim.y + ht;
    float* rec = partial + tile * a.splits * (NB / 2) * kConsumerThreads + tid;
    float* mine = slot();
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) mine[e * kConsumerThreads] = acc[e];
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

  // ---- dw[h, i, j]: accumulator entry 4 m + e is row (e < 2 ? ra : rb),
  // n = 8 m + 2 t + e % 2, h = ht NB + n
  const int i0 = ib * kIB + il, j = jb * kJB + g;
  if (j >= a.F) return;
#pragma unroll
  for (int m = 0; m < NB / 8; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = ht * NB + 8 * m + 2 * t + e % 2;
      const int i = i0 + e / 2;
      if (h < a.H && i < a.Hp)
        dw[(static_cast<long long>(h) * a.Hp + i) * a.F + j] = acc[4 * m + e];
    }
  }
}

size_t dw_smem_bytes(int nb, int stages) {
  return static_cast<size_t>(stages) * (2 * nb * kKT + kKT * (kIB + kJB)) *
             4 + 2 * kDwMaxStages * 8;
}

template <int NB>
cudaError_t run_dw(const float* gp, const float* xkp, const float* x0p,
                   float* dw, void* partial, void* counters, DwArgs a,
                   int h_tiles, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  a.stages = kDwMaxStages;
  while (a.stages > 2 && dw_smem_bytes(NB, a.stages) > kSmemMax) --a.stages;
  const size_t smem = dw_smem_bytes(NB, a.stages);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        cin_dw_tc<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const dim3 grid(static_cast<unsigned>(a.i_blocks * a.j_blocks),
                  static_cast<unsigned>(h_tiles),
                  static_cast<unsigned>(a.splits));
  cin_dw_tc<NB><<<grid, kThreads, smem, stream>>>(
      gp, xkp, x0p, dw, static_cast<float*>(partial),
      static_cast<int32_t*>(counters), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_all(const void* g, const void* xk, const void* x0, long long B,
                   int Hp, int F, int H, int D, int nb, DwArgs a, int h_tiles,
                   float* gp, float* xkp, float* x0p, float* dw,
                   void* partial, void* counters, cudaStream_t s) {
  const long long cols = B * D;
  cudaError_t err = launch_pack(
      pack_kmajor<T>,
      static_cast<long long>(h_tiles) * a.k_tiles * nb * kKT, s,
      static_cast<const T*>(g), gp, cols, H, D, nb, kKT,
      static_cast<long long>(a.k_tiles), false);
  if (err != cudaSuccess) return err;
  err = launch_pack(pack_columns<T>,
                    static_cast<long long>(a.k_tiles) * a.i_blocks * kKT * kIB,
                    s, static_cast<const T*>(xk), xkp, cols, Hp, D, kIB,
                    a.i_blocks);
  if (err != cudaSuccess) return err;
  err = launch_pack(pack_columns<T>,
                    static_cast<long long>(a.k_tiles) * a.j_blocks * kKT * kJB,
                    s, static_cast<const T*>(x0), x0p, cols, F, D, kJB,
                    a.j_blocks);
  if (err != cudaSuccess) return err;
  if (nb == 200)
    return run_dw<200>(gp, xkp, x0p, dw, partial, counters, a, h_tiles, s);
  if (nb == 64)
    return run_dw<64>(gp, xkp, x0p, dw, partial, counters, a, h_tiles, s);
  return cudaErrorInvalidValue;
}

// ---- dx0 -----------------------------------------------------------------
struct Dx0Args {
  long long cols;       // B * D
  int Hp, F, H, D;
  int chunks;           // ceil(H / 40)
  int groups;           // ceil(Hp / (200 / Fq))
  int units;            // chunks * groups, chunk major
  int splits;           // unit ranges (blockIdx.y)
  int stages;
};

// P = Fq / 8: the product's 200 columns n = 8 m + ... are i = m / P of
// the group and j = 8 (m % P) + ..., so that entry 4 m + e of u adds into
// entry 4 (m % P) + e of the dx0 accumulator (an m64n(Fq) layout)
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
cin_dx0_tc(const T* __restrict__ xk, const float* __restrict__ ga,
           const float* __restrict__ wb, T* __restrict__ out,
           float* __restrict__ partial, int32_t* __restrict__ counters,
           Dx0Args a) {
  constexpr int kFq = 8 * P;
  constexpr int kIg = kN / kFq;                  // i of a group
  extern __shared__ __align__(128) unsigned char smem[];
  float* abuf = reinterpret_cast<float*>(smem);  // [2][2][16][10][8][4]
  float* bst = abuf + 2 * 2 * kAPart;            // [stages][2][25][2][8][4]
  uint64_t* a_full = reinterpret_cast<uint64_t*>(bst + a.stages * kBStage);
  uint64_t* a_empty = a_full + 2;
  uint64_t* b_full = a_empty + 2;
  uint64_t* b_empty = b_full + kDx0MaxStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = blockIdx.x, split = blockIdx.y, fb = blockIdx.z;
  // the (field block, column tile) whose partials and counter this is
  const long long tile = static_cast<long long>(fb) * gridDim.x + ct;
  const int u0 = static_cast<int>(static_cast<long long>(split) * a.units /
                                  a.splits);
  const int u1 = static_cast<int>(static_cast<long long>(split + 1) *
                                  a.units / a.splits);

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      hop::mbar_init(a_full + b, 1);
      hop::mbar_init(a_empty + b, 4 * kConsumers);
    }
    for (int s = 0; s < a.stages; ++s) {
      hop::mbar_init(b_full + s, 1);
      hop::mbar_init(b_empty + s, 4 * kConsumers);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer: the A chunk at each unit that starts one (into the
    // chunk buffer that is free), then the unit's k-steps of B
    hop::regs_release<kProducerRegs>();
    if (tid == kConsumerThreads) {
      int lc = -1, bs = 0;
      for (int u = u0; u < u1; ++u) {
        const int ch = u / a.groups, gr = u % a.groups;
        if (u == u0 || gr == 0) {
          ++lc;
          const int b = lc & 1;
          if (lc >= 2) hop::mbar_wait(a_empty + b, ((lc >> 1) - 1) & 1);
          hop::mbar_expect_tx(a_full + b, 2 * kAPart * 4);
          const float* src =
              ga + (static_cast<long long>(ct) * a.chunks + ch) * 2 * kAPart;
          float* dst = abuf + b * 2 * kAPart;
          hop::bulk_load(dst, src, kAPart * 4, a_full + b);
          hop::bulk_load(dst + kAPart, src + kAPart, kAPart * 4, a_full + b);
        }
        const float* src =
            wb + ((static_cast<long long>(fb) * a.chunks + ch) * a.groups +
                  gr) * kChunkSteps * kBStage;
        for (int q = 0; q < kChunkSteps; ++q, ++bs) {
          const int s = bs % a.stages;
          if (bs >= a.stages)
            hop::mbar_wait(b_empty + s, (bs / a.stages - 1) & 1);
          hop::mbar_expect_tx(b_full + s, kBStage * 4);
          hop::bulk_load(bst + s * kBStage, src + q * kBStage, kBStage * 4,
                         b_full + s);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns columns wg * 64 .. + 63 of the tile;
  // thread (warp wl, lane 4 g + t) holds rows ra = 16 wl + g and ra + 8
  hop::regs_claim<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int ra = wg * 64 + wl * 16 + g;
  const long long c0 = static_cast<long long>(ct) * kTileC;
  const long long ca = c0 + ra, cb = ca + 8;
  const T* xka = ca < a.cols ? xk + ca / a.D * a.Hp * a.D + ca % a.D : nullptr;
  const T* xkb = cb < a.cols ? xk + cb / a.D * a.Hp * a.D + cb % a.D : nullptr;

  hop::Acc<kN> u;       // each unit's first product overwrites it
  hop::Acc<kFq> dx;
#pragma unroll
  for (int e = 0; e < kFq / 2; ++e) dx[e] = 0.f;

  // the chunk's A fragments (5 k-steps, hi and lo), loaded once a chunk
  // from its shared-memory buffer: thread (wl, 4 g + t) holds rows ra and
  // ra + 8, k columns t and t + 4 of each k-step
  uint32_t ah[kChunkSteps][4], al[kChunkSteps][4];
  int lc = -1, bs = 0;
  for (int un = u0; un < u1; ++un) {
    const int gr = un % a.groups;
    if (un == u0 || gr == 0) {
      ++lc;
      hop::mbar_wait(a_full + (lc & 1), (lc >> 1) & 1);
      // element (m, k) of a part at ((m / 8) * 10 + k / 4) * 32 + (m % 8)
      // * 4 + k % 4 floats
      const float* as = abuf + (lc & 1) * 2 * kAPart;
#pragma unroll
      for (int q = 0; q < kChunkSteps; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = ra + (r & 1) * 8, k = 8 * q + t + (r >> 1) * 4;
          const int off = ((m / 8) * (kChunk / 4) + k / 4) * 32 + g * 4 + t;
          ah[q][r] = __float_as_uint(as[off]);
          al[q][r] = __float_as_uint(as[kAPart + off]);
        }
      }
    }
    // the group's xk[c, i] of both rows, loaded while the products run
    float xv[kIg][2];
#pragma unroll
    for (int il = 0; il < kIg; ++il) {
      const int i = gr * kIg + il;
      xv[il][0] = xka && i < a.Hp
                      ? to_f32(xka[static_cast<long long>(i) * a.D]) : 0.f;
      xv[il][1] = xkb && i < a.Hp
                      ? to_f32(xkb[static_cast<long long>(i) * a.D]) : 0.f;
    }
    // B part p of a stage: core matrices (n / 8, k / 4) at ((n / 8) * 2 +
    // k / 4) * 128 bytes; one group a k-step, each after its stage arrived
#pragma unroll
    for (int q = 0; q < kChunkSteps; ++q) {
      const int s = (bs + q) % a.stages;
      hop::mbar_wait(b_full + s, ((bs + q) / a.stages) & 1);
      hop::wgmma_fence();
      const float* bhi = bst + s * kBStage;
      const uint64_t dbh = hop::make_desc(bhi, 128, 256, hop::kNoSwizzle);
      const uint64_t dbl = hop::make_desc(bhi + kN * 8, 128, 256,
                                          hop::kNoSwizzle);
      hop::wgmma_tf32_rs(u, ah[q], dbh, q > 0);
      hop::wgmma_tf32_rs(u, ah[q], dbl, 1);
      hop::wgmma_tf32_rs(u, al[q], dbh, 1);
      hop::wgmma_commit();
    }
    hop::wgmma_wait<0>();
    hop::reg_fence(u);
    hop::reg_fence(ah);
    hop::reg_fence(al);
    if (lane == 0) {
      for (int q = 0; q < kChunkSteps; ++q)
        hop::mbar_arrive(b_empty + (bs + q) % a.stages);
      if (un + 1 == u1 || (un + 1) % a.groups == 0)
        hop::mbar_arrive(a_empty + (lc & 1));
    }
    bs += kChunkSteps;
#pragma unroll
    for (int m = 0; m < kN / 8; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dx[4 * (m % P) + e] = fmaf(xv[m / P][e / 2], u[4 * m + e],
                                   dx[4 * (m % P) + e]);
    }
  }

  if (a.splits > 1) {
    __shared__ int s_last;
    float* rec = partial +
                 tile * a.splits * (kFq / 2) * kConsumerThreads + tid;
#pragma unroll
    for (int e = 0; e < kFq / 2; ++e)
      rec[(static_cast<long long>(split) * (kFq / 2) + e) * kConsumerThreads] =
          dx[e];
    __threadfence();
    consumers_sync();
    if (tid == 0) s_last = atomicAdd(counters + tile, 1) == a.splits - 1;
    consumers_sync();
    if (!s_last) return;
    __threadfence();
    for (int q = 0; q < a.splits; ++q) {
      const float* part = rec + static_cast<long long>(q) * (kFq / 2) *
                                    kConsumerThreads;
#pragma unroll
      for (int e = 0; e < kFq / 2; ++e) {
        const float v = __ldcg(part + e * kConsumerThreads);
        dx[e] = q == 0 ? v : dx[e] + v;
      }
    }
    if (tid == 0) counters[tile] = 0;
  }

  // ---- dx0[b, j, d]: entry 4 p + e is row (e < 2 ? ra : rb), j = Fq fb +
  // 8 p + 2 t + e % 2; out + (b F + j) D + d for c = b D + d
  T* out_c[2] = {nullptr, nullptr};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long c = r == 0 ? ca : cb;
    if (c < a.cols) out_c[r] = out + c / a.D * a.F * a.D + c % a.D;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = kFq * fb + 8 * p + 2 * t + e % 2;
      if (out_c[e / 2] && j < a.F)
        out_c[e / 2][static_cast<long long>(j) * a.D] = from_f32<T>(dx[4 * p + e]);
    }
  }
}

size_t dx0_smem_bytes(int stages) {
  return static_cast<size_t>(2 * 2 * kAPart + stages * kBStage) * 4 +
         (4 + 2 * kDx0MaxStages) * 8;
}

template <typename T, int P>
cudaError_t run_dx0(const void* xk, const float* ga, const void* wb,
                    void* out, void* partial, void* counters, Dx0Args a,
                    int c_tiles, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  a.stages = kDx0MaxStages;
  while (a.stages > 2 && dx0_smem_bytes(a.stages) > kSmemMax) --a.stages;
  const size_t smem = dx0_smem_bytes(a.stages);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        cin_dx0_tc<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const dim3 grid(static_cast<unsigned>(c_tiles),
                  static_cast<unsigned>(a.splits),
                  static_cast<unsigned>((a.F + 8 * P - 1) / (8 * P)));
  cin_dx0_tc<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xk), ga, static_cast<const float*>(wb),
      static_cast<T*>(out), static_cast<float*>(partial),
      static_cast<int32_t*>(counters), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx0_all(const void* g, const void* xk, const void* wb, void* out,
                    int fq, Dx0Args a, int c_tiles, float* ga, void* partial,
                    void* counters, cudaStream_t s) {
  cudaError_t err = launch_pack(
      pack_kmajor<T>,
      static_cast<long long>(c_tiles) * a.chunks * kTileC * kChunk, s,
      static_cast<const T*>(g), ga, a.cols, a.H, a.D, kTileC, kChunk,
      static_cast<long long>(a.chunks), true);
  if (err != cudaSuccess) return err;
  if (fq == 40)
    return run_dx0<T, 5>(xk, ga, wb, out, partial, counters, a, c_tiles, s);
  if (fq == 200)
    return run_dx0<T, 25>(xk, ga, wb, out, partial, counters, a, c_tiles, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dw [H, Hp, F] f32 from g [B, H, D], xk [B, Hp, D], x0 [B, F, D] (dtype
// 0 = f32, 1 = bf16). nb: the product width over h (200 or 64); the
// scratch the wrapper allocates: gp [ceil(H / nb)][k_tiles][2][nb / 8][8]
// [8][4], xkp [k_tiles][ceil(Hp / 16)][32][16], x0p [k_tiles][ceil(F / 8)]
// [32][8] (f32, written here), partial splits * 128 * nb floats per
// (i-j tile, h tile) (each range's carry, then its partial), counters one
// int per tile, zero.
extern "C" int repro_cin_dw(const void* g, const void* xk, const void* x0,
                            int dtype, long long B, int Hp, int F, int H,
                            int D, int nb, int k_tiles, int splits, void* gp,
                            void* xkp, void* x0p, void* dw, void* partial,
                            void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h_tiles = nb > 0 ? (H + nb - 1) / nb : 0;
  const int i_blocks = (Hp + kIB - 1) / kIB, j_blocks = (F + kJB - 1) / kJB;
  if (B <= 0 || Hp <= 0 || F <= 0 || H <= 0 || D <= 0 ||
      (nb != 200 && nb != 64) ||
      k_tiles != (B * D + kKT - 1) / kKT || splits < 1 || splits > k_tiles ||
      splits > 65535 || h_tiles > 65535 ||
      static_cast<long long>(i_blocks) * j_blocks > 0x7fffffffLL ||
      !partial || (splits > 1 && !counters))
    return static_cast<int>(cudaErrorInvalidValue);
  DwArgs a{B * D, Hp, F, H, i_blocks, j_blocks, k_tiles, splits,
           kDwMaxStages};
  float* const f[4] = {static_cast<float*>(gp), static_cast<float*>(xkp),
                       static_cast<float*>(x0p), static_cast<float*>(dw)};
  if (dtype == 0)
    return static_cast<int>(dw_all<float>(g, xk, x0, B, Hp, F, H, D, nb, a,
                                          h_tiles, f[0], f[1], f[2], f[3],
                                          partial, counters, s));
  if (dtype == 1)
    return static_cast<int>(dw_all<__nv_bfloat16>(
        g, xk, x0, B, Hp, F, H, D, nb, a, h_tiles, f[0], f[1], f[2], f[3],
        partial, counters, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx0 [B, F, D] in the inputs' type (dtype 0 = f32, 1 = bf16) from g
// [B, H, D], xk [B, Hp, D] and w packed by dx0_weights for fq (F padded:
// 40, or 200 in blocks of 200 fields): [ceil(F / fq)][ceil(H / 40)]
// [ceil(Hp / (200 / fq))][5][2][25][2][8][4] f32. Scratch: ga
// [ceil(B D / 128)][ceil(H / 40)][2][16][10][8][4] f32 (written here),
// partial splits * 128 * fq floats per (field block, column tile) when
// splits > 1, counters one int per (field block, column tile), zero.
extern "C" int repro_cin_dx0(const void* g, const void* xk, const void* wb,
                             void* out, int dtype, long long B, int Hp, int F,
                             int H, int D, int fq, int splits, void* ga,
                             void* partial, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hp <= 0 || F <= 0 || H <= 0 || D <= 0 ||
      (fq != 40 && fq != 200) || (fq == 40 && F > fq) ||
      (F + fq - 1) / fq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long c_tiles = (B * D + kTileC - 1) / kTileC;
  const int chunks = (H + kChunk - 1) / kChunk;
  const int groups = (Hp + kN / fq - 1) / (kN / fq);
  const int units = chunks * groups;
  if (c_tiles > 0x7fffffffLL || splits < 1 || splits > units ||
      splits > 65535 || (splits > 1 && (!partial || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  Dx0Args a{B * D, Hp, F, H, D, chunks, groups, units, splits,
            kDx0MaxStages};
  if (dtype == 0)
    return static_cast<int>(dx0_all<float>(
        g, xk, wb, out, fq, a, static_cast<int>(c_tiles),
        static_cast<float*>(ga), partial, counters, s));
  if (dtype == 1)
    return static_cast<int>(dx0_all<__nv_bfloat16>(
        g, xk, wb, out, fq, a, static_cast<int>(c_tiles),
        static_cast<float*>(ga), partial, counters, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
