// The gradient of causal GQA attention (flash_attention.cu's function):
// given q, k, v, the forward's output o and its row logsumexp lse, and
// the output's gradient do, write dq, dk and dv in the inputs' dtype,
// summed in f32:
//
//   P  = exp(s - lse)                (s the scaled, capped, masked scores)
//   dV = P^T dO                      D  = rowsum(dO o O)
//   dP = dO V^T                      dS = P o (dP - D) [o (1 - tanh^2)]
//   dQ = dS K scale                  dK = dS^T Q scale
//
// where the factor 1 - tanh^2(x / softcap) applies under a soft-cap, and
// a KV head sums the dK and dV of its group of H / Hk query heads.
// Masked scores give P = 0, so they add nothing.
//
// Replaces: no Pallas kernel. The JAX package takes this gradient by
// autodiff of its plain blockwise_sdpa (src/repro/models/attention.py);
// the port's plain version is flash_attention_bwd_plain
// (kernels/flash_attention.py), which this kernel is held against.
//
// What bounds it on the H100: operations, five products over the kept
// (query, key) pairs (S, dP, dV, dK, dQ; 10 d FLOP a pair and query
// head): a llama3.2-1b layer (B = 2, T = 4,096, H = 32, D = 64) is
// 3.4e11 FLOP, 0.35 ms at the 989 TFLOP/s bf16 rate, against ~0.05 ms
// for its bytes. This design recomputes S and dP in both of its passes
// (seven products).
//
// Design: three launches (f32 with a group of heads: five), no atomics,
// so two runs give the same bits.
//   1. A pre-pass writes D = rowsum(dO o O) in f32 and copies lse, both
//      to [B, H, Tp] (Tp = T rounded up to 64, zeros past T), so that a
//      tile of either is one aligned bulk copy.
//   2. dK, dV: one CTA per (b, KV head, tile of keys) walks the query
//      tiles its keys' window reaches, for each query head of the group
//      in turn, and writes its keys' rows once (bf16; f32 below).
//   3. dQ: one CTA per (b, query head, tile of 128 queries) walks the key
//      tiles its window reaches (longest tiles first), as the forward.
// A tile wholly above the diagonal, outside the window or past T is never
// visited, so a local layer costs O(T * window).
//   * bf16 (wgmma, TMA): warp-specialized as the forward: warpgroup 0
//     produces (one thread issues TMA copies into an mbarrier ring) and
//     gives its registers away (setmaxnreg 24 / 240), warpgroups 1 and 2
//     consume. In pass 2 each consumer owns 64 keys (128 a CTA) for
//     D <= 128; at D = 256 both own the same 64 keys and each holds half
//     of dK's and dV's columns (64 x 256 f32 each would need 256
//     registers a thread), recomputing S^T and dP^T. S^T = K Q^T and
//     dP^T = V dO^T are SS products (K-major); dV += P^T dO and
//     dK += dS^T Q take P^T and dS^T from registers in the A layout of
//     the S^T accumulator (bf16) and read dO and Q MN-major. Query tiles
//     are 64 rows for D <= 64 and 32 above (registers). In pass 3, S and
//     dP are SS products and dQ += dS K reads K MN-major; key tiles are
//     64 (32 at D = 256, for shared memory). P and dS enter their
//     products in bf16, as P enters the forward's P V. A score costs one
//     fma and one ex2 (P = 2^(s scale log2 e - lse log2 e), the pre-pass
//     storing lse log2 e), and the mask is computed only on the tiles it
//     cuts: the first version, with a 64-bit mask test and __expf on
//     every score, took twice as long (2.25 against 1.10 ms a llama
//     layer).
//   * f32: CUDA cores (a TF32 product would miss the 1e-4 tolerance).
//     Pass 2: one CTA of 8 warps per (b, query head, 32 keys), 32
//     queries a tile; a thread computes four (key, query) scores, then
//     owns one key's D / 8 columns of dK and dV. With a group of heads,
//     each head's partial sums go to scratch and a sum kernel adds them
//     in head order (one CTA per KV head left the longest CTA with the
//     whole group's queries and the card a quarter full). Pass 3: 16
//     queries a CTA of 4 warps, 32 keys a tile; one query's D / 8
//     columns of dQ a thread. Shared-memory loads bound it: every load
//     takes 16 bytes (K and V rows padded to D + 4 floats, conflict-free;
//     Q and dO rows broadcast), and a thread's columns are 4-wide groups
//     (2-wide at D = 16).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

using flash::fast_exp2;
using flash::fast_tanh;
using flash::kLog2e;
using flash::kv_range;
using flash::pack_bf16;

// lse and D are padded to a multiple of this many positions
constexpr int kPad = 64;

__device__ __forceinline__ bool kept(long long qpos, long long kpos,
                                     long long window, long long T) {
  return kpos <= qpos && kpos > qpos - window && qpos < T;
}

// ------------------------------------------------------------ pre-pass --
// one warp per (b, h, t < Tp): D = rowsum(dO o O), and lse in log2 units
// (P = 2^(s log2 e - lse log2 e): one fma before the ex2), padded
template <typename E> __device__ __forceinline__ float to_f(E x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__global__ void __launch_bounds__(256)
bwd_pre(const E* __restrict__ o, const E* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ lse_pad,
        float* __restrict__ dlt_pad, long long rows, long long T,
        long long Tp, int H, int D) {
  const long long row = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                    // uniform across the warp
  const long long bh = row / Tp, t = row % Tp;
  const long long b = bh / H, h = bh % H;
  float acc = 0.f;
  if (t < T) {
    const long long base = ((b * T + t) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      acc += to_f(o[base + d]) * to_f(dout[base + d]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    dlt_pad[row] = acc;
    lse_pad[row] = t < T ? lse[bh * T + t] * kLog2e : 0.f;
  }
}

// ---------------------------------------------------------------- bf16 --
constexpr int kConsumers = 2;
constexpr int kBf16Threads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D> struct Cfg {
  static constexpr int kCb = D < 64 ? D : 64;       // columns of a TMA box
  static constexpr int kBlocks = D / kCb;           // boxes across a row
  static constexpr int kRowBytes = kCb * 2;
  static constexpr hop::Swizzle kSw = flash::swizzle_of(kCb);
  static constexpr int kAtom = 8 * kRowBytes;       // 8 rows: one atom
  // pass 2 (dK, dV)
  static constexpr int kSplit = D == 256 ? 2 : 1;   // consumers a key row
  static constexpr int kDw = D / kSplit;            // dK, dV columns held
  static constexpr int kKeys = 64 * kConsumers / kSplit;  // keys a CTA
  static constexpr int kNq = D >= 128 ? 32 : 64;    // queries a stage
  static constexpr int kStages2 = 3;
  static constexpr int kKvBytes = kKeys * D * 2;    // the CTA's K (or V)
  static constexpr int kQBytes = kNq * D * 2;       // a stage's Q (or dO)
  static constexpr size_t kSmem2 =
      1024 + 2 * kKvBytes + kStages2 * (2 * kQBytes + 2 * kNq * 4) +
      (1 + 2 * kStages2) * sizeof(uint64_t);
  // pass 3 (dQ)
  static constexpr int kBq = 64 * kConsumers;       // queries a CTA
  static constexpr int kBk = D == 256 ? 32 : 64;    // keys a stage
  static constexpr int kStages3 = D == 256 ? 2 : 3;
  static constexpr int kQ3Bytes = kBq * D * 2;      // Q (or dO) of the CTA
  static constexpr int kTileBytes = kBk * D * 2;    // a stage's K (or V)
  static constexpr size_t kSmem3 =
      1024 + 2 * kQ3Bytes + kStages3 * 2 * kTileBytes +
      (1 + 2 * kStages3) * sizeof(uint64_t);
};

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  // swizzle atoms repeat every 1,024 bytes: align the base to them
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the A x B products over a K-major pair: rows of A (64) and of B (N)
// stored [block][rows][kCb]; k-steps of 16 over D
template <int D, int N>
__device__ __forceinline__ void ss_product(hop::Acc<N>& acc,
                                           const __nv_bfloat16* A,
                                           const __nv_bfloat16* B,
                                           int b_rows) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk * 16 / C::kCb, off = kk * 16 % C::kCb;
    const uint64_t da = hop::make_desc(A + blk * 64 * C::kCb + off, 16,
                                       C::kAtom, C::kSw);
    const uint64_t db = hop::make_desc(B + blk * b_rows * C::kCb + off, 16,
                                       C::kAtom, C::kSw);
    hop::wgmma_bf16_ss(acc, da, db, kk > 0);
  }
}

// acc += A B with A in registers (K = `rows` of B, 16 a step) and B the
// MN-major [block][rows][kCb] tile, from column block `blk0`
template <int D, int N, int K>
__device__ __forceinline__ void rs_product(hop::Acc<N>& acc,
                                           const uint32_t (&a)[K / 4],
                                           const __nv_bfloat16* B,
                                           int blk0) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = hop::make_desc(
        B + (blk0 * K + kk * 16) * C::kCb, K * C::kRowBytes, C::kAtom,
        C::kSw);
    hop::wgmma_bf16_rs_tb(
        acc, *reinterpret_cast<const uint32_t(*)[4]>(a + 4 * kk), db, 1);
  }
}

// P and dS of a tile in place (s <- P, dp <- dS) from the raw products s
// and dP, element i of the accumulator layout: lse2(i) its row's
// logsumexp in log2 units, dlt(i) its row's D, kept(i) whether the mask
// keeps it. The caller picks the instance once a tile (kCap, and a kept
// that is always true on a tile the mask does not cut).
template <int N, bool kCap, typename Lse, typename Dlt, typename Kept>
__device__ __forceinline__ void tile_grads(float (&s)[N / 2],
                                           float (&dp)[N / 2], float scale,
                                           float cap, Lse lse2, Dlt dlt,
                                           Kept kept) {
  const float f = scale * kLog2e, to_cap = scale / cap;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float pr, dsv;
    if (kCap) {
      const float th = fast_tanh(s[i] * to_cap);
      pr = fast_exp2(fmaf(cap * th, kLog2e, -lse2(i)));
      dsv = (1.f - th * th) * (dp[i] - dlt(i));
    } else {
      pr = fast_exp2(fmaf(s[i], f, -lse2(i)));
      dsv = dp[i] - dlt(i);
    }
    if (!kept(i)) pr = 0.f;
    s[i] = pr;
    dp[i] = pr * dsv;
  }
}

template <int N, typename Lse, typename Dlt, typename Kept>
__device__ __forceinline__ void probs_and_grads(float (&s)[N / 2],
                                                float (&dp)[N / 2],
                                                float scale, float cap,
                                                bool whole, Lse lse2,
                                                Dlt dlt, Kept kept) {
  auto all = [](int) { return true; };
  if (cap > 0.f) {
    if (whole)
      tile_grads<N, true>(s, dp, scale, cap, lse2, dlt, all);
    else
      tile_grads<N, true>(s, dp, scale, cap, lse2, dlt, kept);
  } else {
    if (whole)
      tile_grads<N, false>(s, dp, scale, cap, lse2, dlt, all);
    else
      tile_grads<N, false>(s, dp, scale, cap, lse2, dlt, kept);
  }
}

// the bf16 A fragments of an accumulator (rows, then columns in pairs)
template <int N>
__device__ __forceinline__ void to_bf16(const float (&x)[N / 2],
                                        uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[2 * j] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[2 * j + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// ---- pass 2: dK and dV. One CTA per (b, KV head, kKeys keys).
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
bwd_dkdv_bf16(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap,
              const float* __restrict__ lse_pad,
              const float* __restrict__ dlt_pad,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              long long T, long long Tp, int H, int Hk, long long window,
              float cap, float scale) {
  using C = Cfg<D>;
  constexpr int kNq = C::kNq, kS = C::kStages2, kCb = C::kCb;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + C::kKeys * D;          // [64-row part][block]
  __nv_bfloat16* Qs = Vs + C::kKeys * D;          // [stage][block][kNq]
  __nv_bfloat16* DOs = Qs + kS * kNq * D;
  float* Ls = reinterpret_cast<float*>(DOs + kS * kNq * D);  // [stage][kNq]
  float* Dls = Ls + kS * kNq;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Dls + kS * kNq);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kS;

  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk;
  const int group = H / Hk;
  const long long k0 = static_cast<long long>(blockIdx.y) * C::kKeys;
  // the query tiles the keys' window reaches: queries k0 .. last
  long long last = k0 + C::kKeys - 1 + window - 1;
  if (last > T - 1) last = T - 1;
  const int qlo = static_cast<int>(k0 / kNq);
  const int nqt = static_cast<int>(last / kNq) - qlo + 1;
  const int items = group * nqt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) hop::mbar_init(full + s, 1);
    for (int s = 0; s < kS; ++s) hop::mbar_init(empty + s, 128 * kConsumers);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hop::regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(kv_full, 2 * C::kKvBytes);
      for (int c = 0; c < C::kKeys / 64; ++c)
        for (int j = 0; j < C::kBlocks; ++j) {
          const int off = (c * C::kBlocks + j) * 64 * kCb;
          const int row = static_cast<int>(k0) + 64 * c;
          hop::tma_load_4d(Ks + off, &kmap, kv_full, j * kCb, hk, row, b);
          hop::tma_load_4d(Vs + off, &vmap, kv_full, j * kCb, hk, row, b);
        }
      for (int i = 0; i < items; ++i) {
        const int s = i % kS;
        const uint32_t ph = (i / kS) & 1;
        const int h = hk * group + i / nqt;
        const int q0 = (qlo + i % nqt) * kNq;
        hop::mbar_wait(empty + s, ph ^ 1);
        hop::mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * kNq * 4);
        for (int j = 0; j < C::kBlocks; ++j) {
          const int off = (s * C::kBlocks + j) * kNq * kCb;
          hop::tma_load_4d(Qs + off, &qmap, full + s, j * kCb, h, q0, b);
          hop::tma_load_4d(DOs + off, &domap, full + s, j * kCb, h, q0, b);
        }
        const long long at = (static_cast<long long>(b) * H + h) * Tp + q0;
        hop::bulk_load(Ls + s * kNq, lse_pad + at, kNq * 4, full + s);
        hop::bulk_load(Dls + s * kNq, dlt_pad + at, kNq * 4, full + s);
      }
    }
    return;
  }

  hop::regs_claim<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this consumer's 64 key rows, and its first column block of dK, dV
  const int part = C::kSplit == 1 ? c : 0;
  const int blk0 = C::kSplit == 1 ? 0 : c * (C::kDw / kCb);
  const __nv_bfloat16* Kc = Ks + part * C::kBlocks * 64 * kCb;
  const __nv_bfloat16* Vc = Vs + part * C::kBlocks * 64 * kCb;
  const long long kbase = k0 + 64 * part;          // this consumer's keys
  const long long kpos0 = kbase + 16 * warp + g, kpos1 = kpos0 + 8;
  const int win = static_cast<int>(window < (1LL << 30) ? window
                                                         : (1LL << 30));

  float dkacc[C::kDw / 2], dvacc[C::kDw / 2];
#pragma unroll
  for (int i = 0; i < C::kDw / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  float sacc[kNq / 2], dpacc[kNq / 2];
  uint32_t p[kNq / 4], ds[kNq / 4];

  hop::mbar_wait(kv_full, 0);
  for (int i = 0; i < items; ++i) {
    const int s = i % kS;
    const long long q0 = static_cast<long long>(qlo + i % nqt) * kNq;
    const __nv_bfloat16* Qb = Qs + s * C::kBlocks * kNq * kCb;
    const __nv_bfloat16* DOb = DOs + s * C::kBlocks * kNq * kCb;
    hop::mbar_wait(full + s, (i / kS) & 1);
    hop::reg_fence(sacc);
    hop::reg_fence(dpacc);
    hop::wgmma_fence();
    ss_product<D, kNq>(sacc, Kc, Qb, kNq);      // S^T = K Q^T
    ss_product<D, kNq>(dpacc, Vc, DOb, kNq);    // dP^T = V dO^T
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(sacc);
    hop::reg_fence(dpacc);
    // element n: key kpos0 (+ 8 where n & 2) against query q0 + col(n)
    const float* L = Ls + s * kNq;
    const float* Dl = Dls + s * kNq;
    auto col = [&](int n) { return 8 * (n / 4) + 2 * t + (n & 1); };
    const bool whole = kbase + 63 <= q0 && kbase > q0 + kNq - 1 - window &&
                       q0 + kNq <= T;
    const int qk = static_cast<int>(q0 - kpos0);    // query - key, col 0
    const int qlim = static_cast<int>(T - q0 < kNq ? T - q0 : kNq);
    probs_and_grads<kNq>(
        sacc, dpacc, scale, cap, whole, [&](int n) { return L[col(n)]; },
        [&](int n) { return Dl[col(n)]; },
        [&](int n) {
          const int dd = qk + col(n) - 8 * ((n >> 1) & 1);
          return dd >= 0 && dd < win && col(n) < qlim;
        });
    to_bf16<kNq>(sacc, p);
    to_bf16<kNq>(dpacc, ds);
    hop::reg_fence(dvacc);
    hop::reg_fence(dkacc);
    hop::wgmma_fence();
    rs_product<D, C::kDw, kNq>(dvacc, p, DOb, blk0);   // dV += P^T dO
    rs_product<D, C::kDw, kNq>(dkacc, ds, Qb, blk0);   // dK += dS^T Q
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(dvacc);
    hop::reg_fence(dkacc);
    hop::reg_fence(p);
    hop::reg_fence(ds);
    hop::mbar_arrive(empty + s);
  }

  const long long kstride = static_cast<long long>(Hk) * D;
  const long long base = static_cast<long long>(b) * T * kstride + hk * D;
#pragma unroll
  for (int j = 0; j < C::kDw / 8; ++j) {
    const int col = blk0 * kCb + 8 * j + 2 * t;
    if (kpos0 < T) {
      const long long at = base + kpos0 * kstride + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dkacc[4 * j] * scale, dkacc[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dvacc[4 * j], dvacc[4 * j + 1]);
    }
    if (kpos1 < T) {
      const long long at = base + kpos1 * kstride + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dkacc[4 * j + 2] * scale, dkacc[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dvacc[4 * j + 2], dvacc[4 * j + 3]);
    }
  }
}

// ---- pass 3: dQ. One CTA per (b, query head, 128 queries).
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap domap,
            const float* __restrict__ lse_pad,
            const float* __restrict__ dlt_pad,
            __nv_bfloat16* __restrict__ dq, long long T, long long Tp, int H,
            int Hk, long long window, float cap, float scale) {
  using C = Cfg<D>;
  constexpr int kBk = C::kBk, kS = C::kStages3, kCb = C::kCb;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* DOs = Qs + C::kBq * D;        // [consumer][block][64]
  __nv_bfloat16* Ks = DOs + C::kBq * D;        // [stage][block][kBk]
  __nv_bfloat16* Vs = Ks + kS * kBk * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kS * kBk * D);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kS;

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hk);
  const long long q0 =
      static_cast<long long>(gridDim.y - 1 - blockIdx.y) * C::kBq;
  int lo, hi;
  kv_range(q0, C::kBq, kBk, T, window, &lo, &hi);
  const int tiles = hi - lo + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) hop::mbar_init(full + s, 1);
    for (int s = 0; s < kS; ++s) hop::mbar_init(empty + s, 128 * kConsumers);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hop::regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(q_full, 2 * C::kQ3Bytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int j = 0; j < C::kBlocks; ++j) {
          const int off = (c * C::kBlocks + j) * 64 * kCb;
          const int row = static_cast<int>(q0) + 64 * c;
          hop::tma_load_4d(Qs + off, &qmap, q_full, j * kCb, h, row, b);
          hop::tma_load_4d(DOs + off, &domap, q_full, j * kCb, h, row, b);
        }
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kS;
        const uint32_t ph = (i / kS) & 1;
        const int kt0 = (lo + i) * kBk;
        hop::mbar_wait(empty + s, ph ^ 1);
        hop::mbar_expect_tx(full + s, 2 * C::kTileBytes);
        for (int j = 0; j < C::kBlocks; ++j) {
          const int off = (s * C::kBlocks + j) * kBk * kCb;
          hop::tma_load_4d(Ks + off, &kmap, full + s, j * kCb, hk, kt0, b);
          hop::tma_load_4d(Vs + off, &vmap, full + s, j * kCb, hk, kt0, b);
        }
      }
    }
    return;
  }

  hop::regs_claim<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row_lo = q0 + 64 * c;            // this consumer's rows
  const long long qpos0 = row_lo + 16 * warp + g, qpos1 = qpos0 + 8;
  const bool in0 = qpos0 < T, in1 = qpos1 < T;
  const int win = static_cast<int>(window < (1LL << 30) ? window
                                                         : (1LL << 30));
  const __nv_bfloat16* Qc = Qs + c * C::kBlocks * 64 * kCb;
  const __nv_bfloat16* DOc = DOs + c * C::kBlocks * 64 * kCb;
  const long long row0 = (static_cast<long long>(b) * H + h) * Tp;
  const float lse0 = in0 ? lse_pad[row0 + qpos0] : 0.f;
  const float lse1 = in1 ? lse_pad[row0 + qpos1] : 0.f;
  const float dl0 = in0 ? dlt_pad[row0 + qpos0] : 0.f;
  const float dl1 = in1 ? dlt_pad[row0 + qpos1] : 0.f;

  float dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  float sacc[kBk / 2], dpacc[kBk / 2];
  uint32_t ds[kBk / 4];

  hop::mbar_wait(q_full, 0);
  for (int i = 0; i < tiles; ++i) {
    const int s = i % kS;
    const long long kt0 = static_cast<long long>(lo + i) * kBk;
    const __nv_bfloat16* Kb = Ks + s * C::kBlocks * kBk * kCb;
    const __nv_bfloat16* Vb = Vs + s * C::kBlocks * kBk * kCb;
    hop::mbar_wait(full + s, (i / kS) & 1);
    hop::reg_fence(sacc);
    hop::reg_fence(dpacc);
    hop::wgmma_fence();
    ss_product<D, kBk>(sacc, Qc, Kb, kBk);      // S = Q K^T
    ss_product<D, kBk>(dpacc, DOc, Vb, kBk);    // dP = dO V^T
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(sacc);
    hop::reg_fence(dpacc);
    // element n: query qpos0 (+ 8 where n & 2) against key
    // kt0 + 8 (n / 4) + 2 t + (n & 1)
    const bool whole = kt0 + kBk - 1 <= row_lo &&
                       kt0 > row_lo + 63 - window && row_lo + 64 <= T;
    const int qk = static_cast<int>(qpos0 - kt0) - 2 * t;  // query - key
    probs_and_grads<kBk>(
        sacc, dpacc, scale, cap, whole,
        [&](int n) { return n & 2 ? lse1 : lse0; },
        [&](int n) { return n & 2 ? dl1 : dl0; },
        [&](int n) {
          const int dd = qk + 8 * ((n >> 1) & 1) - 8 * (n / 4) - (n & 1);
          return dd >= 0 && dd < win && (n & 2 ? in1 : in0);
        });
    to_bf16<kBk>(dpacc, ds);
    hop::reg_fence(dqacc);
    hop::wgmma_fence();
    rs_product<D, D, kBk>(dqacc, ds, Kb, 0);     // dQ += dS K
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(dqacc);
    hop::reg_fence(ds);
    hop::mbar_arrive(empty + s);
  }

  const long long qstride = static_cast<long long>(H) * D;
  __nv_bfloat16* qh = dq + b * T * qstride + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (qpos0 < T)
      *reinterpret_cast<__nv_bfloat162*>(qh + qpos0 * qstride + col) =
          __floats2bfloat162_rn(dqacc[4 * j] * scale,
                                dqacc[4 * j + 1] * scale);
    if (qpos1 < T)
      *reinterpret_cast<__nv_bfloat162*>(qh + qpos1 * qstride + col) =
          __floats2bfloat162_rn(dqacc[4 * j + 2] * scale,
                                dqacc[4 * j + 3] * scale);
  }
}

// ----------------------------------------------------------------- f32 --
constexpr int kKeysF = 32;   // pass 2: keys a CTA; pass 3: keys a tile
constexpr int kQ2 = 32;      // pass 2: queries a tile, 8 warps a CTA
constexpr int kQF = 16;      // pass 3: queries a CTA, 4 warps

__device__ __forceinline__ float cap_score(float acc, float scale, float cap,
                                           float* th) {
  float x = acc * scale;
  *th = 0.f;
  if (cap > 0.f) {
    *th = tanhf(x / cap);
    x = cap * *th;
  }
  return x;
}

// V consecutive floats of shared memory (16- or 8-byte aligned)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

// the columns a thread of pass 2 or 3 accumulates: 8 threads a row, each
// kGroups groups of kV consecutive columns, 8 kV j + kV c0 + u
template <int D> struct Cols {
  static constexpr int kV = D >= 32 ? 4 : 2;
  static constexpr int kGroups = D / (8 * kV);
};

// rows [r0, r0 + n) of a [T, stride] head into shared rows of ld floats,
// 16 bytes a thread; rows at or past T as zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src,
                                           long long stride, long long r0,
                                           int n, long long T) {
  for (int x = threadIdx.x; x < n * D / 4; x += blockDim.x) {
    const int rr = x / (D / 4), d = 4 * (x % (D / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + rr < T)
      v = *reinterpret_cast<const float4*>(src + (r0 + rr) * stride + d);
    *reinterpret_cast<float4*>(dst + rr * ld + d) = v;
  }
}

// the (query, key) scores of queries 4 warp .. 4 warp + 3 against key
// `lane`: s = q . k and dp = dO . v over D, four columns a load (K and V
// rows padded to D + 4 floats: conflict-free 16-byte loads)
template <int D>
__device__ __forceinline__ void scores4(const float* Qs, const float* DOs,
                                        const float* kr, const float* vr,
                                        int warp, float (&dot)[4],
                                        float (&dpd)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) dot[i] = dpd[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float k4[4], v4[4];
    load_vec<4>(kr + d, k4);
    load_vec<4>(vr + d, v4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float q4[4], o4[4];
      load_vec<4>(Qs + (4 * warp + i) * D + d, q4);
      load_vec<4>(DOs + (4 * warp + i) * D + d, o4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dot[i] = fmaf(q4[u], k4[u], dot[i]);
        dpd[i] = fmaf(o4[u], v4[u], dpd[i]);
      }
    }
  }
}

// ---- pass 2: dK, dV of 32 keys from one query head (b, h): into dk, dv
// [B, T, out_heads, D] at head h (out_heads = H: a group's partial sums,
// added by bwd_group_sum) or at its KV head (out_heads = Hk, group 1)
template <int D>
__global__ void __launch_bounds__(256)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse_pad,
             const float* __restrict__ dlt_pad, float* __restrict__ dk,
             float* __restrict__ dv, long long T, long long Tp, int H, int Hk,
             int out_heads, long long window, float cap, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kV = Cols<D>::kV, kGroups = Cols<D>::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [32][D + 4]
  float* Vs = Ks + kKeysF * kLd;
  float* Qs = Vs + kKeysF * kLd;                // [32][D]
  float* DOs = Qs + kQ2 * D;
  float* Ps = DOs + kQ2 * D;                    // [32 keys][33]
  float* DSs = Ps + kKeysF * (kQ2 + 1);
  float* Ls = DSs + kKeysF * (kQ2 + 1);         // [32]
  float* Dls = Ls + kQ2;

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hk);
  const long long k0 = static_cast<long long>(blockIdx.y) * kKeysF;
  const long long qstride = static_cast<long long>(H) * D;
  const long long kstride = static_cast<long long>(Hk) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the accumulating thread's key and column groups
  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;

  stage_rows<D>(Ks, kLd, k + b * T * kstride + hk * D, kstride, k0, kKeysF,
                T);
  stage_rows<D>(Vs, kLd, v + b * T * kstride + hk * D, kstride, k0, kKeysF,
                T);
  float dka[kGroups][kV], dva[kGroups][kV];
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
#pragma unroll
    for (int u = 0; u < kV; ++u) dka[j][u] = dva[j][u] = 0.f;

  long long last = k0 + kKeysF - 1 + window - 1;
  if (last > T - 1) last = T - 1;
  const int qlo = static_cast<int>(k0 / kQ2);
  const int qhi = static_cast<int>(last / kQ2);
  const long long row0 = (static_cast<long long>(b) * H + h) * Tp;
  for (int qt = qlo; qt <= qhi; ++qt) {
    const long long q0 = static_cast<long long>(qt) * kQ2;
    __syncthreads();
    stage_rows<D>(Qs, D, q + b * T * qstride + h * D, qstride, q0, kQ2, T);
    stage_rows<D>(DOs, D, dout + b * T * qstride + h * D, qstride, q0, kQ2,
                  T);
    if (threadIdx.x < kQ2) {
      Ls[threadIdx.x] = lse_pad[row0 + q0 + threadIdx.x];
      Dls[threadIdx.x] = dlt_pad[row0 + q0 + threadIdx.x];
    }
    __syncthreads();
    float dot[4], dpd[4];
    scores4<D>(Qs, DOs, Ks + lane * kLd, Vs + lane * kLd, warp, dot, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = 4 * warp + i;
      float th;
      const float x = cap_score(dot[i], scale, cap, &th);
      const float pr = kept(q0 + qi, k0 + lane, window, T)
                           ? exp2f(fmaf(x, kLog2e, -Ls[qi])) : 0.f;
      float dsv = pr * (dpd[i] - Dls[qi]);
      if (cap > 0.f) dsv *= 1.f - th * th;
      Ps[lane * (kQ2 + 1) + qi] = pr;
      DSs[lane * (kQ2 + 1) + qi] = dsv;
    }
    __syncthreads();
    // dV[r] += P[r, :] dO, dK[r] += dS[r, :] Q
#pragma unroll 4
    for (int qi = 0; qi < kQ2; ++qi) {
      const float pr = Ps[r * (kQ2 + 1) + qi];
      const float dsv = DSs[r * (kQ2 + 1) + qi];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        float o4[kV], q4[kV];
        load_vec<kV>(DOs + qi * D + 8 * kV * j + kV * c0, o4);
        load_vec<kV>(Qs + qi * D + 8 * kV * j + kV * c0, q4);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          dva[j][u] = fmaf(pr, o4[u], dva[j][u]);
          dka[j][u] = fmaf(dsv, q4[u], dka[j][u]);
        }
      }
    }
  }
  if (k0 + r < T) {
    const long long ostride = static_cast<long long>(out_heads) * D;
    const long long at = b * T * ostride + (k0 + r) * ostride +
                         (out_heads == H ? h : hk) * D;
    float* dkr = dk + at;
    float* dvr = dv + at;
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        dkr[8 * kV * j + kV * c0 + u] = dka[j][u] * scale;
        dvr[8 * kV * j + kV * c0 + u] = dva[j][u];
      }
  }
}

// the group's partial dK (or dV) rows, [B, T, H, D], summed over each KV
// head's query heads in their order: out [B, T, Hk, D]
__global__ void __launch_bounds__(256)
bwd_group_sum(const float* __restrict__ part, float* __restrict__ out,
              long long n, int group, int D) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n) return;
  const long long row = i / D, d = i % D;
  float acc = 0.f;
  for (int g = 0; g < group; ++g) acc += part[(row * group + g) * D + d];
  out[i] = acc;
}

// ---- pass 3: dQ of 16 queries of (b, query head)
template <int D>
__global__ void __launch_bounds__(128)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse_pad,
           const float* __restrict__ dlt_pad, float* __restrict__ dq,
           long long T, long long Tp, int H, int Hk, long long window,
           float cap, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kV = Cols<D>::kV, kGroups = Cols<D>::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [16][D]
  float* DOs = Qs + kQF * D;
  float* Ks = DOs + kQF * D;                    // [32][D + 4]
  float* Vs = Ks + kKeysF * kLd;
  float* DSs = Vs + kKeysF * kLd;               // [16][33]
  float* Ls = DSs + kQF * (kKeysF + 1);
  float* Dls = Ls + kQF;

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hk);
  const long long q0 =
      static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kQF;
  const long long qstride = static_cast<long long>(H) * D;
  const long long kstride = static_cast<long long>(Hk) * D;
  const float* kh = k + b * T * kstride + hk * D;
  const float* vh = v + b * T * kstride + hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the accumulating thread's query and column groups
  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;
  const long long row0 = (static_cast<long long>(b) * H + h) * Tp;

  stage_rows<D>(Qs, D, q + b * T * qstride + h * D, qstride, q0, kQF, T);
  stage_rows<D>(DOs, D, dout + b * T * qstride + h * D, qstride, q0, kQF, T);
  if (threadIdx.x < kQF) {
    Ls[threadIdx.x] = lse_pad[row0 + q0 + threadIdx.x];
    Dls[threadIdx.x] = dlt_pad[row0 + q0 + threadIdx.x];
  }
  float dqa[kGroups][kV];
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
#pragma unroll
    for (int u = 0; u < kV; ++u) dqa[j][u] = 0.f;

  int lo, hi;
  kv_range(q0, kQF, kKeysF, T, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const long long k0 = static_cast<long long>(kt) * kKeysF;
    __syncthreads();
    stage_rows<D>(Ks, kLd, kh, kstride, k0, kKeysF, T);
    stage_rows<D>(Vs, kLd, vh, kstride, k0, kKeysF, T);
    __syncthreads();
    float dot[4], dpd[4];
    scores4<D>(Qs, DOs, Ks + lane * kLd, Vs + lane * kLd, warp, dot, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = 4 * warp + i;
      float th;
      const float x = cap_score(dot[i], scale, cap, &th);
      const float pr = kept(q0 + qi, k0 + lane, window, T)
                           ? exp2f(fmaf(x, kLog2e, -Ls[qi])) : 0.f;
      float dsv = pr * (dpd[i] - Dls[qi]);
      if (cap > 0.f) dsv *= 1.f - th * th;
      DSs[qi * (kKeysF + 1) + lane] = dsv;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKeysF; ++kk) {
      const float dsv = DSs[r * (kKeysF + 1) + kk];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        float k4[kV];
        load_vec<kV>(Ks + kk * kLd + 8 * kV * j + kV * c0, k4);
#pragma unroll
        for (int u = 0; u < kV; ++u) dqa[j][u] = fmaf(dsv, k4[u], dqa[j][u]);
      }
    }
  }
  if (q0 + r < T) {
    float* dqr = dq + b * T * qstride + (q0 + r) * qstride + h * D;
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int u = 0; u < kV; ++u)
        dqr[8 * kV * j + kV * c0 + u] = dqa[j][u] * scale;
  }
}

// ------------------------------------------------------------- launch --
// Each instance opts in to the dynamic shared memory it needs, once (the
// attribute belongs to each instantiated function).
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool* opted) {
  if (*opted || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *opted = true;
  return err;
}

template <typename E>
cudaError_t run_pre(const void* o, const void* dout, const void* lse,
                    float* lse_pad, float* dlt_pad, long long B,
                    long long T, long long Tp, int H, int D,
                    cudaStream_t stream) {
  const long long rows = B * H * Tp;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_pre<E><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout),
      static_cast<const float*>(lse), lse_pad, dlt_pad, rows, T, Tp, H, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse_pad,
                     const float* dlt_pad, void* dq, void* dk, void* dv,
                     long long B, long long T, long long Tp, int H, int Hk,
                     long long window, float cap, float scale,
                     cudaStream_t stream) {
  using C = Cfg<D>;
  static bool opted2 = false, opted3 = false;
  cudaError_t err = opt_in(bwd_dkdv_bf16<D>, C::kSmem2, &opted2);
  if (err == cudaSuccess) err = opt_in(bwd_dq_bf16<D>, C::kSmem3, &opted3);
  if (err != cudaSuccess) return err;
  const long long key_tiles = (T + C::kKeys - 1) / C::kKeys;
  const long long q_tiles = (T + C::kBq - 1) / C::kBq;
  if (key_tiles > 65535 || q_tiles > 65535 || T > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // pass 2's maps: Q and dO in tiles of kNq rows, K and V of 64
  CUtensorMap qmap, kmap, vmap, domap;
  err = flash::head_map(&qmap, q, B, T, H, D, C::kCb, C::kNq);
  if (err == cudaSuccess)
    err = flash::head_map(&domap, dout, B, T, H, D, C::kCb, C::kNq);
  if (err == cudaSuccess)
    err = flash::head_map(&kmap, k, B, T, Hk, D, C::kCb, 64);
  if (err == cudaSuccess)
    err = flash::head_map(&vmap, v, B, T, Hk, D, C::kCb, 64);
  if (err != cudaSuccess) return err;
  bwd_dkdv_bf16<D><<<dim3(static_cast<unsigned>(B * Hk),
                          static_cast<unsigned>(key_tiles)),
                     kBf16Threads, C::kSmem2, stream>>>(
      qmap, kmap, vmap, domap, lse_pad, dlt_pad,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T,
      Tp, H, Hk, window, cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // pass 3's maps: Q and dO in tiles of 64 rows, K and V of kBk
  err = flash::head_map(&qmap, q, B, T, H, D, C::kCb, 64);
  if (err == cudaSuccess)
    err = flash::head_map(&domap, dout, B, T, H, D, C::kCb, 64);
  if (err == cudaSuccess)
    err = flash::head_map(&kmap, k, B, T, Hk, D, C::kCb, C::kBk);
  if (err == cudaSuccess)
    err = flash::head_map(&vmap, v, B, T, Hk, D, C::kCb, C::kBk);
  if (err != cudaSuccess) return err;
  bwd_dq_bf16<D><<<dim3(static_cast<unsigned>(B * H),
                        static_cast<unsigned>(q_tiles)),
                   kBf16Threads, C::kSmem3, stream>>>(
      qmap, kmap, vmap, domap, lse_pad, dlt_pad,
      static_cast<__nv_bfloat16*>(dq), T, Tp, H, Hk, window, cap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse_pad,
                    const float* dlt_pad, void* dq, void* dk, void* dv,
                    float* part, long long B, long long T, long long Tp,
                    int H, int Hk, long long window, float cap, float scale,
                    cudaStream_t stream) {
  static bool opted2 = false, opted3 = false;
  const size_t smem2 = sizeof(float) *
      (2 * kKeysF * (D + 4) + 2 * kQ2 * D + 2 * kKeysF * (kQ2 + 1) +
       2 * kQ2);
  const size_t smem3 = sizeof(float) *
      (2 * kQF * D + 2 * kKeysF * (D + 4) + kQF * (kKeysF + 1) + 2 * kQF);
  cudaError_t err = opt_in(bwd_dkdv_f32<D>, smem2, &opted2);
  if (err == cudaSuccess) err = opt_in(bwd_dq_f32<D>, smem3, &opted3);
  if (err != cudaSuccess) return err;
  const long long key_tiles = (T + kKeysF - 1) / kKeysF;
  const long long q_tiles = (T + kQF - 1) / kQF;
  if (key_tiles > 65535 || q_tiles > 65535) return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  // one CTA per query head: a group's heads write partial sums to part
  // ([2, B, T, H, D]), which bwd_group_sum adds in order
  const bool grouped = H != Hk;
  if (grouped && part == nullptr) return cudaErrorInvalidValue;
  const long long n_part = B * T * H * D;
  float* dkp = grouped ? part : static_cast<float*>(dk);
  float* dvp = grouped ? part + n_part : static_cast<float*>(dv);
  bwd_dkdv_f32<D><<<dim3(static_cast<unsigned>(B * H),
                         static_cast<unsigned>(key_tiles)),
                    256, smem2, stream>>>(
      qf, kf, vf, df, lse_pad, dlt_pad, dkp, dvp, T, Tp, H, Hk,
      grouped ? H : Hk, window, cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (grouped) {
    const long long n = B * T * Hk * D;
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    bwd_group_sum<<<blocks, 256, 0, stream>>>(dkp, static_cast<float*>(dk),
                                              n, H / Hk, D);
    bwd_group_sum<<<blocks, 256, 0, stream>>>(dvp, static_cast<float*>(dv),
                                              n, H / Hk, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bwd_dq_f32<D><<<dim3(static_cast<unsigned>(B * H),
                       static_cast<unsigned>(q_tiles)),
                  128, smem3, stream>>>(
      qf, kf, vf, df, lse_pad, dlt_pad, static_cast<float*>(dq), T, Tp, H,
      Hk, window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. q, o, dout, dq: [B, T, H, D]; k, v, dk, dv:
// [B, T, Hk, D], all contiguous, 16-byte aligned; lse: f32 [B, H, T];
// lse_pad, dlt_pad: f32 scratch of B * H * Tp, Tp = T rounded up to 64;
// part: f32 scratch of 2 * B * T * H * D where dtype is f32 and H > Hk,
// else unread (may be null). D in {16, 32, 64, 128, 256}; H % Hk == 0.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* lse_pad, void* dlt_pad, void* part, int dtype, long long B,
    long long T, int H, int Hk, int D, long long window, float softcap,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      B * H > 0x7fffffffLL || window <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long Tp = (T + kPad - 1) / kPad * kPad;
  float* lp = static_cast<float*>(lse_pad);
  float* dp = static_cast<float*>(dlt_pad);
  cudaError_t err =
      dtype == 1 ? run_pre<__nv_bfloat16>(o, dout, lse, lp, dp, B, T, Tp, H,
                                          D, s)
                 : run_pre<float>(o, dout, lse, lp, dp, B, T, Tp, H, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define REPRO_FLASH_BWD_CASE(DIM)                                          \
  case DIM:                                                                \
    return static_cast<int>(                                               \
        dtype == 1 ? run_bf16<DIM>(q, k, v, dout, lp, dp, dq, dk, dv, B,   \
                                   T, Tp, H, Hk, window, softcap, scale,   \
                                   s)                                      \
                   : run_f32<DIM>(q, k, v, dout, lp, dp, dq, dk, dv,       \
                                  static_cast<float*>(part), B, T, Tp, H,  \
                                  Hk, window, softcap, scale, s));
  switch (D) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(256)
  }
#undef REPRO_FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
