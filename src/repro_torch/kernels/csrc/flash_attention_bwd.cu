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
// What bounds it on the H100: its bound is operations, five products over
// the kept (query, key) pairs (S, dP, dV, dK, dQ; 10 d FLOP a pair and
// query head): a llama3.2-1b layer (B = 2, T = 4,096, H = 32, D = 64) is
// 3.4e11 FLOP, 0.35 ms at the 989 TFLOP/s bf16 rate, against ~0.05 ms for
// its bytes. What sets its pace (clock64 stamps in one CTA): at D <= 128
// each consumer's chain of steps between its products (the exponentials,
// dS, its shared-memory copies and their proxy fences), with the tensor
// cores busy about a third of an item; at D = 256 the dQ tiles' writes
// (64 KB of f32 adds an item of 64 keys) and its single stage.
// It runs each of the five products once: S and dP are formed once and
// feed dV, dK and dQ (the design it replaced recomputed both for dQ, and
// at D = 256 both consumers formed the same S^T and dP^T).
//
// Design: three launches (f32 with a group of heads: five); no atomics
// whose order varies, so two runs give the same bits.
//   1. A pre-pass writes D = rowsum(dO o O) in f32 and copies lse, both
//      to [B, H, Tp] (Tp = T rounded up to 64, zeros past T), so that a
//      tile of either is one aligned bulk copy.
//   2. dK, dV and dQ: a persistent grid (one CTA an SM) takes tiles of
//      kKeys keys of one (b, KV head) in order from a counter, kt-major,
//      and walks the query tiles of 64 that the keys' window reaches,
//      last first, each for every query head of the group; it writes its
//      keys' dK and dV rows once, and adds each query tile's part of dQ
//      into f32 tiles in device memory (B H Tp / 64 tiles of 64 x D).
//   3. dq = those tiles times the scale, in the inputs' dtype.
// A tile wholly above the diagonal, outside the window or past T is never
// visited, so a local layer costs O(T * window).
//   * dQ in a fixed order: the key tiles that reach a query tile add
//     their parts in key order. A turn count per (b, head, query tile)
//     (per half of one at D = 256) says how many have; a writer thread
//     waits for its tile's turn (kt - the first key tile reaching the
//     query tile), stores (turn 0) or adds (a bulk reduce-add copy from
//     shared memory, f32 adds in L2) the staged part, waits for the copy
//     to complete and releases the turn. A key tile waits only on lower
//     ones, which were taken before it by CTAs that are running, so no
//     wait can deadlock; walking its query tiles last first, a key tile
//     meets the one before it on the same query tile, not behind it.
//   * bf16 (wgmma, TMA): warpgroup 0 produces (thread 0 takes tiles and
//     issues TMA copies of K and V, then each item's Q and dO, into an
//     mbarrier ring; lane 0 of warps 1 and 2 each write one staging
//     buffer's dQ parts) and gives its
//     registers away (setmaxnreg 40 / 232: 40 + 2 x 232 = 3 x 168, the
//     registers the CTA holds). For D <= 128 each consumer owns 64 keys
//     (128 a CTA): S^T = K Q^T and dP^T = V dO^T are SS products;
//     P and dS, in registers, feed dV += P^T dO and dK += dS^T Q as the
//     A of register products (Q and dO MN-major). Both write their dS^T
//     rows, bf16 in the 128-byte swizzle, into the item's buffer (two,
//     by item parity), and the consumers take turns: consumer n % 2
//     forms item n's dQ = dS K over all 128 keys (A and B both MN-major
//     in shared memory) and stages it for its writer. At D = 256 the dK
//     and dV of 128 keys would not fit in registers, so the consumers
//     split one 64-key tile's products by kind, not by keys: warpgroup 1
//     forms S^T, P and dV; it hands P (1 - tanh^2) to warpgroup 2 in f16
//     through shared memory; warpgroup 2 forms dP^T, dS, dK (from the
//     shared dS^T) and the item's dQ, in four 64-column blocks staged in
//     two halves. No product is formed twice. P and dS enter their
//     products in bf16, as P enters the forward's P V. A score costs one
//     fma and one ex2 (P = 2^(s scale log2 e - lse log2 e), the pre-pass
//     storing lse log2 e), and the mask is computed only on the tiles it
//     cuts. Overlapping a consumer's next S^T and dP^T with its current
//     dV, dK and dQ (as the forward overlaps) needs ~190 live registers
//     a thread; ptxas spilled every such version tried and each ran
//     slower, so each consumer's steps run in turn and the two consumers
//     overlap each other.
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
#include <cuda_fp16.h>
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
// setmaxnreg budgets: the CTA holds the 168 registers a thread its launch
// bounds give (168 x 384), so producer + 2 consumers <= 3 x 168 = 504, or
// a consumer's setmaxnreg.inc waits for registers that never come
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kNq = 64;             // queries a tile

template <int D> struct Cfg {
  static constexpr int kCb = D < 64 ? D : 64;       // columns of a TMA box
  static constexpr int kBlocks = D / kCb;           // boxes across a row
  static constexpr int kRowBytes = kCb * 2;
  static constexpr hop::Swizzle kSw = flash::swizzle_of(kCb);
  static constexpr int kAtom = 8 * kRowBytes;       // 8 rows: one atom
  // D <= 128: each consumer owns 64 keys; D = 256: the consumers split the
  // products of the same 64 keys by kind (their dK and dV would not fit)
  static constexpr bool kKinds = D == 256;
  static constexpr int kKeys = kKinds ? 64 : 128;   // keys a CTA
  static constexpr int kStages = D <= 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int kChunks = D / kCb;           // dQ products of kCb
  // a dQ tile is written in pieces (two halves at D = 256, where shared
  // memory holds two halves rather than two tiles), each with its own
  // turns, staged in a ring of two buffers, each with its own writer
  static constexpr int kPieces = kKinds ? 2 : 1;
  static constexpr int kQBufs = 2;
  static constexpr int kPieceFloats = kNq * D / kPieces;
  static constexpr int kKvBytes = kKeys * D * 2;    // the CTA's K (or V)
  static constexpr int kQBytes = kNq * D * 2;       // a stage's Q (or dO)
  static constexpr int kXBytes = kKinds ? kKeys * kNq * 2 : 0;  // P, f16
  static constexpr int kDsBufs = kKinds ? 1 : 2;
  static constexpr int kDsBytes = kKeys * kNq * 2;  // dS^T, bf16
  static constexpr int kBars = 2 + 2 * kStages + 2 + 2 * kQBufs + 4 + 4;
  static constexpr size_t kSmem =
      1024 + 2 * kKvBytes + kStages * (2 * kQBytes + 2 * kNq * 4) +
      kXBytes + kDsBufs * kDsBytes + kQBufs * kPieceFloats * 4 +
      kBars * sizeof(uint64_t) + 2 * sizeof(int);
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
// MN-major [block][rows][kCb] tile
template <int D, int K>
__device__ __forceinline__ void rs_product(hop::Acc<D>& acc,
                                           const uint32_t (&a)[K / 4],
                                           const __nv_bfloat16* B) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = hop::make_desc(B + kk * 16 * C::kCb,
                                       K * C::kRowBytes, C::kAtom, C::kSw);
    hop::wgmma_bf16_rs_tb(
        acc, *reinterpret_cast<const uint32_t(*)[4]>(a + 4 * kk), db, 1);
  }
}

// dQ's column block `ch` (kCb columns) over KEYS keys: dS [64 queries x
// KEYS] from the swizzled dS^T rows (MN-major A: a row holds the 64
// queries of one key, 128 bytes) times K [KEYS x kCb] (MN-major B: the
// keys' [part][block][64][kCb] tiles as TMA wrote them)
template <int D, int KEYS>
__device__ __forceinline__ void dq_product(hop::Acc<Cfg<D>::kCb>& acc,
                                           const __nv_bfloat16* DSs,
                                           const __nv_bfloat16* Ks, int ch) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint64_t da = hop::make_desc(DSs + kk * 16 * kNq, KEYS * kNq * 2,
                                       1024, hop::kSwizzle128);
    const int part = kk / 4, row = kk % 4 * 16;
    const uint64_t db = hop::make_desc(
        Ks + ((part * C::kBlocks + ch) * 64 + row) * C::kCb,
        64 * C::kRowBytes, C::kAtom, C::kSw);
    hop::wgmma_bf16_ss_tt(acc, da, db, kk > 0);
  }
}

// dK += dS^T Q over an item's 64 queries: A the swizzled dS^T rows of one
// 64-key block (K-major: a 128-byte row holds one key's 64 queries, and a
// k-step of 16 queries starts 32 bytes further along it), B the item's Q
// (MN-major, [block][64][kCb])
template <int D>
__device__ __forceinline__ void dk_product(hop::Acc<D>& acc,
                                           const __nv_bfloat16* dsm,
                                           const __nv_bfloat16* Qb) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < kNq / 16; ++kk) {
    const uint64_t da =
        hop::make_desc(dsm + kk * 16, 16, 1024, hop::kSwizzle128);
    const uint64_t db = hop::make_desc(Qb + kk * 16 * C::kCb,
                                       kNq * C::kRowBytes, C::kAtom, C::kSw);
    hop::wgmma_bf16_ss_nt(acc, da, db, 1);
  }
}

// P and dS of a block in place (s <- P, dp <- dS) from the raw products
// s and dP, element i of the accumulator layout: lse2(i) its query's
// logsumexp in log2 units, dlt(i) its query's D, kept(i) whether the
// mask keeps it. The caller picks the instance once an item (kCap, and a
// kept that is always true on a block the mask does not cut).
template <bool kCap, typename Lse, typename Dlt, typename Kept>
__device__ __forceinline__ void tile_grads(float (&s)[kNq / 2],
                                           float (&dp)[kNq / 2], float scale,
                                           float cap, Lse lse2, Dlt dlt,
                                           Kept kept) {
  const float f = scale * kLog2e, to_cap = scale / cap;
#pragma unroll
  for (int i = 0; i < kNq / 2; ++i) {
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

template <typename Lse, typename Dlt, typename Kept>
__device__ __forceinline__ void probs_and_grads(float (&s)[kNq / 2],
                                                float (&dp)[kNq / 2],
                                                float scale, float cap,
                                                bool whole, Lse lse2,
                                                Dlt dlt, Kept kept) {
  auto all = [](int) { return true; };
  if (cap > 0.f) {
    if (whole)
      tile_grads<true>(s, dp, scale, cap, lse2, dlt, all);
    else
      tile_grads<true>(s, dp, scale, cap, lse2, dlt, kept);
  } else {
    if (whole)
      tile_grads<false>(s, dp, scale, cap, lse2, dlt, all);
    else
      tile_grads<false>(s, dp, scale, cap, lse2, dlt, kept);
  }
}

// P of a [64 keys x 64 queries] block in place (s <- P) from the raw
// products s, element i of the accumulator layout: lse2(i) its query's
// logsumexp in log2 units, kept(i) whether the mask keeps it; x (the
// thread's slots of four f16, 128 apart) takes P (1 - tanh^2), what dS
// needs of it (f16: 2^-12 relative above 2^-14, where P counts). The
// caller picks the instance once a tile (kCap, and a kept that is always
// true on a tile the mask does not cut).
template <bool kCap, typename Lse, typename Kept>
__device__ __forceinline__ void probs_block(float (&s)[kNq / 2], uint2* x,
                                            float scale, float cap,
                                            Lse lse2, Kept kept) {
  const float f = scale * kLog2e, to_cap = scale / cap;
#pragma unroll
  for (int j = 0; j < kNq / 8; ++j) {
    float pc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float pr, d = 1.f;
      if (kCap) {
        const float th = fast_tanh(s[i] * to_cap);
        pr = fast_exp2(fmaf(cap * th, kLog2e, -lse2(i)));
        d = 1.f - th * th;
      } else {
        pr = fast_exp2(fmaf(s[i], f, -lse2(i)));
      }
      if (!kept(i)) pr = 0.f;
      s[i] = pr;
      pc[e] = kCap ? pr * d : pr;
    }
    const __half2 lo = __floats2half2_rn(pc[0], pc[1]);
    const __half2 hi = __floats2half2_rn(pc[2], pc[3]);
    x[j * 128] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                            *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <typename Lse, typename Kept>
__device__ __forceinline__ void probs(float (&s)[kNq / 2], uint2* x,
                                      float scale, float cap, bool whole,
                                      Lse lse2, Kept kept) {
  auto all = [](int) { return true; };
  if (cap > 0.f) {
    if (whole)
      probs_block<true>(s, x, scale, cap, lse2, all);
    else
      probs_block<true>(s, x, scale, cap, lse2, kept);
  } else {
    if (whole)
      probs_block<false>(s, x, scale, cap, lse2, all);
    else
      probs_block<false>(s, x, scale, cap, lse2, kept);
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

// rows kpos0 (kpos0 + 8) of a [T, stride] output from a [64 x D]
// accumulator, times mul, in bf16; rows at or past T are not written
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           long long stride,
                                           long long kpos0, long long T,
                                           int t, const float (&acc)[D / 2],
                                           float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (kpos0 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + kpos0 * stride + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (kpos0 + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (kpos0 + 8) * stride + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// A tile of work: kKeys keys of one (b, KV head), and the query tiles
// their window reaches, qhi down to qlo, each for every head of the group
// (item i: query tile qhi - i / group, head hk group + i % group).
struct Tile {
  int b, hk, kt, qlo, qhi;
  long long k0;
};

template <int kKeys>
__device__ __forceinline__ Tile tile_of(int tile, int B, int Hk,
                                        long long T, long long window) {
  Tile w;
  w.kt = tile / (B * Hk);
  w.b = tile % (B * Hk) / Hk;
  w.hk = tile % Hk;
  w.k0 = static_cast<long long>(w.kt) * kKeys;
  long long last = w.k0 + kKeys - 1 + window - 1;
  if (last > T - 1) last = T - 1;
  w.qlo = static_cast<int>(w.k0 / kNq);
  w.qhi = static_cast<int>(last / kNq);
  return w;
}

// ---- dK, dV and dQ in one launch. A persistent grid takes tiles in
// order from a counter (sync[0]); tile (kt, b, hk) is number
// kt B Hk + b Hk + hk. Warpgroup 0: thread 0 takes tiles and issues the
// TMA copies, lane 0 of warps 1 and 2 write dQ (one a staging buffer). D <=
// 128: warpgroups 1 and 2 each own 64 keys and form their S^T, dP^T, P,
// dS, dV and dK, and in turns the items' dQ. D = 256: warpgroup 1 forms
// S^T, P and dV; warpgroup 2 dP^T, dS, dK and the tile's dQ.
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
bwd_bf16(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap,
         const __grid_constant__ CUtensorMap domap,
         const float* __restrict__ lse_pad, const float* __restrict__ dlt_pad,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
         float* __restrict__ dq_acc, uint32_t* __restrict__ sync,
         long long T, long long Tp, int B, int H, int Hk, long long window,
         float cap, float scale) {
  using C = Cfg<D>;
  constexpr int kS = C::kStages, kQB = C::kQBufs, kCb = C::kCb;
  constexpr int kKeys = C::kKeys, kChunks = C::kChunks;
  constexpr int kPieces = C::kPieces, kPieceFloats = C::kPieceFloats;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kKeys * D;             // [part][block][64][kCb]
  __nv_bfloat16* Qs = Vs + kKeys * D;             // [stage][block][64][kCb]
  __nv_bfloat16* DOs = Qs + kS * kNq * D;
  __nv_bfloat16* DSs = DOs + kS * kNq * D;        // [buf][keys][64]
  __half* Xs =                                    // D = 256
      reinterpret_cast<__half*>(DSs + C::kDsBufs * kKeys * kNq);
  float* Stg = reinterpret_cast<float*>(Xs) + C::kXBytes / 4;  // [buf][piece]
  float* Ls = Stg + kQB * kPieceFloats;           // [stage][64]
  float* Dls = Ls + kS * kNq;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Dls + kS * kNq);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + kS;
  uint64_t* pfull = empty + kS;                   // D = 256: P handed over
  uint64_t* pempty = pfull + 1;
  uint64_t* qfull = pempty + 1;                   // staging, to the writers
  uint64_t* qempty = qfull + kQB;
  uint64_t* dsfull = qempty + kQB;                // D <= 128: dS^T buffers
  uint64_t* dsempty = dsfull + 2;
  uint64_t* tfull = dsempty + 2;                  // the tile ring, two slots
  uint64_t* tempty = tfull + 2;
  int* tiles = reinterpret_cast<int*>(tempty + 2);

  const int group = H / Hk;
  const int nqt = static_cast<int>(Tp / kNq);
  const int ntiles = static_cast<int>((T + kKeys - 1) / kKeys) * B * Hk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    hop::mbar_init(kv_empty, 256);
    for (int s = 0; s < kS; ++s) hop::mbar_init(full + s, 1);
    for (int s = 0; s < kS; ++s) hop::mbar_init(empty + s, 256);
    hop::mbar_init(pfull, 128);
    hop::mbar_init(pempty, 128);
    for (int s = 0; s < kQB; ++s) hop::mbar_init(qfull + s, 128);
    for (int s = 0; s < kQB; ++s) hop::mbar_init(qempty + s, 1);
    for (int s = 0; s < 2; ++s) hop::mbar_init(dsfull + s, 256);
    for (int s = 0; s < 2; ++s) hop::mbar_init(dsempty + s, 128);
    for (int s = 0; s < 2; ++s) hop::mbar_init(tfull + s, 1);
    for (int s = 0; s < 2; ++s) hop::mbar_init(tempty + s, 256 + kQB);
    hop::mbar_init_fence();
  }
  __syncthreads();

  // the next tile from the ring (every role but the taker), or -1 at the end
  auto next_tile = [&](int tl) {
    hop::mbar_wait(tfull + (tl & 1), (tl >> 1) & 1);
    const int tile = tiles[tl & 1];
    hop::mbar_arrive(tempty + (tl & 1));
    return tile < ntiles ? tile : -1;
  };

  if (wg == 0) {
    hop::regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      // ---- tiles in order, then their K, V and each item's Q, dO, lse, D
      int it = 0;
      for (int tl = 0;; ++tl) {
        hop::mbar_wait(tempty + (tl & 1), ((tl >> 1) & 1) ^ 1);
        const int tile = static_cast<int>(atomicAdd(sync, 1u));
        tiles[tl & 1] = tile;
        hop::mbar_arrive(tfull + (tl & 1));
        if (tile >= ntiles) break;
        const Tile w = tile_of<kKeys>(tile, B, Hk, T, window);
        hop::mbar_wait(kv_empty, (tl & 1) ^ 1);
        hop::mbar_expect_tx(kv_full, 2 * C::kKvBytes);
        for (int c = 0; c < kKeys / 64; ++c)
          for (int j = 0; j < C::kBlocks; ++j) {
            const int off = (c * C::kBlocks + j) * 64 * kCb;
            const int row = static_cast<int>(w.k0) + 64 * c;
            hop::tma_load_4d(Ks + off, &kmap, kv_full, j * kCb, w.hk, row,
                             w.b);
            hop::tma_load_4d(Vs + off, &vmap, kv_full, j * kCb, w.hk, row,
                             w.b);
          }
        const int items = (w.qhi - w.qlo + 1) * group;
        for (int i = 0; i < items; ++i, ++it) {
          const int s = it % kS;
          const int h = w.hk * group + i % group;
          const int q0 = (w.qhi - i / group) * kNq;
          hop::mbar_wait(empty + s, ((it / kS) & 1) ^ 1);
          hop::mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * kNq * 4);
          for (int j = 0; j < C::kBlocks; ++j) {
            const int off = (s * C::kBlocks + j) * kNq * kCb;
            hop::tma_load_4d(Qs + off, &qmap, full + s, j * kCb, h, q0, w.b);
            hop::tma_load_4d(DOs + off, &domap, full + s, j * kCb, h, q0,
                             w.b);
          }
          const long long at = (static_cast<long long>(w.b) * H + h) * Tp + q0;
          hop::bulk_load(Ls + s * kNq, lse_pad + at, kNq * 4, full + s);
          hop::bulk_load(Dls + s * kNq, dlt_pad + at, kNq * 4, full + s);
        }
      }
    } else if (threadIdx.x % 32 == 0 && threadIdx.x / 32 <= kQB) {
      // ---- dQ: each item's tile, a piece at a time, once its turn comes
      // (sync[1 + piece of (b, h, query tile)] counts the key tiles that
      // have added theirs): stored by the first key tile that reaches it,
      // added by the rest. Lane 0 of warp 1 + qb writes the pieces staged
      // in buffer qb, so two pieces wait for their turns and their copies
      // at once.
      const int qb = threadIdx.x / 32 - 1;
      int it = 0;
      for (int tl = 0;; ++tl) {
        const int tile = next_tile(tl);
        if (tile < 0) break;
        const Tile w = tile_of<kKeys>(tile, B, Hk, T, window);
        const int items = (w.qhi - w.qlo + 1) * group;
        for (int i = 0; i < items; ++i, ++it) {
          const int h = w.hk * group + i % group;
          const int qt = w.qhi - i / group;
          long long first = static_cast<long long>(qt) * kNq - window + 1;
          if (first < 0) first = 0;
          const uint32_t turn = static_cast<uint32_t>(w.kt - first / kKeys);
          const long long at =
              ((static_cast<long long>(w.b) * H + h) * nqt + qt) * kPieces;
          for (int pc = 0; pc < kPieces; ++pc) {
            const int u = it * kPieces + pc;
            if (u % kQB != qb) continue;
            uint32_t* flag = sync + 1 + at + pc;
            float* dst = dq_acc + (at + pc) * kPieceFloats;
            const float* src = Stg + qb * kPieceFloats;
            hop::mbar_wait(qfull + qb, (u / kQB) & 1);
            // a turn that never comes (a fault elsewhere) ends the launch
            // with an error, not a hang: a turn takes microseconds
            for (long long spins = 0; hop::ld_acquire(flag) != turn; ++spins)
              if (spins > (1LL << 26)) __trap();
            hop::fence_proxy_async_all();
            if (turn == 0)
              hop::bulk_store(dst, src, kPieceFloats * 4);
            else
              hop::bulk_reduce_add_f32(dst, src, kPieceFloats * 4);
            hop::bulk_commit();
            hop::bulk_wait_read();
            hop::mbar_arrive(qempty + qb);
            hop::bulk_wait();
            hop::fence_proxy_async_all();
            hop::red_release_add(flag, 1u);
          }
        }
      }
    }
    return;
  }

  hop::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int win = static_cast<int>(window < (1LL << 30) ? window
                                                         : (1LL << 30));
  const long long kstride = static_cast<long long>(Hk) * D;
  auto col = [&](int e) { return 8 * (e / 4) + 2 * t + (e & 1); };
  // this thread's queries' lse (log2 units) or D in item n's stage
  auto rows_of = [&](const float* base, int n, float (&v)[kNq / 4]) {
#pragma unroll
    for (int j = 0; j < kNq / 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(
          base + n % kS * kNq + 8 * j + 2 * t);
      v[2 * j] = x.x;
      v[2 * j + 1] = x.y;
    }
  };
  // dS^T (bf16 pairs, the A layout of an accumulator) into shared rows:
  // key r, query c at byte r 128 + ((c / 8) ^ (r % 8)) 16 + (c % 8) 2 (the
  // 128-byte swizzle), the A of dQ (and of dK at D = 256)
  auto store_ds = [&](unsigned char* dsb, int j, uint32_t lo, uint32_t hi) {
    const int r = 16 * warp + g;
    *reinterpret_cast<uint32_t*>(dsb + r * 128 + ((j ^ g) << 4) + 4 * t) = lo;
    *reinterpret_cast<uint32_t*>(dsb + (r + 8) * 128 + ((j ^ g) << 4) +
                                 4 * t) = hi;
  };
  // the dQ tile's column block ch into staging ([block][2 (e / 4) +
  // half][128][2])
  auto stage_dq = [&](float2* st, int ch, const float (&acc)[kCb / 2]) {
#pragma unroll
    for (int j = 0; j < kCb / 8; ++j) {
      st[(ch * kCb / 4 + 2 * j) * 128] = make_float2(acc[4 * j],
                                                     acc[4 * j + 1]);
      st[(ch * kCb / 4 + 2 * j + 1) * 128] = make_float2(acc[4 * j + 2],
                                                         acc[4 * j + 3]);
    }
  };
  int it = 0;

  if constexpr (!C::kKinds) {
    // ---- D <= 128: consumer c owns keys k0 + 64 c ..; per item S^T =
    // K Q^T, dP^T = V dO^T, P and dS in registers, dV += P^T dO and dK +=
    // dS^T Q. Both write their dS^T rows into the item's buffer (two
    // buffers, by item parity), and consumer n % 2 forms item n's dQ =
    // dS K over all kKeys keys and stages it, so the two take turns.
    // dQ joins dV and dK's group where registers hold all three (D <= 64)
    constexpr bool kDqJoins = D <= 64;
    const int c = wg - 1;
    const __nv_bfloat16* Kc = Ks + c * 64 * D;
    const __nv_bfloat16* Vc = Vs + c * 64 * D;
    float sacc[kNq / 2], dpacc[kNq / 2], dkacc[D / 2], dvacc[D / 2];
    float dqacc[kCb / 2];
    uint32_t p[kNq / 4], ds[kNq / 4];
    for (int tl = 0;; ++tl) {
      const int tile = next_tile(tl);
      if (tile < 0) break;
      const Tile w = tile_of<kKeys>(tile, B, Hk, T, window);
      const int items = (w.qhi - w.qlo + 1) * group;
      const long long kbase = w.k0 + 64 * c;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
      hop::mbar_wait(kv_full, tl & 1);
      for (int i = 0; i < items; ++i, ++it) {
        const int s = it % kS, db = it & 1;
        const bool mine = db == c;               // this item's dQ is ours
        const long long q0 = static_cast<long long>(w.qhi - i / group) * kNq;
        const __nv_bfloat16* Qb = Qs + s * kNq * D;
        const __nv_bfloat16* DOb = DOs + s * kNq * D;
        __nv_bfloat16* DSb = DSs + db * kKeys * kNq;
        hop::mbar_wait(full + s, (it / kS) & 1);
        hop::reg_fence(sacc);
        hop::reg_fence(dpacc);
        hop::wgmma_fence();
        ss_product<D, kNq>(sacc, Kc, Qb, kNq);      // S^T = K Q^T
        ss_product<D, kNq>(dpacc, Vc, DOb, kNq);    // dP^T = V dO^T
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::reg_fence(sacc);
        hop::reg_fence(dpacc);
        // element e: key kbase + 16 warp + g (+ 8 where e & 2) against
        // query q0 + col(e); its query's lse and D held in registers where
        // they fit (D <= 64), else read where they are
        constexpr int kHeld = D <= 64 ? kNq / 4 : 1;
        float lv[kHeld], dl[kHeld];
        const float* L = Ls + s * kNq;
        const float* Dl = Dls + s * kNq;
        if constexpr (D <= 64) {
          rows_of(Ls, it, lv);
          rows_of(Dls, it, dl);
        }
        const bool whole = kbase + 63 <= q0 &&
                           kbase > q0 + kNq - 1 - window && q0 + kNq <= T;
        const int qk = static_cast<int>(q0 - kbase) - 16 * warp - g;
        const int qlim = static_cast<int>(T - q0 < kNq ? T - q0 : kNq);
        probs_and_grads(
            sacc, dpacc, scale, cap, whole,
            [&](int e) {
              if constexpr (D <= 64)
                return lv[2 * (e / 4) + (e & 1)];
              else
                return L[col(e)];
            },
            [&](int e) {
              if constexpr (D <= 64)
                return dl[2 * (e / 4) + (e & 1)];
              else
                return Dl[col(e)];
            },
            [&](int e) {
              const int dd = qk + col(e) - 8 * ((e >> 1) & 1);
              return dd >= 0 && dd < win && col(e) < qlim;
            });
        to_bf16<kNq>(sacc, p);
        to_bf16<kNq>(dpacc, ds);
        // the buffer's previous item's dQ has read it
        hop::mbar_wait(dsempty + db, ((it >> 1) & 1) ^ 1);
        unsigned char* dsb =
            reinterpret_cast<unsigned char*>(DSb + c * 64 * kNq);
#pragma unroll
        for (int j = 0; j < kNq / 8; ++j)
          store_ds(dsb, j, ds[2 * j], ds[2 * j + 1]);
        hop::fence_proxy_async();
        hop::mbar_arrive(dsfull + db);
        hop::reg_fence(dvacc);
        hop::reg_fence(dkacc);
        hop::wgmma_fence();
        rs_product<D, kNq>(dvacc, p, DOb);          // dV += P^T dO
        rs_product<D, kNq>(dkacc, ds, Qb);          // dK += dS^T Q
        hop::wgmma_commit();
        auto issue_dq = [&]() {
          hop::mbar_wait(dsfull + db, (it >> 1) & 1);   // both halves in
          hop::reg_fence(dqacc);
          hop::wgmma_fence();
          dq_product<D, kKeys>(dqacc, DSb, Ks, 0);      // dQ = dS K
          hop::wgmma_commit();
        };
        if (kDqJoins && mine) issue_dq();
        hop::wgmma_wait<0>();
        hop::reg_fence(dvacc);
        hop::reg_fence(dkacc);
        hop::reg_fence(p);
        hop::reg_fence(ds);
        hop::mbar_arrive(empty + s);
        if (mine) {
          if (!kDqJoins) {
            issue_dq();
            hop::wgmma_wait<0>();
          }
          hop::reg_fence(dqacc);
          const int qb = it % kQB;
          float2* st =
              reinterpret_cast<float2*>(Stg + qb * kPieceFloats) + tid;
          hop::mbar_wait(qempty + qb, ((it / kQB) & 1) ^ 1);
#pragma unroll
          for (int ch = 0; ch < kChunks; ++ch) {
            if (ch > 0) {
              hop::reg_fence(dqacc);
              hop::wgmma_fence();
              dq_product<D, kKeys>(dqacc, DSb, Ks, ch);
              hop::wgmma_commit();
              hop::wgmma_wait<0>();
              hop::reg_fence(dqacc);
            }
            stage_dq(st, ch, dqacc);
          }
          hop::mbar_arrive(dsempty + db);
          hop::fence_proxy_async();
          hop::mbar_arrive(qfull + qb);
        }
      }
      hop::mbar_arrive(kv_empty);
      const long long kpos0 = kbase + 16 * warp + g;
      __nv_bfloat16* kh = dk + static_cast<long long>(w.b) * T * kstride +
                          w.hk * D;
      __nv_bfloat16* vh = dv + static_cast<long long>(w.b) * T * kstride +
                          w.hk * D;
      store_rows<D>(kh, kstride, kpos0, T, t, dkacc, scale);
      store_rows<D>(vh, kstride, kpos0, T, t, dvacc, 1.f);
    }
  } else {
    uint2* X4 = reinterpret_cast<uint2*>(Xs) + tid;
    if (wg == 1) {
      // ---- D = 256, warpgroup 1: S^T = K Q^T, P, dV += P^T dO
      float sacc[kNq / 2], dvacc[D / 2];
      uint32_t p[kNq / 4];
      for (int tl = 0;; ++tl) {
        const int tile = next_tile(tl);
        if (tile < 0) break;
        const Tile w = tile_of<kKeys>(tile, B, Hk, T, window);
        const int items = (w.qhi - w.qlo + 1) * group;
        const long long kpos0 = w.k0 + 16 * warp + g;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dvacc[i] = 0.f;
        hop::mbar_wait(kv_full, tl & 1);
        for (int i = 0; i < items; ++i, ++it) {
          const int s = it % kS;
          const long long q0 = static_cast<long long>(w.qhi - i / group) * kNq;
          hop::mbar_wait(full + s, (it / kS) & 1);
          hop::reg_fence(sacc);
          hop::wgmma_fence();
          ss_product<D, kNq>(sacc, Ks, Qs + s * kNq * D, kNq);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::reg_fence(sacc);
          // element e: key kpos0 (+ 8 where e & 2) against query q0 + col(e)
          float lv[kNq / 4];
          rows_of(Ls, it, lv);
          const bool whole = w.k0 + 63 <= q0 &&
                             w.k0 > q0 + kNq - 1 - window && q0 + kNq <= T;
          const int qk = static_cast<int>(q0 - kpos0);
          const int qlim = static_cast<int>(T - q0 < kNq ? T - q0 : kNq);
          hop::mbar_wait(pempty, (it & 1) ^ 1);
          probs(sacc, X4, scale, cap, whole,
                [&](int e) { return lv[2 * (e / 4) + (e & 1)]; },
                [&](int e) {
                  const int dd = qk + col(e) - 8 * ((e >> 1) & 1);
                  return dd >= 0 && dd < win && col(e) < qlim;
                });
          hop::mbar_arrive(pfull);
          to_bf16<kNq>(sacc, p);
          hop::reg_fence(dvacc);
          hop::wgmma_fence();
          rs_product<D, kNq>(dvacc, p, DOs + s * kNq * D);   // dV += P^T dO
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::reg_fence(dvacc);
          hop::reg_fence(p);
          hop::mbar_arrive(empty + s);
        }
        hop::mbar_arrive(kv_empty);
        store_rows<D>(
            dv + static_cast<long long>(w.b) * T * kstride + w.hk * D,
            kstride, kpos0, T, t, dvacc, 1.f);
      }
      return;
    }

    // ---- D = 256, warpgroup 2: dP^T = V dO^T, dS (P from warpgroup 1), dK
    // += dS^T Q, the tile's dQ = dS K
    unsigned char* dsb = reinterpret_cast<unsigned char*>(DSs);
    float dpacc[kNq / 2], dkacc[D / 2], dqacc[kCb / 2];
    for (int tl = 0;; ++tl) {
      const int tile = next_tile(tl);
      if (tile < 0) break;
      const Tile w = tile_of<kKeys>(tile, B, Hk, T, window);
      const int items = (w.qhi - w.qlo + 1) * group;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dkacc[i] = 0.f;
      hop::mbar_wait(kv_full, tl & 1);
      for (int i = 0; i < items; ++i, ++it) {
        const int s = it % kS;
        const __nv_bfloat16* Qb = Qs + s * kNq * D;
        hop::mbar_wait(full + s, (it / kS) & 1);
        hop::reg_fence(dpacc);
        hop::wgmma_fence();
        ss_product<D, kNq>(dpacc, Vs, DOs + s * kNq * D, kNq);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::reg_fence(dpacc);
        // dS = P (1 - tanh^2) (dP - D), P in the layout warpgroup 1 wrote
        float dl[kNq / 4];
        rows_of(Dls, it, dl);
        hop::mbar_wait(pfull, it & 1);
#pragma unroll
        for (int j = 0; j < kNq / 8; ++j) {
          const uint2 x = X4[j * 128];
          const float2 lo =
              __half22float2(*reinterpret_cast<const __half2*>(&x.x));
          const float2 hi =
              __half22float2(*reinterpret_cast<const __half2*>(&x.y));
          const float d0 = dl[2 * j], d1 = dl[2 * j + 1];
          store_ds(dsb, j,
                   pack_bf16(lo.x * (dpacc[4 * j] - d0),
                             lo.y * (dpacc[4 * j + 1] - d1)),
                   pack_bf16(hi.x * (dpacc[4 * j + 2] - d0),
                             hi.y * (dpacc[4 * j + 3] - d1)));
        }
        hop::mbar_arrive(pempty);
        hop::fence_proxy_async();
        hop::named_sync(1, 128);
        hop::reg_fence(dkacc);
        hop::reg_fence(dqacc);
        hop::wgmma_fence();
        dk_product<D>(dkacc, DSs, Qb);                // dK += dS^T Q
        dq_product<D, 64>(dqacc, DSs, Ks, 0);             // dQ = dS K, block 0
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::reg_fence(dkacc);
        hop::reg_fence(dqacc);
        hop::mbar_arrive(empty + s);
        // the dQ tile into staging, a piece at a time
#pragma unroll
        for (int pc = 0; pc < kPieces; ++pc) {
          const int u = it * kPieces + pc, qb = u % kQB;
          float2* st =
              reinterpret_cast<float2*>(Stg + qb * kPieceFloats) + tid;
          hop::mbar_wait(qempty + qb, ((u / kQB) & 1) ^ 1);
#pragma unroll
          for (int cc = 0; cc < kChunks / kPieces; ++cc) {
            const int ch = pc * (kChunks / kPieces) + cc;
            if (ch > 0) {
              hop::reg_fence(dqacc);
              hop::wgmma_fence();
              dq_product<D, 64>(dqacc, DSs, Ks, ch);
              hop::wgmma_commit();
              hop::wgmma_wait<0>();
              hop::reg_fence(dqacc);
            }
            stage_dq(st, cc, dqacc);
          }
          hop::fence_proxy_async();
          hop::mbar_arrive(qfull + qb);
        }
      }
      hop::mbar_arrive(kv_empty);
      store_rows<D>(
          dk + static_cast<long long>(w.b) * T * kstride + w.hk * D,
          kstride, w.k0 + 16 * warp + g, T, t, dkacc, scale);
    }
  }
}

// dq [B, T, H, D] = dq_acc scale in bf16: dq_acc holds [B, H, Tp / 64]
// tiles of 64 queries x D, each as the writer left it ([block][2 (n / 4)
// + half][128 threads][2]: the accumulator layout of the dQ product);
// one thread per pair of columns
template <int D>
__global__ void __launch_bounds__(256)
bwd_dq_out(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
           long long T, long long Tp, int H, long long pairs, float scale) {
  constexpr int kCb = Cfg<D>::kCb;
  const long long f = blockIdx.x * 256LL + threadIdx.x;
  if (f >= pairs) return;
  const long long tile = f / (kNq * D / 2);
  const int r = static_cast<int>(f % (kNq * D / 2));
  const long long nqt = Tp / kNq;
  const long long bh = tile / nqt;
  const int tid = r % 128, jj = r / 128 % (kCb / 4), ch = r / (32 * kCb);
  const int lane = tid % 32;
  const int row = 16 * (tid / 32) + lane / 4 + 8 * (jj & 1);
  const int col = ch * kCb + 8 * (jj >> 1) + 2 * (lane % 4);
  const long long q = tile % nqt * kNq + row;
  if (q >= T) return;
  const float2 x = reinterpret_cast<const float2*>(acc)[f];
  *reinterpret_cast<__nv_bfloat162*>(
      dq + ((bh / H * T + q) * H + bh % H) * D + col) =
      __floats2bfloat162_rn(x.x * scale, x.y * scale);
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
                     float* dq_acc, uint32_t* sync, long long B, long long T,
                     long long Tp, int H, int Hk, long long window, float cap,
                     float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool opted = false;
  cudaError_t err = opt_in(bwd_bf16<D>, C::kSmem, &opted);
  if (err != cudaSuccess) return err;
  if (dq_acc == nullptr || sync == nullptr) return cudaErrorInvalidValue;
  const long long tiles = (T + C::kKeys - 1) / C::kKeys * B * Hk;
  if (tiles > 0x7fffffffLL || T > 0x7fffffffLL) return cudaErrorInvalidValue;
  // every map in boxes of kCb columns x 64 rows
  CUtensorMap qmap, kmap, vmap, domap;
  err = flash::head_map(&qmap, q, B, T, H, D, C::kCb, kNq);
  if (err == cudaSuccess)
    err = flash::head_map(&domap, dout, B, T, H, D, C::kCb, kNq);
  if (err == cudaSuccess)
    err = flash::head_map(&kmap, k, B, T, Hk, D, C::kCb, 64);
  if (err == cudaSuccess)
    err = flash::head_map(&vmap, v, B, T, Hk, D, C::kCb, 64);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one CTA an SM (its shared memory), each taking tiles until none is left
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  bwd_bf16<D><<<grid, kBf16Threads, C::kSmem, stream>>>(
      qmap, kmap, vmap, domap, lse_pad, dlt_pad,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      dq_acc, sync, T, Tp, static_cast<int>(B), H, Hk, window, cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pairs = B * H * Tp * D / 2;
  bwd_dq_out<D><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0,
                  stream>>>(dq_acc, static_cast<__nv_bfloat16*>(dq), T, Tp,
                            H, pairs, scale);
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
// scratch: f32, where dtype is bf16 B * H * Tp * D (the dQ tiles), where
// it is f32 and H > Hk 2 * B * T * H * D (each head's partial dK and dV),
// else unread (may be null); sync: where dtype is bf16, 1 + 2 * B * H *
// Tp / 64 zeros (uint32), else unread. D in {16, 32, 64, 128, 256}; H %
// Hk == 0.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* lse_pad, void* dlt_pad, void* scratch, void* sync, int dtype,
    long long B, long long T, int H, int Hk, int D, long long window,
    float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      B * H > 0x7fffffffLL || window <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long Tp = (T + kPad - 1) / kPad * kPad;
  float* lp = static_cast<float*>(lse_pad);
  float* dp = static_cast<float*>(dlt_pad);
  float* f = static_cast<float*>(scratch);
  cudaError_t err =
      dtype == 1 ? run_pre<__nv_bfloat16>(o, dout, lse, lp, dp, B, T, Tp, H,
                                          D, s)
                 : run_pre<float>(o, dout, lse, lp, dp, B, T, Tp, H, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define REPRO_FLASH_BWD_CASE(DIM)                                          \
  case DIM:                                                                \
    return static_cast<int>(                                               \
        dtype == 1 ? run_bf16<DIM>(q, k, v, dout, lp, dp, dq, dk, dv, f,   \
                                   static_cast<uint32_t*>(sync), B, T, Tp, \
                                   H, Hk, window, softcap, scale, s)       \
                   : run_f32<DIM>(q, k, v, dout, lp, dp, dq, dk, dv, f, B, \
                                  T, Tp, H, Hk, window, softcap, scale,    \
                                  s));
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
