// Causal online-softmax attention (FlashAttention), with an optional
// sliding window and a tanh logit soft-cap, over grouped-query heads.
//
//   o[b, t, h] = softmax_s(mask(cap(q[b,t,h] . k[b,s,h/g] * scale))) v[b,s,h/g]
//
// where g = H / Hk, cap(x) = softcap * tanh(x / softcap) when softcap > 0,
// and the mask keeps key s for query t when s <= t, s > t - window and
// s < T. Masked scores are -1e30 (not -inf), as in both JAX versions, so
// exp(s - m) never sees inf - inf. q, o: [B, T, H, D]; k, v: [B, T, Hk, D],
// all contiguous. The KV head of query head h is h / g: K and V are read
// in place, never repeated g times.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (the Pallas TPU kernel), and the model's blockwise_sdpa
// (src/repro/models/attention.py), which computes the same function.
//
// Order of operations: the f32 product q.k is scaled (as blockwise_sdpa
// does; the Pallas kernel scales q before the product), then soft-capped,
// then masked. Running max, sum and output are f32.
//
// What bounds it on the H100: operations. A llama3.2-1b prefill layer
// (B = 2, T = 4,096, H = 32, D = 64, causal) is 1.4e11 FLOP, 0.14 ms at
// the 989 TFLOP/s bf16 tensor-core rate, against ~0.02 ms for its bytes.
//
// Design. A kv tile that lies wholly above the diagonal, wholly outside
// the window or past T is skipped, which changes no value and makes a
// local layer cost O(T * window); only the tiles the mask cuts pay for
// masking. Query tiles are launched longest first.
//   * bf16 (Hopper's wgmma and TMA): one CTA of three warpgroups per
//     (b, h, tile of 128 queries). Warpgroup 0 is the producer: one
//     thread copies Q once and then each K and V tile by TMA
//     (cp.async.bulk.tensor over a 4-d map of [B, T, heads, D], so query
//     head h reads KV head h / g in place) into a ring of stages (three
//     of 128 keys for D <= 128, two of 64 keys at D = 256), each stage's
//     K and V signalling their own mbarrier when full; every consumer
//     thread arrives on the stage's "empty" barrier when done with it.
//     Warpgroups 1 and 2 consume, 64 query rows each: S = Q K^T is a
//     wgmma with Q and K in shared memory (K-major), O += P V a wgmma
//     with P in registers (bf16, the A layout of the S accumulator) and
//     V in shared memory read through a transposed (MN-major)
//     descriptor. Tiles land swizzled (128-byte rows of 64 columns, D / 64
//     boxes a row; 64- and 32-byte rows at D = 32 and 16), and the
//     descriptors read the same swizzle. Per tile, S of the next tile and
//     P V of the previous one are issued together and the softmax of S
//     runs while P V is on the tensor cores; O is rescaled after it.
//     The producer gives its registers to the consumers (setmaxnreg: 24
//     and 240 a thread), so one CTA fills an SM: shared memory 113 KB at
//     D = 64 (Q 16 KB, three stages of 32), 225 KB at D = 128 and 193 KB
//     at D = 256. P enters P V in bf16, as in blockwise_sdpa (the Pallas
//     kernel keeps it f32); the row sum takes P in f32. Exponentials
//     are ex2 (on a whole tile without soft-cap, of one fma that folds
//     the scale in; else __expf), the soft-cap's tanh is 1 - 2 / (e^2x +
//     1) (absolute error ~1e-7). The tensor maps are encoded per call on
//     the host.
//   * f32: CUDA cores (a TF32 product would miss the 3e-4 tolerance).
//     Each warp owns 4 query rows, 16 per CTA; tiles of 32 keys, one key
//     per lane for the scores, D / 32 output columns per lane for P V.
// Given an lse pointer (training), each row's logsumexp m + log l of its
// scores is written as f32 [B, H, T] for the backward
// (flash_attention_bwd.cu); serving passes null and writes nothing more.
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
using flash::kNeg;
using flash::kv_range;
using flash::pack_bf16;

constexpr int kThreads = 128;

__device__ __forceinline__ float score(float acc, float scale, float cap,
                                       long long qpos, long long kpos,
                                       long long window, long long T) {
  float s = acc * scale;
  if (cap > 0.f) s = cap * tanhf(s / cap);
  const bool ok = kpos <= qpos && kpos > qpos - window && kpos < T;
  return ok ? s : kNeg;
}

// the bf16 kernel's barriers, [q_full, k_full[S], v_full[S],
// k_empty[S], v_empty[S]]: Q and each stage's K and V are full when their
// bytes have landed (one arrival: the producer's); a stage's K (V) is
// empty when every consumer thread has arrived, K after its S = Q K^T,
// V after its P V, so K slots turn over a tile earlier than V's
__device__ __forceinline__ void mbar_init_all(uint64_t* bars, int stages,
                                              int consumers) {
  hop::mbar_init(bars, 1);
  for (int s = 0; s < 2 * stages; ++s) hop::mbar_init(bars + 1 + s, 1);
  for (int s = 0; s < 2 * stages; ++s)
    hop::mbar_init(bars + 1 + 2 * stages + s, consumers);
  hop::mbar_init_fence();
}

// ---------------------------------------------------------------- bf16 --
// One CTA per (b, h, tile of 128 queries): warpgroup 0 produces (one
// thread issues the TMA copies), warpgroups 1 and 2 consume, each owning
// 64 query rows.
constexpr int kBq = 128;                 // queries per CTA
constexpr int kConsumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kBf16Threads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;        // setmaxnreg budgets (x 128 threads
constexpr int kConsumerRegs = 240;       // each, 24 + 2 x 240 <= 512)

template <int D> struct Bf16Cfg {
  static constexpr int kBk = D == 256 ? 64 : 128;   // keys per tile
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 3 : 4;  // ring
  static constexpr int kCb = D < 64 ? D : 64;       // columns of a TMA box
  static constexpr int kBlocks = D / kCb;           // boxes across a row
  static constexpr int kRowBytes = kCb * 2;         // 32, 64 or 128: the
  static constexpr hop::Swizzle kSw =               // swizzle of both
      kRowBytes == 128 ? hop::kSwizzle128           // TMA and wgmma
      : kRowBytes == 64 ? hop::kSwizzle64 : hop::kSwizzle32;
  static constexpr int kAtom = 8 * kRowBytes;       // 8 rows: one atom
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kTileBytes = kBk * D * 2;    // one K (or V) tile
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes +
      (1 + 4 * kStages) * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
           long long T, int H, int Hk, long long window, float cap,
           float scale) {
  using Cfg = Bf16Cfg<D>;
  constexpr int kBk = Cfg::kBk, kStages = Cfg::kStages, kCb = Cfg::kCb;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms repeat every 1,024 bytes: align the base to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBq * D;          // [stage][block][kBk][kCb]
  __nv_bfloat16* Vs = Ks + kStages * kBk * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * kBk * D);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const long long q0 =
      static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kBq;
  int lo, hi;
  kv_range(q0, kBq, kBk, T, window, &lo, &hi);
  const int tiles = hi - lo + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init_all(q_full, kStages, 128 * kConsumers);
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q once, then K and V tiles into the ring
    hop::regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(q_full, Cfg::kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int j = 0; j < Cfg::kBlocks; ++j)
          hop::tma_load_4d(Qs + (c * Cfg::kBlocks + j) * 64 * kCb, &qmap,
                           q_full, j * kCb, h, static_cast<int>(q0) + 64 * c,
                           b);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (lo + i) * kBk;
        hop::mbar_wait(k_empty + s, ph ^ 1);   // the consumers released it
        hop::mbar_expect_tx(k_full + s, Cfg::kTileBytes);
        for (int j = 0; j < Cfg::kBlocks; ++j)
          hop::tma_load_4d(Ks + (s * Cfg::kBlocks + j) * kBk * kCb, &kmap,
                           k_full + s, j * kCb, hk, k0, b);
        hop::mbar_wait(v_empty + s, ph ^ 1);
        hop::mbar_expect_tx(v_full + s, Cfg::kTileBytes);
        for (int j = 0; j < Cfg::kBlocks; ++j)
          hop::tma_load_4d(Vs + (s * Cfg::kBlocks + j) * kBk * kCb, &vmap,
                           v_full + s, j * kCb, hk, k0, b);
      }
    }
    return;
  }

  // ---- consumers
  hop::regs_claim<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row_lo = q0 + 64 * c;           // this warpgroup's rows
  const long long qpos0 = row_lo + 16 * warp + g, qpos1 = qpos0 + 8;
  const __nv_bfloat16* Qc = Qs + c * Cfg::kBlocks * 64 * kCb;

  // S = Q K^T over D / 16 k-steps; the k-th reads 32 bytes into block
  // k * 16 / kCb of the Q and K rows
  auto qk = [&](hop::Acc<kBk>& s_acc, int stage) {
    const __nv_bfloat16* Kb = Ks + stage * Cfg::kBlocks * kBk * kCb;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk * 16 / kCb, off = kk * 16 % kCb;
      const uint64_t da = hop::make_desc(Qc + blk * 64 * kCb + off, 16,
                                         Cfg::kAtom, Cfg::kSw);
      const uint64_t db = hop::make_desc(Kb + blk * kBk * kCb + off, 16,
                                         Cfg::kAtom, Cfg::kSw);
      hop::wgmma_bf16_ss(s_acc, da, db, kk > 0);
    }
  };
  // O += P V over kBk / 16 k-steps of 16 keys (two 8-row atoms); V is
  // the MN-major B: lbo steps over blocks of kCb columns
  auto pv = [&](hop::Acc<D>& o_acc, const uint32_t (&p)[kBk / 4],
                int stage) {
    const __nv_bfloat16* Vb = Vs + stage * Cfg::kBlocks * kBk * kCb;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint64_t db = hop::make_desc(Vb + kk * 16 * kCb,
                                         kBk * Cfg::kRowBytes, Cfg::kAtom,
                                         Cfg::kSw);
      hop::wgmma_bf16_rs_tb(
          o_acc, *reinterpret_cast<const uint32_t(*)[4]>(p + 4 * kk), db,
          1);
    }
  };

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float sacc[kBk / 2];
  uint32_t p[kBk / 4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // scale, cap, mask (on a tile the mask cuts), then the online softmax:
  // sacc becomes exp(s - m) in f32 and the row sums take it in f32;
  // returns each row's correction exp(m_old - m_new) in *c0, *c1
  auto softmax = [&](int kt, float* c0, float* c1) {
    const long long k0 = static_cast<long long>(kt) * kBk;
    const bool whole = k0 + kBk - 1 <= row_lo &&
                       k0 > row_lo + 63 - window && k0 + kBk <= T;
    // a whole tile with no cap keeps its raw products: the scale folds
    // into the exponent below (scale > 0, so the row max commutes). The
    // branches are uniform and taken once a tile, outside the loops over
    // the tile's scores
    const bool raw = whole && !(cap > 0.f) && scale > 0.f;
    if (!whole) {
      // scale, cap and mask by position (the tiles the mask cuts)
      const int dq = static_cast<int>(qpos0 - k0) - 2 * t;
      const int lim = static_cast<int>(
          (T - k0 < kBk ? T - k0 : kBk) - 2 * t);   // keys at or past T
      const long long wq = window < (1LL << 30) ? window : (1LL << 30);
      const int win = static_cast<int>(wq);
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // key k0 + 8 j + 2 t + (e & 1) against query qpos0 (+ 8)
          const int d = dq + 8 * (e >> 1) - 8 * j - (e & 1);  // q - k
          const bool ok = d >= 0 && d < win && 8 * j + (e & 1) < lim;
          float v = sacc[4 * j + e] * scale;
          if (cap > 0.f) v = cap * fast_tanh(v / cap);
          sacc[4 * j + e] = ok ? v : kNeg;
        }
      }
    } else if (cap > 0.f) {
#pragma unroll
      for (int j = 0; j < kBk / 2; ++j)
        sacc[j] = cap * fast_tanh(sacc[j] * scale / cap);
    } else if (!raw) {
#pragma unroll
      for (int j = 0; j < kBk / 2; ++j) sacc[j] *= scale;
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (raw) {
      mx0 *= scale;
      mx1 *= scale;
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    *c0 = __expf(m0 - mn0);
    *c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    if (raw) {
      // exp(s scale - m) = 2^(s (scale log2 e) - m log2 e): one fma and
      // one ex2 a score (every score of a whole tile is a real one, so
      // no -1e30 - (-1e30) arises here)
      const float f = scale * kLog2e;
      const float b0 = -mn0 * kLog2e, b1 = -mn1 * kLog2e;
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        sacc[4 * j] = fast_exp2(fmaf(sacc[4 * j], f, b0));
        sacc[4 * j + 1] = fast_exp2(fmaf(sacc[4 * j + 1], f, b0));
        sacc[4 * j + 2] = fast_exp2(fmaf(sacc[4 * j + 2], f, b1));
        sacc[4 * j + 3] = fast_exp2(fmaf(sacc[4 * j + 3], f, b1));
        sum0 += sacc[4 * j] + sacc[4 * j + 1];
        sum1 += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        sacc[4 * j] = __expf(sacc[4 * j] - mn0);
        sacc[4 * j + 1] = __expf(sacc[4 * j + 1] - mn0);
        sacc[4 * j + 2] = __expf(sacc[4 * j + 2] - mn1);
        sacc[4 * j + 3] = __expf(sacc[4 * j + 3] - mn1);
        sum0 += sacc[4 * j] + sacc[4 * j + 1];
        sum1 += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
    }
    l0 = l0 * *c0 + sum0;  // this lane's columns; the quad adds at the end
    l1 = l1 * *c1 + sum1;
  };
  // P in bf16: the accumulator layout of S is the A layout of P V
  auto to_p = [&]() {
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      p[2 * j] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
      p[2 * j + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
    }
  };
  auto rescale = [&](float c0, float c1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[4 * j] *= c0;
      oacc[4 * j + 1] *= c0;
      oacc[4 * j + 2] *= c1;
      oacc[4 * j + 3] *= c1;
    }
  };

  hop::mbar_wait(q_full, 0);
  // the first tile: S, then its softmax
  float c0, c1;
  hop::mbar_wait(k_full, 0);
  hop::reg_fence(sacc);
  hop::wgmma_fence();
  qk(sacc, 0);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::reg_fence(sacc);
  hop::mbar_arrive(k_empty);            // K of tile 0 is free
  softmax(lo, &c0, &c1);
  to_p();
  // tile i: S_i = Q K_i^T is issued, then O += P_{i-1} V_{i-1}; the
  // softmax of S_i runs while P V is on the tensor cores
  for (int i = 1; i < tiles; ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    hop::mbar_wait(k_full + s, (i / kStages) & 1);
    hop::reg_fence(sacc);
    hop::reg_fence(oacc);
    hop::wgmma_fence();
    qk(sacc, s);
    hop::wgmma_commit();
    hop::mbar_wait(v_full + sp, ((i - 1) / kStages) & 1);
    pv(oacc, p, sp);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();                 // S_i is ready
    hop::reg_fence(sacc);
    hop::mbar_arrive(k_empty + s);        // K of tile i is free
    softmax(lo + i, &c0, &c1);
    hop::wgmma_wait<0>();                 // P_{i-1} V_{i-1} is done
    hop::reg_fence(oacc);
    hop::reg_fence(p);                    // P's registers held until here
    rescale(c0, c1);
    to_p();
    hop::mbar_arrive(v_empty + sp);       // V of tile i - 1 is free
  }
  const int sl = (tiles - 1) % kStages;
  hop::mbar_wait(v_full + sl, ((tiles - 1) / kStages) & 1);
  hop::reg_fence(oacc);
  hop::wgmma_fence();
  pv(oacc, p, sl);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::reg_fence(oacc);
  hop::reg_fence(p);
  hop::mbar_arrive(v_empty + sl);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {
    // the row's logsumexp of the (scaled, capped, masked) scores, for the
    // backward: m + log l (every row < T keeps its own key, so l >= 1)
    float* lh = lse + (static_cast<long long>(b) * H + h) * T;
    if (qpos0 < T) lh[qpos0] = m0 + logf(l0);
    if (qpos1 < T) lh[qpos1] = m1 + logf(l1);
  }
  const long long qstride = static_cast<long long>(H) * D;
  __nv_bfloat16* oh = o + b * T * qstride + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (qpos0 < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + qpos0 * qstride + col) =
          __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (qpos1 < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + qpos1 * qstride + col) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv1,
                                oacc[4 * j + 3] * inv1);
  }
}

// ----------------------------------------------------------------- f32 --
constexpr int kBqF = 16;  // queries per CTA (4 warps x 4 rows)
constexpr int kBkF = 32;  // keys per staged tile (one per lane)
constexpr int kRowsPerWarp = 4;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, long long T, int H, int Hk,
          long long window, float cap, float scale) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  constexpr int kLdK = D + 1;           // lane = key reads K[lane][d]
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [16][D]
  float* Ks = Qs + kBqF * D;                   // [32][D + 1]
  float* Vs = Ks + kBkF * kLdK;                // [32][D]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const long long q0 =
      static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kBqF;
  const long long qstride = static_cast<long long>(H) * D;
  const long long kstride = static_cast<long long>(Hk) * D;
  const float* qh = q + b * T * qstride + h * D;
  const float* kh = k + b * T * kstride + hk * D;
  const float* vh = v + b * T * kstride + hk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int c = threadIdx.x; c < kBqF * D; c += kThreads) {
    const int r = c / D, d = c % D;
    Qs[c] = q0 + r < T ? qh[(q0 + r) * qstride + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }

  int lo, hi;
  kv_range(q0, kBqF, kBkF, T, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const long long k0 = static_cast<long long>(kt) * kBkF;
    __syncthreads();
    for (int c = threadIdx.x; c < kBkF * D; c += kThreads) {
      const int r = c / D, d = c % D;
      const bool in = k0 + r < T;
      Ks[r * kLdK + d] = in ? kh[(k0 + r) * kstride + d] : 0.f;
      Vs[r * D + d] = in ? vh[(k0 + r) * kstride + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const float* qr = Qs + r * D;
      const float* kr = Ks + lane * kLdK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float s =
          score(dot, scale, cap, q0 + r, k0 + lane, window, T);
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      const float p = expf(s - mn);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = mn;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[i][e] *= corr;
#pragma unroll 4
      for (int j = 0; j < kBkF; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[i][e] = fmaf(pj, Vs[j * D + d], acc[i][e]);
        }
      }
    }
  }

  float* oh = o + b * T * qstride + h * D;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long qp = q0 + warp * kRowsPerWarp + i;
    if (qp >= T) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * H + h) * T + qp] = m[i] + logf(l[i]);
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int d = lane + 32 * e;
      if (d < D) oh[qp * qstride + d] = acc[i][e] * inv;
    }
  }
}

// ------------------------------------------------------------- launch --
// Each run_* opts its own template instance in to the dynamic shared
// memory it needs, once (the attribute belongs to each instantiated
// function, not to the function type that instances share).
template <int D>
cudaError_t head_map(CUtensorMap* map, const void* ptr, long long B,
                     long long T, int heads, int rows) {
  return flash::head_map(map, ptr, B, T, heads, D, Bf16Cfg<D>::kCb, rows);
}

template <int D>
cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o,
                     float* lse, long long B, long long T, int H, int Hk,
                     long long window, float cap, float scale,
                     cudaStream_t stream) {
  using Cfg = Bf16Cfg<D>;
  static bool opted = false;
  auto kernel = flash_bf16<D>;
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Cfg::kSmem));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const long long tiles = (T + kBq - 1) / kBq;
  if (tiles > 65535 || T > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the pointers change from call to call: the maps are encoded per call
  // and passed by value (__grid_constant__)
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = head_map<D>(&qmap, q, B, T, H, 64);
  if (err == cudaSuccess) err = head_map<D>(&kmap, k, B, T, Hk, Cfg::kBk);
  if (err == cudaSuccess) err = head_map<D>(&vmap, v, B, T, Hk, Cfg::kBk);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>(tiles));
  kernel<<<grid, kBf16Threads, Cfg::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, T, H, Hk,
      window, cap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o,
                    float* lse, long long B, long long T, int H, int Hk,
                    long long window, float cap, float scale,
                    cudaStream_t stream) {
  static bool opted = false;
  const size_t smem =
      static_cast<size_t>(kBqF * D + kBkF * (D + 1) + kBkF * D) *
      sizeof(float);
  auto kernel = flash_f32<D>;
  if (smem > 48 * 1024 && !opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const long long tiles = (T + kBqF - 1) / kBqF;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, T, H, Hk,
      window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. D in {16, 32, 64, 128, 256}; H % Hk == 0.
// lse: f32 [B, H, T], each row's logsumexp for the backward, or null
// (serving: nothing is written).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int dtype,
                                     long long B, long long T, int H,
                                     int Hk, int D, long long window,
                                     float softcap, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(DIM)                                              \
  case DIM:                                                                \
    return static_cast<int>(                                               \
        dtype == 1 ? run_bf16<DIM>(q, k, v, o, static_cast<float*>(lse), B, \
                                   T, H, Hk, window, softcap, scale, s)    \
                   : run_f32<DIM>(q, k, v, o, static_cast<float*>(lse), B,  \
                                  T, H, Hk, window, softcap, scale, s));
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
  }
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
