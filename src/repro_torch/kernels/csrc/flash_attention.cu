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
// Design: one CTA of 4 warps per (b, h, tile of 64 queries); tiles of
// 64 keys are staged in shared memory and walked in order. A kv tile
// that lies wholly above the diagonal, wholly outside the window or past
// T is skipped, which changes no value and makes a local layer cost
// O(T * window); only the tiles the mask cuts pay for masking. Query
// tiles are launched longest first.
//   * bf16: each warp owns 16 query rows. S = Q K^T and O += P V run on
//     the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), with
//     every fragment loaded by ldmatrix (.trans for V). P enters P V in
//     bf16, as in blockwise_sdpa (the Pallas kernel keeps it f32); the
//     row sum takes P in f32; exponentials are __expf. Tiles arrive by
//     cp.async, the next K/V tile loading while this one is used when
//     D <= 128. Rows are padded by 16 bytes, so the fragment loads hit
//     distinct banks. Shared memory: (64 + 2 x stages x 64) x (D + 8) x
//     2 B, 46 KB at D = 64, 87 KB at D = 128 and 101 KB at D = 256 (one
//     stage), above the 48 KB default, so every template instance opts
//     in to its own size before its first launch.
//   * f32: CUDA cores (a TF32 product would miss the 3e-4 tolerance).
//     Each warp owns 4 query rows, 16 per CTA; tiles of 32 keys, one key
//     per lane for the scores, D / 32 output columns per lane for P V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float score(float acc, float scale, float cap,
                                       long long qpos, long long kpos,
                                       long long window, long long T) {
  float s = acc * scale;
  if (cap > 0.f) s = cap * tanhf(s / cap);
  const bool ok = kpos <= qpos && kpos > qpos - window && kpos < T;
  return ok ? s : kNeg;
}

// kv tiles of width bk that one query tile [q0, q0 + bq) may see
__device__ __forceinline__ void kv_range(long long q0, int bq, int bk,
                                         long long T, long long window,
                                         int* lo, int* hi) {
  long long first = q0 - window + 1;
  if (first < 0) first = 0;
  long long last = q0 + bq - 1;
  if (last > T - 1) last = T - 1;
  *lo = static_cast<int>(first / bk);
  *hi = static_cast<int>(last / bk);  // inclusive
}

// ---------------------------------------------------------------- bf16 --
constexpr int kBq = 64;  // queries per CTA (4 warps x 16 rows)
constexpr int kBk = 64;  // keys per staged tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared without the registers; zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a [T, stride] head slice into s[64][D + 8], by
// cp.async (the caller commits and waits); rows at or past T are zero
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* s,
                                           const __nv_bfloat16* g,
                                           long long r0, long long T,
                                           long long stride) {
  constexpr int kLd = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = r0 + r < T;
    cp_async16(s + r * kLd + col, g + (in ? r0 + r : 0) * stride + col, in);
  }
}

// K/V tiles in flight: two (the next tile loads while this one is
// used) where shared memory allows two CTAs per SM, else one
template <int D>
__host__ __device__ constexpr int kv_stages() { return D <= 128 ? 2 : 1; }

template <int D>
constexpr size_t bf16_smem() {
  return static_cast<size_t>(kBq + 2 * kv_stages<D>() * kBk) * (D + 8) *
         sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, long long T, int H, int Hk,
           long long window, float cap, float scale) {
  constexpr int kLd = D + 8;
  constexpr int kStages = kv_stages<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBq * kLd;             // [kStages][64][kLd]
  __nv_bfloat16* Vs = Ks + kStages * kBk * kLd;   // [kStages][64][kLd]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hk);
  const long long q0 =
      static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kBq;
  const long long qstride = static_cast<long long>(H) * D;
  const long long kstride = static_cast<long long>(Hk) * D;
  const __nv_bfloat16* qh = q + b * T * qstride + h * D;
  const __nv_bfloat16* kh = k + b * T * kstride + hk * D;
  const __nv_bfloat16* vh = v + b * T * kstride + hk * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, row = lane & 7;  // ldmatrix addressing
  const int r0 = warp * 16;
  const long long qpos0 = q0 + r0 + g, qpos1 = qpos0 + 8;

  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int lo, hi;
  kv_range(q0, kBq, kBk, T, window, &lo, &hi);
  stage_bf16<D>(Qs, qh, q0, T, qstride);
  if (kStages == 2) {
    stage_bf16<D>(Ks, kh, static_cast<long long>(lo) * kBk, T, kstride);
    stage_bf16<D>(Vs, vh, static_cast<long long>(lo) * kBk, T, kstride);
    cp_async_commit();
  }
  for (int kt = lo; kt <= hi; ++kt) {
    const long long k0 = static_cast<long long>(kt) * kBk;
    const int buf = kStages == 2 ? (kt - lo) & 1 : 0;
    if (kStages == 2 && kt < hi) {  // prefetch the next tile
      stage_bf16<D>(Ks + (buf ^ 1) * kBk * kLd, kh, k0 + kBk, T, kstride);
      stage_bf16<D>(Vs + (buf ^ 1) * kBk * kLd, vh, k0 + kBk, T, kstride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (kStages == 1) {
        stage_bf16<D>(Ks, kh, k0, T, kstride);
        stage_bf16<D>(Vs, vh, k0, T, kstride);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kb = Ks + buf * kBk * kLd;
    const __nv_bfloat16* Vb = Vs + buf * kBk * kLd;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (r0 + row + 8 * (mat & 1)) * kLd + kk +
                         8 * (mat >> 1));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kb + (j * 8 + row + 8 * (mat >> 1)) * kLd + kk +
                            8 * (mat & 1));
        mma_bf16(s[j], a[0], a[1], a[2], a[3], bk[0], bk[1]);
        mma_bf16(s[j + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
      }
    }

    // scale, cap and (on a tile the mask cuts) mask; new row maxima
    const bool whole = k0 + kBk - 1 <= q0 && k0 > q0 + kBq - 1 - window &&
                       k0 + kBk <= T;
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (whole) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale;
          if (cap > 0.f) s[j][e] = cap * tanhf(s[j][e] / cap);
        }
      } else {
        const long long kp = k0 + j * 8 + 2 * t;
        s[j][0] = score(s[j][0], scale, cap, qpos0, kp, window, T);
        s[j][1] = score(s[j][1], scale, cap, qpos0, kp + 1, window, T);
        s[j][2] = score(s[j][2], scale, cap, qpos1, kp, window, T);
        s[j][3] = score(s[j][3], scale, cap, qpos1, kp + 1, window, T);
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + sum0;  // this lane's columns; the quad adds at the end
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[j][0] *= c0;
      oacc[j][1] *= c0;
      oacc[j][2] *= c1;
      oacc[j][3] *= c1;
    }

    // O += P V: P's accumulator layout is the A fragment of the next mma
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t a0 = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t a1 = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      const uint32_t a2 = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, Vb + (ks * 16 + row + 8 * (mat & 1)) * kLd + jd * 16 +
                    8 * (mat >> 1));
        mma_bf16(oacc[2 * jd], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(oacc[2 * jd + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + b * T * qstride + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (qpos0 < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + qpos0 * qstride + col) =
          __floats2bfloat162_rn(oacc[j][0] * inv0, oacc[j][1] * inv0);
    if (qpos1 < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + qpos1 * qstride + col) =
          __floats2bfloat162_rn(oacc[j][2] * inv1, oacc[j][3] * inv1);
  }
}

// ----------------------------------------------------------------- f32 --
constexpr int kBqF = 16;  // queries per CTA (4 warps x 4 rows)
constexpr int kBkF = 32;  // keys per staged tile (one per lane)
constexpr int kRowsPerWarp = 4;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, long long T,
          int H, int Hk, long long window, float cap, float scale) {
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
cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o,
                     long long B, long long T, int H, int Hk,
                     long long window, float cap, float scale,
                     cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = bf16_smem<D>();
  auto kernel = flash_bf16<D>;
  if (smem > 48 * 1024 && !opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const long long tiles = (T + kBq - 1) / kBq;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      T, H, Hk, window, cap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o,
                    long long B, long long T, int H, int Hk,
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
      static_cast<const float*>(v), static_cast<float*>(o), T, H, Hk,
      window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. D in {16, 32, 64, 128, 256}; H % Hk == 0.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
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
        dtype == 1 ? run_bf16<DIM>(q, k, v, o, B, T, H, Hk, window,        \
                                   softcap, scale, s)                      \
                   : run_f32<DIM>(q, k, v, o, B, T, H, Hk, window,         \
                                  softcap, scale, s));
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
