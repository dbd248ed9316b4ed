// One xDeepFM CIN layer (Compressed Interaction Network, xDeepFM eq. 6):
//
//   out[b, h, d] = sum_{i < Hp, j < F} w[h, i, j] * xk[b, i, d] * x0[b, j, d]
//
// xk: [B, Hp, D], x0: [B, F, D], w: [H, Hp, F], out: [B, H, D], all
// contiguous, f32 or bf16 (out in the inputs' type); sums in f32.
//
// Replaces: src/repro/kernels/cin.py, cin_layer_pallas (the Pallas TPU
// kernel that fuses the outer product z[b, i, j, d] with the [H, Hp*F]
// compression matmul in VMEM).
//
// What bounds it on the H100: operations. At Hp = 200, F = 39, H = 200,
// D = 10 a batch of 512 rows is 2 * B * H * Hp * F * D = 1.6e10 FLOP,
// 0.24 ms at the 67 TFLOP/s f32 rate of the CUDA cores, against ~5 us
// for its bytes; z itself would be 82 GB at B = 262,144 and never exists.
//
// Design: the layer is a GEMM out[h, c] = W[h, (i, j)] Z[(i, j), c] over
// the columns c = b * D + d of the whole batch (so a CTA's columns may
// span several batch rows, and B * D need not divide the tile), with Z
// never formed: it is factored as
//     out[h, c] = sum_i xk[c, i] * (sum_j w[h, i, j] * x0[c, j]).
// One CTA of 128 threads owns 64 rows h and 128 columns c. It stages
// x0[c, :] for its columns once ([F][128] floats), then for each i the
// slice w[h0:h0+64, i, :] and xk[c, i], the next i's slice loading (by
// cp.async) while this one is used. The wrapper lays w out as wt
// [Hp][F][Hpad] in f32 (h innermost, zero-padded to a multiple of 64),
// so that a slice is F contiguous runs of 256 bytes. Each thread forms
// an 8 x 8 tile of the inner sum over j (F multiply-adds per output, 64
// per four 16-byte shared loads) and adds it, times xk, into its 8 x 8
// accumulators. W (6.2 MB at full width) is read through L2, once per
// CTA. All arithmetic is f32 on CUDA cores: a
// TF32 product would keep ~3 digits, not the 2e-4 the tests hold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTileH = 64;    // rows h per CTA
constexpr int kTileC = 128;   // columns c = b * D + d per CTA

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(addr), "l"(src));
}

// slice i of wt ([Hp][F][Hpad] f32), rows h0 .. h0 + 63: F x 64 floats,
// contiguous along h, into s[F][64]
__device__ __forceinline__ void stage_w(float* s, const float* wt, int i,
                                        int F, int Hpad, int h0) {
  const float* src = wt + static_cast<long long>(i) * F * Hpad + h0;
  for (int e = threadIdx.x; e < F * (kTileH / 4); e += kThreads) {
    const int j = e / (kTileH / 4), q = (e % (kTileH / 4)) * 4;
    cp_async16(s + j * kTileH + q, src + static_cast<long long>(j) * Hpad + q);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T>
__device__ __forceinline__ float xk_at(const T* xk, long long c0, int i,
                                       long long cols, int Hp, int D) {
  const long long c = c0 + threadIdx.x;  // one column per thread
  if (c >= cols) return 0.f;
  const long long b = c / D, d = c % D;
  return to_f32(xk[(b * Hp + i) * D + d]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cin_layer(const T* __restrict__ xk, const T* __restrict__ x0,
          const float* __restrict__ wt, T* __restrict__ out, long long B,
          int Hp, int F, int H, int Hpad, int D) {
  extern __shared__ __align__(16) float smem[];
  float* X0s = smem;                     // [F][kTileC]
  float* Ws = X0s + F * kTileC;          // [2][F][kTileH]
  float* Xks = Ws + 2 * F * kTileH;      // [2][kTileC]

  const long long cols = B * D;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTileC;
  const int h0 = blockIdx.y * kTileH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty < 8

  stage_w(Ws, wt, 0, F, Hpad, h0);
  for (int e = threadIdx.x; e < F * kTileC; e += kThreads) {
    const int j = e / kTileC, cl = e % kTileC;
    const long long c = c0 + cl;
    float val = 0.f;
    if (c < cols) {
      const long long b = c / D, d = c % D;
      val = to_f32(x0[(b * F + j) * D + d]);
    }
    X0s[j * kTileC + cl] = val;
  }
  float xnext = xk_at(xk, c0, 0, cols, Hp, D);

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;

  for (int i = 0; i < Hp; ++i) {
    const int buf = i & 1;
    Xks[buf * kTileC + threadIdx.x] = xnext;
    if (i + 1 < Hp) {  // the next slice loads while this one is used
      stage_w(Ws + (buf ^ 1) * F * kTileH, wt, i + 1, F, Hpad, h0);
      xnext = xk_at(xk, c0, i + 1, cols, Hp, D);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* W = Ws + buf * F * kTileH;
    const float* Xk = Xks + buf * kTileC;

    float inner[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) inner[a][e] = 0.f;
    for (int j = 0; j < F; ++j) {
      const float4 wa = *reinterpret_cast<const float4*>(
          W + j * kTileH + ty * 8);
      const float4 wb = *reinterpret_cast<const float4*>(
          W + j * kTileH + ty * 8 + 4);
      const float4 xa = *reinterpret_cast<const float4*>(
          X0s + j * kTileC + tx * 4);
      const float4 xb = *reinterpret_cast<const float4*>(
          X0s + j * kTileC + 64 + tx * 4);
      const float wr[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          inner[a][e] = fmaf(wr[a], xr[e], inner[a][e]);
    }
    const float4 ka = *reinterpret_cast<const float4*>(Xk + tx * 4);
    const float4 kb = *reinterpret_cast<const float4*>(Xk + 64 + tx * 4);
    const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[a][e] = fmaf(kr[e], inner[a][e], acc[a][e]);
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int h = h0 + ty * 8 + a;
    if (h >= H) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long c = c0 + (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
      if (c >= cols) continue;
      const long long b = c / D, d = c % D;
      out[(b * H + h) * D + d] = from_f32<T>(acc[a][e]);
    }
  }
}

// Each instance opts in to the dynamic shared memory it needs (the
// attribute belongs to the instantiated function), raising its limit
// only when a larger F asks for more.
template <typename T>
cudaError_t run(const void* xk, const void* x0, const void* wt, void* out,
                long long B, int Hp, int F, int H, int Hpad, int D,
                cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  const size_t smem =
      static_cast<size_t>(F * kTileC + 2 * F * kTileH + 2 * kTileC) *
      sizeof(float);
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        cin_layer<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const long long blocks = (B * D + kTileC - 1) / kTileC;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(Hpad / kTileH));
  cin_layer<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xk), static_cast<const T*>(x0),
      static_cast<const float*>(wt), static_cast<T*>(out), B, Hp, F, H,
      Hpad, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of xk, x0 and out): 0 = f32, 1 = bf16. wt is w laid out as
// [Hp][F][Hpad] f32, Hpad a multiple of 64 >= H, zero past H.
extern "C" int repro_cin_layer(const void* xk, const void* x0,
                               const void* wt, void* out, int dtype,
                               long long B, int Hp, int F, int H, int Hpad,
                               int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hp <= 0 || F <= 0 || H <= 0 || D <= 0 || Hpad < H ||
      Hpad % kTileH != 0 || (B * D + kTileC - 1) / kTileC > 0x7fffffffLL ||
      Hpad / kTileH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(
        run<float>(xk, x0, wt, out, B, Hp, F, H, Hpad, D, s));
  if (dtype == 1)
    return static_cast<int>(
        run<__nv_bfloat16>(xk, x0, wt, out, B, Hp, F, H, Hpad, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
