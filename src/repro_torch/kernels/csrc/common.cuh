// Shared pieces of the graph kernels: type codes, combine identities,
// message shapes, warp reduction and the dtype x combine x msg dispatch.
//
// Every kernel takes its payload dtype as a template parameter T (f32,
// f64, i32, i64); the edge weight is always f32. The message type M is
// T for "copy" and the promotion of T with f32 otherwise (f32 for the
// integer types, as in JAX and PyTorch). Sums accumulate wider than M:
// floats in f64 (rounded once at the end), integers in 64-bit unsigned
// arithmetic, which wraps like the two's-complement sums of the plain
// versions. min/max accumulate in M.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace rk {

enum Combine { SUM = 0, MIN = 1, MAX = 2 };
enum Msg { COPY = 0, MUL = 1, ADD = 2 };
enum Dtype { F32 = 0, F64 = 1, I32 = 2, I64 = 3 };

template <typename T> struct Bounds;
template <> struct Bounds<float> {
  __device__ static float lo() { return -INFINITY; }
  __device__ static float hi() { return INFINITY; }
};
template <> struct Bounds<double> {
  __device__ static double lo() { return -INFINITY; }
  __device__ static double hi() { return INFINITY; }
};
template <> struct Bounds<int32_t> {
  __device__ static int32_t lo() { return INT32_MIN; }
  __device__ static int32_t hi() { return INT32_MAX; }
};
template <> struct Bounds<int64_t> {
  __device__ static int64_t lo() { return INT64_MIN; }
  __device__ static int64_t hi() { return INT64_MAX; }
};

// message type: T for copy, promote(T, f32) for mul/add
template <typename T> struct WithF32 { using type = float; };
template <> struct WithF32<double> { using type = double; };
template <typename T, int MSG> struct MsgType {
  using type = typename WithF32<T>::type;
};
template <typename T> struct MsgType<T, COPY> { using type = T; };

// accumulator type
template <typename M, int C> struct AccType { using type = M; };
template <> struct AccType<float, SUM> { using type = double; };
template <> struct AccType<double, SUM> { using type = double; };
template <> struct AccType<int32_t, SUM> { using type = unsigned long long; };
template <> struct AccType<int64_t, SUM> { using type = unsigned long long; };

template <typename A, int C> __device__ __forceinline__ A identity() {
  if constexpr (C == SUM) return A(0);
  else if constexpr (C == MIN) return Bounds<A>::hi();
  else return Bounds<A>::lo();
}

template <typename A, int C>
__device__ __forceinline__ A combine(A a, A b) {
  if constexpr (C == SUM) return a + b;
  else if constexpr (C == MIN) return b < a ? b : a;
  else return b > a ? b : a;
}

template <typename T, typename M, int MSG>
__device__ __forceinline__ M message(T x, float w) {
  if constexpr (MSG == COPY) return static_cast<M>(x);
  else if constexpr (MSG == MUL) return static_cast<M>(x) * static_cast<M>(w);
  else return static_cast<M>(x) + static_cast<M>(w);
}

// M -> accumulator (integers sign-extend into the 64-bit unsigned sum)
template <typename A, typename M> __device__ __forceinline__ A to_acc(M v) {
  if constexpr (std::is_same<A, unsigned long long>::value)
    return static_cast<unsigned long long>(static_cast<long long>(v));
  else return static_cast<A>(v);
}

// accumulator -> output type (one rounding for float sums; integer sums
// truncate modulo 2^bits)
template <typename O, typename A> __device__ __forceinline__ O from_acc(A v) {
  if constexpr (std::is_same<A, unsigned long long>::value)
    return static_cast<O>(static_cast<long long>(v));
  else return static_cast<O>(v);
}

template <typename A, int C> __device__ __forceinline__ A warp_reduce(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine<A, C>(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// runtime (dtype, combine, msg) -> L::run<T, C, MSG>(args)
template <typename L, typename T, int C>
cudaError_t by_msg(int msg, const typename L::Args& a) {
  switch (msg) {
    case COPY: return L::template run<T, C, COPY>(a);
    case MUL: return L::template run<T, C, MUL>(a);
    case ADD: return L::template run<T, C, ADD>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename L, typename T>
cudaError_t by_combine(int combine, int msg, const typename L::Args& a) {
  switch (combine) {
    case SUM: return by_msg<L, T, SUM>(msg, a);
    case MIN: return by_msg<L, T, MIN>(msg, a);
    case MAX: return by_msg<L, T, MAX>(msg, a);
  }
  return cudaErrorInvalidValue;
}

template <typename L>
cudaError_t dispatch(int dtype, int combine, int msg,
                     const typename L::Args& a) {
  switch (dtype) {
    case F32: return by_combine<L, float>(combine, msg, a);
    case F64: return by_combine<L, double>(combine, msg, a);
    case I32: return by_combine<L, int32_t>(combine, msg, a);
    case I64: return by_combine<L, int64_t>(combine, msg, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace rk

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
