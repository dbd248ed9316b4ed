// What the two ELL pull kernels (ell_spmv.cu, the full scan;
// ell_pull_frontier.cu, the listed rows) share: a lane's walk over one
// row's real slots in chunks, the reduce of a lane group's partials and
// the combine of a split row's pieces in piece order.
//
//   out[v] = combine_{j < len(v)} msg(x[idx[v, j]], w[v, j])
//
// len(v) is row_len[v] (the row's real slots: the graph's in-degree) or
// d_ell. An index outside [0, num_sources) is the identity wherever it
// sits in the row. A lane group of G lanes serves one row (or one piece
// of it): C column lanes (C = the power of two >= the payload width, at
// most 32) times G / C slot lanes; each slot's index is read once per
// tile of C columns, and row s of x is read as C contiguous values.
//
// Two layouts of the rows, a compile-time choice (ROWS) of each kernel:
// the dense ELL, row v at idx + v * d_ell; and the row layout, the
// graph's CSR, row v the slots [row_ptr[v], row_ptr[v+1]) of idx and w
// (row_ptr takes row_len's place). A CSR row is not 16-byte aligned: its
// walk starts at the aligned slot at or below its first (row_span), so
// that its chunks keep their 16-byte loads, and the slots before its
// first are loaded with the chunk but not combined. On the H100 that
// pulls 3-4 % faster than a walk from the row's first slot with one load
// a slot (PERF.md).
#pragma once

#include "common.cuh"

namespace rk {

// output type of a pull: M, except that an int32 sum widens to int64
template <typename M, int C> struct PullOut { using type = M; };
template <> struct PullOut<int32_t, SUM> { using type = int64_t; };

template <typename M, int C> using A_of = typename AccType<M, C>::type;

__device__ __forceinline__ long long row_length(const int32_t* row_len,
                                                long long v, long long d) {
  if (!row_len) return d;
  const long long l = row_len[v];
  return l < 0 ? 0 : (l > d ? d : l);
}

constexpr int kChunk = 4;   // slots a lane loads at once (16 B of indices)

// where one row's walk reads, relative to idx and w: `at` its base and
// the row's slots [from, from + len) from that base. The dense ELL: base
// v * d_ell, from 0. The row layout (ROWS, rp the row offsets): base the
// row's first slot, rounded down to a multiple of kChunk where `vec`
// (its 16-byte chunks then aligned), from the slots rounded off.
struct RowSpan {
  long long at;
  int from;
  long long len;
};

template <bool ROWS>
__device__ __forceinline__ RowSpan row_span(const int32_t* rp, long long v,
                                            long long d_ell, bool vec) {
  if constexpr (ROWS) {
    const long long s = rp[v], e = rp[v + 1];
    const long long at = vec ? s & ~static_cast<long long>(kChunk - 1) : s;
    return {at, static_cast<int>(s - at), e - s};
  } else {
    return {v * d_ell, 0, row_length(rp, v, d_ell)};
  }
}

// indices and weights of slots [j, j + kChunk) of one row, -1 / 0 at and
// past `cap`; one 16-byte load each where `vec` says the row is aligned
template <int MSG>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ ri,
                                           const float* __restrict__ rw,
                                           long long j, long long cap,
                                           bool vec, int32_t (&s)[kChunk],
                                           float (&wv)[kChunk]) {
  if (vec && j + kChunk <= cap) {
    const int4 v = *reinterpret_cast<const int4*>(ri + j);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    if (MSG != COPY) {
      const float4 f = *reinterpret_cast<const float4*>(rw + j);
      wv[0] = f.x; wv[1] = f.y; wv[2] = f.z; wv[3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      s[k] = j + k < cap ? ri[j + k] : -1;
      if (MSG != COPY) wv[k] = j + k < cap ? rw[j + k] : 0.f;
    }
  }
  if (MSG == COPY) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) wv[k] = 0.f;
  }
}

// combine of one row's slots [lo, hi) for column c by one lane, which
// takes the chunks of kChunk slots at lo + kChunk * (first + k * step),
// k = 0, 1, ... The first chunk is loaded before the row length is
// known (any slot below `cap`, d_ell, may be read), and each chunk's
// payload loads are issued together. With ROWS nothing at or past hi is
// loaded, and the walk's first `skip` slots (skip < kChunk: the slots
// below the row's first in its aligned chunk) are loaded but not
// combined.
template <typename T, typename M, typename A, int C, int MSG,
          bool ROWS = false>
__device__ __forceinline__ A walk_chunks(const T* __restrict__ x,
                                         const int32_t* __restrict__ ri,
                                         const float* __restrict__ rw,
                                         long long lo, long long hi,
                                         long long first, long long step,
                                         long long cap, bool vec,
                                         long long c, long long B,
                                         long long num_sources,
                                         int skip = 0) {
  A acc = identity<A, C>();
  long long j = lo + kChunk * first;
  int32_t s[kChunk];
  float wv[kChunk];
  load_chunk<MSG>(ri, rw, j, ROWS ? hi : cap, vec, s, wv);
  if constexpr (ROWS) {
    if (first == 0) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < skip) s[k] = -1;
    }
  }
  while (j < hi) {
    const long long jn = j + kChunk * step;
    int32_t sn[kChunk] = {-1, -1, -1, -1};
    float wn[kChunk] = {0.f, 0.f, 0.f, 0.f};
    if (jn < hi) load_chunk<MSG>(ri, rw, jn, ROWS ? hi : cap, vec, sn, wn);
    T xv[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool ok = j + k < hi && s[k] >= 0 && s[k] < num_sources;
      s[k] = ok ? s[k] : -1;
      xv[k] = ok ? x[static_cast<long long>(s[k]) * B + c] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (s[k] >= 0)
        acc = combine<A, C>(acc, to_acc<A, M>(message<T, M, MSG>(xv[k],
                                                                 wv[k])));
    j = jn;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      s[k] = sn[k];
      wv[k] = wn[k];
    }
  }
  return acc;
}

// the combine of a lane group's partials for its column: the slot lanes
// of a group of G lanes (C column lanes apart) fold into slot lane 0.
// Every lane of the warp must call it (the shuffles name the full warp).
template <typename A, int C>
__device__ __forceinline__ A group_reduce(A acc, int G, int col_lanes) {
  for (int off = G / 2; off >= col_lanes; off >>= 1)
    acc = combine<A, C>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

// A row's `count` pieces stored their partials at partial[(first + q) *
// B + c], q < count: combined in piece order for columns c0, c0 + step,
// ... < B (past L1: other CTAs wrote them), and each column's result
// handed to put(c, r)
template <typename A, int C, typename Put>
__device__ __forceinline__ void combine_pieces_into(const A* partial,
                                                    long long first,
                                                    long long count,
                                                    long long B, long long c0,
                                                    long long step, Put put) {
  for (long long c = c0; c < B; c += step) {
    A r = identity<A, C>();
    for (long long q = first; q < first + count; ++q)
      r = combine<A, C>(
          r, *reinterpret_cast<const volatile A*>(partial + q * B + c));
    put(c, r);
  }
}

// the same, stored to out_row[c]
template <typename A, int C, typename O>
__device__ __forceinline__ void combine_pieces(const A* partial,
                                               long long first,
                                               long long count, long long B,
                                               long long c0, long long step,
                                               O* out_row) {
  combine_pieces_into<A, C>(partial, first, count, B, c0, step,
                            [out_row](long long c, A r) {
                              out_row[c] = from_acc<O, A>(r);
                            });
}

// ---- host: the grid of a launch over `units` pieces of work, per_pass
// of them a pass of one CTA (one per lane group). block / 128 passes per
// CTA (the tuner's block_n or block_r), fewer where the units would then
// fill fewer than four CTAs per SM; returns units per CTA.
inline long long units_per_block(long long block, long long units,
                                 long long per_pass) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  long long passes = block / 128 > 1 ? block / 128 : 1;
  const long long min_blocks = 4LL * sms;
  const long long want = (units + min_blocks - 1) / min_blocks;
  const long long fit = (want + per_pass - 1) / per_pass;   // passes
  if (fit < passes) passes = fit > 1 ? fit : 1;
  return passes * per_pass;
}

}  // namespace rk
