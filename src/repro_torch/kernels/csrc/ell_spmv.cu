// Full-scan ELL pull: out[v] = combine_{j < len(v)} msg(x[idx[v, j]], w[v, j])
// for every row v of the [n, d_ell] ELL-in layout, where len(v) is
// row_len[v] (the row's real slots; the graph's in-degree) or d_ell; or
// of the row layout (the graph's CSR: row v at [row_ptr[v], row_ptr[v+1])
// of idx and w, ell_rows.cuh), an instance of its own (ROWS).
//
// Replaces: src/repro/kernels/ell_spmv.py, ell_spmv_pallas (the Pallas
// TPU kernel whose grid tiles [block_n, d_ell] VMEM blocks).
//
// What bounds it on the H100: device-memory bytes over the real slots
// only: 4 B of index (and 4 B of weight unless the message is a copy)
// per real edge, row_len, one payload row per edge (random, mostly L2
// hits) and the output. On Kronecker scale 16 that is ~8 MB (~2.4 us at
// 3.35 TB/s) against the 5.15 GB the padded layout holds; on the road
// stand-in ~56 MB.
//
// Design: a row plan (ell_row_plan in kernels/ell_spmv.py, built once
// per graph) sorts the rows by length into classes, and one launch runs
// one section of CTAs per class, the longest rows first:
//   * short rows (len <= 8, <= 16, <= 32): groups of 2, 4 or 8 lanes
//     per row, several rows per warp;
//   * medium rows: one warp per row;
//   * hub rows: one CTA per piece of at most `piece` slots. A hub of
//     one piece is written by its CTA; the pieces of a longer hub store
//     partials, and the last of its CTAs to arrive (a counter per hub,
//     reset by that CTA) combines them in piece order.
// A lane loads its row's slots in chunks of 4 (16 bytes of indices in
// one load where the layout is aligned), the first chunk together with
// the row length and the next chunk while the current one's payload
// loads are in flight. A group never reads past len(v) but to finish
// its first chunk, so the padding costs (almost) nothing. For
// [n+1, B] payloads the group's lanes are C column lanes (C = the power
// of two >= B, at most 32) times slot lanes: each slot's index is read
// once per tile of C columns, and row s of x is read as C contiguous
// values. The plan is built for one C: its class bounds and piece size
// keep the serial steps of a lane about the same whatever C is. Float
// sums accumulate in f64, integer sums in 64-bit, and every combine runs
// in an order fixed by the plan, so the result is deterministic. The
// kernel is latency-bound (a pass is rows -> row length and indices ->
// payload), so it is held to 40 registers for six CTAs per SM, which
// timed faster on the H100 than 48 registers at five (PERF.md).
//
// Epilogues: what a finished (row, column) does with its combined value.
// StoreRows writes it to out, as above. PprStep (float32 payload, copy
// message, sum, at most 64 columns; entry point repro_ell_spmv_ppr) is
// one personalized-PageRank power step fused into the pull: for row v,
// column c and the row's float32 message m,
//   rank_out[v, c] = resid[c] >= tol ? base[v, c] + damp * m : rank[v, c]
// (each operation rounded on its own, as PyTorch's separate passes round
// them), and |rank_out - rank| folded into the column's running maximum.
// A thread holds the maxima of its two columns (t % C and that + C, for
// C column lanes) in registers; each CTA reduces them in shared memory
// and adds them into slot (CTA % nslots) of an [nslots, B] array with an
// unsigned atomicMax on the float bits (the values are >= 0, and a NaN
// wins, as in torch.amax); the wrapper takes the maximum over the slots.
// Slots and not one [B] row: at width 64 every row longer than 32 slots
// is a CTA of its own, a million of them a step on a degree-32 graph,
// and the slots spread their atomics over 1,024 addresses a column.
// Each row's base and rank are prefetched into L2 when the row starts.
// The fused step never writes the [n, B] message array, and reads the
// payload unpadded (num_sources = n).
#include "ell_rows.cuh"

namespace rk {

constexpr int kPullThreads = 256;
constexpr int kPullClasses = 4;      // 2, 4, 8 lanes and a warp per row

struct PullSections {
  long long row_off[kPullClasses + 1];   // class k: rows[off[k]:off[k+1]]
  long long block_off[kPullClasses];     // class k's first block; hub
                                         // pieces come first, then the
                                         // classes from the widest down
  long long rpb[kPullClasses];           // rows per CTA of class k
  int group[kPullClasses];               // lanes per row of class k
};

struct PullArgs {
  const void* x;
  const int32_t* idx;
  const float* w;
  const int32_t* row_len;    // [n], or null: every row has d_ell slots
  const int32_t* row_ptr;    // [n + 1]: the row layout (idx, w [m]), or null
  const int32_t* rows;       // [n] row ids sorted by class
  void* out;
  long long n, d_ell, num_sources, B, block_n;
  long long class_off[kPullClasses + 1];  // class k: rows[off[k]:off[k+1]];
                                          // hubs from off[kPullClasses]
  long long pieces, piece;   // hub CTAs, slots per piece
  const int32_t* piece_hub;  // [pieces] hub index (into the hub rows)
  const int32_t* hub_first;  // [hubs + 1] first piece of each hub
  int32_t* counters;         // [hubs] arrivals, zero between launches
  void* partial;             // [pieces, B] accumulators of split hubs
  cudaStream_t stream;
};

// the plain store of a finished (row v, column c)
struct StoreRows {
  template <typename O>
  __device__ __forceinline__ void put(O* out, long long v, long long B,
                                      long long c, bool, O r) {
    out[v * B + c] = r;
  }
  __device__ __forceinline__ void prefetch(long long, long long, int, int) {}
  template <bool ROWS>
  __device__ __forceinline__ void finish(long long, long long, int, int) {}
};

// one PPR power step on a finished (row v, column c): see the note above
struct PprStep {
  static constexpr int kMaxCols = 64;
  const float* base;
  const float* rank;
  const float* resid;
  float* rank_out;
  unsigned int* slots;       // [nslots, B] float bits of the largest change
  long long nslots;
  float damp, tol;
  unsigned int lo = 0, hi = 0;   // this thread's maxima: columns t % C, + C

  // base and rank of row v's columns cl, cl + C, ... into L2 while the
  // row's gathers run: the put would otherwise wait a DRAM round trip
  // for them at the end of each row (13.6 against 12.4 ms a step on
  // scale-21 Urand at width 64 on the H100, PERF.md)
  __device__ __forceinline__ void prefetch(long long v, long long B, int cl,
                                           int col_lanes) {
    for (long long c = cl; c < B; c += col_lanes) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(rank + v * B + c));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(base + v * B + c));
    }
  }

  __device__ __forceinline__ void put(float*, long long v, long long B,
                                      long long c, bool second, float m) {
    const long long i = v * B + c;
    const float old = rank[i];
    const float r = __ldg(resid + c) >= tol
                        ? __fadd_rn(base[i], __fmul_rn(damp, m))
                        : old;
    rank_out[i] = r;
    const unsigned int d = __float_as_uint(fabsf(__fsub_rn(r, old)));
    if (second) hi = d > hi ? d : hi;
    else lo = d > lo ? d : lo;
  }

  // the CTA's maxima into its slot; every thread of the CTA calls it (a
  // template, so each kernel instance has its own shared array)
  template <bool ROWS>
  __device__ __forceinline__ void finish(long long blk, long long B, int t,
                                         int col_lanes) {
    __shared__ unsigned int red[kMaxCols];
    if (t < kMaxCols) red[t] = 0u;
    __syncthreads();
    const int cl = t % col_lanes;
    if (lo) atomicMax(red + cl, lo);
    if (hi) atomicMax(red + cl + col_lanes, hi);
    __syncthreads();
    if (t < B && red[t]) atomicMax(slots + (blk % nslots) * B + t, red[t]);
  }
};

// row_len: the row lengths, or with ROWS the row offsets
template <typename T, typename M, typename O, int C, int MSG, typename E,
          bool ROWS>
__global__ void __launch_bounds__(kPullThreads, 6)
ell_spmv_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                const float* __restrict__ w,
                const int32_t* __restrict__ row_len,
                const int32_t* __restrict__ rows, O* __restrict__ out,
                long long d_ell, long long num_sources, long long B,
                bool vec, int col_lanes, PullSections sec, long long hubs_at,
                long long pieces, long long piece,
                const int32_t* __restrict__ piece_hub,
                const int32_t* __restrict__ hub_first,
                int32_t* __restrict__ counters, A_of<M, C>* partial, E ep) {
  using A = A_of<M, C>;
  const long long blk = blockIdx.x;
  const int t = threadIdx.x;
  const int cl = t % col_lanes;
  if (blk >= pieces) {
    // ---- a class of short or medium rows: G lanes per row. The
    // unrolled select keeps the section table in parameter space.
    int G = 0;
    long long r_lo = 0, r_end = 0, rpb = 1;
#pragma unroll
    for (int q = 0; q < kPullClasses; ++q) {
      const long long b_end = q == 0 ? ~0ull >> 1 : sec.block_off[q - 1];
      if (blk >= sec.block_off[q] && blk < b_end) {
        G = sec.group[q];
        rpb = sec.rpb[q];
        r_lo = sec.row_off[q] + (blk - sec.block_off[q]) * rpb;
        r_end = sec.row_off[q + 1];
      }
    }
    const int S = G / col_lanes;                 // slot lanes per row
    const int gl = t % G;
    const int sl = gl / col_lanes;
    const int groups = kPullThreads / G;
    const long long r_hi = r_lo + rpb < r_end ? r_lo + rpb : r_end;
    // the trip counts are uniform across the warp, so every lane meets
    // the shuffles
    for (long long base = r_lo; base < r_hi; base += groups) {
      const long long i = base + t / G;
      const bool live = i < r_hi;
      const long long v = live ? rows[i] : 0;
      long long len;           // with ROWS: the walk's end, skip + length
      int skip = 0;
      const int32_t* ri;
      const float* rw;
      if constexpr (ROWS) {
        const RowSpan rs = live ? row_span<true>(row_len, v, d_ell, vec)
                                : RowSpan{0, 0, 0};
        len = rs.from + rs.len;
        skip = rs.from;
        ri = idx + rs.at;
        rw = w + rs.at;
      } else {
        len = live ? row_length(row_len, v, d_ell) : 0;
        ri = idx + v * d_ell;
        rw = w + v * d_ell;
      }
      if (live && sl == 0) ep.prefetch(v, B, cl, col_lanes);
      for (long long c0 = 0; c0 < B; c0 += col_lanes) {
        const long long c = c0 + cl;
        A acc = c < B ? walk_chunks<T, M, A, C, MSG, ROWS>(
                            x, ri, rw, 0, len, sl, S, d_ell, vec, c, B,
                            num_sources, skip)
                      : identity<A, C>();
        acc = group_reduce<A, C>(acc, G, col_lanes);
        if (live && sl == 0 && c < B)
          ep.put(out, v, B, c, c0 != 0, from_acc<O, A>(acc));
      }
    }
    ep.template finish<ROWS>(blk, B, t, col_lanes);
    return;
  }
  // ---- one piece of a hub row: the whole CTA, (256 / C) slot lanes
  __shared__ A red[kPullThreads / 32][32];
  __shared__ bool last;
  const long long p = blk;
  const long long h = piece_hub[p];
  const long long v = rows[hubs_at + h];
  const long long first = hub_first[h], count = hub_first[h + 1] - first;
  long long len;
  int off = 0;
  const int32_t* ri;
  const float* rw;
  if constexpr (ROWS) {
    const RowSpan rs = row_span<true>(row_len, v, d_ell, vec);
    len = rs.len;
    off = rs.from;
    ri = idx + rs.at;
    rw = w + rs.at;
  } else {
    len = row_length(row_len, v, d_ell);
    ri = idx + v * d_ell;
    rw = w + v * d_ell;
  }
  const long long lo = (p - first) * piece;
  const long long hi = lo + piece < len ? lo + piece : len;
  const int S = kPullThreads / col_lanes;
  const int sl = t / col_lanes;
  const int warp = t / 32, lane = t % 32;
  if (count == 1 && t < col_lanes) ep.prefetch(v, B, cl, col_lanes);
  for (long long c0 = 0; c0 < B; c0 += col_lanes) {
    const long long c = c0 + cl;
    A acc = c < B ? walk_chunks<T, M, A, C, MSG, ROWS>(
                        x, ri, rw, lo, off + hi, sl, S, d_ell, vec, c, B,
                        num_sources, off)
                  : identity<A, C>();
    acc = group_reduce<A, C>(acc, 32, col_lanes);
    if (lane < col_lanes) red[warp][lane] = acc;
    __syncthreads();
    if (t < col_lanes && c < B) {
      A r = red[0][t];
      for (int q = 1; q < kPullThreads / 32; ++q)
        r = combine<A, C>(r, red[q][t]);
      if (count == 1) ep.put(out, v, B, c, c0 != 0, from_acc<O, A>(r));
      else partial[p * B + c] = r;
    }
    __syncthreads();
  }
  if (count == 1) {
    ep.template finish<ROWS>(blk, B, t, col_lanes);
    return;
  }
  // the last piece of this hub to arrive combines the partials in order
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counters + h, 1) == count - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine_pieces_into<A, C>(partial, first, count, B, t, kPullThreads,
                            [&](long long c, A r) {
                              ep.put(out, v, B, c, c >= col_lanes,
                                     from_acc<O, A>(r));
                            });
  if (t == 0) counters[h] = 0;     // ready for the next launch
  ep.template finish<ROWS>(blk, B, t, col_lanes);
}

struct PullLauncher {
  using Args = PullArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    return launch<T, C, MSG>(a, StoreRows{});
  }

  template <typename T, int C, int MSG, typename E>
  static cudaError_t launch(const Args& a, E ep) {
    using M = typename MsgType<T, MSG>::type;
    using O = typename PullOut<M, C>::type;
    int col_lanes = 1;
    while (col_lanes < a.B && col_lanes < 32) col_lanes *= 2;
    static const int kLanes[kPullClasses] = {2, 4, 8, 32};
    // block_n / 128 passes per CTA (a pass gives every group one row):
    // block_n rows per CTA in the 2-lane class at width 1
    PullSections sec;
    long long next = a.pieces;
    for (int k = 0; k < kPullClasses + 1; ++k) sec.row_off[k] = a.class_off[k];
    for (int k = kPullClasses - 1; k >= 0; --k) {
      const int g = kLanes[k] * col_lanes;
      sec.group[k] = g < 32 ? g : 32;
      const long long rows_k = a.class_off[k + 1] - a.class_off[k];
      sec.rpb[k] = units_per_block(a.block_n, rows_k,
                                   kPullThreads / sec.group[k]);
      sec.block_off[k] = next;
      next += (rows_k + sec.rpb[k] - 1) / sec.rpb[k];
    }
    const long long blocks = next;
    // 16-byte chunk loads need every row (and so every chunk) aligned;
    // the row layout aligns each row's walk itself (ell_rows.cuh)
    const bool vec = (a.row_ptr || a.d_ell % kChunk == 0) &&
                     reinterpret_cast<uintptr_t>(a.idx) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
    if (blocks == 0) return cudaSuccess;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    auto kernel = a.row_ptr ? ell_spmv_kernel<T, M, O, C, MSG, E, true>
                            : ell_spmv_kernel<T, M, O, C, MSG, E, false>;
    kernel<<<static_cast<unsigned>(blocks), kPullThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.idx, a.w,
        a.row_ptr ? a.row_ptr : a.row_len, a.rows, static_cast<O*>(a.out),
        a.d_ell, a.num_sources, a.B, vec, col_lanes, sec,
        a.class_off[kPullClasses], a.pieces, a.piece, a.piece_hub,
        a.hub_first, a.counters, static_cast<A_of<M, C>*>(a.partial), ep);
    return cudaGetLastError();
  }
};

}  // namespace rk

extern "C" int repro_ell_spmv(
    const void* x, int dtype, const void* idx, const void* w, void* out,
    long long n, long long d_ell, long long num_sources, long long B,
    long long block_n, int combine, int msg, const void* row_len,
    const void* rows, long long o1, long long o2, long long o3,
    long long hubs_at, long long pieces, long long piece,
    const void* piece_hub,
    const void* hub_first, void* counters, void* partial,
    const void* row_ptr, void* stream) {
  rk::PullArgs a{x, static_cast<const int32_t*>(idx),
                 static_cast<const float*>(w),
                 static_cast<const int32_t*>(row_len),
                 static_cast<const int32_t*>(row_ptr),
                 static_cast<const int32_t*>(rows), out, n, d_ell,
                 num_sources, B, block_n, {0, o1, o2, o3, hubs_at}, pieces,
                 piece,
                 static_cast<const int32_t*>(piece_hub),
                 static_cast<const int32_t*>(hub_first),
                 static_cast<int32_t*>(counters), partial,
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::PullLauncher>(dtype, combine, msg,
                                                          a));
}

// one PPR power step: the full-scan pull of x [n, B] (float32, copy, sum;
// B <= 64) with the PprStep epilogue (see the note at the top); row_ptr
// as in repro_ell_spmv
extern "C" int repro_ell_spmv_ppr(
    const void* x, const void* idx, const void* w, long long n,
    long long d_ell, long long B, long long block_n, const void* row_len,
    const void* rows, long long o1, long long o2, long long o3,
    long long hubs_at, long long pieces, long long piece,
    const void* piece_hub, const void* hub_first, void* counters,
    void* partial, const void* base, const void* rank, const void* resid,
    void* rank_out, void* slots, long long nslots, float damp, float tol,
    const void* row_ptr, void* stream) {
  if (B < 1 || B > rk::PprStep::kMaxCols || nslots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rk::PullArgs a{x, static_cast<const int32_t*>(idx),
                 static_cast<const float*>(w),
                 static_cast<const int32_t*>(row_len),
                 static_cast<const int32_t*>(row_ptr),
                 static_cast<const int32_t*>(rows), nullptr, n, d_ell, n, B,
                 block_n, {0, o1, o2, o3, hubs_at}, pieces, piece,
                 static_cast<const int32_t*>(piece_hub),
                 static_cast<const int32_t*>(hub_first),
                 static_cast<int32_t*>(counters), partial,
                 static_cast<cudaStream_t>(stream)};
  rk::PprStep ep{static_cast<const float*>(base),
                 static_cast<const float*>(rank),
                 static_cast<const float*>(resid),
                 static_cast<float*>(rank_out),
                 static_cast<unsigned int*>(slots), nslots, damp, tol};
  return static_cast<int>(
      rk::PullLauncher::launch<float, rk::SUM, rk::COPY>(a, ep));
}
