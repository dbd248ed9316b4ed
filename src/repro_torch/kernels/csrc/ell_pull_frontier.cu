// Frontier ELL pull: the full-scan gather restricted to a compacted list
// of touched rows,
//   out[r] = combine_{j < len(v)} msg(x[idx[v, j]], w[v, j]),  v = rows[r]
// with len(v) = row_len[v] (the row's real slots: the graph's in-degree)
// or d_ell, and the identity for sentinel rows (rows[r] outside
// [0, row_limit)). The rows are the dense ELL's or, in an instance of
// its own (ROWS), the row layout's (the graph's CSR: row v at
// [row_ptr[v], row_ptr[v+1]) of idx and w, ell_rows.cuh).
//
// Replaces: src/repro/kernels/ell_pull_frontier.py,
// ell_pull_frontier_pallas (the Pallas TPU kernel that tiles the row-id
// list and gathers row ids -> ELL rows -> payloads inside each tile).
//
// What bounds it on the H100: device-memory bytes of the listed rows'
// real slots only: 4 B of index (and 4 B of weight unless the message is
// a copy) per real in-edge of a listed row, the list, row_len of the
// listed rows, one payload row per edge and the output rows. A listed
// row costs at least one 32-byte sector of indices even when it is
// short, and each step of a lane is a dependent chain (list -> row
// length and indices -> payload), so small lists are latency-bound.
//
// Design: the work plan (frontier_plan in kernels/ell_pull_frontier.py)
// is fixed by what the host knows without reading the list: d_ell and
// the payload width. Each row gets a lane group of the full scan's
// classes (2, 4 or 8 slot lanes for d_ell <= 8, 16, 32, else a warp,
// times C column lanes), so on a road graph (d_ell = 8) sixteen rows
// share a warp. A row is cut into `pieces` units of at most `piece`
// slots (the full scan's medium row), and the grid covers R x pieces
// units, all first pieces first: a unit past its row's length exits at
// once, so a short list of hub rows spreads over the card instead of one
// CTA. A row longer than one piece stores one partial per piece, and
// the last of its units to finish (a counter per list entry, reset by
// that unit) combines them in piece order. Lanes walk the slots with the
// full scan's chunked loads (ell_rows.cuh). Float sums accumulate in
// f64, integer sums in 64-bit, every combine in an order fixed by the
// plan: the result is deterministic and equal to the plain version. A
// device-side classification of the listed rows by length would fit
// each row's group to its own length, at the price of a pass over the
// list before the gather; the plan by d_ell needs none, and a short row
// in a long-row group only leaves lanes idle. The kernel is held to 64
// registers (four CTAs per SM): at the full scan's 40 it spilled, and
// timed slower on the H100 (PERF.md).
#include "ell_rows.cuh"

namespace rk {

constexpr int kFrontierThreads = 256;

struct FrontierArgs {
  const void* x;           // [num_sources + 1 (, B)], sentinel row last
  const int32_t* idx;      // [n, d_ell], or the row layout's [m]
  const float* w;          // [n, d_ell], or [m]
  const int32_t* row_len;  // [n], or null: every row has d_ell slots
  const int32_t* row_ptr;  // [n + 1]: the row layout (idx, w [m]), or null
  const int32_t* rows;     // [R] row ids
  void* out;               // [R (, B)]
  long long R, d_ell, num_sources, row_limit, B, block_r;
  int group, col_lanes;    // lanes per unit, column lanes among them
  long long piece, pieces; // slots per unit, units per row
  int32_t* counters;       // [R] arrivals, zero between launches
  void* partial;           // [R * pieces, B] accumulators of split rows
  cudaStream_t stream;
};

// row_len: the row lengths, or with ROWS the row offsets
template <typename T, typename M, typename O, int C, int MSG, bool ROWS>
__global__ void __launch_bounds__(kFrontierThreads, 4)
ell_frontier_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    const float* __restrict__ w,
                    const int32_t* __restrict__ row_len,
                    const int32_t* __restrict__ rows, O* __restrict__ out,
                    long long R, long long d_ell, long long num_sources,
                    long long row_limit, long long B, bool vec, int G,
                    int col_lanes, long long piece, long long pieces,
                    long long upb, int32_t* __restrict__ counters,
                    A_of<M, C>* partial) {
  using A = A_of<M, C>;
  const int t = threadIdx.x, lane = t % 32;
  const int cl = t % col_lanes;
  const int sl = (t % G) / col_lanes;         // slot lane in the group
  const int S = G / col_lanes;                // slot lanes per unit
  const int groups = kFrontierThreads / G;
  const long long units = R * pieces;
  const long long u_lo = static_cast<long long>(blockIdx.x) * upb;
  const long long u_hi = u_lo + upb < units ? u_lo + upb : units;
  // the trip counts are uniform across the CTA, so every lane meets the
  // shuffles
  for (long long base = u_lo; base < u_hi; base += groups) {
    const long long u = base + t / G;
    const bool in = u < u_hi;
    const long long p = in ? u / R : 0;       // unit u: piece p of entry r
    const long long r = in ? u % R : 0;
    const long long v = in ? rows[r] : -1;
    const bool live = v >= 0 && v < row_limit;
    RowSpan rs{0, 0, 0};
    if constexpr (ROWS)
      if (live) rs = row_span<true>(row_len, v, d_ell, vec);
    const long long len = ROWS ? rs.len
                               : live ? row_length(row_len, v, d_ell) : 0;
    const long long count = len > piece ? (len + piece - 1) / piece : 1;
    // the first piece of a sentinel or empty row writes the identity
    const bool work = in && p < count;
    const long long lo = p * piece;
    const long long hi = lo + piece < len ? lo + piece : len;
    const long long at = ROWS ? rs.at : (live ? v : 0) * d_ell;
    const int32_t* ri = idx + at;
    const float* rw = w + at;
    for (long long c0 = 0; c0 < B; c0 += col_lanes) {
      const long long c = c0 + cl;
      A acc = work && live && c < B
                  ? walk_chunks<T, M, A, C, MSG, ROWS>(
                        x, ri, rw, lo, rs.from + hi, sl, S, d_ell, vec, c,
                        B, num_sources, rs.from)
                  : identity<A, C>();
      acc = group_reduce<A, C>(acc, G, col_lanes);
      if (work && sl == 0 && c < B) {
        if (count == 1) out[r * B + c] = from_acc<O, A>(acc);
        else partial[(r * pieces + p) * B + c] = acc;
      }
    }
    if (pieces == 1) continue;
    // a split row (only rows longer than 32 slots split, and they get a
    // whole warp, so this is uniform across the warp): the last of its
    // units to finish combines the pieces in order
    __threadfence();
    __syncwarp();
    int last = 0;
    if (work && count > 1 && lane == 0)
      last = atomicAdd(counters + r, 1) == count - 1;
    if (__shfl_sync(0xffffffffu, last, 0)) {
      __threadfence();
      combine_pieces<A, C>(partial, r * pieces, count, B, lane, 32,
                           out + r * B);
      if (lane == 0) counters[r] = 0;   // ready for the next launch
    }
  }
}

struct FrontierLauncher {
  using Args = FrontierArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    using O = typename PullOut<M, C>::type;
    // the plan's invariants: C column lanes divide a group of at most a
    // warp, and a row cut into pieces gets a whole warp
    if (a.group < 1 || a.group > 32 || 32 % a.group != 0 ||
        a.col_lanes < 1 || a.group % a.col_lanes != 0 || a.piece < kChunk ||
        a.piece % kChunk != 0 || a.pieces < 1 ||
        (a.pieces > 1 && (a.group != 32 || !a.counters || !a.partial)))
      return cudaErrorInvalidValue;
    const long long units = a.R * a.pieces;
    const long long upb = units_per_block(a.block_r, units,
                                          kFrontierThreads / a.group);
    const long long blocks = (units + upb - 1) / upb;
    if (blocks == 0) return cudaSuccess;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    // 16-byte chunk loads need every row (and so every chunk) aligned;
    // the row layout aligns each row's walk itself (ell_rows.cuh)
    const bool vec = (a.row_ptr || a.d_ell % kChunk == 0) &&
                     reinterpret_cast<uintptr_t>(a.idx) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
    auto kernel = a.row_ptr ? ell_frontier_kernel<T, M, O, C, MSG, true>
                            : ell_frontier_kernel<T, M, O, C, MSG, false>;
    kernel<<<static_cast<unsigned>(blocks), kFrontierThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.idx, a.w,
        a.row_ptr ? a.row_ptr : a.row_len, a.rows, static_cast<O*>(a.out),
        a.R, a.d_ell, a.num_sources, a.row_limit, a.B, vec, a.group,
        a.col_lanes, a.piece, a.pieces, upb, a.counters,
        static_cast<A_of<M, C>*>(a.partial));
    return cudaGetLastError();
  }
};

}  // namespace rk

extern "C" int repro_ell_pull_frontier(
    const void* x, int dtype, const void* idx, const void* w,
    const void* row_len, const void* rows, void* out, long long R,
    long long d_ell, long long num_sources, long long row_limit,
    long long B, long long block_r, int combine, int msg, int group,
    int col_lanes, long long piece, long long pieces, void* counters,
    void* partial, const void* row_ptr, void* stream) {
  rk::FrontierArgs a{x, static_cast<const int32_t*>(idx),
                     static_cast<const float*>(w),
                     static_cast<const int32_t*>(row_len),
                     static_cast<const int32_t*>(row_ptr),
                     static_cast<const int32_t*>(rows), out, R, d_ell,
                     num_sources, row_limit, B, block_r, group, col_lanes,
                     piece, pieces, static_cast<int32_t*>(counters), partial,
                     static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::FrontierLauncher>(dtype, combine,
                                                              msg, a));
}
