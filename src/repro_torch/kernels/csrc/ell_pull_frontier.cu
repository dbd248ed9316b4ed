// Frontier ELL pull: the full-scan gather restricted to a compacted list
// of touched rows,
//   out[r] = combine_j msg(x[idx[rows[r], j]], w[rows[r], j]),
// with the identity for sentinel rows (rows[r] outside [0, row_limit)).
//
// Replaces: src/repro/kernels/ell_pull_frontier.py,
// ell_pull_frontier_pallas (the Pallas TPU kernel that tiles the row-id
// list and gathers row ids -> ELL rows -> payloads inside each tile).
//
// What bounds it on the H100: device-memory bytes of the touched rows
// only, R x d_ell x 8 B of layout plus the payload gathers. The rows are
// scattered over the layout, so each row costs at least one 32-byte
// sector of indices and one of weights even when it is short.
//
// Design: the warp-per-row body of the full scan (ell_rows.cuh), with
// the row id read once per warp from the compacted list; a CTA walks
// block_r consecutive entries of the list. The backend sends a step here
// only while R x d_ell undercuts the m-edge full scan, so the kernel
// never reads more than half the full scan's slots.
#include "ell_rows.cuh"

extern "C" int repro_ell_pull_frontier(const void* x, int dtype,
                                       const void* idx, const void* w,
                                       const void* rows, void* out,
                                       long long R, long long d_ell,
                                       long long num_sources,
                                       long long row_limit, long long B,
                                       long long block_r, int combine,
                                       int msg, void* stream) {
  rk::EllArgs a{x, static_cast<const int32_t*>(idx),
                static_cast<const float*>(w),
                static_cast<const int32_t*>(rows), out, R, d_ell,
                num_sources, row_limit, B, block_r,
                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::EllLauncher>(dtype, combine, msg,
                                                         a));
}
