// Full-scan ELL pull: out[v] = combine_j msg(x[idx[v, j]], w[v, j]) for
// every row v of the [n, d_ell] ELL-in layout.
//
// Replaces: src/repro/kernels/ell_spmv.py, ell_spmv_pallas (the Pallas
// TPU kernel whose grid tiles [block_n, d_ell] VMEM blocks).
//
// What bounds it on the H100: device-memory bytes. Every call streams
// the whole ELL view, 8 bytes per slot (int32 index + f32 weight), plus
// one random payload read per real edge. On the road stand-in (n=1.96M,
// d_ell=8) that is ~125 MB (~40 us at 3.35 TB/s); on Kronecker scale 16
// (d_ell ~9.8k, ~350 slots per real edge) it is ~5.15 GB (~1.5 ms), of
// which almost all is sentinel padding.
//
// Design: one warp per row (a CTA walks block_n consecutive rows), lanes
// striding over the row so each step
// reads 32 consecutive slots (128 B of indices, 128 B of weights,
// coalesced); register accumulators and a shuffle reduce, so nothing is
// staged in shared memory and every row is written once. The kernel
// reads the padded layout as it is; skipping the padding needs another
// layout (a later redesign), not a better loop.
#include "ell_rows.cuh"

extern "C" int repro_ell_spmv(const void* x, int dtype, const void* idx,
                              const void* w, void* out, long long n,
                              long long d_ell, long long num_sources,
                              long long B, long long block_n, int combine,
                              int msg, void* stream) {
  rk::EllArgs a{x, static_cast<const int32_t*>(idx),
                static_cast<const float*>(w), nullptr, out, n, d_ell,
                num_sources, n, B, block_n, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::EllLauncher>(dtype, combine, msg,
                                                         a));
}
