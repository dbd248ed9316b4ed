// Binned push: every destination combines msg(x[src], w) over its
// in-edges whose source is active. Destinations are grouped in bins of
// bin_n consecutive ids; the plan holds bin b's (dst-sorted) edges in row
// b of [nb, cap] arrays and a within-bin CSR pointer ptr[nb, bin_n + 1].
//
// Replaces: src/repro/kernels/coo_push.py, coo_push_pallas with
// strategy="scan" (the Pallas TPU kernel that runs destination bins in
// parallel, streams edge blocks, and reduces each bin into a private
// accumulator block).
//
// What bounds it on the H100: device-memory bytes, 8 B per real edge of
// the plan (int32 source + int32 destination; +4 B of weight unless the
// message is a copy) plus the active flag and payload row of each
// edge's source, read at random (mostly L2 hits), and the output. The
// frontier does not shrink the scan: an inactive source is still read
// to be skipped, which is why the backend charges a push m reads.
//
// Design: edge-parallel. Each bin's real edges ptr[b, 0]:ptr[b, bin_n]
// are cut into units of E edges (push_units in kernels/coo_push.py),
// one CTA each, so the grid follows the edge count and not the bins,
// and a hub's run is shared by as many CTAs as its length needs. Each
// warp of a CTA (a piece) walks a contiguous slice of its unit, 32 edges
// a step: each lane loads one edge's source, destination and weight
// (coalesced) and its source's active flag. The warp's lanes are S edge
// lanes times C column lanes (C = the power of two >= B, at most 32;
// S = 32 / C), so a step is C sub-steps of S edges; the payload loads of
// up to 8 sub-steps are issued before they combine. Runs are contiguous
// because the plan is dst-sorted: a segmented scan over the edge lanes
// (shuffles keyed by destination) combines each run inside a sub-step,
// and the run still open at its end is carried to the next. A run that
// starts and ends inside the piece is written at once. A run cut by a
// piece boundary leaves a tail (its owner's partial) and heads (the
// partials of the pieces it continues into) in shared memory, and the
// CTA walks each cut run from its owner, combining the heads in piece
// order. A run cut by a unit boundary leaves the same records in global
// memory, and the last CTA of the bin to arrive (a counter per bin,
// reset by that CTA) walks them in unit order. No atomics touch the
// results, so the output is deterministic: float sums accumulate in f64
// and round once, integer sums in 64 bits. Destinations with no in-edge
// are listed in the plan and set to the identity by a last section of
// CTAs. The unit CTAs are as many as fit on the card at once, each
// looping over units (the next unit's descriptor loads while this one
// runs), and are held to 64 registers for four CTAs per SM.
#include "common.cuh"

namespace rk {

constexpr int kPushThreads = 256;
constexpr int kPushPieces = kPushThreads / 32;   // a piece is a warp
constexpr int kPushBatch = 8;          // sub-steps loaded before they combine
constexpr int kHeadOpen = 1;           // the first run began before
constexpr int kMid = 2;                // ... and runs past the end
constexpr int kTailOpen = 4;           // the last run runs past the end

struct PushArgs {
  const void* x;            // [n (, B)]
  const uint8_t* active;    // [n] bool
  const int32_t* src;       // [nb, cap]
  const int32_t* dst;       // [nb, cap]
  const float* w;           // [nb, cap]
  void* out;                // [n (, B)]
  long long n, cap, B;
  long long units, unit_edges;
  const int4* unit;          // [units] (bin, first edge, bin's edges,
                             // the bin's units)
  int32_t* counters;         // [nb] arrivals, zero between launches
  const int32_t* empty;      // [n_empty] destinations with no in-edge
  long long n_empty;
  int32_t* rec_flags;        // [units] flags of a unit cut by a run
  int32_t* rec_key;          // [units] the destination of its tail
  void* rec_head;            // [units, B] partial of its head run
  void* rec_tail;            // [units, B] partial of its tail run
  cudaStream_t stream;
};

template <typename A>
__device__ __forceinline__ A load_volatile(const A* p) {
  return *reinterpret_cast<const volatile A*>(p);   // past L1
}

template <typename T, typename M, int C, int MSG, bool WIDE>
__global__ void __launch_bounds__(kPushThreads, 4)
coo_push_kernel(const T* __restrict__ x, const uint8_t* __restrict__ active,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst, const float* __restrict__ w,
                M* __restrict__ out, long long n, long long cap, long long B,
                int col_lanes, long long units, long long unit_ctas,
                long long unit_edges, const int4* __restrict__ unit,
                int32_t* __restrict__ counters,
                const int32_t* __restrict__ empty, long long n_empty,
                int32_t* rec_flags, int32_t* rec_key,
                typename AccType<M, C>::type* rec_head,
                typename AccType<M, C>::type* rec_tail) {
  using A = typename AccType<M, C>::type;
  const int t = threadIdx.x;
  const long long blk = blockIdx.x;
  if (blk >= unit_ctas) {
    // ---- the identity for destinations with no in-edge
    const long long per = static_cast<long long>(kPushThreads) * 4;
    const long long lo = (blk - unit_ctas) * per;
    const long long total = n_empty * B;
    for (long long i = lo + t; i < lo + per && i < total; i += kPushThreads)
      out[static_cast<long long>(empty[i / B]) * B + i % B] =
          from_acc<M, A>(identity<A, C>());
    return;
  }
  __shared__ A s_head[kPushThreads];    // [piece (warp)][column lane]
  __shared__ A s_tail[kPushThreads];
  __shared__ int s_flags[kPushPieces];
  __shared__ int s_key[kPushPieces];
  __shared__ int s_scope;
  __shared__ bool s_last;

  // each CTA takes units blk, blk + unit_ctas, ... (as many CTAs as fit
  // on the card at once, so a unit's set-up overlaps other CTAs' work
  // and no CTA waits to be scheduled)
  int4 next = unit[blk];
  for (long long u = blk; u < units; u += unit_ctas) {
    const int4 info = next;
    if (u + unit_ctas < units) next = unit[u + unit_ctas];   // prefetch
    const long long b = info.x, lo = info.y, eb = info.z, nu = info.w;
    const long long ub0 = u - lo / unit_edges;     // the bin's first unit
    const bool split = nu > 1;
    const long long hi = lo + unit_edges < eb ? lo + unit_edges : eb;
    // a piece (warp) walks whole steps of 32 edges
    long long per = (hi - lo + kPushPieces - 1) / kPushPieces;
    per = (per + 31) / 32 * 32;
    const int live_pieces = static_cast<int>((hi - lo + per - 1) / per);
    const int p = t / 32, lane = t % 32;
    const int cl = lane % col_lanes;       // column lane
    const int sl = lane / col_lanes;       // edge lane
    const int S = 32 / col_lanes;          // edges per sub-step
    const long long plo = lo + p * per;
    const long long phi = plo + per < hi ? plo + per : hi;
    const int32_t* bs = src + b * cap;
    const int32_t* bd = dst + b * cap;
    const float* bw = w + b * cap;

    for (long long c0 = 0; c0 < B; c0 += col_lanes) {
      const long long c = c0 + cl;
      const bool col = c < B;
      if (t == 0) s_scope = 0;
      // ---- each piece (a warp) walks its slice, 32 edges a step; the next
      // step's edges load while the current one combines
      if (plo < phi) {
        const int hk = bd[plo];
        const bool h_open = plo > 0 && bd[plo - 1] == hk;
        const int k_after = phi < eb ? bd[phi] : -1;   // key past the slice
        int ck = hk;                       // the open run and its partial
        A cv = identity<A, C>();
        // a run that ended: the piece's head, or a result
        auto flush = [&](int k, A v, int slot) {
          if (h_open && k == hk) s_head[slot] = v;
          else if (col) out[static_cast<long long>(k) * B + c] =
              from_acc<M, A>(v);
        };
        // one edge per lane, coalesced; lanes past the slice get key -1
        // (fixed up per step) and no message
        auto meta = [&](long long t0, int& kl, int32_t& ul, float& wl) {
          const long long e = t0 + lane;
          const bool in = e < phi;
          kl = in ? bd[e] : -1;
          ul = in ? bs[e] : -1;
          wl = (MSG == COPY || !in) ? 0.f : bw[e];
        };
        int k0l, k1l, k2l;
        int32_t u0l, u1l, u2l;
        float w0l, w1l, w2l;
        meta(plo, k0l, u0l, w0l);
        meta(plo + 32, k1l, u1l, w1l);
        T x0l = T(0), x1l = T(0);
        bool a0l = false, a1l = false;
        if (!WIDE) {                       // one column: payloads prefetched
          x0l = u0l >= 0 && u0l < n ? x[u0l] : T(0);
          a0l = u0l >= 0 && u0l < n && active[u0l];
        }
        for (long long t0 = plo; t0 < phi; t0 += 32) {
          meta(t0 + 64, k2l, u2l, w2l);
          if (WIDE) {
            a0l = u0l >= 0 && u0l < n && active[u0l];
          } else {
            x1l = u1l >= 0 && u1l < n ? x[u1l] : T(0);
            a1l = u1l >= 0 && u1l < n && active[u1l];
          }
          const int nvalid = phi - t0 < 32 ? static_cast<int>(phi - t0) : 32;
          const int klast = __shfl_sync(0xffffffffu, k0l, nvalid - 1);
          const int kl = t0 + lane < phi ? k0l : klast;
          if (!WIDE) {
            // ---- one column: a segmented scan over the warp's 32 edges
            const int k = kl;
            A v = a0l ? to_acc<A, M>(message<T, M, MSG>(x0l, w0l))
                      : identity<A, C>();
            const int kf = __shfl_sync(0xffffffffu, k, 0);
            if (kf != ck) {                // the open run ended at the step
              if (lane == 0) flush(ck, cv, t);
              ck = kf;
              cv = identity<A, C>();
            }
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const A ov = __shfl_up_sync(0xffffffffu, v, d);
              const int ok = __shfl_up_sync(0xffffffffu, k, d);
              if (lane >= d && ok == k) v = combine<A, C>(ov, v);
            }
            if (k == ck) v = combine<A, C>(cv, v);
            const int kn = __shfl_down_sync(0xffffffffu, k, 1);
            if (lane < 31 && kn != k) flush(k, v, t - lane);
            ck = __shfl_sync(0xffffffffu, k, 31);
            cv = __shfl_sync(0xffffffffu, v, 31);
          } else {
            // ---- C column lanes: sub-steps of S edges; the payload loads
            // of up to kPushBatch sub-steps are issued before they combine
            // the source of an active edge, else -1: one shuffle for both
            const int32_t up = a0l ? u0l : -1;
            for (int q0 = 0; q0 < col_lanes; q0 += kPushBatch) {
              T xv[kPushBatch];
              int kq[kPushBatch];
              float wq[kPushBatch];
              bool aq[kPushBatch];
#pragma unroll
              for (int i = 0; i < kPushBatch; ++i) {
                kq[i] = ck;
                aq[i] = false;
                if (q0 + i < col_lanes) {      // uniform
                  const int from = (q0 + i) * S + sl;
                  const int32_t u = __shfl_sync(0xffffffffu, up, from);
                  kq[i] = __shfl_sync(0xffffffffu, kl, from);
                  wq[i] = MSG == COPY ? 0.f
                                      : __shfl_sync(0xffffffffu, w0l, from);
                  aq[i] = u >= 0 && col;
                  xv[i] = aq[i] ? x[static_cast<long long>(u) * B + c] : T(0);
                }
              }
#pragma unroll
              for (int i = 0; i < kPushBatch; ++i) {
                if (q0 + i >= col_lanes) break;          // uniform
                const int k = kq[i];
                A v = aq[i] ? to_acc<A, M>(message<T, M, MSG>(xv[i], wq[i]))
                            : identity<A, C>();
                if (S == 1) {            // one edge a sub-step: no scan
                  if (k != ck) {
                    flush(ck, cv, t);
                    ck = k;
                    cv = identity<A, C>();
                  }
                  cv = combine<A, C>(cv, v);
                  continue;
                }
                const int kf = __shfl_sync(0xffffffffu, k, cl);
                if (kf != ck) {            // the open run ended
                  if (sl == 0) flush(ck, cv, t);
                  ck = kf;
                  cv = identity<A, C>();
                }
                for (int d = 1; d < S; d <<= 1) {
                  const A ov = __shfl_up_sync(0xffffffffu, v, d * col_lanes);
                  const int ok = __shfl_up_sync(0xffffffffu, k, d * col_lanes);
                  if (sl >= d && ok == k) v = combine<A, C>(ov, v);
                }
                if (k == ck) v = combine<A, C>(cv, v);
                const int kn = __shfl_down_sync(0xffffffffu, k, col_lanes);
                if (sl < S - 1 && kn != k) flush(k, v, t - lane + cl);
                ck = __shfl_sync(0xffffffffu, k, (S - 1) * col_lanes + cl);
                cv = __shfl_sync(0xffffffffu, v, (S - 1) * col_lanes + cl);
              }
            }
          }
          k0l = k1l; u0l = u1l; w0l = w1l; x0l = x1l; a0l = a1l;
          k1l = k2l; u1l = u2l; w1l = w2l;
        }
        const bool t_open = k_after == ck;
        int flags = h_open ? kHeadOpen : 0;
        if (sl == 0) {
          if (!t_open) {
            if (h_open && ck == hk) s_head[t] = cv;
            else if (col) out[static_cast<long long>(ck) * B + c] =
                from_acc<M, A>(cv);
          } else if (h_open && ck == hk) {
            s_head[t] = cv;                // one run across the whole slice
          } else {
            s_tail[t] = cv;
          }
        }
        if (t_open)
          flags |= (h_open && ck == hk) ? kMid | kTailOpen : kTailOpen;
        if (lane == 0) {
          s_flags[p] = flags;
          s_key[p] = ck;
        }
      }
      __syncthreads();
      // ---- runs cut by piece boundaries, walked from their owners
      if (sl == 0 && p < live_pieces &&
          (s_flags[p] & (kTailOpen | kMid)) == kTailOpen) {
        A v = s_tail[t];
        int q = p + 1;
        for (; q < live_pieces; ++q) {
          v = combine<A, C>(v, s_head[q * 32 + cl]);
          if (!(s_flags[q] & kMid)) break;
        }
        if (q < live_pieces) {
          if (col) out[static_cast<long long>(s_key[p]) * B + c] =
              from_acc<M, A>(v);
        } else {                           // runs into the next unit
          if (col) rec_tail[u * B + c] = v;
          if (cl == 0) {
            atomicOr(&s_scope, kTailOpen);
            rec_key[u] = s_key[p];
          }
        }
      }
      // ---- the unit's own head: the run an earlier unit owns
      if (t < col_lanes && (s_flags[0] & kHeadOpen)) {
        A v = s_head[cl];
        int q = 0;
        while ((s_flags[q] & kMid) && q + 1 < live_pieces) {
          ++q;
          v = combine<A, C>(v, s_head[q * 32 + cl]);
        }
        if (col) rec_head[u * B + c] = v;
        if (cl == 0)
          atomicOr(&s_scope,
                   kHeadOpen | ((s_flags[q] & kMid) ? kMid | kTailOpen : 0));
      }
      __syncthreads();
      if (t == 0 && split) rec_flags[u] = s_scope;
      __syncthreads();                     // s_head/s_tail are reused
    }
    if (split) {
      // ---- the last unit of the bin to arrive walks the runs cut by units
      __threadfence();
      __syncthreads();
      if (t == 0) s_last = atomicAdd(counters + b, 1) == nu - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        for (long long i = t; i < nu * B; i += kPushThreads) {
          const long long uq = ub0 + i / B, c = i % B;
          if ((load_volatile(rec_flags + uq) & (kTailOpen | kMid)) !=
              kTailOpen)
            continue;
          A v = load_volatile(rec_tail + uq * B + c);
          for (long long q = uq + 1; q < ub0 + nu; ++q) {
            v = combine<A, C>(v, load_volatile(rec_head + q * B + c));
            if (!(load_volatile(rec_flags + q) & kMid)) break;
          }
          out[static_cast<long long>(load_volatile(rec_key + uq)) * B + c] =
              from_acc<M, A>(v);
        }
        if (t == 0) counters[b] = 0;     // ready for the next launch
      }
      __syncthreads();                   // s_last is reused
    }
  }
}

struct PushLauncher {
  using Args = PushArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    using A = typename AccType<M, C>::type;
    int col_lanes = 1;
    while (col_lanes < a.B && col_lanes < 32) col_lanes *= 2;
    auto kernel = a.B > 1 ? coo_push_kernel<T, M, C, MSG, true>
                          : coo_push_kernel<T, M, C, MSG, false>;
    // as many unit CTAs as fit on the card at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kPushThreads, 0);
    if (err != cudaSuccess) return err;
    const long long fit = static_cast<long long>(sms > 0 ? sms : 1) *
                          (per_sm > 0 ? per_sm : 1);
    const long long unit_ctas = a.units < fit ? a.units : fit;
    const long long per = static_cast<long long>(kPushThreads) * 4;
    const long long blocks = unit_ctas + (a.n_empty * a.B + per - 1) / per;
    if (blocks == 0) return cudaSuccess;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned>(blocks), kPushThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.active, a.src, a.dst, a.w,
        static_cast<M*>(a.out), a.n, a.cap, a.B, col_lanes, a.units,
        unit_ctas, a.unit_edges, a.unit, a.counters, a.empty, a.n_empty,
        a.rec_flags, a.rec_key, static_cast<A*>(a.rec_head),
        static_cast<A*>(a.rec_tail));
    return cudaGetLastError();
  }
};

}  // namespace rk

extern "C" int repro_coo_push(
    const void* x, int dtype, const void* active, const void* src,
    const void* dst, const void* w, void* out, long long n, long long cap,
    long long B, int combine, int msg, long long units,
    long long unit_edges, const void* unit, void* counters,
    const void* empty, long long n_empty, void* rec_flags, void* rec_key,
    void* rec_head, void* rec_tail, void* stream) {
  rk::PushArgs a{x,
                 static_cast<const uint8_t*>(active),
                 static_cast<const int32_t*>(src),
                 static_cast<const int32_t*>(dst),
                 static_cast<const float*>(w),
                 out, n, cap, B, units, unit_edges,
                 static_cast<const int4*>(unit),
                 static_cast<int32_t*>(counters),
                 static_cast<const int32_t*>(empty), n_empty,
                 static_cast<int32_t*>(rec_flags),
                 static_cast<int32_t*>(rec_key), rec_head, rec_tail,
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::PushLauncher>(dtype, combine, msg,
                                                          a));
}
