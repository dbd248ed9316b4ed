// Binned push, one-hot strategy: every destination combines
// msg(x[src], w) over its in-edges whose source is active, over the same
// bin plan as coo_push.cu (row b of [nb, cap] holds bin b's dst-sorted
// edges; ptr[b, j] .. ptr[b, j + 1] are destination b * bin_n + j's).
//
// Replaces: src/repro/kernels/coo_push.py, coo_push_pallas with
// strategy="mxu" (the Pallas TPU kernel whose float sums are the one-hot
// matmul onehot[bin_n, block_e] @ msgs[block_e, B] on the MXU, and whose
// min, max and integer sums are a masked window reduce).
//
// What bounds it on the H100: the function's bytes are those of the scan
// (8 B per plan slot plus the gathered payload rows, ~0.002-0.09 ms per
// push on the graphs of this repo). The one-hot design's own floor is
// its multiply-adds: each edge meets only its own destination tile of 64
// rows, m x 64 x B x 4 products (the four parts) x 2 FLOP, which at
// B = 32 on Kronecker scale 16 is 2.9e10, about 0.06 ms at the 495
// TFLOP/s TF32 rate. In practice it is bound by the issue of its many
// small products (one m64nNk8 wgmma per 8 edges, whatever B), by the
// per-element convert and by the round trips of each staged chunk.
//
// Design. Destination tiles of 64 rows inside each bin own contiguous
// edge ranges ptr[b, r0] .. ptr[b, r0 + 64] (the edges are dst-sorted),
// and each tile's range is cut into units of at most E edges (mxu_units
// in kernels/coo_push.py; an empty tile gets one empty unit), so a hub's
// edges spread over CTAs. A tile cut across units is finished by the
// last of its CTAs to arrive (a counter per split tile, reset by that
// CTA), which combines the units' partials from global memory in unit
// order: no atomics on results, the output is deterministic.
//   * float32 sums: onehot[64, chunk] @ msgs[chunk, N] by wgmma
//     (m64nNk8 .tf32). One CTA (a warpgroup) covers all payload columns
//     (up to 32 a launch; wider payloads run in slices), so each edge's
//     metadata is read once, and walks a contiguous run of units as one
//     stream of staged chunks of 64 to 512 edges. The products sum
//     each message in four parts, exactly. A destination row's messages
//     in a chunk share a scale 2^e per column: the least power of two
//     above their largest finite magnitude (a first pass over the
//     staged chunk, combined per run of one row within a warp, then a
//     shared-memory atomic max). Each message is multiplied by 2^-e
//     (exact), and part j is the remainder of the parts before it
//     rounded to a multiple of 2^(-11 (j + 1)), so it has at most 11
//     significant bits (exact in TF32); a row's sum of one part over a
//     chunk, at most 512 x 2^11 of its quanta, is exact in the tensor
//     cores' f32 accumulation whatever the terms' signs. The four part
//     sums are added in f64 and multiplied back by 2^e. What is lost is
//     below 2^(e - 45) a message, e from the row's own terms: each
//     destination keeps its relative precision, however far apart the
//     column's magnitudes are across rows. (A split relative to each
//     message's own exponent is exact per message but not in the sum:
//     where large terms cancel within a chunk, the small ones lost
//     their low bits in the f32 partial sums, up to 5e-3 on a bin of
//     +-2^14 terms.) An infinite or NaN message goes whole into part 0
//     and takes no part in the scale. Part j goes to columns
//     [jP, (j + 1)P) of the B operand (P = the slice's columns rounded
//     up to 2, 8, 16 or 32; N = 4P), which is written transposed,
//     [column][edge], in 8 x 16-byte core matrices (padded, so that a
//     warp's 32 edges hit 32 banks), K-major
//     as TF32 requires. The one-hot A operand is built in registers from
//     the staged tile rows (no vote, no skipped tile: every product is
//     one the tile needs), two groups of 4 k-steps in flight, their
//     registers held until their products complete (wgmma reads them
//     asynchronously). The part sums of a chunk are added to f64
//     registers once per chunk and rounded once at the end. Staging
//     runs ahead: a chunk's metadata
//     loads two chunks early, its sources' active flags one early, and
//     its payload rows arrive by cp.async (a gather: TMA has none) into
//     the second of two buffers while the current chunk is converted
//     and multiplied.
//   * min, max, integer and float64 sums: the window reduce on CUDA
//     cores over the same units (one CTA each). Each chunk's messages are
//     staged and each (destination, column) of the tile combines only
//     its own run of the chunk, ptr[b, j] .. ptr[b, j + 1] cut to the
//     chunk, into a per-tile accumulator in shared memory. Integer sums
//     wrap like the plain version's cast (64-bit unsigned accumulation,
//     truncated), float64 sums add in f64.
#include "common.cuh"
#include "hopper.cuh"

namespace rk {

constexpr int kTileRows = 64;          // destinations of a tile (wgmma's M)
constexpr int kRelNone = kTileRows;    // the row of a slot that is no live
                                       // edge: it matches no row
// edges staged per chunk (sums): 512 for payloads of at most 4 columns
// (a road graph's tile of ~260 edges is then one chunk), else 256
template <int NW>
__host__ __device__ constexpr int max_chunk() { return NW == 8 ? 512 : 256; }
constexpr int kMaxWinChunk = 1024;     // edges staged per chunk (window)
constexpr int kSmemBudget = 64 * 1024; // a CTA's staging, bytes, so that
                                       // several CTAs share an SM
constexpr int kSmemMax = 200 * 1024;   // what wide payloads may take
constexpr int kWinThreads = 256;
constexpr uint32_t kOne = 0x3f800000u; // 1.0f, exact in TF32
constexpr int kCoreWords = 36;         // a core matrix (32 words) + 4 of
                                       // padding: the next one's banks
                                       // shift by 4

struct MxuArgs {
  const void* x;          // [n (, B)]
  const uint8_t* active;  // [n] bool
  const int32_t* src;     // [nb, cap]
  const int32_t* dst;     // [nb, cap]
  const float* w;         // [nb, cap]
  const int32_t* ptr;     // [nb, bin_n + 1]
  void* out;              // [n (, B)]
  long long n, bin_n, cap, B, units;
  const int4* table;      // [units, 2]: the Unit fields
  int32_t* counters;      // [records] arrivals, zero between launches
  void* rec;              // [records, 64, B] partials of split tiles
  cudaStream_t stream;
};

// a work unit: edges [lo, hi) of row b of the plan, the k-th of nu units
// of the tile of `rows` destinations from bin-relative row r0; a split
// tile's partials are records rec0 .. rec0 + nu - 1 (rec0 = -1 if nu = 1)
struct Unit {
  int b, r0, rows, lo, hi, k, nu, rec0;
};

__device__ __forceinline__ Unit load_unit(const int4* table, long long u) {
  const int4 p = table[2 * u], q = table[2 * u + 1];
  return {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
}

__device__ __forceinline__ double pow2(int k) {   // 2^k, |k| < 1023
  return __longlong_as_double(static_cast<long long>(1023 + k) << 52);
}

__device__ __forceinline__ float pow2f(int k) {   // 2^k, |k| < 127
  return __int_as_float((127 + k) << 23);
}

// the scale exponent e of a row's column: the least e with 2^e above
// the magnitude whose float32 bits are `bits` (-126 for a subnormal or
// zero magnitude), so e is in [-126, 128]
__device__ __forceinline__ int scale_exp(uint32_t bits) {
  const int biased = static_cast<int>(bits >> 23);
  return biased == 0 ? -126 : biased - 126;
}

// the four parts of a float32 m scaled below 1 in magnitude: part j
// the remainder of the parts before it rounded to a multiple of
// 2^(-11 (j + 1)), by adding and taking away 1.5 x 2^23 of those quanta
// (every step exact; part 0 reaches at most 2^11 quanta, 1)
__device__ __forceinline__ void split4(float m, float (&p)[4]) {
  const float mag[4] = {1.5f * 4096.f, 1.5f * 2.f, 1.5f / 1024.f,
                        1.5f / 2097152.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = __fsub_rn(__fadd_rn(m, mag[j]), mag[j]);
    m = __fsub_rn(m, p[j]);
  }
}

template <typename A>
__device__ __forceinline__ A load_volatile(const A* p) {
  return *reinterpret_cast<const volatile A*>(p);   // past L1
}

// A split tile: this CTA's partial is in its record; the last CTA of the
// tile to arrive combines the records in unit order and writes the rows
// (records and output rows are ld apart, columns [0, B) of them)
template <typename A, int C, typename O>
__device__ void finish_split(const Unit& un, long long v0, long long B,
                             long long ld, const A* rec, int32_t* counters,
                             O* out) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counters + un.rec0, 1) == un.nu - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long total = static_cast<long long>(un.rows) * B;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const long long r = i / B, c = i % B;
    A v = identity<A, C>();
    for (int q = 0; q < un.nu; ++q)
      v = combine<A, C>(v, load_volatile(
          rec + (static_cast<long long>(un.rec0 + q) * kTileRows + r) * ld +
          c));
    out[(v0 + r) * ld + c] = from_acc<O, A>(v);
  }
  if (threadIdx.x == 0) counters[un.rec0] = 0;   // ready for the next launch
}

// ---------------------------------------------------------- float sums --
// A CTA (one warpgroup) walks the units [u0, u0 + per) in order as one
// stream of chunks (an empty unit is one chunk of no edge), so the
// staging pipeline runs across unit boundaries; each unit's accumulator
// is written (or recorded) after its last chunk. The product's N
// columns hold each message's part j in columns [jP, (j + 1)P) (P =
// N / 4), so one wgmma a k-step makes the four products and their sums
// stay apart. Shared
// memory: bop [N / 8][chunk / 4] core matrices of 8 columns x 4 edges
// (the wgmma B operand, K-major), raw [2][chunk][bs] payload rows as
// gathered, rel and w [3][chunk] per staged edge (three slots: the chunk
// being multiplied, the next one being staged, and one the last warp
// may still read). The kernel takes columns [0, B) of payload rows ld
// apart (the launcher cuts payloads wider than 32 columns).
template <typename T, int MSG, int NW>
__global__ void __launch_bounds__(128)
mxu_sum_wgmma(const T* __restrict__ x, const uint8_t* __restrict__ active,
              const int32_t* __restrict__ src,
              const int32_t* __restrict__ dst, const float* __restrict__ w,
              float* __restrict__ out, long long n, long long bin_n,
              long long cap, int B, long long ld, int bs, int chunk,
              const int4* __restrict__ table, long long units,
              long long per, int32_t* counters, double* rec) {
  constexpr int kPerThread = max_chunk<NW>() / 128;   // edges a thread
                                                      // stages a chunk
  constexpr int P = NW / 4;                 // columns of each part
  extern __shared__ __align__(128) unsigned char smem[];
  // core matrices kCoreWords apart along K, groups of 8 columns
  // sbo_words apart
  const int sbo_words = chunk / 4 * kCoreWords;
  uint32_t* bop = reinterpret_cast<uint32_t*>(smem);
  T* raw = reinterpret_cast<T*>(bop + NW / 8 * sbo_words);
  int32_t* s_rel = reinterpret_cast<int32_t*>(raw + 2 * chunk * bs);
  float* s_w = reinterpret_cast<float*>(s_rel + 3 * chunk);

  const long long u_first = blockIdx.x * per;
  const long long u_end = u_first + per < units ? u_first + per : units;
  if (u_first >= u_end) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool vec = (ld * sizeof(T)) % 16 == 0 && (B * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // columns past B (of each part) stay zero in the B operand
  for (int i = tid; i < NW / 8 * sbo_words; i += 128) bop[i] = 0u;
  // each (tile row, column)'s largest finite |message| of the chunk, as
  // float32 bits (which order as unsigned integers), rows kMaxLd apart
  // (odd, so that a warp's distinct rows hit distinct banks); zero
  // between chunks (the fold of a chunk clears what its max pass set)
  constexpr int kMaxLd = P + 1;
  __shared__ uint32_t s_max[kTileRows * kMaxLd];
  for (int i = tid; i < kTileRows * kMaxLd; i += 128) s_max[i] = 0u;

  // a position in the stream: unit u (its fields), chunk c of it
  struct Cursor {
    long long u;
    int c;
    Unit un;
  };
  auto chunks_of = [&](const Unit& q) {
    return q.hi > q.lo ? (q.hi - q.lo + chunk - 1) / chunk : 1;
  };
  auto advance = [&](Cursor& q) {
    if (++q.c == chunks_of(q.un)) {
      q.c = 0;
      if (++q.u < u_end) q.un = load_unit(table, q.u);
    }
  };

  // the edges of chunk k + 1 (u1, d1, w1, the tile's first destination
  // v1 and the sources' active flags act1) and of chunk k + 2 (u2, d2,
  // w2, v2) in registers: each chunk's metadata loads two chunks ahead
  // and its flags one ahead, so that the gather is issued without
  // waiting on either
  int32_t u1[kPerThread], d1[kPerThread], u2[kPerThread], d2[kPerThread];
  float w1[kPerThread], w2[kPerThread];
  long long v1 = 0, v2 = 0;
  bool act1[kPerThread];
  auto load_meta = [&](const Cursor& q, int32_t (&u)[kPerThread],
                       int32_t (&d)[kPerThread], float (&wt)[kPerThread],
                       long long& vb) {
    const bool live = q.u < u_end;
    const long long lo = static_cast<long long>(q.un.lo) + q.c * chunk;
    const long long off = static_cast<long long>(q.un.b) * cap;
    vb = static_cast<long long>(q.un.b) * bin_n + q.un.r0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * 128;
      const bool in = live && e < chunk && lo + e < q.un.hi;
      u[i] = in ? src[off + lo + e] : -1;
      d[i] = in ? dst[off + lo + e] : -1;
      wt[i] = in && MSG != COPY ? w[off + lo + e] : 0.f;
    }
  };
  auto load_active = [&]() {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      act1[i] = u1[i] >= 0 && u1[i] < n && d1[i] >= 0 && d1[i] < n &&
                active[u1[i]];
  };
  // chunk k's tile rows and weights into slot k % 3, its payload rows
  // into raw[k % 2] by cp.async (only live edges: a real edge whose
  // source is active)
  auto stage = [&](long long k) {
    int32_t* rel = s_rel + (k % 3) * chunk;
    float* wv = s_w + (k % 3) * chunk;
    T* rw = raw + (k % 2) * chunk * bs;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * 128;
      if (e >= chunk) break;
      int r = kRelNone;
      if (act1[i]) {
        r = static_cast<int>(d1[i] - v1);
        const T* xu = x + static_cast<long long>(u1[i]) * ld;
        if (vec) {
          for (int j = 0; j < B; j += 16 / sizeof(T))
            hop::cp_async<16>(rw + e * bs + j, xu + j);
        } else {
          for (int j = 0; j < B; ++j)
            hop::cp_async<sizeof(T)>(rw + e * bs + j, xu + j);
        }
      }
      rel[e] = r;
      wv[e] = w1[i];
    }
    hop::cp_async_commit();
  };

  // per chunk the products accumulate in f32, the four parts apart,
  // each part's sum exact; then they are added to f64. A thread holds
  // kHi of part 0's columns, and the other parts of the same columns
  // P / 2, P and 3P / 2 registers further (at N = 8: the lanes one, two
  // and three up)
  constexpr int kHi = NW == 8 ? 4 : P / 2;
  double accd[kHi];
#pragma unroll
  for (int i = 0; i < kHi; ++i) accd[i] = 0.0;
  float acc[NW / 2];
  const int row0 = 16 * warp + g;
  // the one-hot A of k-steps k0 .. k0 + 3 (each 8 edges: rows row0 and
  // row0 + 8, edges t and t + 4) and their products; the A registers of a
  // group stay untouched until its products are done (wgmma reads them
  // asynchronously)
  auto onehot = [&](const int32_t* rel, int k0, uint32_t (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ra = rel[8 * (k0 + j) + t];
      const int rb = rel[8 * (k0 + j) + t + 4];
      a[j][0] = ra == row0 ? kOne : 0u;
      a[j][1] = ra == row0 + 8 ? kOne : 0u;
      a[j][2] = rb == row0 ? kOne : 0u;
      a[j][3] = rb == row0 + 8 ? kOne : 0u;
    }
  };
  auto products = [&](int k0, const uint32_t (&a)[4][4]) {
    hop::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hop::wgmma_tf32_rs(acc, a[j],
                         hop::make_desc(bop + (k0 + j) * 2 * kCoreWords,
                                        4 * kCoreWords, 4 * sbo_words,
                                        hop::kNoSwizzle),
                         k0 + j > 0);     // two core matrices a k-step
    hop::wgmma_commit();
  };

  Cursor cm{u_first, 0, load_unit(table, u_first)};   // metadata
  Cursor cc = cm;                                      // products
  load_meta(cm, u1, d1, w1, v1);
  advance(cm);
  load_active();
  stage(0);
  load_meta(cm, u1, d1, w1, v1);
  advance(cm);
  for (long long k = 0; cc.u < u_end; ++k) {
    const int len = min(chunk, cc.un.hi - cc.un.lo - cc.c * chunk);
    // whole groups of 4 k-steps of 8 edges, in pairs but at N = 8 (where
    // the products are cheapest and a tile is one chunk, so the padding
    // counts): zeros past len in the B operand, no row in the A
    constexpr int kPad = NW == 8 ? 32 : 64;
    const int len_pad = (len + kPad - 1) & ~(kPad - 1);
    load_active();                       // chunk k + 1's flags
    load_meta(cm, u2, d2, w2, v2);       // chunk k + 2
    advance(cm);
    hop::cp_async_wait<0>();
    __syncthreads();            // chunk k's rows and metadata are in
    const int32_t* rel_k = s_rel + (k % 3) * chunk;
    const float* w_k = s_w + (k % 3) * chunk;
    const T* raw_k = raw + (k % 2) * chunk * bs;
    // ---- scale: each (row, column)'s largest finite |message| into
    // s_max. A warp whose live edges all go to one row (a hub's) reduces
    // each column in one instruction; any other takes the maximum of
    // each run of one row (its live edges are contiguous, dst-sorted) by
    // a segmented shuffle. One lane of a run issues the atomic. Columns
    // four at a time, so that their chains overlap
    for (int e0 = 0; e0 < len; e0 += 128) {    // the same trips per warp
      const int e = e0 + tid;
      const int r = e < len ? rel_k[e] : kRelNone;
      const float we = r != kRelNone ? w_k[e] : 0.f;
      const T* xe = raw_k + e * bs;
      auto mag = [&](int c) -> uint32_t {    // |message| bits, 0 if none
        if (r == kRelNone) return 0u;
        const float m = message<T, float, MSG>(xe[c], we);
        return isfinite(m) ? __float_as_uint(fabsf(m)) : 0u;
      };
      const int top = __reduce_max_sync(0xffffffffu,
                                        r == kRelNone ? -1 : r);
      if (__all_sync(0xffffffffu, r == kRelNone || r == top)) {
        if (top < 0) continue;                 // no live edge
#pragma unroll 4
        for (int c = 0; c < P && c < B; ++c) {
          const uint32_t v = __reduce_max_sync(0xffffffffu, mag(c));
          if (lane == 0 && v != 0u) atomicMax(s_max + top * kMaxLd + c, v);
        }
        continue;
      }
      bool same[5];                            // lane + 2^s in r's run
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int ro = __shfl_down_sync(0xffffffffu, r, 1 << s);
        same[s] = lane + (1 << s) < 32 && ro == r;
      }
      const int r_prev = __shfl_up_sync(0xffffffffu, r, 1);
      const bool head = r != kRelNone && (lane == 0 || r_prev != r);
#pragma unroll 4
      for (int c = 0; c < P && c < B; ++c) {
        uint32_t v = mag(c);
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const uint32_t vo = __shfl_down_sync(0xffffffffu, v, 1 << s);
          if (same[s]) v = max(v, vo);
        }
        if (head && v != 0u) atomicMax(s_max + r * kMaxLd + c, v);
      }
    }
    __syncthreads();
    // ---- convert: message, scaled to its row's 2^e, four-part split,
    // transposed into the B operand; a thread takes one edge at a time
    // and writes its B columns (the core matrices' padded stride puts 32
    // edges in 32 banks)
    for (int e = tid; e < len_pad; e += 128) {
      const bool live = e < len && rel_k[e] != kRelNone;
      const int r = live ? rel_k[e] : 0;
      const float we = w_k[e];
      uint32_t* at = bop + (e / 4) * kCoreWords + e % 4;
      const T* xe = raw_k + e * bs;
      // a loop over the P columns a part has room for, two at a time
      // (unrolled further, the split's temporaries would take the
      // registers of every column at once); columns past B stay zero
#pragma unroll 2
      for (int c = 0; c < P && c < B; ++c) {
        const float m = live ? message<T, float, MSG>(xe[c], we) : 0.f;
        float part[4];
        if (isfinite(m)) {
          // times 2^-e in two exact steps (2^-e itself may not be a
          // normal float)
          const int ne = -scale_exp(s_max[r * kMaxLd + c]);
          split4(__fmul_rn(__fmul_rn(m, pow2f(ne / 2)), pow2f(ne - ne / 2)),
                 part);
        } else {
          part[0] = m;
          part[1] = part[2] = part[3] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cj = c + q * P;
          at[(cj / 8) * sbo_words + (cj % 8) * 4] = __float_as_uint(part[q]);
        }
      }
    }
    stage(k + 1);               // no edge when the stream has ended
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      u1[i] = u2[i];
      d1[i] = d2[i];
      w1[i] = w2[i];
    }
    v1 = v2;
    hop::fence_proxy_async();   // the B operand, to the tensor cores
    __syncthreads();
    // ---- products, two groups of A registers in flight (none for an
    // empty unit)
    if (len_pad > 0) {
      const int32_t* rel = s_rel + (k % 3) * chunk;
      uint32_t a0[4][4], a1[4][4];
      for (int k0 = 0; k0 < len_pad / 8; k0 += 8) {
        if (k0 > 0) {
          hop::wgmma_wait<1>();        // the group that read a0 is done
          hop::reg_fence(a0);
        }
        onehot(rel, k0, a0);
        products(k0, a0);
        if (kPad == 64 || k0 + 4 < len_pad / 8) {
          if (k0 > 0) {
            hop::wgmma_wait<1>();      // ... and the one that read a1
            hop::reg_fence(a1);
          }
          onehot(rel, k0 + 4, a1);
          products(k0 + 4, a1);
        }
      }
      hop::wgmma_wait<0>();
      hop::reg_fence(a0);
      hop::reg_fence(a1);
      hop::reg_fence(acc);
      // the four part sums (each exact) in f64, times the row's 2^e;
      // the owner of (row, column) clears its s_max for the next chunk
      // (at N = 8 the lanes t = 0 hold the part-0 columns and take the
      // other parts from the three lanes up)
#pragma unroll
      for (int i = 0; i < kHi; ++i) {
        double sum;
        if constexpr (NW == 8)
          sum = static_cast<double>(acc[i]) +
                static_cast<double>(
                    __shfl_down_sync(0xffffffffu, acc[i], 1)) +
                static_cast<double>(
                    __shfl_down_sync(0xffffffffu, acc[i], 2)) +
                static_cast<double>(
                    __shfl_down_sync(0xffffffffu, acc[i], 3));
        else
          sum = static_cast<double>(acc[i]) +
                static_cast<double>(acc[i + kHi]) +
                static_cast<double>(acc[i + 2 * kHi]) +
                static_cast<double>(acc[i + 3 * kHi]);
        const int r = row0 + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * t + (i & 1);
        if (col < P) {
          uint32_t* mx = s_max + r * kMaxLd + col;
          accd[i] += sum * pow2(scale_exp(*mx));
          *mx = 0u;
        }
      }
    }
    if (cc.c + 1 < chunks_of(cc.un)) {
      advance(cc);
      continue;
    }
    // ---- the unit's last chunk: this thread's accumulator fragment,
    // rows row0 (+ 8), columns 8 (i / 4) + 2 t (+ 1) (at N = 8, lanes
    // t = 0 hold the hi columns)
    const Unit& un = cc.un;
    const long long v0 = static_cast<long long>(un.b) * bin_n + un.r0;
    const bool split = un.nu > 1;
#pragma unroll
    for (int i = 0; i < kHi; ++i) {
      const int r = row0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      if (col < B) {
        if (split)
          rec[(static_cast<long long>(un.rec0 + un.k) * kTileRows + r) *
                  ld + col] = accd[i];
        else if (r < un.rows)
          out[(v0 + r) * ld + col] = static_cast<float>(accd[i]);
      }
      accd[i] = 0.0;
    }
    if (split)
      finish_split<double, SUM, float>(un, v0, B, ld, rec, counters, out);
    advance(cc);
  }
  hop::cp_async_wait<0>();
}

// ------------------------------------------------------ window reduce --
// Shared memory: acc [64][B] of the accumulator type, msg [chunk][B]
// staged messages (the identity for a slot that is no live edge), runs
// [65] the tile's row pointers.
template <typename T, typename M, int C, int MSG>
__global__ void __launch_bounds__(kWinThreads)
mxu_window(const T* __restrict__ x, const uint8_t* __restrict__ active,
           const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
           const float* __restrict__ w, const int32_t* __restrict__ ptr,
           M* __restrict__ out, long long n, long long bin_n, long long cap,
           long long B, int chunk, const int4* __restrict__ table,
           int32_t* counters, typename AccType<M, C>::type* rec) {
  using A = typename AccType<M, C>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);
  M* msg = reinterpret_cast<M*>(acc + kTileRows * B);
  int32_t* runs = reinterpret_cast<int32_t*>(msg + chunk * B);

  const Unit un = load_unit(table, blockIdx.x);
  const long long v0 = static_cast<long long>(un.b) * bin_n + un.r0;
  const int32_t* bsrc = src + un.b * cap;
  const int32_t* bdst = dst + un.b * cap;
  const float* bw = w + un.b * cap;
  const long long pairs = kTileRows * B;
  for (long long p = threadIdx.x; p < pairs; p += kWinThreads)
    acc[p] = identity<A, C>();
  const long long r_end = un.r0 + kTileRows < bin_n ? un.r0 + kTileRows
                                                    : bin_n;
  for (int i = threadIdx.x; i <= kTileRows; i += kWinThreads) {
    const long long r = un.r0 + i < r_end ? un.r0 + i : r_end;
    runs[i] = ptr[un.b * (bin_n + 1) + r];
  }

  for (long long base = un.lo; base < un.hi; base += chunk) {
    const long long len = un.hi - base < chunk ? un.hi - base : chunk;
    __syncthreads();            // the previous chunk is consumed
    for (long long i = threadIdx.x; i < len * B; i += kWinThreads) {
      const long long e = base + i / B, c = i % B;
      const int32_t u = bsrc[e], d = bdst[e];
      M v = from_acc<M, A>(identity<A, C>());
      if (u >= 0 && u < n && d >= 0 && d < n && active[u])
        v = message<T, M, MSG>(x[static_cast<long long>(u) * B + c],
                               MSG == COPY ? 0.f : bw[e]);
      msg[i] = v;
    }
    __syncthreads();
    // each (row, column) combines its own run, cut to the chunk
    for (long long p = threadIdx.x; p < pairs; p += kWinThreads) {
      const int r = static_cast<int>(p / B);
      const long long c = p % B;
      const long long e0 = runs[r] > base ? runs[r] : base;
      const long long e1 = runs[r + 1] < base + len ? runs[r + 1]
                                                    : base + len;
      if (e0 >= e1) continue;
      A v = acc[p];
      for (long long e = e0; e < e1; ++e)
        v = combine<A, C>(v, to_acc<A, M>(msg[(e - base) * B + c]));
      acc[p] = v;
    }
  }
  __syncthreads();
  const bool split = un.nu > 1;
  for (long long p = threadIdx.x; p < pairs; p += kWinThreads) {
    const long long r = p / B, c = p % B;
    if (split)
      rec[(static_cast<long long>(un.rec0 + un.k) * kTileRows + r) * B + c] =
          acc[p];
    else if (r < un.rows)
      out[(v0 + r) * B + c] = from_acc<M, A>(acc[p]);
  }
  if (split) finish_split<A, C, M>(un, v0, B, B, rec, counters, out);
}

// ------------------------------------------------------------- launch --
// payload rows staged at an odd stride (rows copied element by element)
// or an odd multiple of 4 elements (16-byte copies), so that a warp's 32
// edges read a column from 32 (or 8) banks
inline int raw_stride(long long B, bool vec) {
  const int b = static_cast<int>(B);
  if (!vec) return b | 1;
  return (b / 4) % 2 == 0 ? b + 4 : b;
}

// one launch per slice of at most 32 columns, NW = four times the
// slice's columns rounded up to 2, 8, 16 or 32
template <typename T, int MSG, int NW>
cudaError_t launch_slice(const MxuArgs& a, long long c0, int cols) {
  auto kernel = mxu_sum_wgmma<T, MSG, NW>;
  // above 48 KB a kernel must opt in to dynamic shared memory: once per
  // instantiation (the static is per (T, MSG, NW))
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return err;
  const bool vec = (a.B * sizeof(T)) % 16 == 0 &&
                   (cols * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int bs = raw_stride(cols, vec);
  // the B operand's NW / 8 column groups take kCoreWords words per 4
  // edges each
  const size_t per_edge = NW / 8 * kCoreWords + 2 * bs * sizeof(T) +
                          3 * (sizeof(int32_t) + sizeof(float));
  // chunks of 64 to 512 edges (whole pairs of groups of 4 k-steps), as
  // long as the budget allows
  int chunk = max_chunk<NW>();
  // (at 17-32 columns a chunk of 64 edges is 57 KB: there the budget is
  // twice as large, for chunks of 128)
  const size_t budget = NW == 128 ? kSmemBudget * 2 : kSmemBudget;
  while (chunk > 64 && chunk * per_edge > budget) chunk /= 2;
  const size_t smem = chunk * per_edge;
  // as many CTAs as fit on the card at once, each walking a contiguous
  // run of units
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, 128, smem);
  if (occ != cudaSuccess) return occ;
  const long long fit = static_cast<long long>(sms > 0 ? sms : 1) *
                        (per_sm > 0 ? per_sm : 1);
  const long long grid = a.units < fit ? a.units : fit;
  const long long per = (a.units + grid - 1) / grid;
  kernel<<<static_cast<unsigned>(grid), 128, smem, a.stream>>>(
      static_cast<const T*>(a.x) + c0, a.active, a.src, a.dst, a.w,
      static_cast<float*>(a.out) + c0, a.n, a.bin_n, a.cap, cols, a.B, bs,
      chunk, a.table, a.units, per, a.counters,
      static_cast<double*>(a.rec) + c0);
  return cudaGetLastError();
}

template <typename T, int MSG>
cudaError_t launch_sum(const MxuArgs& a) {
  for (long long c0 = 0; c0 < a.B; c0 += 32) {
    const int cols = static_cast<int>(a.B - c0 < 32 ? a.B - c0 : 32);
    const cudaError_t err =
        cols <= 2    ? launch_slice<T, MSG, 8>(a, c0, cols)
        : cols <= 8  ? launch_slice<T, MSG, 32>(a, c0, cols)
        : cols <= 16 ? launch_slice<T, MSG, 64>(a, c0, cols)
                     : launch_slice<T, MSG, 128>(a, c0, cols);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, typename M, int C, int MSG>
cudaError_t launch_window(const MxuArgs& a) {
  using A = typename AccType<M, C>::type;
  // the tile's accumulator, then as many staged slots as the budget
  // leaves (at least 64: wide payloads go past the budget)
  const size_t fixed = kTileRows * a.B * sizeof(A) +
                       (kTileRows + 1) * sizeof(int32_t);
  int chunk = kMaxWinChunk;
  while (chunk > 64 && fixed + chunk * a.B * sizeof(M) > kSmemBudget)
    chunk /= 2;
  while (chunk > 8 && fixed + chunk * a.B * sizeof(M) > kSmemMax) chunk /= 2;
  const size_t smem = fixed + chunk * a.B * sizeof(M);
  auto kernel = mxu_window<T, M, C, MSG>;
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(a.units), kWinThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.active, a.src, a.dst, a.w, a.ptr,
      static_cast<M*>(a.out), a.n, a.bin_n, a.cap, a.B, chunk, a.table,
      a.counters, static_cast<A*>(a.rec));
  return cudaGetLastError();
}

struct MxuLauncher {
  using Args = MxuArgs;
  template <typename T, int C, int MSG>
  static cudaError_t run(const Args& a) {
    using M = typename MsgType<T, MSG>::type;
    if (a.units == 0) return cudaSuccess;
    if (a.units > 0x7fffffffLL || a.B < 1 || a.B > 256)
      return cudaErrorInvalidValue;
    if constexpr (C == SUM && std::is_same<M, float>::value) {
      return launch_sum<T, MSG>(a);
    } else {
      return launch_window<T, M, C, MSG>(a);
    }
  }
};

}  // namespace rk

extern "C" int repro_coo_push_mxu(const void* x, int dtype,
                                  const void* active, const void* src,
                                  const void* dst, const void* w,
                                  const void* ptr, void* out, long long n,
                                  long long bin_n, long long cap,
                                  long long B, int combine, int msg,
                                  long long units,
                                  const void* table, void* counters,
                                  void* rec, void* stream) {
  rk::MxuArgs a{x,
                static_cast<const uint8_t*>(active),
                static_cast<const int32_t*>(src),
                static_cast<const int32_t*>(dst),
                static_cast<const float*>(w),
                static_cast<const int32_t*>(ptr),
                out, n, bin_n, cap, B, units,
                static_cast<const int4*>(table),
                static_cast<int32_t*>(counters), rec,
                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(rk::dispatch<rk::MxuLauncher>(dtype, combine, msg,
                                                          a));
}
