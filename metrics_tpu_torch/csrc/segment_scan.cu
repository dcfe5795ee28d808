// Segmented multi-lane inclusive scan of integer lanes, for Hopper (sm_90a).
//
// Replaces: metrics_tpu/ops/segment.py: the inner `kernel` of _multi_scan_pallas
// (pl.pallas_call at :340), reached from segment_multi_scan (:434). On the exact
// AUROC / average-precision path it propagates tie-run-end counts
// (ops/clf_curve.py:_run_end_counts and ops/rank.py:rank_run_end_counts): two
// int32 `min` lanes, one global segment, suffix direction.
//
// Function: for k <= 4 lanes of one integer type (int32 or int64), each with its
// own op (sum, min or max), out[l][i] = the op over lane l's rows from the start
// of i's segment up to i, in scan order. A row whose flag is set starts a new
// segment; with no flag column the whole array is one segment. With `reverse` the
// scan order runs from the last row to the first (the flags then mark segment
// LAST rows in array order): the caller's flip-scan-flip, done by index mapping.
// Sums wrap modulo 2^bits, as torch and XLA integer adds do.
//
// Bound: the function reads each lane once and writes each output once, plus one
// flag byte per row when flags are given: 16 B per row for the curve path's two
// int32 lanes, 1.43 GB at N = 89,137,319, about 0.43 ms at the H100 SXM's
// 3.35 TB/s. The work per row is a few integer compares, far below the issue
// rate, so bytes bound it.
//
// Design: one pass, a decoupled look-back scan (Merrill & Garland) under the
// segmented monoid (fa, a) + (fb, b) = (fa | fb, fb ? b : op(a, b)).
//   - Tiles are cut at array rows that are multiples of the tile size, counted
//     from row 0. Each CTA takes the next tile in scan order from an atomic counter
//     (never blockIdx: CTAs start in no order, and a look-back on blockIdx could
//     wait on a CTA that is not resident). In reverse the tiles are walked from the
//     last one and the rows inside a tile from the end, so only the first tile in
//     scan order is ragged and every vector access stays aligned.
//   - Loads first: the tile is copied into shared memory with 16-byte cp.async,
//     all in flight before any scan step: 128 B of lane values per thread (kRows
//     rows, a function of K and sizeof(T)), 32 KB per CTA, and up to six CTAs per
//     SM, so that about 192 KB per SM are in flight. A ragged tile, or a lane or
//     flag pointer that is not 16-byte aligned (a view such as buf[1:]), takes
//     coalesced scalar loads and stores instead, inside the same kernel.
//   - Scan inside the tile: the values stay in shared memory, so that registers
//     stay few (about 40 a thread for two int32 lanes) and six CTAs fit an SM.
//     Each thread reads its kRows consecutive rows (XOR-swizzled 16-byte slots,
//     no bank conflicts) once for its aggregate; a warp shuffle scans the thread
//     aggregates and shared memory the eight warp aggregates; once the tile's
//     prefix is known, each thread reads its rows again, scans them from its own
//     prefix and writes the results back in place.
//   - Publishing: the tile's aggregate (status A), then its inclusive prefix
//     (status P). The K values are written first, then the status word with
//     st.release.gpu; readers load the status with ld.acquire.gpu and the values
//     through L2. Aggregate and prefix have their own slots, never rewritten.
//   - Look-back: warp 0 reads 32 predecessors' status words at once and stops at
//     the nearest P, or at the nearest predecessor whose aggregate carries a
//     segment flag, since nothing before it reaches this tile.
//   - The results leave shared memory with 16-byte streaming stores.
// Rows past N hold the op's identity with no flag, which changes nothing. Scratch
// holds the tile counter, the status words and the tile values; one
// cudaMemsetAsync on the caller's stream zeroes the counter and the status words
// before each launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_segment_scan.so segment_scan.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kStatusAgg = 1u, kStatusIncl = 2u, kStatusFlag = 4u;
constexpr long long kHeaderBytes = 16;  // the tile counter, then one status word per tile

enum Op { kSum = 0, kMin = 1, kMax = 2 };

// Rows per thread: 128 B of lane values per thread for any K and element size, in
// whole 16-byte vectors (at least two per lane), a power of two.
__host__ __device__ constexpr int rows_per_thread(int k, int elem_bytes) { return (k == 1 ? 128 : k == 2 ? 64 : 32) / elem_bytes; }
__host__ __device__ constexpr long long tile_rows(int k, int elem_bytes) { return (long long)kThreads * rows_per_thread(k, elem_bytes); }
// CTAs per SM that the register budget is cut for: six (40 registers a thread, the
// most that 33 KB of shared memory each allows) where the lanes are narrow, fewer
// where more lanes or flags need more registers than that without spilling.
__host__ __device__ constexpr int min_ctas(int k, int elem_bytes, bool flags) {
  return k * elem_bytes > 16 ? 3 : (flags || k * elem_bytes > 8) ? 4 : 6;
}
long long num_tiles(int k, int elem_bytes, long long n) {
  return (n + tile_rows(k, elem_bytes) - 1) / tile_rows(k, elem_bytes);
}
long long zeroed_bytes(long long tiles) { return (kHeaderBytes + 4 * tiles + 15) / 16 * 16; }

template <typename T> struct Traits;
template <> struct Traits<int32_t> {
  using U = uint32_t;
  using Vec = int4;
  static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX;
};
template <> struct Traits<int64_t> {
  using U = unsigned long long;
  using Vec = longlong2;
  static constexpr int64_t lo = INT64_MIN, hi = INT64_MAX;
};

template <typename T, int K>
struct Lanes {
  const T* in[K];
  T* out[K];
  int op[K];
};

template <typename T>
__device__ __forceinline__ T combine(int op, T a, T b) {
  if (op == kSum) return (T)((typename Traits<T>::U)a + (typename Traits<T>::U)b);  // wraps
  if (op == kMin) return a < b ? a : b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T identity(int op) {
  return op == kSum ? T(0) : (op == kMin ? Traits<T>::hi : Traits<T>::lo);
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  if constexpr (sizeof(T) == 8) {
    return (T)__shfl_up_sync(kFull, (long long)v, d);
  } else {
    return (T)__shfl_up_sync(kFull, (int)v, d);
  }
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  if constexpr (sizeof(T) == 8) {
    return (T)__shfl_down_sync(kFull, (long long)v, d);
  } else {
    return (T)__shfl_down_sync(kFull, (int)v, d);
  }
}

template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  if constexpr (sizeof(T) == 8) {
    return (T)__shfl_sync(kFull, (long long)v, src);
  } else {
    return (T)__shfl_sync(kFull, (int)v, src);
  }
}

// a tile value read through L2, where other CTAs' writes are visible
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  if constexpr (sizeof(T) == 8) {
    return (T)__ldcg(reinterpret_cast<const long long*>(p));
  } else {
    return (T)__ldcg(reinterpret_cast<const int*>(p));
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Shared-memory position of 16-byte slot s: the XOR spreads both the striped copies
// (consecutive slots) and the per-thread reads (slots v apart, v in {2, 4, 8}) over
// all eight 16-byte bank groups.
__device__ __forceinline__ int swizzle(int s) { return s ^ ((s >> 3) & 7); }

template <typename T, int K>
__device__ __forceinline__ void set_identity(const Lanes<T, K>& L, bool& f, T (&v)[K]) {
  f = false;
#pragma unroll
  for (int l = 0; l < K; ++l) v[l] = identity<T>(L.op[l]);
}

template <typename T, int K>
__device__ __forceinline__ void copy(bool sf, const T (&sv)[K], bool& f, T (&v)[K]) {
  f = sf;
#pragma unroll
  for (int l = 0; l < K; ++l) v[l] = sv[l];
}

// (f, v) <- (pf, pv) + (f, v): prepend a prefix aggregate to an element.
template <typename T, int K>
__device__ __forceinline__ void prepend(const Lanes<T, K>& L, bool pf, const T (&pv)[K], bool& f, T (&v)[K]) {
  if (!f) {
#pragma unroll
    for (int l = 0; l < K; ++l) v[l] = combine(L.op[l], pv[l], v[l]);
  }
  f = f || pf;
}

// (pf, pv) <- (pf, pv) + (f, v): append an element to a running prefix.
template <typename T, int K>
__device__ __forceinline__ void append(const Lanes<T, K>& L, bool& pf, T (&pv)[K], bool f, const T (&v)[K]) {
  bool ef = f;
  T ev[K];
  copy(f, v, ef, ev);
  prepend(L, pf, pv, ef, ev);
  copy(ef, ev, pf, pv);
}

template <typename T, int K>
__device__ __forceinline__ void warp_inclusive_scan(const Lanes<T, K>& L, bool& f, T (&v)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool fu = __shfl_up_sync(kFull, (int)f, d) != 0;
    T vu[K];
#pragma unroll
    for (int l = 0; l < K; ++l) vu[l] = shfl_up(v[l], d);
    if (lane >= d) prepend(L, fu, vu, f, v);
  }
}

// Warp 0 of tile s > 0: the exclusive prefix of the tile, from the status words of
// its predecessors, 32 at a time (lane i looks at tile pred - i).
template <typename T, int K>
__device__ __forceinline__ void look_back(const Lanes<T, K>& L, long long s, const unsigned* status,
                                          const T* agg_v, const T* incl_v, bool& pf, T (&pv)[K]) {
  const int lane = threadIdx.x & 31;
  set_identity(L, pf, pv);
  for (long long pred = s - 1;; pred -= 32) {
    const long long j = pred - lane;
    unsigned st;
    do {
      st = j >= 0 ? load_acquire(status + j) : kStatusIncl;
    } while (!__all_sync(kFull, st != 0));
    const unsigned stops = __ballot_sync(kFull, (st & (kStatusIncl | kStatusFlag)) != 0);
    const int stop = stops ? __ffs(stops) - 1 : 31;
    bool f;
    T v[K];
    set_identity(L, f, v);
    if (lane <= stop && j >= 0) {
      const T* src = (st & kStatusIncl) ? incl_v + j * K : agg_v + j * K;
#pragma unroll
      for (int l = 0; l < K; ++l) v[l] = load_cg(src + l);
      f = (st & kStatusFlag) != 0;
    }
    // fold the window in scan order (the highest lane is the earliest tile) into lane 0
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool fd = __shfl_down_sync(kFull, (int)f, d) != 0;
      T vd[K];
#pragma unroll
      for (int l = 0; l < K; ++l) vd[l] = shfl_down(v[l], d);
      if (lane + d < 32) prepend(L, fd, vd, f, v);
    }
    const bool wf = __shfl_sync(kFull, (int)f, 0) != 0;
    T wv[K];
#pragma unroll
    for (int l = 0; l < K; ++l) wv[l] = shfl_idx(v[l], 0);
    prepend(L, wf, wv, pf, pv);  // the window comes before what was found so far
    if (stops) return;
  }
}

// Shared memory of one tile: K lanes of values, then the flag bytes.
template <typename T, int K, bool FLAGS>
__host__ __device__ constexpr int buffer_bytes() {
  return K * (int)tile_rows(K, sizeof(T)) * (int)sizeof(T) + (FLAGS ? (int)tile_rows(K, sizeof(T)) : 0);
}

// Copies tile s (scan order) into a shared-memory buffer: 16-byte cp.async, all in
// flight together, when the tile is whole and aligned; else coalesced scalar loads,
// with identities and no flags past row n.
template <typename T, int K, bool REVERSE, bool FLAGS>
__device__ __forceinline__ void load_tile(const Lanes<T, K>& L, const uint8_t* __restrict__ flags, long long n,
                                          long long tiles, bool aligned, long long s, unsigned char* buf) {
  constexpr int kRows = rows_per_thread(K, sizeof(T));
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSlots = kRows / kVec;
  constexpr int kTile = kThreads * kRows;
  T* sv = reinterpret_cast<T*>(buf);
  uint8_t* sf = buf + K * kTile * sizeof(T);
  const int tid = threadIdx.x;
  const long long row0 = (REVERSE ? tiles - 1 - s : s) * kTile;
  const long long left = n - row0;
  const int rows = left < kTile ? (int)left : kTile;
  if (aligned && rows == kTile) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int slot = r * kThreads + tid;
        cp_async16(sv + l * kTile + swizzle(slot) * kVec, L.in[l] + row0 + (long long)slot * kVec);
      }
    }
    if (FLAGS) {
      for (int slot = tid; slot < kTile / 16; slot += kThreads) cp_async16(sf + slot * 16, flags + row0 + slot * 16);
    }
  } else {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const T id = identity<T>(L.op[l]);
      for (int e = tid; e < kTile; e += kThreads)
        sv[l * kTile + swizzle(e / kVec) * kVec + e % kVec] = e < rows ? L.in[l][row0 + e] : id;
    }
    if (FLAGS) {
      for (int e = tid; e < kTile; e += kThreads) sf[e] = e < rows ? flags[row0 + e] : 0;
    }
  }
}

// One CTA per tile, its place in scan order taken from the counter when it starts.
// The lane values stay in shared memory: a thread reads its kRows rows twice (for
// its aggregate, then for its results), which keeps registers few and lets six
// CTAs, 192 KB of loads, share an SM. The direction is a template parameter: as a
// kernel argument it costs the two-int32-lane instance registers past the six-CTA
// budget of 40, a spill, and 4% on the DLRM lanes (H100 80GB HBM3, 700 W,
// scripts/torch_kernel_ab.py), for a build only 5 s shorter.
template <typename T, int K, bool REVERSE, bool FLAGS>
__global__ void __launch_bounds__(kThreads, min_ctas(K, sizeof(T), FLAGS))
segment_scan_kernel(Lanes<T, K> L, const uint8_t* __restrict__ flags, long long n, long long tiles, bool aligned,
                    unsigned* __restrict__ header, T* __restrict__ agg_v, T* __restrict__ incl_v) {
  constexpr int kRows = rows_per_thread(K, sizeof(T));
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte slot
  constexpr int kSlots = kRows / kVec;  // slots per thread and lane
  constexpr int kTile = kThreads * kRows;
  using Vec = typename Traits<T>::Vec;
  __shared__ __align__(16) unsigned char buf[buffer_bytes<T, K, FLAGS>()];
  __shared__ unsigned s_tile;
  __shared__ int s_wf[kWarps];
  __shared__ T s_wv[K][kWarps];
  __shared__ int s_pf;
  __shared__ T s_pv[K];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned* status = header + kHeaderBytes / 4;
  if (tid == 0) s_tile = atomicAdd(header, 1u);
  __syncthreads();
  const long long s = s_tile;  // the tile's place in scan order
  load_tile<T, K, REVERSE, FLAGS>(L, flags, n, tiles, aligned, s, buf);
  cp_async_wait_all();
  __syncthreads();

  T* sv = reinterpret_cast<T*>(buf);
  const uint8_t* sf = buf + K * kTile * sizeof(T);
  // this thread's kRows consecutive rows in scan order: in reverse, the rows of the
  // mirror thread, last first
  const int owner = REVERSE ? kThreads - 1 - tid : tid;
  unsigned fbits = 0;  // bit i: row i of this thread (scan order) starts a segment
  if (FLAGS) {
#pragma unroll
    for (int w = 0; w < kRows / 4; ++w) {
      const unsigned word = *reinterpret_cast<const unsigned*>(sf + owner * kRows + 4 * w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = REVERSE ? kRows - 1 - (4 * w + c) : 4 * w + c;
        if ((word >> (8 * c)) & 0xffu) fbits |= 1u << i;
      }
    }
  }

  // ---- the thread's aggregate over its rows
  bool tf = FLAGS && fbits != 0;
  T tv[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T r = identity<T>(L.op[l]);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int slot = owner * kSlots + (REVERSE ? kSlots - 1 - q : q);
      const Vec x = *reinterpret_cast<const Vec*>(sv + l * kTile + swizzle(slot) * kVec);
      const T* xe = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const T e = xe[REVERSE ? kVec - 1 - c : c];
        r = FLAGS && ((fbits >> (q * kVec + c)) & 1u) ? e : combine(L.op[l], r, e);
      }
    }
    tv[l] = r;
  }

  // ---- warp scan of the thread aggregates; exclusive prefix within the warp
  warp_inclusive_scan(L, tf, tv);
  bool xf = __shfl_up_sync(kFull, (int)tf, 1) != 0;
  T xv[K];
#pragma unroll
  for (int l = 0; l < K; ++l) xv[l] = shfl_up(tv[l], 1);
  if (lane == 0) set_identity(L, xf, xv);
  if (lane == 31) {
    s_wf[warp] = tf;
#pragma unroll
    for (int l = 0; l < K; ++l) s_wv[l][warp] = tv[l];
  }
  __syncthreads();

  // ---- warp 0: the tile's aggregate, published; its prefix, looked back for
  if (warp == 0) {
    bool af, pf;
    T av[K], pv[K];
    set_identity(L, af, av);
    for (int w = 0; w < kWarps; ++w) {
      T wv[K];
#pragma unroll
      for (int l = 0; l < K; ++l) wv[l] = s_wv[l][w];
      append(L, af, av, s_wf[w] != 0, wv);
    }
    if (s == 0) {
      set_identity(L, pf, pv);
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < K; ++l) incl_v[l] = av[l];
        store_release(status, kStatusIncl | (af ? kStatusFlag : 0u));
      }
    } else {
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < K; ++l) agg_v[s * K + l] = av[l];
        store_release(status + s, kStatusAgg | (af ? kStatusFlag : 0u));
      }
      look_back(L, s, status, agg_v, incl_v, pf, pv);
      if (lane == 0) {
        prepend(L, pf, pv, af, av);  // inclusive prefix = exclusive prefix + aggregate
#pragma unroll
        for (int l = 0; l < K; ++l) incl_v[s * K + l] = av[l];
        store_release(status + s, kStatusIncl | (af ? kStatusFlag : 0u));
      }
    }
    if (lane == 0) {
      s_pf = pf;
#pragma unroll
      for (int l = 0; l < K; ++l) s_pv[l] = pv[l];
    }
  }
  __syncthreads();

  // ---- each thread's prefix: the tile's, the warps before, the lanes before; then
  // its rows again, scanned from that prefix, written back in place
  bool pf = s_pf != 0;
  T pv[K];
#pragma unroll
  for (int l = 0; l < K; ++l) pv[l] = s_pv[l];
  for (int w = 0; w < warp; ++w) {
    T wv[K];
#pragma unroll
    for (int l = 0; l < K; ++l) wv[l] = s_wv[l][w];
    append(L, pf, pv, s_wf[w] != 0, wv);
  }
  append(L, pf, pv, xf, xv);
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T r = pv[l];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int slot = owner * kSlots + (REVERSE ? kSlots - 1 - q : q);
      Vec* p = reinterpret_cast<Vec*>(sv + l * kTile + swizzle(slot) * kVec);
      Vec x = *p;
      T* xe = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        T& e = xe[REVERSE ? kVec - 1 - c : c];
        r = FLAGS && ((fbits >> (q * kVec + c)) & 1u) ? e : combine(L.op[l], r, e);
        e = r;
      }
      *p = x;
    }
  }
  __syncthreads();

  // ---- out with 16-byte stores, or scalar ones for a ragged or unaligned tile
  const long long row0 = (REVERSE ? tiles - 1 - s : s) * kTile;
  const long long left = n - row0;
  const int rows = left < kTile ? (int)left : kTile;
  if (aligned && rows == kTile) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int slot = r * kThreads + tid;
        __stcs(reinterpret_cast<Vec*>(L.out[l] + row0 + (long long)slot * kVec),
               *reinterpret_cast<const Vec*>(sv + l * kTile + swizzle(slot) * kVec));  // streaming
      }
    }
  } else {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      for (int e = tid; e < rows; e += kThreads) L.out[l][row0 + e] = sv[l * kTile + swizzle(e / kVec) * kVec + e % kVec];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int K, bool REVERSE, bool FLAGS>
cudaError_t launch_kernel(const Lanes<T, K>& L, const uint8_t* flags, long long n, long long tiles, bool aligned,
                          void* scratch, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed_bytes(tiles), stream);
  if (err != cudaSuccess) return err;
  unsigned* header = reinterpret_cast<unsigned*>(scratch);
  T* agg_v = reinterpret_cast<T*>(reinterpret_cast<char*>(scratch) + zeroed_bytes(tiles));
  T* incl_v = agg_v + (long long)K * tiles;
  segment_scan_kernel<T, K, REVERSE, FLAGS><<<(unsigned)tiles, kThreads, 0, stream>>>(L, flags, n, tiles, aligned,
                                                                                       header, agg_v, incl_v);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch(const void* const* values, void* const* outs, const int* ops, const uint8_t* flags, long long n,
                   bool reverse, void* scratch, cudaStream_t stream) {
  Lanes<T, K> L;
  bool aligned = flags == nullptr || aligned16(flags);
  for (int l = 0; l < K; ++l) {
    L.in[l] = reinterpret_cast<const T*>(values[l]);
    L.out[l] = reinterpret_cast<T*>(outs[l]);
    L.op[l] = ops[l];
    aligned = aligned && aligned16(values[l]) && aligned16(outs[l]);
  }
  const long long tiles = num_tiles(K, sizeof(T), n);
  if (reverse) {
    return flags ? launch_kernel<T, K, true, true>(L, flags, n, tiles, aligned, scratch, stream)
                 : launch_kernel<T, K, true, false>(L, flags, n, tiles, aligned, scratch, stream);
  }
  return flags ? launch_kernel<T, K, false, true>(L, flags, n, tiles, aligned, scratch, stream)
               : launch_kernel<T, K, false, false>(L, flags, n, tiles, aligned, scratch, stream);
}

template <typename T>
cudaError_t launch_k(int k, const void* const* values, void* const* outs, const int* ops, const uint8_t* flags,
                     long long n, bool reverse, void* scratch, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(values, outs, ops, flags, n, reverse, scratch, stream);
    case 2: return launch<T, 2>(values, outs, ops, flags, n, reverse, scratch, stream);
    case 3: return launch<T, 3>(values, outs, ops, flags, n, reverse, scratch, stream);
    case 4: return launch<T, 4>(values, outs, ops, flags, n, reverse, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Rows of one tile (one CTA) for k lanes of 8-byte (is64) or 4-byte values.
extern "C" long long tm_segment_scan_tile_rows(int k, int is64) {
  return k < 1 || k > kMaxLanes ? 0 : tile_rows(k, is64 ? 8 : 4);
}

// Bytes of device scratch that tm_segment_scan needs for k lanes of n rows
// (8-byte lanes when is64): the tile counter and one status word per tile (zeroed
// by each call), then each tile's aggregate and inclusive prefix, k values each.
extern "C" long long tm_segment_scan_scratch_bytes(int k, int is64, long long n) {
  if (k < 1 || k > kMaxLanes || n <= 0) return 0;
  const int elem = is64 ? 8 : 4;
  const long long tiles = num_tiles(k, elem, n);
  return zeroed_bytes(tiles) + 2LL * k * tiles * elem;
}

// values / outs: host arrays of k device pointers (1-D contiguous lanes of n rows,
// int64 when is64 else int32); ops: host array of k op codes (0 sum, 1 min, 2 max);
// flags: n bytes (non-zero starts a segment) or null for one global segment;
// scratch: tm_segment_scan_scratch_bytes(k, is64, n) bytes, 16-byte aligned.
// Enqueues one memset and one kernel on `stream`; returns the CUDA error code of
// the two (0 on success).
extern "C" int tm_segment_scan(int k, const void* const* values, void* const* outs, const int* ops, int is64,
                               const void* flags, long long n, int reverse, void* scratch, void* stream) {
  if (k < 1 || k > kMaxLanes) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < k; ++l)
    if (ops[l] < kSum || ops[l] > kMax) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (num_tiles(k, is64 ? 8 : 4, n) > 0x7fffffffLL || scratch == nullptr || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const uint8_t* f = reinterpret_cast<const uint8_t*>(flags);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = is64 ? launch_k<int64_t>(k, values, outs, ops, f, n, reverse != 0, scratch, s)
                         : launch_k<int32_t>(k, values, outs, ops, f, n, reverse != 0, scratch, s);
  return (int)err;
}
