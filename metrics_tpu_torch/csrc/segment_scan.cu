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
// Design: the GPU has no sequential grid, so the Pallas kernel's carry across an
// in-order grid becomes a three-phase parallel scan under the segmented monoid
// (fa, a) + (fb, b) = (fa | fb, fb ? b : op(a, b)):
//   1. tile_reduce: each warp scans its chunk of kWarpSpan rows in kItems
//      coalesced rounds of 32 (warp shuffles, a running carry in registers); the
//      CTA folds its eight warp aggregates into the tile's (flag, k values);
//   2. carry_scan: one CTA of 1024 threads turns the tile aggregates into each
//      tile's exclusive carry-in (sequential per thread over a chunk, a block
//      scan across threads, then a sequential rewrite of the chunk);
//   3. tile_scan: each warp scans its chunk again, holding the results in
//      registers, then prepends its carry-in (the tile's, then the warps before
//      it in the tile) and writes the outputs.
// Phases 1 and 3 each read the inputs, so the kernel moves about 1.5x the bytes
// of the bound; a single-pass decoupled look-back is left for later work. Rows
// past N load identity values (0, max, min of the type) with no flag, so a
// ragged tail changes nothing. With a single tile, phases 1 and 2 are skipped.
// The lane count K is a template argument, so registers hold only real lanes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_segment_scan.so segment_scan.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 4;
constexpr int kThreads = 256;                          // phases 1 and 3
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                              // rounds of 32 rows per warp
constexpr long long kWarpSpan = 32LL * kItems;         // 256 rows per warp
constexpr long long kTile = kWarps * kWarpSpan;        // 2048 rows per CTA
constexpr int kCarryThreads = 1024;                    // phase 2, one CTA
constexpr int kCarryWarps = kCarryThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Traits;
template <> struct Traits<int32_t> {
  using U = uint32_t;
  static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX;
};
template <> struct Traits<int64_t> {
  using U = unsigned long long;
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
__device__ __forceinline__ T shfl_last(T v) {
  if constexpr (sizeof(T) == 8) {
    return (T)__shfl_sync(kFull, (long long)v, 31);
  } else {
    return (T)__shfl_sync(kFull, (int)v, 31);
  }
}

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

// Row j of the scan order (row n-1-j of the arrays when reversed); rows past n
// load identities with no flag.
template <typename T, int K>
__device__ __forceinline__ void load(const Lanes<T, K>& L, const uint8_t* __restrict__ flags, long long n,
                                     bool reverse, long long j, bool& f, T (&v)[K]) {
  set_identity(L, f, v);
  if (j < n) {
    const long long i = reverse ? n - 1 - j : j;
    f = flags != nullptr && flags[i] != 0;
#pragma unroll
    for (int l = 0; l < K; ++l) v[l] = L.in[l][i];
  }
}

// One warp's chunk of kWarpSpan rows, in kItems coalesced rounds of 32: each round
// is a shuffle scan, prefixed by the warp's running carry (cf, cv), which then
// takes the round's last value. With HOLD, each row's result stays in registers.
template <typename T, int K, bool HOLD>
__device__ __forceinline__ void scan_warp_chunk(const Lanes<T, K>& L, const uint8_t* __restrict__ flags,
                                                long long n, bool reverse, long long base, bool& cf,
                                                T (&cv)[K], T (&hold)[kItems][K], unsigned& hold_f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long start = base + 32LL * r;
    if (start < n) {  // uniform within the warp
      bool f;
      T v[K];
      load(L, flags, n, reverse, start + lane, f, v);
      warp_inclusive_scan(L, f, v);
      prepend(L, cf, cv, f, v);
      if (HOLD) {
#pragma unroll
        for (int l = 0; l < K; ++l) hold[r][l] = v[l];
        if (f) hold_f |= 1u << r;
      }
      cf = __shfl_sync(kFull, (int)f, 31) != 0;
#pragma unroll
      for (int l = 0; l < K; ++l) cv[l] = shfl_last(v[l]);
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_reduce(Lanes<T, K> L, const uint8_t* __restrict__ flags, long long n, bool reverse, long long tiles,
            T* __restrict__ agg_v, uint8_t* __restrict__ agg_f) {
  __shared__ int s_f[kWarps];
  __shared__ T s_v[K][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool cf;
  T cv[K];
  T unused[kItems][K];
  unsigned unused_f = 0;
  set_identity(L, cf, cv);
  scan_warp_chunk<T, K, false>(L, flags, n, reverse, blockIdx.x * kTile + warp * kWarpSpan, cf, cv, unused,
                               unused_f);
  if (lane == 0) {
    s_f[warp] = cf;
#pragma unroll
    for (int l = 0; l < K; ++l) s_v[l][warp] = cv[l];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool af;
    T av[K];
    set_identity(L, af, av);
    for (int w = 0; w < kWarps; ++w) {
      bool wf = s_f[w] != 0;
      T wv[K];
#pragma unroll
      for (int l = 0; l < K; ++l) wv[l] = s_v[l][w];
      prepend(L, af, av, wf, wv);
      copy(wf, wv, af, av);
    }
    agg_f[blockIdx.x] = af;
#pragma unroll
    for (int l = 0; l < K; ++l) agg_v[l * tiles + blockIdx.x] = av[l];
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kCarryThreads)
carry_scan(Lanes<T, K> L, long long tiles, const T* __restrict__ agg_v, const uint8_t* __restrict__ agg_f,
           T* __restrict__ carry_v) {
  __shared__ int s_f[kCarryWarps];
  __shared__ T s_v[K][kCarryWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chunk = (tiles + kCarryThreads - 1) / kCarryThreads;
  const long long t0 = threadIdx.x * chunk;
  const long long t1 = t0 + chunk < tiles ? t0 + chunk : tiles;

  // this thread's chunk of tile aggregates, folded in order
  bool f;
  T v[K];
  set_identity(L, f, v);
  for (long long t = t0; t < t1; ++t) {
    bool tf = agg_f[t] != 0;
    T tv[K];
#pragma unroll
    for (int l = 0; l < K; ++l) tv[l] = agg_v[l * tiles + t];
    prepend(L, f, v, tf, tv);
    copy(tf, tv, f, v);
  }

  // exclusive scan of the thread aggregates across the CTA
  warp_inclusive_scan(L, f, v);
  if (lane == 31) {
    s_f[warp] = f;
#pragma unroll
    for (int l = 0; l < K; ++l) s_v[l][warp] = v[l];
  }
  bool ef = __shfl_up_sync(kFull, (int)f, 1) != 0;  // the previous lane's inclusive value
  T ev[K];
#pragma unroll
  for (int l = 0; l < K; ++l) ev[l] = shfl_up(v[l], 1);
  if (lane == 0) set_identity(L, ef, ev);
  __syncthreads();
  bool pf;
  T pv[K];
  set_identity(L, pf, pv);
  for (int w = 0; w < warp; ++w) {
    bool wf = s_f[w] != 0;
    T wv[K];
#pragma unroll
    for (int l = 0; l < K; ++l) wv[l] = s_v[l][w];
    prepend(L, pf, pv, wf, wv);
    copy(wf, wv, pf, pv);
  }
  prepend(L, pf, pv, ef, ev);

  // each tile's carry-in is the aggregate of every tile before it
  for (long long t = t0; t < t1; ++t) {
#pragma unroll
    for (int l = 0; l < K; ++l) carry_v[l * tiles + t] = ev[l];
    bool tf = agg_f[t] != 0;
    T tv[K];
#pragma unroll
    for (int l = 0; l < K; ++l) tv[l] = agg_v[l * tiles + t];
    prepend(L, ef, ev, tf, tv);
    copy(tf, tv, ef, ev);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_scan(Lanes<T, K> L, const uint8_t* __restrict__ flags, long long n, bool reverse, long long tiles,
          const T* __restrict__ carry_v) {
  __shared__ int s_f[kWarps];
  __shared__ T s_v[K][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = blockIdx.x * kTile + warp * kWarpSpan;
  bool cf;
  T cv[K];
  T hold[kItems][K];
  unsigned hold_f = 0;
  set_identity(L, cf, cv);
  scan_warp_chunk<T, K, true>(L, flags, n, reverse, base, cf, cv, hold, hold_f);
  if (lane == 0) {
    s_f[warp] = cf;
#pragma unroll
    for (int l = 0; l < K; ++l) s_v[l][warp] = cv[l];
  }
  __syncthreads();
  // the warp's prefix: the tile's carry-in, then the warps before this one
  bool pf;
  T pv[K];
  set_identity(L, pf, pv);
  if (carry_v != nullptr) {
#pragma unroll
    for (int l = 0; l < K; ++l) pv[l] = carry_v[l * tiles + blockIdx.x];
  }
  for (int w = 0; w < warp; ++w) {
    bool wf = s_f[w] != 0;
    T wv[K];
#pragma unroll
    for (int l = 0; l < K; ++l) wv[l] = s_v[l][w];
    prepend(L, pf, pv, wf, wv);
    copy(wf, wv, pf, pv);
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long j = base + 32LL * r + lane;
    if (j < n) {
      const long long i = reverse ? n - 1 - j : j;
      bool f = (hold_f >> r) & 1u;
      T v[K];
#pragma unroll
      for (int l = 0; l < K; ++l) v[l] = hold[r][l];
      prepend(L, pf, pv, f, v);
#pragma unroll
      for (int l = 0; l < K; ++l) L.out[l][i] = v[l];
    }
  }
}

long long num_tiles(long long n) { return (n + kTile - 1) / kTile; }

template <typename T, int K>
cudaError_t launch(const void* const* values, void* const* outs, const int* ops, const uint8_t* flags, long long n,
                   bool reverse, void* scratch, cudaStream_t stream) {
  Lanes<T, K> L;
  for (int l = 0; l < K; ++l) {
    L.in[l] = reinterpret_cast<const T*>(values[l]);
    L.out[l] = reinterpret_cast<T*>(outs[l]);
    L.op[l] = ops[l];
  }
  const long long tiles = num_tiles(n);
  T* carry_v = nullptr;
  if (tiles > 1) {
    T* agg_v = reinterpret_cast<T*>(scratch);
    carry_v = agg_v + (long long)K * tiles;
    uint8_t* agg_f = reinterpret_cast<uint8_t*>(carry_v + (long long)K * tiles);
    tile_reduce<T, K><<<(unsigned)tiles, kThreads, 0, stream>>>(L, flags, n, reverse, tiles, agg_v, agg_f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    carry_scan<T, K><<<1, kCarryThreads, 0, stream>>>(L, tiles, agg_v, agg_f, carry_v);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  tile_scan<T, K><<<(unsigned)tiles, kThreads, 0, stream>>>(L, flags, n, reverse, tiles, carry_v);
  return cudaGetLastError();
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

// Bytes of device scratch that tm_segment_scan needs for k lanes of n rows
// (8-byte lanes when is64): two k x tiles value arrays and one flag byte per tile.
extern "C" long long tm_segment_scan_scratch_bytes(int k, int is64, long long n) {
  const long long tiles = num_tiles(n);
  if (tiles <= 1) return 0;
  return 2LL * k * tiles * (is64 ? 8 : 4) + tiles;
}

// values / outs: host arrays of k device pointers (1-D contiguous lanes of n rows,
// int64 when is64 else int32); ops: host array of k op codes (0 sum, 1 min, 2 max);
// flags: n bytes (non-zero starts a segment) or null for one global segment;
// scratch: tm_segment_scan_scratch_bytes(k, is64, n) bytes. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int tm_segment_scan(int k, const void* const* values, void* const* outs, const int* ops, int is64,
                               const void* flags, long long n, int reverse, void* scratch, void* stream) {
  if (k < 1 || k > kMaxLanes) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < k; ++l)
    if (ops[l] < kSum || ops[l] > kMax) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (num_tiles(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint8_t* f = reinterpret_cast<const uint8_t*>(flags);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = is64 ? launch_k<int64_t>(k, values, outs, ops, f, n, reverse != 0, scratch, s)
                         : launch_k<int32_t>(k, values, outs, ops, f, n, reverse != 0, scratch, s);
  return (int)err;
}
