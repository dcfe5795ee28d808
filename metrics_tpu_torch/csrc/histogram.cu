// Static-length histogram of int32 ids over [0, num_bins), for Hopper (sm_90a).
//
// Replaces: metrics_tpu/ops/histogram.py:_histogram_kernel (launched by
// _pallas_bincount, pl.pallas_call at :142), the Pallas kernel under every
// macro/weighted/none-average stat-scores, confusion-matrix and Jaccard update
// (ops/confmat.py:confusion_counts -> utils/data.py:_bincount_weighted).
//
// Function: out[b] = sum over i with ids[i] == b of w[i], where w is 1 (count
// mode), a 0/1 byte mask (mask mode) or a float32 weight (weight mode). Ids
// outside [0, num_bins) drop. Count and mask modes write int32, weight mode
// float32. tm_histogram zeroes the output itself, on the same stream.
//
// Bound: the function reads each id once (4 B) and each mask byte once (1 B),
// 5 B per element in the mask mode of the confusion path; at N = 2^24 that is
// 84 MB, about 25 us at the H100 SXM's 3.35 TB/s. The work per element is one
// compare and one add, far below the card's issue rate, so bytes bound it.
//
// Design: the TPU kernel compares every input block against a 64-bin tile
// (O(bins * N) work), because the TPU has no fast scattered add. Hopper has
// shared-memory atomics, so this kernel does O(N) work:
//   - each block keeps a private histogram in dynamic shared memory (num_bins *
//     4 B, 64 KB at the 2^14-bin maximum) and at the end adds each non-zero bin
//     once into the output with one global atomic;
//   - each thread takes runs of kRun = 16 consecutive ids in a grid-stride loop and
//     starts all of a run's loads before any atomic: four 16-byte id loads, and one
//     16-byte load of the 16 mask bytes (four of the 16 weights), so many bytes are
//     in flight per thread;
//   - equal neighbouring ids are merged in registers, and each run of equal ids
//     costs one shared-memory atomic (its length, its masked count or its summed
//     weight). Segmentation maps, where neighbouring pixels share their (target,
//     prediction) pair, then take a few atomics per 16 ids instead of 16 that
//     would all hit one address;
//   - the grid (the blocks that fit on the card at once) is computed once per
//     device, mode and bin count and cached, so a launch asks the runtime for
//     nothing but the current device;
//   - the last, ragged run, and ids, masks or weights whose base is not 16-byte
//     aligned (a view such as buf[1:]), take scalar loads inside the same kernel.
//
// Batched mode (tm_histogram_batched): B independent histograms in one launch, the
// counterpart of the Pallas kernel's batching rule (one more grid axis), which the
// fleet's per-row vmap reaches through the custom op's batching rule. Ids (B, k)
// give out (B, num_bins): out[r][b] sums the weights of row r's ids equal to b,
// ids outside [0, num_bins) dropping per row. Count, mask and float32 modes, as above.
//   - The function reads B*k ids (and masks or weights) once and writes B*num_bins
//     outputs once; the output dominates when bins are many (100 rows of 10^6 bins:
//     400 MB, 0.12 ms at 3.35 TB/s), the ids when rows are long.
//   - Rows are independent and B*num_bins may be far above the shared-memory
//     kernel's 2^14 bins (a 1,000-class confusion matrix has 10^6 bins a row), so
//     when B*num_bins > 8,192 each id goes to the output with one global atomic.
//     At most 8,192 bins in all, each block counts into a private shared-memory copy
//     (32 KB, under the 48 KB default) and adds each non-zero bin once at the end.
//   - Neighbouring threads read neighbouring ids (coalesced 128-byte warp loads). In
//     the count and mask modes the lanes of a warp that hit one bin are merged with
//     __match_any_sync and one lane adds their number, so a row of few bins (16 rows
//     of 4) costs a few atomics a warp instead of 32 on one address.
//   - The grid is capped at a few blocks per SM (the SM count is read once per
//     device), so nothing is asked of the runtime per launch but the current device;
//     the output is zeroed with one memset on the same stream. Both are captured by a
//     CUDA graph once a first eager call has filled the cache.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_histogram.so histogram.cu
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;          // consecutive ids per thread and turn
constexpr int kMaxBins = 1 << 14;  // 64 KB of shared memory per block

enum Mode { kCount = 0, kMask = 1, kWeight = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int32_t* __restrict__ ids, const void* __restrict__ weights, long long n, int num_bins,
                 bool aligned, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Acc = typename std::conditional<MODE == kWeight, float, int>::type;
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) hist[b] = Acc(0);
  __syncthreads();

  const uint8_t* mask = reinterpret_cast<const uint8_t*>(weights);
  const float* wf = reinterpret_cast<const float*>(weights);
  const long long runs = (n + kRun - 1) / kRun;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < runs; r += stride) {
    const long long i0 = r * kRun;
    int id[kRun];
    Acc w[kRun];
    if (aligned && i0 + kRun <= n) {
      const int4* p = reinterpret_cast<const int4*>(ids + i0);
      int4 q[kRun / 4];
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) q[k] = __ldg(p + k);
      if (MODE == kMask) {
        const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask + i0));
        const unsigned mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int k = 0; k < kRun; ++k) w[k] = Acc(((mw[k / 4] >> (8 * (k % 4))) & 0xffu) != 0);
      } else if (MODE == kWeight) {
#pragma unroll
        for (int k = 0; k < kRun / 4; ++k) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(wf + i0) + k);
          w[4 * k] = x.x;
          w[4 * k + 1] = x.y;
          w[4 * k + 2] = x.z;
          w[4 * k + 3] = x.w;
        }
      }
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) {
        id[4 * k] = q[k].x;
        id[4 * k + 1] = q[k].y;
        id[4 * k + 2] = q[k].z;
        id[4 * k + 3] = q[k].w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const bool in = i0 + k < n;
        id[k] = in ? __ldg(ids + i0 + k) : -1;  // past the end: an id that drops
        if (MODE == kMask) w[k] = Acc(in && __ldg(mask + i0 + k) != 0);
        if (MODE == kWeight) w[k] = in ? __ldg(wf + i0 + k) : 0.0f;
      }
    }
    // one atomic per run of equal ids
    Acc run = Acc(0);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      run += MODE == kCount ? Acc(1) : w[k];
      if (k == kRun - 1 || id[k + 1] != id[k]) {
        if ((unsigned)id[k] < (unsigned)num_bins && run != Acc(0)) atomicAdd(hist + id[k], run);
        run = Acc(0);
      }
    }
  }
  __syncthreads();

  Acc* gout = reinterpret_cast<Acc*>(out);
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    const Acc v = hist[b];
    if (v != Acc(0)) atomicAdd(gout + b, v);
  }
}

std::mutex g_grid_mutex;
std::unordered_map<long long, int> g_grid;  // (device, mode, bins) -> resident blocks

// The blocks of histogram_kernel<MODE> that fit on the device at once with
// num_bins bins of shared memory; asks the runtime only the first time.
template <int MODE>
cudaError_t resident_blocks(int device, int num_bins, int* blocks) {
  const long long key = ((long long)device << 32) | ((long long)MODE << 20) | num_bins;
  std::lock_guard<std::mutex> lock(g_grid_mutex);
  auto it = g_grid.find(key);
  if (it != g_grid.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  const size_t smem = (size_t)num_bins * 4;
  cudaError_t err;
  if (smem > 48 * 1024) {
    // The limit belongs to the kernel, not to this bin count: raise it to what the
    // largest histogram needs, so that no later bin count lowers it under an earlier
    // one whose grid is already cached.
    err = cudaFuncSetAttribute(histogram_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBins * 4);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel<MODE>, kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm < 1 ? 1 : per_sm);
  g_grid.emplace(key, *blocks);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int MODE>
cudaError_t launch(const int32_t* ids, const void* weights, long long n, int num_bins, void* out,
                   cudaStream_t stream) {
  int device = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = resident_blocks<MODE>(device, num_bins, &resident)) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(out, 0, (size_t)num_bins * 4, stream)) != cudaSuccess) return err;
  const long long runs = (n + kRun - 1) / kRun;
  const long long needed = (runs + kThreads - 1) / kThreads;
  const int grid = (int)(needed < resident ? needed : resident);
  const bool aligned = aligned16(ids) && (MODE == kCount || aligned16(weights));
  histogram_kernel<MODE><<<grid, kThreads, (size_t)num_bins * 4, stream>>>(ids, weights, n, num_bins, aligned, out);
  return cudaGetLastError();
}

constexpr int kBatchedSmemBins = 1 << 13;  // 32 KB: no opt-in to more shared memory

template <int MODE, bool SMEM>
__global__ void __launch_bounds__(kThreads)
histogram_batched_kernel(const int32_t* __restrict__ ids, const void* __restrict__ weights, long long n,
                         unsigned row_len, int num_bins, int total_bins, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Acc = typename std::conditional<MODE == kWeight, float, int>::type;
  Acc* hist = SMEM ? reinterpret_cast<Acc*>(smem_raw) : reinterpret_cast<Acc*>(out);
  if (SMEM) {
    for (int b = threadIdx.x; b < total_bins; b += blockDim.x) hist[b] = Acc(0);
    __syncthreads();
  }
  const uint8_t* mask = reinterpret_cast<const uint8_t*>(weights);
  const float* wf = reinterpret_cast<const float*>(weights);
  const unsigned lane = threadIdx.x & 31u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound depends on the warp's first index only: all 32 lanes take every turn
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31u); base < n; base += stride) {
    const long long i = base + lane;
    int key = -1;
    Acc w = Acc(0);
    if (i < n) {
      const int id = __ldg(ids + i);
      bool keep = (unsigned)id < (unsigned)num_bins;
      if (MODE == kMask) keep = keep && __ldg(mask + i) != 0;
      if (MODE == kWeight) w = __ldg(wf + i);
      // n < 2^31, so 32-bit division; row * num_bins + id < total_bins < 2^31
      if (keep) key = (int)((unsigned)i / row_len) * num_bins + id;
    }
    if (MODE == kWeight) {
      if (key >= 0 && w != 0.0f) atomicAdd(hist + key, w);
    } else {
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == (unsigned)(__ffs(peers) - 1)) atomicAdd(hist + key, (Acc)__popc(peers));
    }
  }
  if (SMEM) {
    __syncthreads();
    Acc* gout = reinterpret_cast<Acc*>(out);
    for (int b = threadIdx.x; b < total_bins; b += blockDim.x) {
      const Acc v = hist[b];
      if (v != Acc(0)) atomicAdd(gout + b, v);
    }
  }
}

std::unordered_map<int, int> g_sms;  // device -> SM count, under g_grid_mutex

cudaError_t sm_count(int device, int* sms) {
  std::lock_guard<std::mutex> lock(g_grid_mutex);
  auto it = g_sms.find(device);
  if (it != g_sms.end()) {
    *sms = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) g_sms.emplace(device, *sms);
  return err;
}

template <int MODE>
cudaError_t launch_batched(const int32_t* ids, const void* weights, long long n, unsigned row_len, int num_bins,
                           int total_bins, void* out, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = sm_count(device, &sms)) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(out, 0, (size_t)total_bins * 4, stream)) != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const long long warps_needed = (n + 31) / 32;
  if (total_bins <= kBatchedSmemBins) {
    // each thread takes at least 16 ids, so the per-block flush stays small beside them
    long long grid = (n + (long long)kThreads * 16 - 1) / ((long long)kThreads * 16);
    if (grid > 2LL * sms) grid = 2LL * sms;
    histogram_batched_kernel<MODE, true><<<(int)grid, kThreads, (size_t)total_bins * 4, stream>>>(
        ids, weights, n, row_len, num_bins, total_bins, out);
  } else {
    long long grid = (warps_needed * 32 + kThreads - 1) / kThreads;
    if (grid > 8LL * sms) grid = 8LL * sms;
    histogram_batched_kernel<MODE, false><<<(int)grid, kThreads, 0, stream>>>(ids, weights, n, row_len, num_bins,
                                                                              total_bins, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Batched mode: ids (rows, row_len), row-major and contiguous, n = rows * row_len
// ids in all; out (rows, num_bins), zeroed here. mode as for tm_histogram. rows *
// num_bins and n must each be below 2^31. Returns the CUDA error code (0 on success).
extern "C" int tm_histogram_batched(const void* ids, const void* weights, int mode, long long n, long long row_len,
                                    long long rows, int num_bins, void* out, void* stream) {
  if (rows <= 0 || num_bins <= 0) return (int)cudaSuccess;
  const long long total = rows * (long long)num_bins;
  if (total > 0x7fffffffLL || n > 0x7fffffffLL || n != rows * row_len) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* x = reinterpret_cast<const int32_t*>(ids);
  const unsigned len = row_len > 0 ? (unsigned)row_len : 1u;
  cudaError_t err;
  switch (mode) {
    case kCount: err = launch_batched<kCount>(x, weights, n, len, num_bins, (int)total, out, s); break;
    case kMask: err = launch_batched<kMask>(x, weights, n, len, num_bins, (int)total, out, s); break;
    case kWeight: err = launch_batched<kWeight>(x, weights, n, len, num_bins, (int)total, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// mode: 0 count (weights unused, int32 out), 1 byte mask (int32 out), 2 float32
// weights (float32 out). Zeroes `out` (num_bins values, at most 2^14) and adds into
// it, on `stream`. Returns the CUDA error code of the memset and launch (0 on success).
extern "C" int tm_histogram(const void* ids, const void* weights, int mode, long long n, int num_bins,
                            void* out, void* stream) {
  if (num_bins <= 0) return (int)cudaSuccess;
  if (num_bins > kMaxBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)num_bins * 4, s);
  const int32_t* x = reinterpret_cast<const int32_t*>(ids);
  cudaError_t err;
  switch (mode) {
    case kCount: err = launch<kCount>(x, weights, n, num_bins, out, s); break;
    case kMask: err = launch<kMask>(x, weights, n, num_bins, out, s); break;
    case kWeight: err = launch<kWeight>(x, weights, n, num_bins, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
