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
// float32. The output is zeroed by the caller.
//
// Bound: the function reads each id once (4 B) and each mask byte once (1 B),
// 5 B per element in the mask mode of the confusion path; at N = 2^24 that is
// 84 MB, about 25 us at the H100 SXM's 3.35 TB/s. The work per element is one
// compare and one add, far below the card's issue rate, so bytes bound it.
//
// Design, and what it does about atomic contention: the TPU kernel compares
// every input block against a 64-bin tile (O(bins * N) work), because the TPU has
// no fast scattered add. Hopper has shared-memory atomics, so this kernel does
// O(N) work instead. Each block keeps a private histogram in dynamic shared
// memory (num_bins * 4 B, 64 KB at the 2^14-bin maximum), walks the ids in a
// grid-stride loop with one shared-memory atomicAdd per kept id, and at the end
// adds each non-zero bin once into the global output with one global atomicAdd.
// Contention on a hot bin is thus confined to one SM's shared memory, and the
// global traffic is at most grid * num_bins atomics, independent of N. The grid
// is sized to the blocks that fit on the card at once, so the flush costs at most
// one global atomic per bin per resident block. Warp aggregation of equal ids
// and vectorised loads are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_histogram.so histogram.cu
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

enum Mode { kCount = 0, kMask = 1, kWeight = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int32_t* __restrict__ ids, const void* __restrict__ weights,
                 long long n, int num_bins, void* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  using Acc = typename std::conditional<MODE == kWeight, float, int>::type;
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) hist[b] = Acc(0);
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int id = __ldg(ids + i);
    if ((unsigned)id < (unsigned)num_bins) {  // drops negative and >= num_bins ids
      if (MODE == kCount) {
        atomicAdd(reinterpret_cast<int*>(hist) + id, 1);
      } else if (MODE == kMask) {
        if (__ldg(reinterpret_cast<const unsigned char*>(weights) + i))
          atomicAdd(reinterpret_cast<int*>(hist) + id, 1);
      } else {
        atomicAdd(reinterpret_cast<float*>(hist) + id, __ldg(reinterpret_cast<const float*>(weights) + i));
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

template <int MODE>
cudaError_t launch(const int32_t* ids, const void* weights, long long n, int num_bins, void* out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)num_bins * 4;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(histogram_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel<MODE>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(needed < resident ? needed : resident);
  histogram_kernel<MODE><<<grid, kThreads, smem, stream>>>(ids, weights, n, num_bins, out);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 count (weights unused, int32 out), 1 byte mask (int32 out), 2 float32
// weights (float32 out). Returns the CUDA error code of the launch (0 on success).
extern "C" int tm_histogram(const void* ids, const void* weights, int mode, long long n, int num_bins,
                            void* out, void* stream) {
  if (n <= 0 || num_bins <= 0) return (int)cudaSuccess;
  const int32_t* x = reinterpret_cast<const int32_t*>(ids);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kCount: err = launch<kCount>(x, weights, n, num_bins, out, s); break;
    case kMask: err = launch<kMask>(x, weights, n, num_bins, out, s); break;
    case kWeight: err = launch<kWeight>(x, weights, n, num_bins, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
