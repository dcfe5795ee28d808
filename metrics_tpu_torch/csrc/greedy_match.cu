// Greedy COCO matching of score-sorted detections to ground truths, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. It is the counterpart of the on-device lax.scan of
// metrics_tpu/functional/detection/_mean_ap_kernel.py:_per_group_from_iou (:26),
// vmapped over area ranges and groups by _match_groups_core (:65), _match_groups
// (:88) and _match_groups_from_iou (:92): the one sequential step of mAP.
//
// Function, for each group n, area range a and IoU threshold t:
//   - IoU entries of an invalid detection or ground truth count as 0;
//   - a ground truth is ignored when it is invalid or its area lies outside
//     [lo, hi]; ignored and already matched ground truths are never matched;
//   - detections are visited in order (rows are score-sorted by the caller); each
//     valid one takes the first ground truth of largest IoU among the others (the
//     order of lax.scan's permuted row: the in-range valid gts first, in their own
//     order), and is matched when that IoU is strictly above the threshold;
//   - an unmatched detection whose area lies outside [lo, hi] is ignored, and an
//     invalid one always is; npig[n, a] counts the valid in-range ground truths.
// Ignored ground truths score 0 in the JAX scan, so its "first maximum in the
// permuted order" is the first maximum among the free in-range gts in their own
// order; when every free IoU is 0 (or none is free) the scan's argmax is the
// permuted row's first slot (the first gt of least key ignored_area + 2 * invalid),
// which only matters for a threshold below 0. A NaN IoU among the free gts is the
// scan's maximum and is never above a threshold: that detection stays unmatched.
// Every step is a comparison, so the masks equal the scan's bit for bit.
//
// Bound: the function reads the IoU (N*D*G floats), the areas and valid masks, and
// writes two (N, A, T, D) byte masks and npig; at the COCO 2017 val small bucket
// (N = 400,000 groups of 16 x 16, A = 4, T = 10) that is ~1 GB, ~0.3 ms at
// 3.35 TB/s. The comparisons (N*A*T*D*G at most) are far below the instruction rate.
//
// Design: one thread per (n, a, t) walks the D detections in order, its set of
// removed (ignored or matched) gts a bitmask in shared memory, word w of thread i
// at w * blockDim + i (no bank conflicts); each step visits only the free gts of
// the bitmask (__ffs), so empty and small groups cost little. The T threads of a
// group read the same IoU rows (L1 broadcasts them), each writes its own D
// consecutive bytes of the outputs. Supports 1 <= G <= kMaxG.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_greedy_match.so greedy_match.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxG = 4096;  // 128 words a thread: 32 KB of shared memory per block

__global__ void __launch_bounds__(kThreads)
greedy_match_kernel(const float* __restrict__ iou, const float* __restrict__ d_area,
                    const float* __restrict__ g_area, const uint8_t* __restrict__ det_valid,
                    const uint8_t* __restrict__ gt_valid, const float* __restrict__ thresholds,
                    const float* __restrict__ ranges, long long n_groups, int D, int G, int T, int A,
                    uint8_t* __restrict__ matched_out, uint8_t* __restrict__ ignored_out,
                    int32_t* __restrict__ npig) {
  extern __shared__ uint32_t removed_all[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_groups * A * T) return;
  const int t = (int)(i % T);
  const long long na = i / T;
  const int a = (int)(na % A);
  const long long n = na / A;
  const float lo = ranges[2 * a], hi = ranges[2 * a + 1];
  const float thr = thresholds[t];
  const int words = (G + 31) >> 5;
  uint32_t* removed = removed_all + threadIdx.x;
  const int stride = blockDim.x;

  const uint8_t* gv = gt_valid + n * G;
  const float* ga = g_area + n * G;
  int first = 0, first_key = 4, in_range = 0;
  for (int w = 0; w < words; ++w) {
    uint32_t word = 0;
    for (int b = 0; b < 32; ++b) {
      const int g = (w << 5) + b;
      if (g >= G) {
        word |= 1u << b;
        continue;
      }
      const bool valid = gv[g] != 0;
      const bool outside = ga[g] < lo || ga[g] > hi;
      if (!valid || outside) {
        word |= 1u << b;
      } else {
        ++in_range;
      }
      const int key = (int)outside + 2 * (int)!valid;
      if (key < first_key) {
        first_key = key;
        first = g;
      }
    }
    removed[w * stride] = word;
  }
  if (t == 0) npig[na] = in_range;

  const uint8_t* dv = det_valid + n * D;
  const float* da = d_area + n * D;
  uint8_t* m_out = matched_out + i * D;
  uint8_t* i_out = ignored_out + i * D;
  for (int d = 0; d < D; ++d) {
    const bool valid_d = dv[d] != 0;
    bool matched = false;
    if (valid_d) {
      const float* row = iou + (n * D + d) * G;
      float best = 0.0f;
      int arg = -1;
      bool nan = false;
      for (int w = 0; w < words && !nan; ++w) {
        uint32_t free = ~removed[w * stride];
        while (free) {
          const int g = (w << 5) + __ffs(free) - 1;
          free &= free - 1;
          const float v = row[g];
          if (v != v) {
            nan = true;
            break;
          }
          if (v > best) {
            best = v;
            arg = g;
          }
        }
      }
      if (!nan) {
        if (arg < 0) arg = first;  // every free IoU is 0: the scan's argmax is slot 0
        matched = best > thr;
        if (matched) removed[(arg >> 5) * stride] |= 1u << (arg & 31);
      }
    }
    const bool outside = da[d] < lo || da[d] > hi;
    m_out[d] = matched;
    i_out[d] = (!matched && outside) || !valid_d;
  }
}

}  // namespace

extern "C" int tm_greedy_match(const void* iou, const void* d_area, const void* g_area, const void* det_valid,
                               const void* gt_valid, const void* thresholds, const void* ranges, long long n,
                               int d, int g, int t, int a, void* matched, void* ignored, void* npig, void* stream) {
  if (n < 0 || d < 0 || g < 1 || g > kMaxG || t < 1 || a < 1) return (int)cudaErrorInvalidValue;
  const long long threads = n * a * t;
  if (threads == 0) return (int)cudaSuccess;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kThreads * ((g + 31) >> 5) * sizeof(uint32_t);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  greedy_match_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      reinterpret_cast<const float*>(iou), reinterpret_cast<const float*>(d_area),
      reinterpret_cast<const float*>(g_area), reinterpret_cast<const uint8_t*>(det_valid),
      reinterpret_cast<const uint8_t*>(gt_valid), reinterpret_cast<const float*>(thresholds),
      reinterpret_cast<const float*>(ranges), n, d, g, t, a, reinterpret_cast<uint8_t*>(matched),
      reinterpret_cast<uint8_t*>(ignored), reinterpret_cast<int32_t*>(npig));
  return (int)cudaGetLastError();
}
