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
// Bound: the function reads the IoU of the valid (detection, gt) pairs, the areas
// and valid masks, and writes two (N, A, T, D) byte masks and npig. At the COCO 2017
// val small bucket (N = 400,000 groups of 16 x 16, A = 4, T = 10) the masks are
// 512 MB of the ~583 MB it must move: ~0.17 ms at 3.35 TB/s. The comparisons are
// few; what the card spends beyond the stores is instruction issue and latency of
// the per-group pass and the walk.
//
// Design: two variants behind one C entry, which picks one per call.
//   narrow (G <= 64, D <= 128, A * T < 2^15, and enough triples: narrow_min_triples):
//     one thread per (n, a, t), 256 a block. The block first computes, one warp per
//     group (every load issued first: one round trip to memory) and by ballots for
//     each area range, each (group, area range) pair's removed set (ignored gts and
//     padding), npig, first slot, and the bits of its valid and out-of-range
//     detections, into shared memory: once per pair, not once per threshold. Where
//     G and D fit in 16 lanes a warp takes two area ranges at once (H = 2), which
//     halves that pass. Each thread then keeps its removed set in one 64-bit
//     register, visits only the valid detections (__ffs over the bits; once no gt
//     is free the rest are settled at once), and reads a row's free gts as 16-byte
//     loads, skipping any four that are all removed. Results stay bits until each
//     run of 16 detections is expanded to bytes: at D = 16 one 16-byte store a
//     thread, a warp's 512 consecutive bytes; otherwise staged in shared memory,
//     and the block writes its contiguous output range with 16-byte streaming
//     stores (bytes for a misaligned tail).
//   warp (the rest: wide groups, long rows, or too few triples to fill 132 SMs):
//     one warp per (n, a, t). Lane l owns gts l, l + 32, ...; its share of the
//     removed set is ceil(G / 32) bits in LW registers (LW = 1, 2 or 4: G <= 4096).
//     Per valid detection each lane forms its (value, index) best over its free gts
//     with coalesced loads (the first four of them prefetched while the previous
//     detection reduces), the warp reduces with __shfl_xor_sync ordering by larger
//     value then smaller index (the first-maximum rule), __any_sync carries the NaN
//     rule, and the owning lane sets the winner's bit. Each 32 detections end in one
//     coalesced 32-byte store per output.
// What the card said (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has the numbers): a
// thread per (group, area range) walking the T thresholds in turn, its stores
// strided by T * D, was 2.8 times slower than the narrow variant at the small
// bucket; a persistent grid that loads the next tile's groups during a tile's walk
// was slower (60 registers: fewer blocks); fewer registers by launch bounds spilled
// and gained under 8%.
// Crossover, from the variant sweep of scripts/torch_kernel_ab.py (synthetic
// N x 16 x G inputs, ms of one call, narrow / warp, same card): G = 16 at 5,120
// triples 0.0327 / 0.0309, at 20,480 0.0327 / 0.0720; G = 32 at 5,120 0.0467 /
// 0.0326, at 20,480 0.0462 / 0.0752; G = 64 at 20,480 0.0812 / 0.0779, at 40,960
// 0.0832 / 0.1405. So the narrow variant from 16,384 triples where G <= 32 and from
// 32,768 where G <= 64; at the COCO shapes 0.409 / 8.70 ms (400,000 x 16 x 16),
// 1.129 / 12.88 (524,288 x 64 x 64) and 0.125 / 0.0305 (32 x 64 x 64).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_greedy_match.so greedy_match.cu
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 4096;
constexpr int kNarrowThreads = 256;
constexpr int kNarrowMaxG = 64;
constexpr int kNarrowMaxD = 128;
constexpr int kNarrowDW = kNarrowMaxD / 32;  // detection words of a pair
constexpr int kNarrowMaxSmem = 96 * 1024;
constexpr int kWarpThreads = 128;  // four (n, a, t) warps a block
constexpr int kPrefetch = 4;       // gts a lane prefetches of the next valid row
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* iou;
  const float* d_area;
  const float* g_area;
  const uint8_t* det_valid;
  const uint8_t* gt_valid;
  const float* thresholds;
  const float* ranges;
  long long n;
  int D, G, T, A;
  uint8_t* matched;
  uint8_t* ignored;
  int32_t* npig;
  uint32_t at_magic, t_magic;  // for div16 by A * T and by T
};

__device__ __forceinline__ bool outside(float area, float lo, float hi) { return area < lo || area > hi; }

// four bits to four bytes of 0 or 1, bit k into byte k
__device__ __forceinline__ uint32_t expand4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// bits 0..nb-1 as nb bytes at dst (a stage, or the output where D = 16); nb is a
// multiple of 16 (4) where D is, and dst is then 16- (4-) byte aligned
__device__ __forceinline__ void stage_bits(uint8_t* dst, uint32_t bits, int nb, int D) {
  if ((D & 15) == 0) {
    for (int k = 0; k < nb; k += 16)
      *reinterpret_cast<uint4*>(dst + k) = make_uint4(expand4(bits >> k), expand4(bits >> (k + 4)),
                                                      expand4(bits >> (k + 8)), expand4(bits >> (k + 12)));
  } else if ((D & 3) == 0) {
    for (int k = 0; k < nb; k += 4) *reinterpret_cast<uint32_t*>(dst + k) = expand4(bits >> k);
  } else {
    for (int k = 0; k < nb; ++k) dst[k] = (bits >> k) & 1u;
  }
}

__device__ __forceinline__ void copy_out(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src, long long bytes) {
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const long long vecs = bytes >> 4;
    for (long long c = threadIdx.x; c < vecs; c += blockDim.x)
      __stcs(reinterpret_cast<uint4*>(dst) + c, reinterpret_cast<const uint4*>(src)[c]);
    done = vecs << 4;
  }
  for (long long b = done + threadIdx.x; b < bytes; b += blockDim.x) dst[b] = src[b];
}

// ---- narrow: one thread per (n, a, t), removed set in one register ------------------

// n / d for n, d < 2^16, with m = 2^32 / d + 1 (d > 1): n * m / 2^32 exceeds n / d by
// less than 2^-16 <= 1 / d, too little to reach the next integer
__device__ __forceinline__ int div16(int n, int d, uint32_t m) { return d == 1 ? n : (int)__umulhi((uint32_t)n, m); }

// W: mask words (G <= 32 * W). H: area ranges a warp takes at once in the per-pair
// pass, 2 where G and D fit in 16 lanes
template <int W, int H>
__global__ void __launch_bounds__(kNarrowThreads) greedy_match_narrow(Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = p.D, G = p.G, T = p.T, A = p.A;
  const long long total = p.n * A * T;
  const long long i0 = (long long)blockIdx.x * kNarrowThreads;
  const int count = (int)min((long long)kNarrowThreads, total - i0);
  const int AT = A * T;
  // 64-bit division is a long emulated sequence: one, uniform, where 32 bits do not do
  const long long n0 = total <= INT_MAX ? (long long)((int)i0 / AT) : i0 / AT;
  const int r0 = (int)(i0 - n0 * AT);  // the block's first triple within group n0
  const int groups = div16(r0 + count - 1, AT, p.at_magic) + 1;
  const int DW = (D + 31) >> 5;
  const int stride = W + 1 + 2 * DW;  // per pair: removed[W], first, valid bits[DW], outside bits[DW]
  const int stage = ((kNarrowThreads * D) + 15) & ~15;
  // D = 16: a thread's results are one 16-byte store, a warp's 512 consecutive bytes,
  // so they go straight to the outputs; otherwise through the stages
  const bool direct = D == 16 && ((reinterpret_cast<uintptr_t>(p.matched) | reinterpret_cast<uintptr_t>(p.ignored)) & 15) == 0;
  uint8_t* stage_m = smem;
  uint8_t* stage_i = smem + stage;
  uint32_t* info_all = reinterpret_cast<uint32_t*>(smem + 2 * stage);
  constexpr int kLanes = 32 / H;  // lanes of one area range
  const int lane = threadIdx.x & 31, sub = lane / kLanes, li = lane % kLanes;
  const uint32_t half = H == 1 ? kFull : 0xFFFFu;

  // per group, one warp each, every load first (one round trip to memory): then per
  // area range the pair's removed set, npig, first slot and detection bits, by ballots
  for (int j = threadIdx.x >> 5; j < groups; j += kNarrowThreads / 32) {
    const long long n = n0 + j;
    bool g_valid[W], d_valid[kNarrowDW];
    float g_ar[W], d_ar[kNarrowDW];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int g = (w << 5) + li;
      g_valid[w] = g < G && p.gt_valid[n * G + g] != 0;
      g_ar[w] = g < G ? p.g_area[n * G + g] : 0.0f;
    }
#pragma unroll
    for (int w = 0; w < kNarrowDW; ++w) {
      const int d = (w << 5) + li;
      d_valid[w] = d < D && p.det_valid[n * D + d] != 0;
      d_ar[w] = d < D ? p.d_area[n * D + d] : 0.0f;
    }
    uint32_t vb[kNarrowDW];
#pragma unroll
    for (int w = 0; w < kNarrowDW; ++w) vb[w] = w < DW ? (__ballot_sync(kFull, d_valid[w]) & half) : 0u;
    for (int a0 = 0; a0 < A; a0 += H) {
      const int a = a0 + sub;
      const bool on = a < A;
      const float lo = on ? p.ranges[2 * a] : 0.0f, hi = on ? p.ranges[2 * a + 1] : 0.0f;
      // the gts by key ignored_area + 2 * invalid: key 0 are the kept ones; the first
      // slot is the first gt of the least key present, one reduction over the lanes
      uint32_t kept[W];
      int code = INT_MAX;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int g = (w << 5) + li;
        const bool out = outside(g_ar[w], lo, hi);
        kept[w] = (__ballot_sync(kFull, g_valid[w] && !out) >> (sub * kLanes)) & half;
        if (g < G) code = min(code, ((int)out + 2 * (int)!g_valid[w]) * kMaxG + g);
      }
      if (H == 1) {
        code = __reduce_min_sync(kFull, code);
      } else {
        for (int off = kLanes / 2; off; off >>= 1) code = min(code, __shfl_xor_sync(kFull, code, off));
      }
      uint32_t* info = info_all + (j * A + a) * stride;
#pragma unroll
      for (int w = 0; w < kNarrowDW; ++w) {
        if (w < DW) {
          const uint32_t ob = __ballot_sync(kFull, ((w << 5) + li) < D && outside(d_ar[w], lo, hi));
          if (li == 0 && on) {
            info[W + 1 + w] = vb[w];
            info[W + 1 + DW + w] = (ob >> (sub * kLanes)) & half;
          }
        }
      }
      if (li == 0 && on) {
        int in_range = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          info[w] = ~kept[w];  // with H == 2, bits 16..31 (gts past G <= 16) are set
          in_range += __popc(kept[w]);
        }
        info[W] = (uint32_t)(code % kMaxG);
        const int first_thread = j * AT + a * T - r0;  // the block's thread of (n, a, 0) writes npig
        if (first_thread >= 0 && first_thread < count) p.npig[n * A + a] = in_range;
      }
    }
  }
  __syncthreads();

  if ((int)threadIdx.x < count) {
    const int r = r0 + threadIdx.x;
    const int j = div16(r, AT, p.at_magic);
    const int a = div16(r - j * AT, T, p.t_magic);
    const int t = r - j * AT - a * T;
    const long long n = n0 + j;
    const uint32_t* info = info_all + (j * A + a) * stride;
    // bit g: gt g ignored, padding or matched
    uint64_t removed = info[0] | (W == 2 ? (uint64_t)info[1] << 32 : ~0ull << 32);
    const int first = (int)info[W];
    const float thr = p.thresholds[t];
    const float* base = p.iou + n * D * G;
    const bool vec = (G & 3) == 0 && (reinterpret_cast<uintptr_t>(p.iou) & 15) == 0;
    uint8_t* sm = direct ? p.matched + (i0 + threadIdx.x) * D : stage_m + threadIdx.x * D;
    uint8_t* si = direct ? p.ignored + (i0 + threadIdx.x) * D : stage_i + threadIdx.x * D;
    for (int w = 0; w < DW; ++w) {
      const int d0 = w << 5;
      const uint32_t vb = info[W + 1 + w], ob = info[W + 1 + DW + w];
      uint32_t rem = vb, mword = 0;
      while (rem) {
        if (removed == ~0ull) {  // no free gt: each valid detection left takes slot 0, matched below 0
          if (0.0f > thr) mword |= rem;
          break;
        }
        const int b = __ffs(rem) - 1;
        rem &= rem - 1;
        const float* row = base + (long long)(d0 + b) * G;
        const uint64_t fr = ~removed;
        float best = 0.0f;
        int arg = -1;
        bool nan = false;
#pragma unroll
        for (int q = 0; q < 8 * W; ++q) {
          const uint32_t nib = (uint32_t)(fr >> (4 * q)) & 0xFu;  // padding gts are removed: nib == 0 past G
          if (nib) {
            const int g4 = 4 * q;
            float v[4];
            if (vec) {
              const float4 x = __ldg(reinterpret_cast<const float4*>(row + g4));
              v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) v[j] = (nib >> j) & 1u ? __ldg(row + g4 + j) : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if ((nib >> j) & 1u) {
                nan |= v[j] != v[j];
                if (v[j] > best) {
                  best = v[j];
                  arg = g4 + j;
                }
              }
            }
          }
        }
        if (!nan) {
          if (arg < 0) arg = first;  // every free IoU is 0: the scan's argmax is slot 0
          if (best > thr) {
            mword |= 1u << b;
            removed |= 1ull << arg;
          }
        }
      }
      const int nb = min(32, D - d0);
      stage_bits(sm + d0, mword, nb, D);
      stage_bits(si + d0, ~vb | (~mword & ob), nb, D);
    }
  }
  if (direct) return;
  __syncthreads();
  const long long bytes = (long long)count * D;
  copy_out(p.matched + i0 * D, stage_m, bytes);
  copy_out(p.ignored + i0 * D, stage_i, bytes);
}

// ---- warp: one warp per (n, a, t), lane l owns gts l, l + 32, ... --------------------

__device__ __forceinline__ void fetch_row(const float* __restrict__ row, int lane, int G, float (&dst)[kPrefetch]) {
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int g = lane + 32 * k;
    dst[k] = g < G ? __ldg(row + g) : 0.0f;
  }
}

template <int LW>
__global__ void __launch_bounds__(kWarpThreads) greedy_match_warp(Args p) {
  const int D = p.D, G = p.G, T = p.T, A = p.A;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  const long long total = p.n * A * T;
  if (i >= total) return;  // whole warps only
  const long long na = total <= INT_MAX ? (long long)((int)i / T) : i / T;  // 64-bit division only where needed
  const int t = (int)(i - na * T);
  const long long n = total <= INT_MAX ? (long long)((int)na / A) : na / A;
  const int a = (int)(na - n * A);
  const float lo = p.ranges[2 * a], hi = p.ranges[2 * a + 1];
  const float thr = p.thresholds[t];

  // the lane's share of the removed set: bit b of word w is gt lane + 32 * (32 * w + b)
  uint32_t removed[LW];
  int in_range = 0, first_code = INT_MAX;
#pragma unroll
  for (int w = 0; w < LW; ++w) {
    uint32_t word = kFull;
    for (int b = 0; b < 32; ++b) {
      const int g = lane + 32 * ((w << 5) + b);
      if (g >= G) break;
      const bool valid = p.gt_valid[n * G + g] != 0;
      const bool out = outside(p.g_area[n * G + g], lo, hi);
      if (valid && !out) {
        word &= ~(1u << b);
        ++in_range;
      }
      first_code = min(first_code, ((int)out + 2 * (int)!valid) * kMaxG + g);
    }
    removed[w] = word;
  }
  for (int off = 16; off; off >>= 1) {
    in_range += __shfl_xor_sync(kFull, in_range, off);
    first_code = min(first_code, __shfl_xor_sync(kFull, first_code, off));
  }
  const int first = first_code % kMaxG;
  if (t == 0 && lane == 0) p.npig[na] = in_range;

  const float* base = p.iou + n * D * G;
  const uint8_t* dv = p.det_valid + n * D;
  const float* da = p.d_area + n * D;
  uint8_t* m_out = p.matched + i * D;
  uint8_t* i_out = p.ignored + i * D;
  float cur[kPrefetch], nxt[kPrefetch];
  int pending = -1;  // the detection whose row nxt holds
  uint32_t vb_next = __ballot_sync(kFull, lane < D && dv[lane] != 0);
  uint32_t ob_next = __ballot_sync(kFull, lane < D && outside(da[lane], lo, hi));
  if (vb_next) {
    pending = __ffs(vb_next) - 1;
    fetch_row(base + (long long)pending * G, lane, G, nxt);
  }
  for (int d0 = 0; d0 < D; d0 += 32) {
    const uint32_t vb = vb_next, ob = ob_next;
    const int dn = d0 + 32 + lane;
    vb_next = __ballot_sync(kFull, dn < D && dv[dn] != 0);
    ob_next = __ballot_sync(kFull, dn < D && outside(da[dn], lo, hi));
    uint32_t rem = vb, mword = 0;
    while (rem) {  // the same bits in every lane: the walk is uniform
      const int b = __ffs(rem) - 1;
      rem &= rem - 1;
      const int d = d0 + b;
      const float* row = base + (long long)d * G;
      if (pending != d) fetch_row(row, lane, G, nxt);
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) cur[k] = nxt[k];
      pending = rem ? d0 + __ffs(rem) - 1 : (vb_next ? d0 + 32 + __ffs(vb_next) - 1 : -1);
      if (pending >= 0) fetch_row(base + (long long)pending * G, lane, G, nxt);

      float best = 0.0f;
      int arg = INT_MAX;  // none: loses to every IoU above 0
      bool nan = false;
      const uint32_t fr0 = ~removed[0];
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        if ((fr0 >> k) & 1u) {
          nan |= cur[k] != cur[k];
          if (cur[k] > best) {
            best = cur[k];
            arg = lane + 32 * k;
          }
        }
      }
#pragma unroll
      for (int w = 0; w < LW; ++w) {
        uint32_t fr = ~removed[w];
        if (w == 0) fr &= ~((1u << kPrefetch) - 1u);
        while (fr) {
          const int k = (w << 5) + __ffs(fr) - 1;
          fr &= fr - 1;
          const float v = __ldg(row + lane + 32 * k);
          nan |= v != v;
          if (v > best) {
            best = v;
            arg = lane + 32 * k;
          }
        }
      }
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oa = __shfl_xor_sync(kFull, arg, off);
        if (ov > best || (ov == best && oa < arg)) {
          best = ov;
          arg = oa;
        }
      }
      if (!__any_sync(kFull, nan)) {
        if (arg == INT_MAX) arg = first;  // every free IoU is 0: the scan's argmax is slot 0
        if (best > thr) {
          mword |= 1u << b;
          if ((arg & 31) == lane) {
            const int k = arg >> 5;
#pragma unroll
            for (int w = 0; w < LW; ++w)
              if ((k >> 5) == w) removed[w] |= 1u << (k & 31);
          }
        }
      }
    }
    const int d = d0 + lane;
    if (d < D) {
      const bool m = (mword >> lane) & 1u;
      m_out[d] = m;
      i_out[d] = !((vb >> lane) & 1u) || (!m && ((ob >> lane) & 1u));
    }
  }
}

// the multiplier of div16 for divisor d < 2^16
uint32_t magic(long long d) { return d > 1 && d < 65536 ? (uint32_t)((1ull << 32) / (unsigned long long)d + 1) : 0u; }

// the fewest (n, a, t) triples for which the narrow variant beats the warp one (header)
long long narrow_min_triples(int g) { return g <= 32 ? 16384 : 32768; }

size_t narrow_smem(long long n, int d, int g, int t, int a) {
  const long long at = (long long)a * t;
  const long long groups = n < (kNarrowThreads - 1) / at + 2 ? n : (kNarrowThreads - 1) / at + 2;
  const int words = g <= 32 ? 1 : 2;
  const size_t stage = ((size_t)kNarrowThreads * d + 15) & ~(size_t)15;
  return 2 * stage + (size_t)groups * a * (words + 1 + 2 * ((d + 31) >> 5)) * sizeof(uint32_t);
}

// above 48 KB of dynamic shared memory (D > 64) the kernel's limit is raised first,
// on the current device, to the most any launch may ask for
template <int W, int H>
cudaError_t launch_narrow(long long blocks, size_t smem, cudaStream_t s, const Args& args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(greedy_match_narrow<W, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, kNarrowMaxSmem);
    if (err != cudaSuccess) return err;
  }
  greedy_match_narrow<W, H><<<(unsigned)blocks, kNarrowThreads, smem, s>>>(args);
  return cudaSuccess;
}

}  // namespace

// variant: -1 picks (as tm_greedy_match does), 0 asks for the narrow kernel, 1 for the
// warp kernel; the variant sweep of scripts/torch_kernel_ab.py calls it with 0 and 1
extern "C" int tm_greedy_match_variant(const void* iou, const void* d_area, const void* g_area, const void* det_valid,
                                       const void* gt_valid, const void* thresholds, const void* ranges, long long n,
                                       int d, int g, int t, int a, void* matched, void* ignored, void* npig,
                                       void* stream, int variant) {
  if (n < 0 || d < 0 || g < 1 || g > kMaxG || t < 1 || a < 1 || variant < -1 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const long long triples = n * a * t;
  if (triples == 0) return (int)cudaSuccess;
  const size_t smem = narrow_smem(n, d, g, t, a);
  const bool narrow_fits = g <= kNarrowMaxG && d <= kNarrowMaxD && smem <= kNarrowMaxSmem && (long long)a * t < 32768;
  if (variant == 0 && !narrow_fits) return (int)cudaErrorInvalidValue;
  const bool narrow = variant == 0 || (variant == -1 && narrow_fits && triples >= narrow_min_triples(g));
  const Args args{reinterpret_cast<const float*>(iou),       reinterpret_cast<const float*>(d_area),
                  reinterpret_cast<const float*>(g_area),    reinterpret_cast<const uint8_t*>(det_valid),
                  reinterpret_cast<const uint8_t*>(gt_valid), reinterpret_cast<const float*>(thresholds),
                  reinterpret_cast<const float*>(ranges),    n,
                  d,                                          g,
                  t,                                          a,
                  reinterpret_cast<uint8_t*>(matched),        reinterpret_cast<uint8_t*>(ignored),
                  reinterpret_cast<int32_t*>(npig),
                  magic(a * t),
                  magic(t)};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (narrow) {
    const long long blocks = (triples + kNarrowThreads - 1) / kNarrowThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const cudaError_t err = g <= 16 && d <= 16 ? launch_narrow<1, 2>(blocks, smem, s, args)
                            : g <= 32          ? launch_narrow<1, 1>(blocks, smem, s, args)
                                               : launch_narrow<2, 1>(blocks, smem, s, args);
    if (err != cudaSuccess) return (int)err;
  } else {
    const long long blocks = (triples + kWarpThreads / 32 - 1) / (kWarpThreads / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (g <= 1024)
      greedy_match_warp<1><<<(unsigned)blocks, kWarpThreads, 0, s>>>(args);
    else if (g <= 2048)
      greedy_match_warp<2><<<(unsigned)blocks, kWarpThreads, 0, s>>>(args);
    else
      greedy_match_warp<4><<<(unsigned)blocks, kWarpThreads, 0, s>>>(args);
  }
  return (int)cudaGetLastError();
}

extern "C" int tm_greedy_match(const void* iou, const void* d_area, const void* g_area, const void* det_valid,
                               const void* gt_valid, const void* thresholds, const void* ranges, long long n,
                               int d, int g, int t, int a, void* matched, void* ignored, void* npig, void* stream) {
  return tm_greedy_match_variant(iou, d_area, g_area, det_valid, gt_valid, thresholds, ranges, n, d, g, t, a, matched,
                                 ignored, npig, stream, -1);
}
