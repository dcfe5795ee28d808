// Kendall's pair counts of each column as a merge count (Knight, 1966), for Hopper (sm_90a).
//
// Replaces: metrics_tpu/functional/regression/kendall.py:_kendall_stats_1d (:17-43),
// plain XLA with no Pallas kernel: two (n, n) float32 sign matrices of the
// differences x_i - x_j and y_i - y_j, summed over their upper triangle in int32, one
// column at a time. That O(n^2) form suits the TPU's vector unit; on this card the
// all-pairs kernel that ported it was bound by instruction issue at about 16
// instructions a pair, so the work itself has to shrink: O(N log N) here.
//
// Function: for x, y (N, C) float32, row-major, out[c] = (concordant, discordant,
// x_tied, y_tied) as int64 over the pairs i < j of column c, as the float32 signs of
// x_i - x_j and y_i - y_j count them: a NaN difference (a NaN value, or inf - inf)
// counts nowhere, +0 and -0 tie, denormals keep IEEE order (built without
// --use_fast_math). With C(k, 2) = k (k - 1) / 2 and R the rows where neither x nor y
// is NaN: x_tied = sum of C(k, 2) over the groups of equal finite x (every row),
// y_tied likewise; Ex, Ey, Exy = the same over the groups of equal x, y and (x, y) in
// R, infinities included; concordant + discordant = C(|R|, 2) - Ex - Ey + Exy; and
// discordant = the strict inversions of y when R is sorted by (x, y).
//
// The chain, all C columns in each launch, nothing read back by the host:
//   1. tm_kendall_keys: zeroes the per-column counters, then one thread a row packs
//      an int64 key: R's rows as (x's signed order key << 32 | y's key); a row whose
//      y alone is NaN as (kHiTailA << 32 | x's key) (tail A), whose x alone is NaN as
//      (kHiTailB << 32 | y's key) (tail B), both NaN as kHiNaN << 32. Block counts of
//      the three kinds (__syncthreads_count), one 64-bit atomic each.
//   2. the caller sorts the keys of each column (torch.sort, dim 1).
//   3. tm_kendall_count:
//      - tile pass: a block sorts the y keys of one tile of kTile = 4,096 sorted rows
//        in shared memory (16 keys a thread: an odd-even transposition sort in
//        registers, then merge rounds with merge-path splits), counting the swaps and,
//        in each merge, |left| - i for a right element written after i left ones: the
//        strict inversions. Rows past R hold the pad key (above every float's key), so
//        they add nothing; both buffers get the pad key there.
//      - merge passes, ceil(log2(N / kTile)) launches: each merges sorted runs pairwise;
//        a block owns kChunk = 1,024 outputs, finds its two merge-path splits by binary
//        search, loads its share of both runs as 16-byte vectors into shared memory,
//        merges 8 outputs a thread with the same counting rule, and stores 16-byte
//        vectors. A block whose outputs all lie past R returns at once.
//      - tie-run kernel: one thread a sorted position; the first position of a run
//        finds its end by a galloping search (one long run costs O(log N), not O(N))
//        and adds C(k, 2): Ex and Exy on the sorted keys, Ey on the merged y, the
//        finite parts to x_tied and y_tied; a run of tail A (tail B) adds C(k2, 2) +
//        k1 k2 to x_tied (y_tied), k1 the rows of R with that x (y), counted by binary
//        search.
//      - finish kernel: out[c] from the counters.
//   Counts within a block are 32-bit in the tile pass (at most C(4096, 2)) and 64-bit
//   elsewhere; each block adds each counter with one 64-bit atomic.
//
// Bound: the function reads 8 N C bytes and writes 32 C: 0.3 us at N = 131,072 and
// 3.35 TB/s, far below what a sort and ~10 launches take. The design itself moves
// about 8 N C bytes for the keys, the sort's passes, 8 N C for the tile pass and
// 8 N C per merge pass, 16 N C for the tie-run pass: bytes and launch latency, not
// operations, set its time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_kendall_merge.so kendall_merge.cu
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kScratch = 16;  // int64 counters per column
enum { kLen = 0, kTailA = 1, kTailB = 2, kDis = 3, kEx = 4, kEy = 5, kExy = 6, kTx = 7, kTy = 8 };
constexpr int kHiTailA = 0x7FFFFFFD, kHiTailB = 0x7FFFFFFE, kHiNaN = 0x7FFFFFFF;
constexpr unsigned kPad = 0xFFFFFFFFu;
constexpr unsigned kNegInf = 0x007FFFFFu, kPosInf = 0xFF800000u;  // order keys of -inf, +inf

constexpr int kKeyThreads = 256;
constexpr int kTileThreads = 256;
constexpr int kTileItems = 16;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kMergeThreads = 128;
constexpr int kMergeItems = 8;
constexpr int kChunk = kMergeThreads * kMergeItems;
constexpr int kTieThreads = 256;
static_assert(kTile % kChunk == 0, "a merge block's outputs never straddle a run pair");

// shared-memory index with one word of padding every 32: a thread's consecutive items
// fall in distinct banks
__device__ __forceinline__ int sidx(int k) { return k + (k >> 5); }

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;  // -0 as +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ u64 pairs(u64 k) { return k * (k - 1) / 2; }

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

// Adds each of the block's K values (one per thread) into dst[k] with one atomic.
template <int K, int kThreads>
__device__ __forceinline__ void block_add(u64 (&v)[K], unsigned long long* dst) {
  __shared__ u64 part[K][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const u64 s = warp_sum(v[k]);
    if (lane == 0) part[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    u64 total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += part[threadIdx.x][w];
    if (total != 0) atomicAdd(dst + threadIdx.x, total);
  }
}

__global__ void __launch_bounds__(kKeyThreads)
kendall_keys_kernel(const float* __restrict__ x, const float* __restrict__ y, long long n, int c,
                    long long* __restrict__ keys, unsigned long long* __restrict__ scratch) {
  const int col = blockIdx.y;
  const long long i = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  int kind = 3;  // 0 in R, 1 tail A, 2 tail B, 3 both NaN or past N
  if (i < n) {
    const float xv = x[i * c + col], yv = y[i * c + col];
    const bool xn = isnan(xv), yn = isnan(yv);
    const unsigned ux = order_key(xv), uy = order_key(yv);
    unsigned hi, lo;
    if (!xn && !yn) {
      hi = ux ^ 0x80000000u;
      lo = uy;
      kind = 0;
    } else if (!xn) {
      hi = kHiTailA;
      lo = ux;
      kind = 1;
    } else if (!yn) {
      hi = kHiTailB;
      lo = uy;
      kind = 2;
    } else {
      hi = kHiNaN;
      lo = 0u;
    }
    keys[col * n + i] = (long long)(((u64)hi << 32) | lo);
  }
  const int in_r = __syncthreads_count(kind == 0);
  const int in_a = __syncthreads_count(kind == 1);
  const int in_b = __syncthreads_count(kind == 2);
  if (threadIdx.x == 0) {
    unsigned long long* s = scratch + (size_t)col * kScratch;
    if (in_r) atomicAdd(s + kLen, (u64)in_r);
    if (in_a) atomicAdd(s + kTailA, (u64)in_a);
    if (in_b) atomicAdd(s + kTailB, (u64)in_b);
  }
}

__global__ void __launch_bounds__(kTileThreads)
kendall_tile_kernel(const long long* __restrict__ keys, long long n, long long stride, unsigned* __restrict__ buf_a,
                    unsigned* __restrict__ buf_b, unsigned long long* __restrict__ scratch) {
  __shared__ unsigned tile[kTile + kTile / 32];
  const int col = blockIdx.y;
  const long long len = (long long)scratch[(size_t)col * kScratch + kLen];
  const long long start = (long long)blockIdx.x * kTile;
  unsigned* a = buf_a + (size_t)col * stride + start;
  unsigned* b = buf_b + (size_t)col * stride + start;
  const int t = threadIdx.x;
  if (start >= len) {  // past R: the pad key in both buffers, which the merges never write
    const uint4 pad = make_uint4(kPad, kPad, kPad, kPad);
    for (int k = t; k < kTile / 4; k += kTileThreads) {
      reinterpret_cast<uint4*>(a)[k] = pad;
      reinterpret_cast<uint4*>(b)[k] = pad;
    }
    return;
  }
  const long long* src = keys + (size_t)col * n + start;
  for (int k = t; k < kTile; k += kTileThreads) {
    const bool in = start + k < len;
    tile[sidx(k)] = in ? (unsigned)src[k] : kPad;  // the low 32 bits: y's key
    if (!in) b[k] = kPad;
  }
  __syncthreads();

  unsigned v[kTileItems];
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) v[i] = tile[sidx(t * kTileItems + i)];
  int inversions = 0;
  // odd-even transposition: each swap of an adjacent strict inversion removes one
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < kTileItems; i += 2) {
      if (v[i] > v[i + 1]) {
        const unsigned tmp = v[i];
        v[i] = v[i + 1];
        v[i + 1] = tmp;
        ++inversions;
      }
    }
  }
  for (int width = kTileItems; width < kTile; width *= 2) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) tile[sidx(t * kTileItems + i)] = v[i];
    __syncthreads();
    const int first = t * kTileItems;
    const int base = first & ~(2 * width - 1);
    const int diag = first - base;
    int lo = diag > width ? diag - width : 0, hi = diag < width ? diag : width;
    while (lo < hi) {  // left elements among the pair's first `diag` outputs (ties: left first)
      const int mid = (lo + hi) >> 1;
      if (tile[sidx(base + mid)] <= tile[sidx(base + width + diag - 1 - mid)]) lo = mid + 1;
      else hi = mid;
    }
    int i = lo, j = diag - lo;
    unsigned a = i < width ? tile[sidx(base + i)] : 0u;  // the two heads, in registers
    unsigned b = j < width ? tile[sidx(base + width + j)] : 0u;
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      if (j >= width || (i < width && a <= b)) {
        v[k] = a;
        ++i;
        a = i < width ? tile[sidx(base + i)] : 0u;
      } else {
        v[k] = b;
        ++j;
        b = j < width ? tile[sidx(base + width + j)] : 0u;
        inversions += width - i;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) tile[sidx(t * kTileItems + i)] = v[i];
  __syncthreads();
  for (int k = t; k < kTile / 4; k += kTileThreads) {
    reinterpret_cast<uint4*>(a)[k] =
        make_uint4(tile[sidx(4 * k)], tile[sidx(4 * k + 1)], tile[sidx(4 * k + 2)], tile[sidx(4 * k + 3)]);
  }
  u64 count[1] = {(u64)inversions};
  block_add<1, kTileThreads>(count, scratch + (size_t)col * kScratch + kDis);
}

// [from, to) of a run into shared memory at `at`, as the aligned 16-byte vectors that
// cover it (the run starts 16-byte aligned and its length is a multiple of 4)
__device__ __forceinline__ void load_range(const unsigned* __restrict__ run, long long from, long long to,
                                           unsigned* smem, int at) {
  for (long long q = (from >> 2) + threadIdx.x; q < ((to + 3) >> 2); q += kMergeThreads) {
    const uint4 w = reinterpret_cast<const uint4*>(run)[q];
    const unsigned e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long p = 4 * q + k;
      if (p >= from && p < to) smem[sidx(at + (int)(p - from))] = e[k];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
kendall_merge_kernel(const unsigned* __restrict__ src, unsigned* __restrict__ dst, long long stride, long long width,
                     unsigned long long* __restrict__ scratch) {
  __shared__ unsigned chunk[kChunk + kChunk / 32];
  __shared__ long long split[2];
  const int col = blockIdx.y;
  const long long len = (long long)scratch[(size_t)col * kScratch + kLen];
  const long long d0 = (long long)blockIdx.x * kChunk;
  if (d0 >= len) return;  // past R: both buffers already hold the pad key
  const long long base = d0 & ~(2 * width - 1);
  const long long nl = width < stride - base ? width : stride - base;
  const long long nr = width < stride - base - nl ? width : stride - base - nl;
  const unsigned* left = src + (size_t)col * stride + base;
  const unsigned* right = left + nl;
  const long long diag0 = d0 - base;
  const int t = threadIdx.x;
  if (t == 0 || t == 32) {  // the block's two merge-path splits, one warp each
    const long long diag = t == 0 ? diag0 : diag0 + kChunk;
    long long lo = diag > nr ? diag - nr : 0, hi = diag < nl ? diag : nl;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (left[mid] <= right[diag - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    split[t >> 5] = lo;
  }
  __syncthreads();
  const long long i0 = split[0], i1 = split[1];
  const long long j0 = diag0 - i0, j1 = diag0 + kChunk - i1;
  const int nls = (int)(i1 - i0);
  load_range(left, i0, i1, chunk, 0);
  load_range(right, j0, j1, chunk, nls);
  __syncthreads();

  const int nrs = kChunk - nls;
  const int diag = t * kMergeItems;
  int lo = diag > nrs ? diag - nrs : 0, hi = diag < nls ? diag : nls;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk[sidx(mid)] <= chunk[sidx(nls + diag - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = diag - lo;
  unsigned a = i < nls ? chunk[sidx(i)] : 0u;  // the two heads, in registers
  unsigned b = j < nrs ? chunk[sidx(nls + j)] : 0u;
  unsigned out[kMergeItems];
  u64 inversions = 0;
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    if (j >= nrs || (i < nls && a <= b)) {
      out[k] = a;
      ++i;
      a = i < nls ? chunk[sidx(i)] : 0u;
    } else {
      out[k] = b;
      ++j;
      b = j < nrs ? chunk[sidx(nls + j)] : 0u;
      inversions += (u64)(nl - (i0 + i));
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) chunk[sidx(diag + k)] = out[k];
  __syncthreads();
  uint4* to = reinterpret_cast<uint4*>(dst + (size_t)col * stride + d0);
  for (int k = t; k < kChunk / 4; k += kMergeThreads) {
    to[k] = make_uint4(chunk[sidx(4 * k)], chunk[sidx(4 * k + 1)], chunk[sidx(4 * k + 2)], chunk[sidx(4 * k + 3)]);
  }
  u64 count[1] = {inversions};
  block_add<1, kMergeThreads>(count, scratch + (size_t)col * kScratch + kDis);
}

// the end of the run of `v` that starts at p (at(p) == v), in a sorted [p, end)
template <typename T, typename At>
__device__ __forceinline__ long long run_end(At at, long long p, long long end, T v) {
  long long lo = p + 1, step = 1;
  while (p + step < end && at(p + step) == v) {
    lo = p + step + 1;
    step <<= 1;
  }
  long long hi = p + step < end ? p + step : end;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (at(mid) == v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// how many of the sorted [0, end) equal v
template <typename T, typename At>
__device__ __forceinline__ u64 count_equal(At at, long long end, T v) {
  long long lo = 0, hi = end;
  while (lo < hi) {  // first >= v
    const long long mid = (lo + hi) >> 1;
    if (at(mid) < v) lo = mid + 1;
    else hi = mid;
  }
  const long long first = lo;
  hi = end;
  while (lo < hi) {  // first > v
    const long long mid = (lo + hi) >> 1;
    if (at(mid) <= v) lo = mid + 1;
    else hi = mid;
  }
  return (u64)(lo - first);
}

__global__ void __launch_bounds__(kTieThreads)
kendall_tie_kernel(const long long* __restrict__ keys, const unsigned* __restrict__ merged, long long n,
                   long long stride, unsigned long long* __restrict__ scratch) {
  const int col = blockIdx.y;
  const long long p = (long long)blockIdx.x * kTieThreads + threadIdx.x;
  unsigned long long* s = scratch + (size_t)col * kScratch;
  const long long len = (long long)s[kLen];
  const long long end_a = len + (long long)s[kTailA];
  const long long end_b = end_a + (long long)s[kTailB];
  const long long* key = keys + (size_t)col * n;
  const unsigned* ys = merged + (size_t)col * stride;
  auto key_at = [key](long long q) { return key[q]; };
  auto x_at = [key](long long q) { return (int)(key[q] >> 32); };
  auto y_at = [ys](long long q) { return ys[q]; };
  u64 c[5] = {0, 0, 0, 0, 0};  // Ex, Ey, Exy, x_tied, y_tied
  if (p < len) {
    const long long k = key[p];
    const int xv = (int)(k >> 32);
    if (p == 0 || x_at(p - 1) != xv) {
      const u64 r = pairs((u64)(run_end(x_at, p, len, xv) - p));
      const unsigned ux = (unsigned)xv ^ 0x80000000u;
      c[0] += r;
      if (ux != kNegInf && ux != kPosInf) c[3] += r;
    }
    if (p == 0 || key[p - 1] != k) c[2] += pairs((u64)(run_end(key_at, p, len, k) - p));
    const unsigned yv = ys[p];
    if (p == 0 || ys[p - 1] != yv) {
      const u64 r = pairs((u64)(run_end(y_at, p, len, yv) - p));
      c[1] += r;
      if (yv != kNegInf && yv != kPosInf) c[4] += r;
    }
  } else if (p < end_b) {  // a tail: the low 32 bits hold the other value's key
    const long long k = key[p];
    const unsigned u = (unsigned)k;
    if ((p == 0 || key[p - 1] != k) && u != kNegInf && u != kPosInf) {
      const bool tail_a = p < end_a;
      const u64 k2 = (u64)(run_end(key_at, p, tail_a ? end_a : end_b, k) - p);
      const u64 k1 = tail_a ? count_equal(x_at, len, (int)(u ^ 0x80000000u)) : count_equal(y_at, len, u);
      if (tail_a) c[3] += pairs(k2) + k1 * k2;
      else c[4] += pairs(k2) + k1 * k2;
    }
  }
  block_add<5, kTieThreads>(c, s + kEx);  // kEx, kEy, kExy, kTx, kTy are consecutive
}

__global__ void kendall_finish_kernel(const unsigned long long* __restrict__ scratch, int c,
                                      long long* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  const long long* s = reinterpret_cast<const long long*>(scratch) + (size_t)col * kScratch;
  const long long len = s[kLen];
  const long long both = len * (len - 1) / 2 - s[kEx] - s[kEy] + s[kExy];  // concordant + discordant
  out[4 * col + 0] = both - s[kDis];
  out[4 * col + 1] = s[kDis];
  out[4 * col + 2] = s[kTx];
  out[4 * col + 3] = s[kTy];
}

}  // namespace

// Rows of one tile of the tile pass: the merge buffers' stride is a multiple of it.
extern "C" long long tm_kendall_tile_rows() { return kTile; }

// x, y: (n, c) float32, row-major; keys: (c, n) int64, written; scratch: (c, 16) int64,
// zeroed here, then the row counts of R and the two tails. Returns the CUDA error.
extern "C" int tm_kendall_keys(const void* x, const void* y, long long n, int c, void* keys, void* scratch,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c <= 0) return (int)cudaSuccess;
  if (c > 65535 || n < 0 || n > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)c * kScratch * sizeof(long long), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  dim3 grid((unsigned)((n + kKeyThreads - 1) / kKeyThreads), (unsigned)c);
  kendall_keys_kernel<<<grid, kKeyThreads, 0, st>>>(reinterpret_cast<const float*>(x),
                                                     reinterpret_cast<const float*>(y), n, c,
                                                     reinterpret_cast<long long*>(keys),
                                                     reinterpret_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}

// keys: (c, n) int64, each column sorted; buf_a, buf_b: (c, stride) uint32 with stride a
// positive multiple of kTile >= n, 16-byte aligned; scratch as tm_kendall_keys left it;
// out: (c, 4) int64, written. Launches the tile pass, ceil(log2(stride / kTile)) merge
// passes, the tie-run and finish kernels. Returns the first CUDA error.
extern "C" int tm_kendall_count(const void* keys, long long n, int c, void* buf_a, void* buf_b, long long stride,
                                void* scratch, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c <= 0) return (int)cudaSuccess;
  if (c > 65535 || n < 0 || n > 0x7FFFFFFFLL || stride < n || stride <= 0 || stride % kTile != 0)
    return (int)cudaErrorInvalidValue;
  unsigned long long* s = reinterpret_cast<unsigned long long*>(scratch);
  const long long* k = reinterpret_cast<const long long*>(keys);
  unsigned* src = reinterpret_cast<unsigned*>(buf_a);
  unsigned* dst = reinterpret_cast<unsigned*>(buf_b);
  cudaError_t err;
  if (n > 0) {
    kendall_tile_kernel<<<dim3((unsigned)(stride / kTile), (unsigned)c), kTileThreads, 0, st>>>(k, n, stride, src,
                                                                                                dst, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (long long width = kTile; width < stride; width *= 2) {
      kendall_merge_kernel<<<dim3((unsigned)(stride / kChunk), (unsigned)c), kMergeThreads, 0, st>>>(src, dst, stride,
                                                                                                    width, s);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      unsigned* tmp = src;
      src = dst;
      dst = tmp;
    }
    kendall_tie_kernel<<<dim3((unsigned)((n + kTieThreads - 1) / kTieThreads), (unsigned)c), kTieThreads, 0, st>>>(
        k, src, n, stride, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  kendall_finish_kernel<<<(c + 127) / 128, 128, 0, st>>>(s, c, reinterpret_cast<long long*>(out));
  return (int)cudaGetLastError();
}
