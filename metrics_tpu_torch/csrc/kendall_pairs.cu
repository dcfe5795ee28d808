// Kendall's pair counts over every pair i < j of each column, for Hopper (sm_90a).
//
// Replaces: metrics_tpu/functional/regression/kendall.py:_kendall_stats_1d (:17-43),
// plain XLA with no Pallas kernel: two (n, n) float32 sign matrices of the
// differences x_i - x_j and y_i - y_j, summed over their upper triangle in int32,
// one column at a time. That form holds 2 n^2 values (17 GB at n = 65,536) and its
// int32 sums wrap past n = 65,536.
//
// Function: for x, y laid out as (C, N) float32 (each column contiguous), out[c] =
// (concordant, discordant, x_tied, y_tied) as int64, over the pairs i < j of column
// c: the float32 signs of dx = x_i - x_j and dy = y_i - y_j multiply to > 0
// (concordant) or < 0 (discordant); dx == 0 (x-tied), dy == 0 (y-tied). A NaN
// difference (a NaN value, or inf - inf) compares false everywhere and counts
// nowhere, as jnp.sign's NaN does. tm_kendall_pairs zeroes out itself, on the same
// stream. Built without --use_fast_math: differences keep their denormals (no
// flush to zero), where XLA's CPU flushes them.
//
// Bound: two float32 subtractions per pair and column, N (N - 1) C operations; at
// N = 131,072 and C = 1 that is 1.7e10, 0.256 ms at the 67 TFLOP/s float32 peak,
// against 8 N C bytes read (1 MB, 0.3 us at 3.35 TB/s): operations bound it. The
// real cost per pair is about a dozen instructions (two subtractions, four
// compares, the sign product and four integer adds), so issue, not the
// subtractions, limits this simple design.
//
// Design:
//   - rows split into tiles of kTile = 1024; the grid walks the upper-triangle
//     tile pairs (bi <= bj) of one column in blockIdx.y, a block taking every
//     gridDim.x-th pair (decoded from its linear index);
//   - each of the block's 256 threads holds kRows = 4 rows of tile bi in
//     registers; tile bj streams through shared memory as (x, y) float2 pairs, one
//     64-bit broadcast load per j serving four pairs;
//   - rows past N load as NaN and so count nowhere: only the diagonal tile pair
//     (bi == bj) needs the i < j test, in a loop of its own;
//   - counts accumulate in 32-bit registers, at most kRows * kTile = 4,096 per
//     tile pair, and are added into 64-bit registers after each tile pair, before
//     they could wrap. The sign product p in {-1, 0, 1} accumulates as its sum s
//     and its magnitude nz, so concordant = (nz + s) / 2 and discordant =
//     (nz - s) / 2;
//   - at the end a warp-shuffle and a shared-memory reduction, then one 64-bit
//     atomicAdd per block and counter.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtm_kendall_pairs.so kendall_pairs.cu
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                 // rows of tile bi per thread
constexpr int kTile = kThreads * kRows;  // rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerColumn = 132 * 8;  // the blocks that fit on an H100 at once

struct Counts32 {
  int s, nz, tx, ty;
};

__device__ __forceinline__ void count_pair(float xi, float yi, float2 j, Counts32& c) {
  const float dx = xi - j.x;
  const float dy = yi - j.y;
  const int sx = (dx > 0.f) - (dx < 0.f);
  const int sy = (dy > 0.f) - (dy < 0.f);
  const int p = sx * sy;
  c.s += p;
  c.nz += p & 1;
  c.tx += dx == 0.f;
  c.ty += dy == 0.f;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

__global__ void __launch_bounds__(kThreads)
kendall_pairs_kernel(const float* __restrict__ x, const float* __restrict__ y, long long n, long long tile_pairs,
                     unsigned long long* __restrict__ out) {
  __shared__ float2 tile[kTile];
  __shared__ long long partial[4][kWarps];
  const long long column = blockIdx.y;
  const float* xc = x + column * n;
  const float* yc = y + column * n;
  long long s = 0, nz = 0, tx = 0, ty = 0;

  for (long long p = blockIdx.x; p < tile_pairs; p += gridDim.x) {
    // p = bj (bj + 1) / 2 + bi with 0 <= bi <= bj
    long long bj = (long long)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
    while (bj * (bj + 1) / 2 > p) --bj;
    while ((bj + 1) * (bj + 2) / 2 <= p) ++bj;
    const long long bi = p - bj * (bj + 1) / 2;

    __syncthreads();  // the previous tile pair's reads of `tile` are done
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const long long j = bj * kTile + k;
      tile[k] = j < n ? make_float2(xc[j], yc[j]) : make_float2(NAN, NAN);
    }
    float xi[kRows], yi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = bi * kTile + threadIdx.x + r * kThreads;
      xi[r] = i < n ? xc[i] : NAN;
      yi[r] = i < n ? yc[i] : NAN;
    }
    __syncthreads();

    Counts32 c = {0, 0, 0, 0};
    if (bi < bj) {
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        const float2 v = tile[k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) count_pair(xi[r], yi[r], v, c);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        for (int k = threadIdx.x + r * kThreads + 1; k < kTile; ++k) count_pair(xi[r], yi[r], tile[k], c);
      }
    }
    s += c.s;
    nz += c.nz;
    tx += c.tx;
    ty += c.ty;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  nz = warp_sum(nz);
  tx = warp_sum(tx);
  ty = warp_sum(ty);
  if (lane == 0) {
    partial[0][warp] = s;
    partial[1][warp] = nz;
    partial[2][warp] = tx;
    partial[3][warp] = ty;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total[4] = {0, 0, 0, 0};
    for (int k = 0; k < 4; ++k)
      for (int w = 0; w < kWarps; ++w) total[k] += partial[k][w];
    unsigned long long* o = out + column * 4;
    atomicAdd(o + 0, (unsigned long long)((total[1] + total[0]) / 2));
    atomicAdd(o + 1, (unsigned long long)((total[1] - total[0]) / 2));
    atomicAdd(o + 2, (unsigned long long)total[2]);
    atomicAdd(o + 3, (unsigned long long)total[3]);
  }
}

}  // namespace

// x, y: (c, n) float32, each column contiguous; out: (c, 4) int64, zeroed here.
// Returns the CUDA error of the memset or the launch (0 on success).
extern "C" int tm_kendall_pairs(const void* x, const void* y, long long n, int c, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c <= 0) return (int)cudaSuccess;
  if (c > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)c * 4 * sizeof(long long), st);
  if (err != cudaSuccess || n < 2) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long tile_pairs = tiles * (tiles + 1) / 2;
  const long long per_column = (kBlocksPerColumn + c - 1) / c;
  dim3 grid((unsigned)(tile_pairs < per_column ? tile_pairs : per_column), (unsigned)c);
  kendall_pairs_kernel<<<grid, kThreads, 0, st>>>(reinterpret_cast<const float*>(x),
                                                    reinterpret_cast<const float*>(y), n, tile_pairs,
                                                    reinterpret_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
