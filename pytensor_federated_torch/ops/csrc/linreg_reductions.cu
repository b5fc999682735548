// Fused logp + gradient reductions of the federated linear regression,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_kernels.py:_linreg_kernel of the JAX
// package.  For every shard s, over its masked observations, with
// r = y - (intercept + offset_s + slope * x) and z2 = r^2 / sigma^2:
//
//     ll_s  = sum m * (-0.5 z2 - log_sigma - 0.5 log 2pi)
//     gmu_s = sum m * r / sigma^2
//     gx_s  = sum m * r * x / sigma^2
//     gz_s  = sum m * (z2 - 1)
//
// and the four totals over shards, sum_s (ll_s, gmu_s, gx_s, gz_s).
//
// What bounds it: device-memory bytes.  A call reads x, y and mask once,
// 12*S*N bytes, and writes 16*(S+1) bytes of results; it does about 17
// float operations for those 12 bytes, two orders of magnitude below the
// H100's float32 operations-per-byte balance.  The design keeps the
// memory pipe full from the first cycle to the last, in one launch:
//
// - Tiles.  Each shard's row of N observations is cut into tiles of kTile
//   observations (the last one ragged); tile t = s * tiles_per_row + c.
//   A tile's four sums go to partials[t], one float4.
// - Persistent grid.  min(n_tiles, blocks-per-SM x SMs) blocks, the
//   blocks per SM from the occupancy of this kernel at its register count
//   (2 on the H100).  Block b walks tiles b, b + gridDim.x, ...
// - Register pipeline.  While a block sums tile t, each of its threads
//   already holds in registers its share of the block's next tile,
//   t + gridDim.x: 16-byte streaming loads (ld.global.cs, lines evicted
//   first, since the inputs are read once), 192 bytes per thread, so two
//   blocks of 256 threads keep 96 KB in flight on every SM while they
//   compute.  A tile is read this way when it is full and its three rows
//   start on a 16-byte boundary; every other tile (a row's ragged tail,
//   rows of a width that is not a multiple of 4, rows of x, y and mask
//   aligned differently) is read with scalar loads when its turn comes.
//   A ring of 3 x 48 KB stages in shared memory, fed by TMA bulk copies,
//   one block per SM, gave the same bits and was slower at the main
//   path's shapes on the H100 (PERF.md).
// - One launch.  After its last tile each block draws an integer ticket
//   (an acq_rel atomic add on an unsigned int, which also publishes the
//   block's partials).  The block that draws the last ticket reads every
//   partial back from L2 (__ldcg), sums each shard's partials, writes the
//   (S, 4) result and the four totals, and puts the ticket back to 0 for
//   the next call on its stream.
//
// Why reruns are bitwise equal, whatever the grid: a tile's sum depends
// only on the tile (its path is chosen from its length and addresses;
// each thread sums at most kTile / kThreads terms in a fixed order, then
// a fixed shuffle tree and a fixed tree over the warps), the partials are
// kept per tile and not per block, and the last block sums them in an
// order fixed by (S, tiles_per_row) alone.  The ticket decides only which
// block finishes, never the order of a float sum; there are no float
// atomics.  The same inputs therefore give the same bits on any grid size
// and any SM count.
//
// The scalars (intercept, slope, log_sigma) and the offsets are read from
// device memory, so a call needs no host copy of the parameters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                       // observations per tile
constexpr int kPerThread = kTile / kThreads;      // 16 terms per thread
constexpr int kVec = kPerThread / 4;              // float4 per array
constexpr int kMaxDevices = 64;
constexpr float kHalfLog2Pi = 0.918938533204672741780329736406f;

struct Acc {
  float ll, gmu, gx, gz;
};

struct Scalars {
  float a;       // intercept + offset_s
  float slope;
  float inv_s2;  // 1 / sigma^2
  float c;       // log_sigma + 0.5 log 2pi
};

__device__ __forceinline__ void accumulate(Acc& acc, float x, float y, float m,
                                           const Scalars& p) {
  const float r = y - (p.a + p.slope * x);
  const float z2 = r * r * p.inv_s2;
  acc.ll += m * (-0.5f * z2 - p.c);
  acc.gmu += m * r;
  acc.gx += m * r * x;
  acc.gz += m * (z2 - 1.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block in a fixed order (shuffle tree within each warp, then
// the warp sums by the first warp).  The result is valid in thread 0.
// `sh` must not be written again until every thread has passed one more
// __syncthreads: callers alternate between two buffers.
__device__ __forceinline__ Acc block_sum(Acc a, float (*sh)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a.ll = warp_sum(a.ll);
  a.gmu = warp_sum(a.gmu);
  a.gx = warp_sum(a.gx);
  a.gz = warp_sum(a.gz);
  if (lane == 0) {
    sh[0][warp] = a.ll;
    sh[1][warp] = a.gmu;
    sh[2][warp] = a.gx;
    sh[3][warp] = a.gz;
  }
  __syncthreads();
  Acc t = {0.f, 0.f, 0.f, 0.f};
  if (warp == 0) {
    const bool live = lane < kWarps;
    t.ll = warp_sum(live ? sh[0][lane] : 0.f);
    t.gmu = warp_sum(live ? sh[1][lane] : 0.f);
    t.gx = warp_sum(live ? sh[2][lane] : 0.f);
    t.gz = warp_sum(live ? sh[3][lane] : 0.f);
  }
  return t;
}

// --- the kernel ------------------------------------------------------------

struct Tile {
  int s;           // shard (row)
  int64_t lo;      // first observation of the tile in its row
  int n;           // observations in the tile
  bool vec;        // full and 16-byte aligned: read as float4
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_per_row,
                                        int64_t n_obs, const float* x,
                                        const float* y, const float* m) {
  Tile tl;
  tl.s = t / tiles_per_row;
  tl.lo = static_cast<int64_t>(t - tl.s * tiles_per_row) * kTile;
  const int64_t left = n_obs - tl.lo;
  tl.n = left < kTile ? static_cast<int>(left) : kTile;
  const int64_t off = static_cast<int64_t>(tl.s) * n_obs + tl.lo;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x + off) |
                          reinterpret_cast<uintptr_t>(y + off) |
                          reinterpret_cast<uintptr_t>(m + off);
  tl.vec = tl.n == kTile && (align & 15u) == 0;
  return tl;
}

// A thread's share of a full tile: float4 k of each array is at
// threadIdx.x + k * kThreads.
struct Regs {
  float4 x[kVec], y[kVec], m[kVec];
};

__device__ __forceinline__ void load_tile(Regs& r, const Tile& tl,
                                          int64_t n_obs, const float* x,
                                          const float* y, const float* m) {
  const int64_t off = static_cast<int64_t>(tl.s) * n_obs + tl.lo;
  const float4* x4 = reinterpret_cast<const float4*>(x + off) + threadIdx.x;
  const float4* y4 = reinterpret_cast<const float4*>(y + off) + threadIdx.x;
  const float4* m4 = reinterpret_cast<const float4*>(m + off) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    r.x[k] = __ldcs(x4 + k * kThreads);
    r.y[k] = __ldcs(y4 + k * kThreads);
    r.m[k] = __ldcs(m4 + k * kThreads);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    linreg_reductions_kernel(const float* __restrict__ intercept,
                             const float* __restrict__ slope,
                             const float* __restrict__ log_sigma,
                             const float* __restrict__ offsets,
                             const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ m,
                             float4* __restrict__ partials,
                             float4* __restrict__ out,
                             unsigned int* __restrict__ ticket, int n_shards,
                             int64_t n_obs, int tiles_per_row) {
  __shared__ float sh[2][4][kWarps];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int n_tiles = n_shards * tiles_per_row;
  const float ls = __ldg(log_sigma);
  const float b0 = __ldg(intercept);
  const float b1 = __ldg(slope);
  const float inv_s2 = expf(-2.0f * ls);

  // `next` holds the block's next tile once it is known to be full and
  // aligned; `tn` describes it.
  Regs next;
  Tile tn = tile_at(blockIdx.x, tiles_per_row, n_obs, x, y, m);
  if (tn.vec) load_tile(next, tn, n_obs, x, y, m);

  int i = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    const Tile tl = tn;
    const Regs cur = next;
    if (t + gridDim.x < n_tiles) {
      tn = tile_at(t + gridDim.x, tiles_per_row, n_obs, x, y, m);
      if (tn.vec) load_tile(next, tn, n_obs, x, y, m);
    }
    const Scalars p = {b0 + __ldg(offsets + tl.s), b1, inv_s2,
                       ls + kHalfLog2Pi};
    Acc acc = {0.f, 0.f, 0.f, 0.f};
    if (tl.vec) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        accumulate(acc, cur.x[k].x, cur.y[k].x, cur.m[k].x, p);
        accumulate(acc, cur.x[k].y, cur.y[k].y, cur.m[k].y, p);
        accumulate(acc, cur.x[k].z, cur.y[k].z, cur.m[k].z, p);
        accumulate(acc, cur.x[k].w, cur.y[k].w, cur.m[k].w, p);
      }
    } else {
      const int64_t off = static_cast<int64_t>(tl.s) * n_obs + tl.lo;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int j = tid + k * kThreads;
        if (j < tl.n) accumulate(acc, x[off + j], y[off + j], m[off + j], p);
      }
    }
    const Acc sum = block_sum(acc, sh[i & 1]);
    if (tid == 0) partials[t] = make_float4(sum.ll, sum.gmu, sum.gx, sum.gz);
  }

  // Draw a ticket; the block that draws the last one finishes the call.
  // The ticket is an acq_rel atomic: it releases this block's partials
  // (all written by thread 0) and, in the last block, acquires every
  // other block's; the __syncthreads passes them on to the block.
  if (tid == 0) {
    unsigned int prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(ticket)
                 : "memory");
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // Each shard's partials are summed by a group of G lanes (G a power of
  // two, at most 32, fixed by n_shards and tiles_per_row): lane l of the
  // group takes tiles l, l + G, ... in order, then a shuffle tree over the
  // group.  Rounds run in lockstep over the whole block so that every lane
  // of a warp reaches every shuffle.
  int G = 1;
  while (G < 32 && G < tiles_per_row && G * 2 * n_shards <= kThreads) G *= 2;
  const int groups = kThreads / G;
  const int g = tid / G;
  const int lane = tid % G;
  Acc tot = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < n_shards; base += groups) {
    const int s = base + g;
    Acc a = {0.f, 0.f, 0.f, 0.f};
    if (s < n_shards) {
      const float4* ps = partials + static_cast<int64_t>(s) * tiles_per_row;
#pragma unroll 4
      for (int c = lane; c < tiles_per_row; c += G) {
        const float4 v = __ldcg(ps + c);
        a.ll += v.x;
        a.gmu += v.y;
        a.gx += v.z;
        a.gz += v.w;
      }
    }
    for (int o = G / 2; o > 0; o >>= 1) {
      a.ll += __shfl_down_sync(0xffffffffu, a.ll, o, G);
      a.gmu += __shfl_down_sync(0xffffffffu, a.gmu, o, G);
      a.gx += __shfl_down_sync(0xffffffffu, a.gx, o, G);
      a.gz += __shfl_down_sync(0xffffffffu, a.gz, o, G);
    }
    if (lane == 0 && s < n_shards) {
      const float4 r = make_float4(a.ll, a.gmu * inv_s2, a.gx * inv_s2, a.gz);
      out[s] = r;
      tot.ll += r.x;
      tot.gmu += r.y;
      tot.gx += r.z;
      tot.gz += r.w;
    }
  }
  // The totals: each group leader's running sum over its shards, then the
  // fixed block tree.  The other lanes add zeros, which is exact.
  const Acc t = block_sum(tot, sh[i & 1]);
  if (tid == 0) {
    out[n_shards] = make_float4(t.ll, t.gmu, t.gx, t.gz);
    *ticket = 0u;
  }
}

int g_blocks[kMaxDevices];  // persistent grid per device; 0 = not yet known

// Blocks of the persistent grid on the current device: the blocks per SM
// that the occupancy calculator allows at this kernel's registers, times
// the SM count.  Returns a negative CUDA error on failure.
int persistent_blocks() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < kMaxDevices && g_blocks[dev] > 0) return g_blocks[dev];
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, linreg_reductions_kernel, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = per_sm * sms;
  if (dev < kMaxDevices) g_blocks[dev] = blocks;
  return blocks;
}

}  // namespace

extern "C" {

// Observations per tile: the wrapper sizes the partials scratch as
// (n_shards * ceil(n_obs / tile), 4) floats.
int linreg_tile() { return kTile; }

// Blocks of the persistent grid on the current device (negative: a CUDA
// error code, negated).
int linreg_persistent_blocks() { return persistent_blocks(); }

// Enqueues the kernel on `stream`, once; returns cudaGetLastError() (0
// when the launch was accepted).  All pointers are device pointers:
// intercept, slope and log_sigma to one float32 each; offsets (S,);
// x, y, m (S, N) contiguous float32; partials (S * tiles_per_row, 4) and
// out (S + 1, 4) float32, 16-byte aligned; ticket one unsigned int that is
// 0 and that no call on another stream uses at the same time.  Row S of
// out receives the totals.  max_blocks > 0 caps the grid (a check that
// the result's bits do not depend on the grid uses it); 0 launches the
// persistent grid.
int linreg_reductions_launch(const float* intercept, const float* slope,
                             const float* log_sigma, const float* offsets,
                             const float* x, const float* y, const float* m,
                             float* partials, float* out,
                             unsigned int* ticket, int n_shards,
                             long long n_obs, int tiles_per_row,
                             int max_blocks, void* stream) {
  const int blocks = persistent_blocks();
  if (blocks < 0) return -blocks;
  const int n_tiles = n_shards * tiles_per_row;
  int grid = n_tiles < blocks ? n_tiles : blocks;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  linreg_reductions_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      intercept, slope, log_sigma, offsets, x, y, m,
      reinterpret_cast<float4*>(partials), reinterpret_cast<float4*>(out),
      ticket, n_shards, n_obs, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

const char* linreg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
