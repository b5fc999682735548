// Fused logp + gradient reductions of the federated linear regression,
// written by hand for Hopper (sm_90a), for C chains in one launch.
//
// Replaces the TPU kernel ops/pallas_kernels.py:_linreg_kernel of the JAX
// package, and the batching rule of its pallas_call: under jax.vmap over
// chains the chain axis becomes one more grid axis, so one call serves
// every chain.  For every chain c and shard s, over the shard's masked
// observations, with r = y - (intercept_c + offset_cs + slope_c * x) and
// z2 = r^2 / sigma_c^2:
//
//     ll_cs  = sum m * (-0.5 z2 - log_sigma_c - 0.5 log 2pi)
//     gmu_cs = sum m * r / sigma_c^2
//     gx_cs  = sum m * r * x / sigma_c^2
//     gz_cs  = sum m * (z2 - 1)
//
// and each chain's four totals over shards.  The data x, y and mask are
// shared by all chains; the parameters are per chain.
//
// What bounds it.  A call reads x, y and mask once, 12*S*N bytes, and
// does about 17*C*S*N float operations.  With one chain that is two
// orders of magnitude below the H100's float32 operations-per-byte
// balance: device-memory bytes bound it.  Past C ~ 13 chains the float32
// operations do.  The design keeps the memory pipe full for one chain and
// reads each tile once for many:
//
// - Tiles.  Each shard's row of N observations is cut into tiles of kTile
//   observations (the last one ragged); tile t = s * tiles_per_row + j.
// - Work items.  An item is one tile and a block of consecutive chains.
//   The block holds the tile's observations in registers (16 per thread)
//   and walks its chains in passes of P, computing P chains' sums from the
//   same registers; a chain's four sums of tile t go to partials[c][t],
//   one float4.  With one chain (P = 1) a thread also prefetches the next
//   item's tile into registers while it sums the current one (16-byte
//   streaming loads, ld.global.cs); with more chains (P = 4) it does not
//   (four chains' sums and parameters take the registers the prefetch
//   took), and the arithmetic hides the loads; the block stages each
//   chain's parameters for the tile's shard in shared memory, one thread
//   per chain.  Chain blocks are sized so that a few tiles still spread
//   over the whole grid.  A full tile whose three rows start on a 16-byte
//   boundary is read as float4; every other tile (a ragged tail, rows of a
//   width that is not a multiple of 4, rows aligned differently) with
//   scalar loads.
// - Persistent grid.  min(items, blocks-per-SM x SMs) blocks, the blocks
//   per SM from the occupancy of the kernel at its register count.  Block
//   b walks items b, b + gridDim.x, ...; consecutive items share a tile,
//   so blocks that run together read it from device memory once and from
//   L2 after that.
// - One launch.  After its last item each block draws an integer ticket
//   (an acq_rel atomic add, which also publishes the block's partials).
//   The block that draws the last ticket reads every partial back from L2,
//   sums each (chain, shard) row's partials, writes the (C, S, 4) result
//   and each chain's four totals, and puts the ticket back to 0 for the
//   next call on its stream.
//
// Why the bits do not depend on the grid or on the other chains of the
// batch.  Every float operation of a chain's sums is written with an
// explicit rounding intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn), so the
// compiler contracts and reorders nothing, whatever the code path around
// it (P = 1 or 4, the lane a chain takes in a pass).  A tile's sum for a
// chain depends only on the tile and the chain's parameters: each thread
// sums its terms in a fixed order, then a fixed shuffle tree and a fixed
// tree over the warps.  The partials are kept per (chain, tile), the last
// block sums each row in an order fixed by (S, tiles_per_row) alone, and
// each chain's totals in an order fixed by S alone.  The ticket decides
// only which block finishes, never the order of a float sum; there are no
// float atomics.  So a chain's outputs in a batch of C equal those of the
// same chain called alone, on any grid size and any SM count.
//
// The parameters are read from device memory through a stride per array
// (0 for one shared by every chain), so a call needs no host copy and no
// gather of the parameters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                       // observations per tile
constexpr int kPerThread = kTile / kThreads;      // 16 terms per thread
constexpr int kVec = kPerThread / 4;              // float4 per array
constexpr int kMaxDevices = 64;
constexpr int kChainsPerPass = 4;                 // P of the batched kernel
constexpr int kRoundsInFlight = 4;                // finishing rounds at a time
constexpr int kRowsShared = 512;                  // rows kept in shared memory
constexpr float kHalfLog2Pi = 0.918938533204672741780329736406f;

struct Args {
  const float* intercept;
  const float* slope;
  const float* log_sigma;
  const float* offsets;
  int64_t stride_intercept;  // elements between chains (0: shared)
  int64_t stride_slope;
  int64_t stride_log_sigma;
  int64_t stride_offsets;    // row stride of the (C, S) offsets
  const float* x;
  const float* y;
  const float* m;
  float4* partials;          // (C, n_tiles)
  float4* out;               // (C, S + 1): per-shard rows, then the totals
  unsigned int* ticket;
  int n_chains;
  int n_shards;
  int64_t n_obs;
  int tiles_per_row;
  int chain_block;           // chains per work item, a multiple of P
  int n_chain_blocks;
};

struct Acc {
  float ll, gmu, gx, gz;
};

struct Scalars {
  float a;       // intercept + offset_s
  float slope;
  float inv_s2;  // 1 / sigma^2
  float neg_c;   // -(log_sigma + 0.5 log 2pi)
};

__device__ __forceinline__ float inv_sigma2(float log_sigma) {
  return expf(__fmul_rn(-2.0f, log_sigma));
}

__device__ __forceinline__ Scalars chain_scalars(const Args& a, int c, int s) {
  const float ls = __ldg(a.log_sigma + c * a.stride_log_sigma);
  Scalars p;
  p.a = __fadd_rn(__ldg(a.intercept + c * a.stride_intercept),
                  __ldg(a.offsets + c * a.stride_offsets + s));
  p.slope = __ldg(a.slope + c * a.stride_slope);
  p.inv_s2 = inv_sigma2(ls);
  p.neg_c = -__fadd_rn(ls, kHalfLog2Pi);
  return p;
}

__device__ __forceinline__ void accumulate(Acc& acc, float x, float y, float m,
                                           const Scalars& p) {
  const float r = __fsub_rn(y, __fmaf_rn(p.slope, x, p.a));
  const float z2 = __fmul_rn(__fmul_rn(r, r), p.inv_s2);
  // -0.5 z2 is exact, so one fused multiply-add rounds -0.5 z2 - c once.
  acc.ll = __fmaf_rn(m, __fmaf_rn(-0.5f, z2, p.neg_c), acc.ll);
  acc.gmu = __fmaf_rn(m, r, acc.gmu);
  acc.gx = __fmaf_rn(__fmul_rn(m, r), x, acc.gx);
  acc.gz = __fmaf_rn(m, __fsub_rn(z2, 1.0f), acc.gz);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Sums each of the V values over the block in a fixed order (shuffle tree
// within each warp, then the warp sums by the first warp).  The results
// are valid in thread 0.  `sh` must not be written again until every
// thread has passed one more __syncthreads: callers alternate between two
// buffers.
template <int V>
__device__ __forceinline__ void block_sum(float (&v)[V], float (*sh)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) sh[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kWarps;
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = warp_sum(live ? sh[i][lane] : 0.f);
  }
}

// --- tiles -------------------------------------------------------------------

struct Tile {
  int s;           // shard (row)
  int64_t lo;      // first observation of the tile in its row
  int n;           // observations in the tile
  bool vec;        // full and 16-byte aligned: read as float4
};

__device__ __forceinline__ Tile tile_at(int t, const Args& a) {
  Tile tl;
  tl.s = t / a.tiles_per_row;
  tl.lo = static_cast<int64_t>(t - tl.s * a.tiles_per_row) * kTile;
  const int64_t left = a.n_obs - tl.lo;
  tl.n = left < kTile ? static_cast<int>(left) : kTile;
  const int64_t off = static_cast<int64_t>(tl.s) * a.n_obs + tl.lo;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.x + off) |
                          reinterpret_cast<uintptr_t>(a.y + off) |
                          reinterpret_cast<uintptr_t>(a.m + off);
  tl.vec = tl.n == kTile && (align & 15u) == 0;
  return tl;
}

// A thread's share of a tile.  Full aligned tiles: float4 k of each array
// is at threadIdx.x + k * kThreads.  Other tiles: observation
// threadIdx.x + i * kThreads is component i % 4 of float4 i / 4 (those at
// or past the tile's end are not read and not summed).
struct Regs {
  float4 x[kVec], y[kVec], m[kVec];
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_comp(float4& v, int i, float f) {
  if (i == 0) v.x = f;
  else if (i == 1) v.y = f;
  else if (i == 2) v.z = f;
  else v.w = f;
}

__device__ __forceinline__ void load_vec(Regs& r, const Tile& tl, const Args& a) {
  const int64_t off = static_cast<int64_t>(tl.s) * a.n_obs + tl.lo;
  const float4* x4 = reinterpret_cast<const float4*>(a.x + off) + threadIdx.x;
  const float4* y4 = reinterpret_cast<const float4*>(a.y + off) + threadIdx.x;
  const float4* m4 = reinterpret_cast<const float4*>(a.m + off) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    r.x[k] = __ldcs(x4 + k * kThreads);
    r.y[k] = __ldcs(y4 + k * kThreads);
    r.m[k] = __ldcs(m4 + k * kThreads);
  }
}

__device__ __forceinline__ void load_scalar(Regs& r, const Tile& tl,
                                            const Args& a) {
  const int64_t off = static_cast<int64_t>(tl.s) * a.n_obs + tl.lo;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < tl.n) {
      set_comp(r.x[i / 4], i % 4, __ldg(a.x + off + j));
      set_comp(r.y[i / 4], i % 4, __ldg(a.y + off + j));
      set_comp(r.m[i / 4], i % 4, __ldg(a.m + off + j));
    }
  }
}

// P chains' sums over the thread's share of a tile, each chain's terms in
// the same order.
template <int P>
__device__ __forceinline__ void sum_tile(Acc (&acc)[P], const Regs& r,
                                         const Tile& tl,
                                         const Scalars (&p)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = Acc{0.f, 0.f, 0.f, 0.f};
  if (tl.vec) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < P; ++j)
          accumulate(acc[j], comp(r.x[k], q), comp(r.y[k], q),
                     comp(r.m[k], q), p[j]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (static_cast<int>(threadIdx.x) + i * kThreads < tl.n) {
#pragma unroll
        for (int j = 0; j < P; ++j)
          accumulate(acc[j], comp(r.x[i / 4], i % 4), comp(r.y[i / 4], i % 4),
                     comp(r.m[i / 4], i % 4), p[j]);
      }
    }
  }
}

// --- the kernel ----------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
    linreg_reductions_kernel(const Args a) {
  __shared__ float sh[2][4 * P][kWarps];
  __shared__ Scalars staged[P > 1 ? kThreads : 1];
  __shared__ float4 rows_sh[kRowsShared];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int n_tiles = a.n_shards * a.tiles_per_row;
  const int n_items = n_tiles * a.n_chain_blocks;

  // With P = 1 there is one chain, whose parameters (but the shard's
  // offset) are read once; `next` holds the block's next tile once it is
  // known to be full and aligned, and `tn` describes it.
  Regs next;
  Tile tn;
  float ls1 = 0.f, b0 = 0.f, b1 = 0.f, inv_s2_1 = 0.f;
  if (P == 1) {
    ls1 = __ldg(a.log_sigma);
    b0 = __ldg(a.intercept);
    b1 = __ldg(a.slope);
    inv_s2_1 = inv_sigma2(ls1);
    tn = tile_at(blockIdx.x / a.n_chain_blocks, a);
    if (tn.vec) load_vec(next, tn, a);
  }

  int i = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int t = w / a.n_chain_blocks;
    const int cb = w - t * a.n_chain_blocks;
    Tile tl;
    Regs cur;
    if (P == 1) {
      tl = tn;
      cur = next;
      if (w + gridDim.x < n_items) {
        tn = tile_at((w + gridDim.x) / a.n_chain_blocks, a);
        if (tn.vec) load_vec(next, tn, a);
      }
    } else {
      tl = tile_at(t, a);
      if (tl.vec) load_vec(cur, tl, a);
    }
    if (!tl.vec) load_scalar(cur, tl, a);

    const int c_lo = cb * a.chain_block;
    const int c_hi = min(a.n_chains, c_lo + a.chain_block);
    for (int c_stage = c_lo; c_stage < c_hi; c_stage += kThreads) {
      const int c_end = min(c_hi, c_stage + kThreads);
      if (P > 1) {
        // Each thread stages one chain's parameters for this tile's shard
        // (one expf per chain, not per thread and pass).
        __syncthreads();  // the previous chains' readers are done
        if (tid < c_end - c_stage) staged[tid] = chain_scalars(a, c_stage + tid, tl.s);
        __syncthreads();
      }
      for (int c0 = c_stage; c0 < c_end; c0 += P, ++i) {
        // Lanes past the last chain compute on the last chain's parameters
        // and are not stored.
        Scalars p[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          // chain_scalars(a, c, tl.s), as one chain computes it.
          p[j] = P == 1 ? Scalars{__fadd_rn(b0, __ldg(a.offsets + tl.s)), b1, inv_s2_1,
                                  -__fadd_rn(ls1, kHalfLog2Pi)}
                        : staged[min(c0 + j, c_end - 1) - c_stage];
        }
        Acc acc[P];
        sum_tile<P>(acc, cur, tl, p);
        float v[4 * P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          v[4 * j] = acc[j].ll;
          v[4 * j + 1] = acc[j].gmu;
          v[4 * j + 2] = acc[j].gx;
          v[4 * j + 3] = acc[j].gz;
        }
        block_sum<4 * P>(v, sh[i & 1]);
        if (tid == 0) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
            if (c0 + j < c_end)
              a.partials[static_cast<int64_t>(c0 + j) * n_tiles + t] =
                  make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
          }
        }
      }
    }
  }

  // Draw a ticket; the block that draws the last one finishes the call.
  // The ticket is an acq_rel atomic: it releases this block's partials
  // (all written by thread 0) and, in the last block, acquires every
  // other block's; the __syncthreads passes them on to the block.
  if (tid == 0) {
    unsigned int prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(a.ticket)
                 : "memory");
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // Each (chain, shard) row's partials are summed by a group of G lanes (G
  // a power of two, at most 32, fixed by n_shards and tiles_per_row): lane
  // l of the group takes tiles l, l + G, ... in order, then a shuffle tree
  // over the group.  Rounds run in lockstep over the whole block so that
  // every lane of a warp reaches every shuffle; kRoundsInFlight rounds at a
  // time (P > 1), so that their loads overlap.  The rows go to `out` and, when
  // they fit, to shared memory for the totals below.
  const int S = a.n_shards;
  int G = 1;
  while (G < 32 && G < a.tiles_per_row && G * 2 * S <= kThreads) G *= 2;
  const int groups = kThreads / G;
  const int g = tid / G;
  const int lane = tid % G;
  const int rows = a.n_chains * S;
  const bool rows_in_sh = rows <= kRowsShared;
  constexpr int R = P == 1 ? 1 : kRoundsInFlight;
  for (int base = 0; base < rows; base += R * groups) {
    Acc r[R];
    float ls[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int row = base + q * groups + g;
      r[q] = Acc{0.f, 0.f, 0.f, 0.f};
      ls[q] = ls1;
      if (row < rows) {
        const int c = row / S;
        const int s = row - c * S;
        if (P > 1) ls[q] = __ldg(a.log_sigma + c * a.stride_log_sigma);
        const float4* ps = a.partials + static_cast<int64_t>(c) * n_tiles +
                           static_cast<int64_t>(s) * a.tiles_per_row;
        for (int j = lane; j < a.tiles_per_row; j += G) {
          const float4 v = __ldcg(ps + j);
          r[q].ll = __fadd_rn(r[q].ll, v.x);
          r[q].gmu = __fadd_rn(r[q].gmu, v.y);
          r[q].gx = __fadd_rn(r[q].gx, v.z);
          r[q].gz = __fadd_rn(r[q].gz, v.w);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (base + q * groups >= rows) break;  // the same for every thread
      for (int o = G / 2; o > 0; o >>= 1) {
        r[q].ll = __fadd_rn(r[q].ll, __shfl_down_sync(0xffffffffu, r[q].ll, o, G));
        r[q].gmu = __fadd_rn(r[q].gmu, __shfl_down_sync(0xffffffffu, r[q].gmu, o, G));
        r[q].gx = __fadd_rn(r[q].gx, __shfl_down_sync(0xffffffffu, r[q].gx, o, G));
        r[q].gz = __fadd_rn(r[q].gz, __shfl_down_sync(0xffffffffu, r[q].gz, o, G));
      }
      const int row = base + q * groups + g;
      if (lane == 0 && row < rows) {
        const int c = row / S;
        const int s = row - c * S;
        const float inv_s2 = P == 1 ? inv_s2_1 : inv_sigma2(ls[q]);
        const float4 v = make_float4(r[q].ll, __fmul_rn(r[q].gmu, inv_s2),
                                     __fmul_rn(r[q].gx, inv_s2), r[q].gz);
        a.out[static_cast<int64_t>(c) * (S + 1) + s] = v;
        if (rows_in_sh) rows_sh[row] = v;
      }
    }
  }
  __syncthreads();  // the rows, written by this block, are visible to it

  // Each chain's totals over its S rows, in an order fixed by S alone.
  if (S <= 32) {
    // A group of H lanes (H the power of two >= S) per chain, lane l
    // holding row l, then a shuffle tree over the group.
    int H = 1;
    while (H < S) H *= 2;
    const int per_round = kThreads / H;
    const int h = tid / H;
    const int hl = tid % H;
    for (int base = 0; base < a.n_chains; base += per_round) {
      const int c = base + h;
      Acc r = {0.f, 0.f, 0.f, 0.f};
      if (c < a.n_chains && hl < S) {
        const float4 v = rows_in_sh ? rows_sh[c * S + hl]
                                    : a.out[static_cast<int64_t>(c) * (S + 1) + hl];
        r = Acc{v.x, v.y, v.z, v.w};
      }
      for (int o = H / 2; o > 0; o >>= 1) {
        r.ll = __fadd_rn(r.ll, __shfl_down_sync(0xffffffffu, r.ll, o, H));
        r.gmu = __fadd_rn(r.gmu, __shfl_down_sync(0xffffffffu, r.gmu, o, H));
        r.gx = __fadd_rn(r.gx, __shfl_down_sync(0xffffffffu, r.gx, o, H));
        r.gz = __fadd_rn(r.gz, __shfl_down_sync(0xffffffffu, r.gz, o, H));
      }
      if (hl == 0 && c < a.n_chains)
        a.out[static_cast<int64_t>(c) * (S + 1) + S] =
            make_float4(r.ll, r.gmu, r.gx, r.gz);
    }
  } else {
    // The whole block per chain: thread l sums rows l, l + kThreads, ...
    // in order, then the fixed block tree.
    for (int c = 0; c < a.n_chains; ++c, ++i) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* row = a.out + static_cast<int64_t>(c) * (S + 1);
      for (int s = tid; s < S; s += kThreads) {
        const float4 u = row[s];
        v[0] = __fadd_rn(v[0], u.x);
        v[1] = __fadd_rn(v[1], u.y);
        v[2] = __fadd_rn(v[2], u.z);
        v[3] = __fadd_rn(v[3], u.w);
      }
      block_sum<4>(v, sh[i & 1]);
      if (tid == 0)
        a.out[static_cast<int64_t>(c) * (S + 1) + S] =
            make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (tid == 0) *a.ticket = 0u;
}

int g_blocks[2][kMaxDevices];  // persistent grid per kernel and device

// Blocks of the persistent grid of the P-chain kernel on the current
// device: the blocks per SM that the occupancy calculator allows at its
// registers, times the SM count.  Returns a negative CUDA error on failure.
template <int P>
int persistent_blocks() {
  const int k = P == 1 ? 0 : 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < kMaxDevices && g_blocks[k][dev] > 0) return g_blocks[k][dev];
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, linreg_reductions_kernel<P>, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = per_sm * sms;
  if (dev < kMaxDevices) g_blocks[k][dev] = blocks;
  return blocks;
}

template <int P>
int launch(Args a, int max_blocks, cudaStream_t stream) {
  const int blocks = persistent_blocks<P>();
  if (blocks < 0) return -blocks;
  const int n_tiles = a.n_shards * a.tiles_per_row;
  // Chain blocks: as many as keep the grid busy when there are fewer
  // tiles than blocks, each a whole number of passes.
  const int passes = (a.n_chains + P - 1) / P;
  int n_cb = blocks / n_tiles;
  if (n_cb < 1) n_cb = 1;
  if (n_cb > passes) n_cb = passes;
  const int passes_per_block = (passes + n_cb - 1) / n_cb;
  a.chain_block = passes_per_block * P;
  a.n_chain_blocks = (a.n_chains + a.chain_block - 1) / a.chain_block;
  const int n_items = n_tiles * a.n_chain_blocks;
  int grid = n_items < blocks ? n_items : blocks;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  linreg_reductions_kernel<P><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Observations per tile: the wrapper sizes the partials scratch as
// (n_chains * n_shards * ceil(n_obs / tile), 4) floats.
int linreg_tile() { return kTile; }

// Blocks of the persistent grid of the one-chain kernel, and of the
// kernel for more chains, on the current device (negative: a CUDA error
// code, negated).
int linreg_persistent_blocks() { return persistent_blocks<1>(); }
int linreg_persistent_blocks_batched() {
  return persistent_blocks<kChainsPerPass>();
}

// Enqueues the kernel on `stream`, once; returns cudaGetLastError() (0
// when the launch was accepted).  All pointers are device pointers.
// Chain c's intercept, slope and log_sigma are at intercept[c *
// stride_intercept] and so on, its offsets at offsets[c * stride_offsets
// + s] (a stride of 0 shares one value among the chains); x, y, m are
// (S, N) contiguous float32, shared; partials (C * S * tiles_per_row, 4)
// and out (C, S + 1, 4) float32, 16-byte aligned; ticket one unsigned int
// that is 0 and that no call on another stream uses at the same time.
// Row S of each chain's block of out receives its totals.  max_blocks > 0
// caps the grid (a check that the result's bits do not depend on the grid
// uses it); 0 launches the persistent grid.
int linreg_reductions_launch(const float* intercept, long long stride_intercept,
                             const float* slope, long long stride_slope,
                             const float* log_sigma, long long stride_log_sigma,
                             const float* offsets, long long stride_offsets,
                             const float* x, const float* y, const float* m,
                             float* partials, float* out,
                             unsigned int* ticket, int n_chains, int n_shards,
                             long long n_obs, int tiles_per_row,
                             int max_blocks, void* stream) {
  Args a;
  a.intercept = intercept;
  a.slope = slope;
  a.log_sigma = log_sigma;
  a.offsets = offsets;
  a.stride_intercept = stride_intercept;
  a.stride_slope = stride_slope;
  a.stride_log_sigma = stride_log_sigma;
  a.stride_offsets = stride_offsets;
  a.x = x;
  a.y = y;
  a.m = m;
  a.partials = reinterpret_cast<float4*>(partials);
  a.out = reinterpret_cast<float4*>(out);
  a.ticket = ticket;
  a.n_chains = n_chains;
  a.n_shards = n_shards;
  a.n_obs = n_obs;
  a.tiles_per_row = tiles_per_row;
  a.chain_block = 0;
  a.n_chain_blocks = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The one-chain kernel (P = 1) reads chain 0's parameters only.
  return n_chains == 1 ? launch<1>(a, max_blocks, st)
                       : launch<kChainsPerPass>(a, max_blocks, st);
}

const char* linreg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
