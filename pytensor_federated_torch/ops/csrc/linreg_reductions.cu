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
// What bounds it: device-memory bytes.  A call reads x, y and mask once,
// 12*S*N bytes, and writes 16*S bytes of results; it does about 15 float
// operations for those 12 bytes, two orders of magnitude below the H100's
// float32 operations-per-byte balance.  So the design streams every input
// byte exactly once, with 16-byte loads where the three rows are equally
// aligned, and spreads the observation axis over blocks of kChunk
// observations so that even 8 shards fill every SM (the TPU kernel walked
// that axis in order on one core).  Each block writes one float4 of
// partial sums; a second small kernel reduces a shard's partials in a
// fixed order.  No float atomics anywhere: reruns are bitwise identical.
//
// The scalars (intercept, slope, log_sigma) and the offsets are read from
// device memory, so a call needs no host copy of the parameters.  The
// kernel masks the ragged end of each row itself; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 4096;   // observations per block; a multiple of 4
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
__device__ __forceinline__ Acc block_sum(Acc a) {
  __shared__ float sh[4][kThreads / 32];
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
    const bool live = lane < kThreads / 32;
    t.ll = warp_sum(live ? sh[0][lane] : 0.f);
    t.gmu = warp_sum(live ? sh[1][lane] : 0.f);
    t.gx = warp_sum(live ? sh[2][lane] : 0.f);
    t.gz = warp_sum(live ? sh[3][lane] : 0.f);
  }
  return t;
}

// grid = (n_chunks, n_shards): block (c, s) reduces observations
// [c*kChunk, min((c+1)*kChunk, n_obs)) of shard s into partials[s, c].
__global__ void __launch_bounds__(kThreads)
    linreg_partials(const float* __restrict__ scalars,
                    const float* __restrict__ offsets,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ m, float4* __restrict__ partials,
                    int64_t n_obs, int n_chunks) {
  const int s = blockIdx.y;
  const int c = blockIdx.x;
  const float log_sigma = scalars[2];
  const Scalars p = {scalars[0] + offsets[s], scalars[1],
                     expf(-2.0f * log_sigma), log_sigma + kHalfLog2Pi};

  const int64_t row = static_cast<int64_t>(s) * n_obs;
  const float* xr = x + row;
  const float* yr = y + row;
  const float* mr = m + row;
  const int64_t lo = static_cast<int64_t>(c) * kChunk;
  const int64_t hi = lo + kChunk < n_obs ? lo + kChunk : n_obs;

  Acc acc = {0.f, 0.f, 0.f, 0.f};
  // 16-byte loads need the three rows at the same offset modulo 16 bytes;
  // a row of a tensor whose width is not a multiple of 4 starts unaligned,
  // so a short scalar head brings the vector part onto the boundary.
  const uintptr_t mis = reinterpret_cast<uintptr_t>(xr + lo) & 15u;
  const bool vec = (reinterpret_cast<uintptr_t>(yr + lo) & 15u) == mis &&
                   (reinterpret_cast<uintptr_t>(mr + lo) & 15u) == mis;
  int64_t vlo = hi, nvec = 0;
  if (vec) {
    const int64_t head = static_cast<int64_t>(((16u - mis) & 15u) >> 2);
    vlo = lo + head < hi ? lo + head : hi;
    nvec = (hi - vlo) >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr + vlo);
    const float4* y4 = reinterpret_cast<const float4*>(yr + vlo);
    const float4* m4 = reinterpret_cast<const float4*>(mr + vlo);
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const float4 xv = x4[i];
      const float4 yv = y4[i];
      const float4 mv = m4[i];
      accumulate(acc, xv.x, yv.x, mv.x, p);
      accumulate(acc, xv.y, yv.y, mv.y, p);
      accumulate(acc, xv.z, yv.z, mv.z, p);
      accumulate(acc, xv.w, yv.w, mv.w, p);
    }
  } else {
    vlo = lo;
  }
  // Scalar head [lo, vlo) and tail [vlo + 4*nvec, hi): the whole range
  // when the rows cannot be read as float4.
  for (int64_t j = lo + threadIdx.x; j < vlo; j += kThreads)
    accumulate(acc, xr[j], yr[j], mr[j], p);
  for (int64_t j = vlo + 4 * nvec + threadIdx.x; j < hi; j += kThreads)
    accumulate(acc, xr[j], yr[j], mr[j], p);

  const Acc t = block_sum(acc);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(s) * n_chunks + c] =
        make_float4(t.ll, t.gmu, t.gx, t.gz);
}

// grid = n_shards: block s sums partials[s, :] in a fixed order and
// writes out[s] = (ll, gmu, gx, gz).
__global__ void __launch_bounds__(kThreads)
    linreg_finalize(const float* __restrict__ scalars,
                    const float4* __restrict__ partials,
                    float4* __restrict__ out, int n_chunks) {
  const int s = blockIdx.x;
  Acc acc = {0.f, 0.f, 0.f, 0.f};
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    const float4 v = partials[static_cast<int64_t>(s) * n_chunks + c];
    acc.ll += v.x;
    acc.gmu += v.y;
    acc.gx += v.z;
    acc.gz += v.w;
  }
  const Acc t = block_sum(acc);
  if (threadIdx.x == 0) {
    const float inv_s2 = expf(-2.0f * scalars[2]);
    out[s] = make_float4(t.ll, t.gmu * inv_s2, t.gx * inv_s2, t.gz);
  }
}

}  // namespace

extern "C" {

// Observations per block of the first kernel: the wrapper sizes the
// partials scratch as (n_shards, ceil(n_obs / chunk), 4).
int linreg_chunk() { return kChunk; }

// Enqueues both kernels on `stream`; returns cudaGetLastError() (0 when
// both launches were accepted).  All pointers are device pointers to
// contiguous float32: scalars (3,), offsets (S,), x/y/m (S, N),
// partials (S, n_chunks, 4), out (S, 4), the last two 16-byte aligned.
int linreg_reductions_launch(const float* scalars, const float* offsets,
                             const float* x, const float* y, const float* m,
                             float* partials, float* out, int n_shards,
                             long long n_obs, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  linreg_partials<<<dim3(n_chunks, n_shards), kThreads, 0, st>>>(
      scalars, offsets, x, y, m, reinterpret_cast<float4*>(partials), n_obs,
      n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linreg_finalize<<<n_shards, kThreads, 0, st>>>(
      scalars, reinterpret_cast<const float4*>(partials),
      reinterpret_cast<float4*>(out), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* linreg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
