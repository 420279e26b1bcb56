// Per-row cross-entropy (Eq. 1) for NVIDIA Hopper (sm_90a):
//
//     lse[r] = log sum_v exp(x[r, v]),   nll[r] = lse[r] - x[r, labels[r]]
//
// for logits x [R, V] (f32 or bf16, read as f32) and labels i32 [R]; both
// outputs are f32 [R].  The backward (softmax - one_hot) is torch ops on the
// saved logits and lse (kernels/cross_entropy/ops.py).
//
// Replaces the TPU kernel repro/kernels/cross_entropy/kernel.py:
// cross_entropy_tiled (body _ce_kernel).  That kernel walks vocab tiles as
// a sequential grid axis, carrying the running (max, sum, label logit) in
// VMEM scratch from one grid step to the next, and its wrapper pads V with
// -1e30 to a multiple of the tile.  Blocks on a GPU run in no order, so the
// vocab sweep of a row lives inside one block here; the ragged tail is
// masked by the loop bounds, so any V works without padding, and the label
// logit is read once directly instead of being searched for in every tile.
//
// Bound: memory.  Each logit is read once: R * V * 4 bytes in f32 (100.7 MB
// at R 512, V 49,152: 0.030 ms at the H100's 3.35 TB/s), half that in bf16.
// The one exponential per logit (25 M at R 512) stays well under the card's
// special-function rate.
//
// Design: one block of 256 threads per row.  Each thread strides over the
// row with 16-byte loads (4 f32 or 8 bf16; four loads in flight per
// iteration) and keeps an online (max m, sum s) pair, one exponential per
// element.  A row whose start is not 16-byte aligned (V * size not a
// multiple of 16) takes a scalar loop.  The 256 pairs merge by warp
// shuffles, then across the 8 warps through shared memory.  Thread 0 reads
// x[r, labels[r]] and writes lse = m + log s and nll = lse - x[label]
// (NaN for a label outside [0, V)).  Extreme logits (+-1e4) stay finite:
// every exponential is of a difference <= 0.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// fold one logit into (m, s): s = sum exp(x_i - m) over the folded x_i
__device__ __forceinline__ void fold(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else if (m != -INFINITY) {
    s += expf(x - m);
  }
}

// merge another thread's pair into (m, s); an empty pair has m = -inf
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one 16-byte pack: 4 f32 or 8 bf16 logits
__device__ __forceinline__ void fold_pack(float& m, float& s, uint4 p,
                                          float) {
  const float4 f = *reinterpret_cast<const float4*>(&p);
  fold(m, s, f.x);
  fold(m, s, f.y);
  fold(m, s, f.z);
  fold(m, s, f.w);
}
__device__ __forceinline__ void fold_pack(float& m, float& s, uint4 p,
                                          __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    fold(m, s, f.x);
    fold(m, s, f.y);
  }
}

__device__ __forceinline__ void merge_warp(float& m, float& s, int width) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < width) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cross_entropy_kernel(const T* __restrict__ logits,
                     const int* __restrict__ labels,
                     float* __restrict__ nll, float* __restrict__ lse,
                     int64_t V) {
  constexpr int kPack = 16 / sizeof(T);
  const int64_t r = blockIdx.x;
  const T* x = logits + r * V;
  float m = -INFINITY, s = 0.0f;
  int64_t done = 0;                      // elements the pack loop covers
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const uint4* xp = reinterpret_cast<const uint4*>(x);
    const int64_t n_pack = V / kPack;
    int64_t i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < n_pack; i += kUnroll * kThreads) {
      uint4 p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) p[u] = xp[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold_pack(m, s, p[u], T());
    }
    for (; i < n_pack; i += kThreads) fold_pack(m, s, xp[i], T());
    done = n_pack * kPack;
  }
  for (int64_t i = done + threadIdx.x; i < V; i += kThreads) {
    fold(m, s, to_f32(x[i]));
  }

  merge_warp(m, s, 32);
  __shared__ float wm[kWarps], ws[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? wm[lane] : -INFINITY;
    s = lane < kWarps ? ws[lane] : 0.0f;
    merge_warp(m, s, kWarps);
    if (lane == 0) {
      const float l = m + logf(s);
      const int y = labels[r];
      const float xy = (y >= 0 && y < V) ? to_f32(x[y]) : NAN;
      lse[r] = l;
      nll[r] = l - xy;
    }
  }
}

// The launch's grid: one block per row (none for R == 0).
inline int64_t grid_blocks(int64_t R) { return R > 0 ? R : 0; }

template <typename T>
int launch(int device, const void* logits, const void* labels, void* nll,
           void* lse, int64_t R, int64_t V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = grid_blocks(R);
  if (blocks > 0) {
    cross_entropy_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(logits), static_cast<const int*>(labels),
        static_cast<float*>(nll), static_cast<float*>(lse), V);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int cross_entropy_f32(int device, const void* logits, const void* labels,
                      void* nll, void* lse, int64_t R, int64_t V,
                      void* stream) {
  return launch<float>(device, logits, labels, nll, lse, R, V, stream);
}

int cross_entropy_bf16(int device, const void* logits, const void* labels,
                       void* nll, void* lse, int64_t R, int64_t V,
                       void* stream) {
  return launch<__nv_bfloat16>(device, logits, labels, nll, lse, R, V,
                               stream);
}

// Host only: the grid launch<T> computes for R rows, as grid3 = (x, y, z)
// (all 0 when nothing is launched).  Launches nothing.
int cross_entropy_geometry(int64_t R, int64_t* grid3) {
  const int64_t blocks = grid_blocks(R);
  grid3[0] = blocks;
  grid3[1] = blocks > 0 ? 1 : 0;
  grid3[2] = blocks > 0 ? 1 : 0;
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
