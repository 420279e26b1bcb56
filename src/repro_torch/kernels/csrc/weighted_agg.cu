// Fused MAFL aggregation (Eq. 10 + Eq. 11) for NVIDIA Hopper (sm_90a):
//
//     out = beta * g + coef * l,   coef = (1 - beta) * weight
//
// computed in f32 and rounded back to the storage type (f32 or bf16).
//
// Replaces the TPU kernel repro/kernels/weighted_agg/kernel.py:weighted_agg_2d
// (body _agg_kernel).  The TPU version tiles a zero-padded [R, 128] view and
// routes leaves under 128 elements to a jnp oracle; this kernel walks the
// flat leaf itself and masks its own ragged edge, so every leaf of every
// size goes through it, one launch per leaf.
//
// Bound: memory.  Each element reads g and l and writes out: 12 bytes per
// f32 element for 3 flops.  A full merge of the paper CNN (P = 421,642
// parameters) moves 5.06 MB, about 1.5 us at the H100's 3.35 TB/s.  The
// eight leaves are eight small launches, so a merge is launch-bound well
// above that; fusing the leaves into one launch or capturing the merge in a
// CUDA graph is later work.
//
// Design: a grid-stride loop over 16-byte packs (float4 / 8 x bf16) when
// all three pointers are 16-byte aligned, then a scalar loop over the tail
// (or over the whole leaf when a pointer is not aligned).
//
// Rounding: beta and coef arrive already rounded to f32 by the host, in the
// JAX kernel's order.  __fmul_rn / __fadd_rn keep nvcc from contracting
// beta*g + coef*l into an FMA, so the result is bitwise the plain PyTorch
// version (two multiplies and an add, each rounded) run eagerly on the card.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;  // 8 resident blocks per H100 SM

__device__ __forceinline__ float mix(float g, float l, float beta,
                                     float coef) {
  return __fadd_rn(__fmul_rn(beta, g), __fmul_rn(coef, l));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one 16-byte pack: 4 f32 or 8 bf16 elements
__device__ __forceinline__ uint4 mix_pack(uint4 g, uint4 l, float beta,
                                          float coef, float) {
  float4 gf = *reinterpret_cast<float4*>(&g);
  float4 lf = *reinterpret_cast<float4*>(&l);
  float4 o = make_float4(mix(gf.x, lf.x, beta, coef),
                         mix(gf.y, lf.y, beta, coef),
                         mix(gf.z, lf.z, beta, coef),
                         mix(gf.w, lf.w, beta, coef));
  return *reinterpret_cast<uint4*>(&o);
}
__device__ __forceinline__ uint4 mix_pack(uint4 g, uint4 l, float beta,
                                          float coef, __nv_bfloat16) {
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
  const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&l);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 a = __bfloat1622float2(g2[k]);
    float2 b = __bfloat1622float2(l2[k]);
    o2[k] = __floats2bfloat162_rn(mix(a.x, b.x, beta, coef),
                                  mix(a.y, b.y, beta, coef));
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(T* __restrict__ out, const T* __restrict__ g,
                    const T* __restrict__ l, int64_t n, int64_t n_pack,
                    float beta, float coef) {
  constexpr int kPack = 16 / sizeof(T);
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint4* gp = reinterpret_cast<const uint4*>(g);
  const uint4* lp = reinterpret_cast<const uint4*>(l);
  uint4* op = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < n_pack; i += stride) {
    op[i] = mix_pack(gp[i], lp[i], beta, coef, T());
  }
  for (int64_t i = n_pack * kPack + tid; i < n; i += stride) {
    out[i] = from_f32<T>(mix(to_f32(g[i]), to_f32(l[i]), beta, coef));
  }
}

template <typename T>
int launch(int device, void* out, const void* g, const void* l, int64_t n,
           float beta, float coef, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kPack = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(l)) & 15) == 0;
  const int64_t n_pack = aligned ? n / kPack : 0;
  const int64_t work = n_pack > n - n_pack * kPack ? n_pack
                                                   : n - n_pack * kPack;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  weighted_agg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), static_cast<const T*>(g),
      static_cast<const T*>(l), n, n_pack, beta, coef);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int weighted_agg_f32(int device, void* out, const void* g, const void* l,
                     int64_t n, float beta, float coef, void* stream) {
  return launch<float>(device, out, g, l, n, beta, coef, stream);
}

int weighted_agg_bf16(int device, void* out, const void* g, const void* l,
                      int64_t n, float beta, float coef, void* stream) {
  return launch<__nv_bfloat16>(device, out, g, l, n, beta, coef, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
