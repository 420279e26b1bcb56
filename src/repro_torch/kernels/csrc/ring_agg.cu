// Fused multi-upload aggregation chain for NVIDIA Hopper (sm_90a):
//
//     acc <- c_u * acc + d_u * locs[u]      for u = 0 .. U-1,  acc = g
//     out  = acc
//
// over a packed [P] parameter buffer, in f32.  g and out are f32; the U
// upload rows locs[u] are f32 or bf16 (exports ring_agg_f32 and
// ring_agg_bf16); coeffs is a device array of U (c, d) f32 pairs, so the
// host never reads a coefficient.
//
// Replaces the TPU kernel src/repro/kernels/weighted_agg/kernel.py:ring_agg_2d
// (body _make_ring_kernel, pallas_call at :113).  That kernel keeps the
// accumulator in its output tile across sequential grid steps over upload
// chunks; GPU blocks run in parallel and in no order, so that carry would
// race here.  Instead every thread owns its elements for the whole chain and
// loops over all U uploads in registers: no cross-block state at all.
//
// Bound: memory.  A chain reads g once (4 B/element), each upload row once
// (s = 4 or 2 B/element) and writes out once (4 B/element): (8 + U*s)*P
// bytes, plus 8*U bytes of coefficients, for 3*U*P flops.  At U = 10 and the
// paper CNN's P = 422,016 that is 20.26 MB in f32 (6.05 us at 3.35 TB/s) and
// 11.82 MB with bf16 uploads (3.53 us); 12.7 MFLOP is 0.19 us at 67 TFLOP/s.
//
// Design (simple first): one thread per 16-byte pack of g/out (4 f32
// elements; a bf16 thread takes 8 elements so its upload load is one 16-byte
// pack too).  The u loop is unrolled by 4 so several independent row loads
// are in flight.  Coefficients are staged in shared memory in tiles of up to
// 1024 pairs.  Every row is P elements apart and P % 128 == 0, so an aligned
// base (checked by the wrapper) aligns every row.  The loop runs exactly U
// steps: no padding and no mask, so signed zeros come out as the plain
// arithmetic gives them.  cp.async/TMA staging of the rows is later work.
//
// Rounding: __fmul_rn / __fadd_rn keep nvcc from contracting the update into
// an FMA, so the result is bitwise the plain PyTorch chain (two multiplies
// and an add per step, each rounded) run eagerly on the card.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoefTile = 1024;

__device__ __forceinline__ float step(float acc, float l, float2 cd) {
  return __fadd_rn(__fmul_rn(cd.x, acc), __fmul_rn(cd.y, l));
}

// upload values of one thread's pack, as f32
template <typename T> struct Row;

template <> struct Row<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* p, float* l) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
  }
};

template <> struct Row<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* l) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      l[2 * k] = f.x;
      l[2 * k + 1] = f.y;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_agg_kernel(float* __restrict__ out, const float* __restrict__ g,
                const T* __restrict__ locs, const float2* __restrict__ coeffs,
                int64_t P, int64_t U) {
  constexpr int kElems = Row<T>::kElems;
  __shared__ float2 coef[kCoefTile];
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads +
                         threadIdx.x) * kElems;
  const bool live = first < P;
  float acc[kElems];
  if (live) {
#pragma unroll
    for (int k = 0; k < kElems; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(g + first + k);
      acc[k] = v.x; acc[k + 1] = v.y; acc[k + 2] = v.z; acc[k + 3] = v.w;
    }
  }
  for (int64_t u0 = 0; u0 < U; u0 += kCoefTile) {
    const int n = static_cast<int>(U - u0 < kCoefTile ? U - u0 : kCoefTile);
    __syncthreads();                    // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += kThreads) coef[j] = coeffs[u0 + j];
    __syncthreads();
    if (live) {
      const T* row = locs + u0 * P + first;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float l[kElems];
        Row<T>::load(row + j * P, l);
        const float2 cd = coef[j];
#pragma unroll
        for (int k = 0; k < kElems; ++k) acc[k] = step(acc[k], l[k], cd);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kElems; k += 4) {
      *reinterpret_cast<float4*>(out + first + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
  }
}

// The launch's grid: one block per kThreads packs of `elems` elements.
inline int64_t grid_blocks(int64_t P, int elems) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * elems;
  return (P + per_block - 1) / per_block;
}

template <typename T>
int launch(int device, void* out, const void* g, const void* locs,
           const void* coeffs, int64_t P, int64_t U, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = grid_blocks(P, Row<T>::kElems);
  ring_agg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(g),
      static_cast<const T*>(locs), static_cast<const float2*>(coeffs), P, U);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).  The
// caller guarantees P % 128 == 0, U >= 1, 16-byte aligned g/locs/out and
// 8-byte aligned coeffs.
int ring_agg_f32(int device, void* out, const void* g, const void* locs,
                 const void* coeffs, int64_t P, int64_t U, void* stream) {
  return launch<float>(device, out, g, locs, coeffs, P, U, stream);
}

int ring_agg_bf16(int device, void* out, const void* g, const void* locs,
                  const void* coeffs, int64_t P, int64_t U, void* stream) {
  return launch<__nv_bfloat16>(device, out, g, locs, coeffs, P, U, stream);
}

// Host only: the grid launch<T> computes for a [P] buffer with upload rows
// of elem_bytes bytes (4: f32, 2: bf16), as grid3 = (x, y, z).  Launches
// nothing.
int ring_agg_geometry(int64_t P, int elem_bytes, int64_t* grid3) {
  if (elem_bytes != 4 && elem_bytes != 2) return cudaErrorInvalidValue;
  grid3[0] = grid_blocks(P, elem_bytes == 4 ? Row<float>::kElems
                                            : Row<__nv_bfloat16>::kElems);
  grid3[1] = 1;
  grid3[2] = 1;
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
