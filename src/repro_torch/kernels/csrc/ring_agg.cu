// Fused multi-upload aggregation chain for NVIDIA Hopper (sm_90a):
//
//     acc <- c_u * acc + d_u * locs[u]      for u = 0 .. U-1,  acc = g
//     out  = acc
//
// over a packed [P] parameter buffer, in f32, for each of W independent
// worlds at once (the sweep tier's world axis; W = 1 is the fleet and
// corridor engines' chain).  g and out are f32 [W, P]; the U upload rows
// of world w, locs[w][u], are f32 or bf16 (exports ring_agg_f32 and
// ring_agg_bf16), P apart, with world w's rows starting w * ldw elements
// in (ldw >= U * P, a multiple of P: a [W, U, P] view of a [W, M, P] upload
// buffer is passed without a copy); coeffs is a device array of W * U
// (c, d) f32 pairs, so the host never reads a coefficient.
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
// bytes, plus 8*U bytes of coefficients, for 3*U*P flops, per world.  At
// U = 10 and the paper CNN's P = 422,016 that is 20.26 MB in f32 (6.05 us
// at 3.35 TB/s) and 11.82 MB with bf16 uploads (3.53 us); 12.7 MFLOP is
// 0.19 us at 67 TFLOP/s.  W worlds move W times the bytes in one launch.
//
// Design: a pack is 16 bytes of an upload row (4 f32 or 8 bf16 elements,
// and the same elements of g and out).
//   - A balanced grid: the block count is a multiple of kSMs (the H100
//     SXM's 132 SMs, a constant, not a device query), at most
//     kThreads * kPacks packs a block, and block i takes one contiguous run
//     of packs (run_of), the runs differing by at most one pack.  So every
//     SM holds as many blocks as every other and the chain ends on all of
//     them together, where blocks of a fixed size leave a tail on a few
//     SMs (413 blocks of 256 packs over 132 SMs put a fourth block on 17
//     of them).  On a card with another SM count the grid is only
//     slightly uneven.
//   - Loads in flight: thread t of a block owns packs t and t + kThreads
//     of its run, and loads kDepth upload rows of both (16 independent
//     16-byte loads) before it does the arithmetic of the first.  That
//     keeps some 50-100 KB in flight per SM from registers alone, so
//     cp.async.bulk (TMA) staging of row segments, the other option, was
//     not needed.  The upload rows are read once, so they are loaded with
//     the streaming cache operator (__ldcs, evict-first): with default
//     caching the deeper loads were no faster than one pack a thread; g
//     and out keep the default, which timed better.
//   - The world axis is the grid's y axis: block (i, w) runs block i's
//     run of world w, so each world's arithmetic, grid and runs are the
//     one-world launch's on its slices, bit for bit, and W = 1 is that
//     launch.
//   - Coefficients are staged in shared memory in tiles of up to 1024
//     pairs.  Every row is P elements apart and P % 128 == 0, so an aligned
//     base (checked by the wrapper) aligns every row.  The loop runs
//     exactly U steps: no padding and no mask, so signed zeros come out as
//     the plain arithmetic gives them.
//
// Rounding: __fmul_rn / __fadd_rn keep nvcc from contracting the update into
// an FMA, so the result is bitwise the plain PyTorch chain (two multiplies
// and an add per step, each rounded, in upload order) run eagerly on the
// card.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;         // the grid is a multiple of this
constexpr int kPacks = 2;         // packs a thread owns
constexpr int kDepth = 8;         // upload rows loaded ahead of their use
constexpr int kCoefTile = 1024;
constexpr int kBlocksPerSM = 2;   // registers capped so two blocks fit

__device__ __forceinline__ float step(float acc, float l, float2 cd) {
  return __fadd_rn(__fmul_rn(cd.x, acc), __fmul_rn(cd.y, l));
}

// one 16-byte pack of an upload row, and its values as f32
template <typename T> struct Row;

template <> struct Row<float> {
  static constexpr int kElems = 4;
  using Raw = float4;
  __device__ __forceinline__ static void unpack(const float4& v, float* l) {
    l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
  }
};

template <> struct Row<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* l) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      l[2 * k] = f.x;
      l[2 * k + 1] = f.y;
    }
  }
};

// The launch's grid: the fewest multiples of kSMs blocks that hold `packs`
// packs at kThreads * kPacks a block.
inline int64_t grid_blocks(int64_t packs) {
  const int64_t per_wave = static_cast<int64_t>(kSMs) * kThreads * kPacks;
  const int64_t waves = (packs + per_wave - 1) / per_wave;
  return kSMs * (waves > 0 ? waves : 1);
}

// Block i's run [lo, hi) of `packs` packs dealt over `blocks` blocks.
__device__ __forceinline__ void run_of(int64_t packs, int64_t blocks,
                                       int64_t i, int64_t& lo, int64_t& hi) {
  const int64_t per = packs / blocks, extra = packs % blocks;
  lo = i * per + (i < extra ? i : extra);
  hi = lo + per + (i < extra ? 1 : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ring_agg_kernel(float* __restrict__ out, const float* __restrict__ g,
                const T* __restrict__ locs, const float2* __restrict__ coeffs,
                int64_t P, int64_t U, int64_t ldw) {
  constexpr int E = Row<T>::kElems;
  using Raw = typename Row<T>::Raw;
  __shared__ float2 coef[kCoefTile];
  const int64_t w = blockIdx.y;      // the world: its own slices throughout
  out += w * P;
  g += w * P;
  locs += w * ldw;
  coeffs += w * U;
  int64_t lo, hi;
  run_of(P / E, gridDim.x, blockIdx.x, lo, hi);
  int64_t first[kPacks];
  bool live[kPacks];
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int64_t pk = lo + threadIdx.x + static_cast<int64_t>(k) * kThreads;
    live[k] = pk < hi;
    first[k] = pk * E;
  }
  float acc[kPacks][E];
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(g + first[k] + e);
      acc[k][e] = v.x; acc[k][e + 1] = v.y;
      acc[k][e + 2] = v.z; acc[k][e + 3] = v.w;
    }
  }
  for (int64_t u0 = 0; u0 < U; u0 += kCoefTile) {
    const int n = static_cast<int>(U - u0 < kCoefTile ? U - u0 : kCoefTile);
    __syncthreads();                    // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += kThreads) coef[j] = coeffs[u0 + j];
    __syncthreads();
    const T* rows = locs + u0 * P;
    for (int j0 = 0; j0 < n; j0 += kDepth) {
      Raw raw[kDepth][kPacks];
#pragma unroll
      for (int d = 0; d < kDepth; ++d)   // every load before any use
#pragma unroll
        for (int k = 0; k < kPacks; ++k)
          if (j0 + d < n && live[k])
            raw[d][k] = __ldcs(reinterpret_cast<const Raw*>(
                rows + (j0 + d) * P + first[k]));
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (j0 + d >= n) break;
        const float2 cd = coef[j0 + d];
#pragma unroll
        for (int k = 0; k < kPacks; ++k) {
          if (!live[k]) continue;
          float l[E];
          Row<T>::unpack(raw[d][k], l);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] = step(acc[k][e], l[e], cd);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      *reinterpret_cast<float4*>(out + first[k] + e) =
          make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2], acc[k][e + 3]);
    }
  }
}

// The launch's grid for W worlds of P elements with upload rows of
// elem_bytes bytes: x the balanced blocks of one world, y the worlds.
inline dim3 ring_grid(int64_t P, int elem_bytes, int64_t W) {
  return dim3(static_cast<unsigned>(grid_blocks(P / (16 / elem_bytes))),
              static_cast<unsigned>(W), 1);
}

template <typename T>
int launch(int device, void* out, const void* g, const void* locs,
           const void* coeffs, int64_t P, int64_t U, int64_t W, int64_t ldw,
           void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_agg_kernel<T><<<ring_grid(P, sizeof(T), W), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(g),
      static_cast<const T*>(locs), static_cast<const float2*>(coeffs), P, U,
      ldw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).  The
// caller guarantees P % 128 == 0, U >= 1, 1 <= W <= 65535, ldw a multiple
// of P of at least U * P, 16-byte aligned g/locs/out and 8-byte aligned
// coeffs.
int ring_agg_f32(int device, void* out, const void* g, const void* locs,
                 const void* coeffs, int64_t P, int64_t U, int64_t W,
                 int64_t ldw, void* stream) {
  return launch<float>(device, out, g, locs, coeffs, P, U, W, ldw, stream);
}

int ring_agg_bf16(int device, void* out, const void* g, const void* locs,
                  const void* coeffs, int64_t P, int64_t U, int64_t W,
                  int64_t ldw, void* stream) {
  return launch<__nv_bfloat16>(device, out, g, locs, coeffs, P, U, W, ldw,
                               stream);
}

// Host only: the grid launch<T> computes for W worlds of a [P] buffer with
// upload rows of elem_bytes bytes (4: f32, 2: bf16), as grid3 = (x, y, z).
// Launches nothing.
int ring_agg_geometry(int64_t P, int elem_bytes, int64_t W, int64_t* grid3) {
  if ((elem_bytes != 4 && elem_bytes != 2) || W < 1 || W > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid = ring_grid(P, elem_bytes, W);
  grid3[0] = grid.x;
  grid3[1] = grid.y;
  grid3[2] = grid.z;
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
