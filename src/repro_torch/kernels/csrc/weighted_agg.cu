// Fused MAFL aggregation (Eq. 10 + Eq. 11) for NVIDIA Hopper (sm_90a), over
// every leaf of a merge in one launch:
//
//     out = beta * g + coef * l,   coef = (1 - beta) * weight
//
// computed in f32 and rounded back to the storage type (f32 or bf16).
//
// Replaces the TPU kernel repro/kernels/weighted_agg/kernel.py:weighted_agg_2d
// (body _agg_kernel).  The TPU version tiles a zero-padded [R, 128] view of
// one leaf and routes leaves under 128 elements to a jnp oracle; this kernel
// walks a table of up to kMaxLeaves flat leaves, masks each leaf's ragged
// edge itself, and so takes every leaf of every size.
//
// Bound: memory.  Each element reads g and l and writes out: 12 bytes per
// f32 element for 3 flops.  A merge of the paper CNN (P = 421,642, 8 leaves)
// moves 5.06 MB, 1.5 us at the H100's 3.35 TB/s; a merge of smollm-360m
// (361,821,120 elements, 290 leaves) 4.34 GB, 1.296 ms.  One launch per
// leaf made the small merge launch-bound (8 launches of a few us each), so
// a merge is one launch per kMaxLeaves leaves: the table travels as the
// kernel's parameter (by value, within the 4 KB parameter limit), with no
// copy, allocation or host sync of its own.
//
// Design: blocks are dealt to leaves by a prefix of per-leaf block counts
// (first[]); a block finds its leaf by binary search over that prefix and
// owns kBlockElems consecutive elements of it.  Where the leaf's three
// pointers are 16-byte aligned it loads them as kUnroll 16-byte packs per
// thread, all issued before any is used; otherwise, and for the tail of
// under one pack, element by element.  The output is one flat buffer in
// which every leaf starts 16-byte aligned; the block holding a leaf's last
// element also zeroes the padding up to the next leaf, so the launches of a
// merge write the whole buffer, each element once.
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
constexpr int kUnroll = 4;          // 16-byte packs per thread per block
constexpr int kMaxLeaves = 112;     // leaves per launch: the table fits 4 KB

struct Leaf {
  const void* g;
  const void* l;
  void* out;
  int64_t n;                        // elements, >= 1
};

// The kernel's one parameter.  Leaf i owns blocks [first[i], first[i + 1]).
struct Table {
  Leaf leaf[kMaxLeaves];
  int first[kMaxLeaves + 1];
  int count;
  float beta;
  float coef;
};
static_assert(sizeof(Table) <= 4096, "kernel parameters are limited to 4 KB");

// elements one block owns: kThreads * kUnroll packs of 16 bytes
inline int64_t block_elems(int elem_bytes) {
  return static_cast<int64_t>(kThreads) * kUnroll * (16 / elem_bytes);
}

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
weighted_agg_kernel(const __grid_constant__ Table t) {
  constexpr int kPack = 16 / sizeof(T);
  constexpr int64_t kBlockElems =
      static_cast<int64_t>(kThreads) * kUnroll * kPack;
  const int blk = blockIdx.x;
  // this block's leaf: the last i with first[i] <= blk (uniform per block)
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const Leaf& leaf = t.leaf[lo];
  const T* __restrict__ g = static_cast<const T*>(leaf.g);
  const T* __restrict__ l = static_cast<const T*>(leaf.l);
  T* __restrict__ out = static_cast<T*>(leaf.out);
  const int64_t n = leaf.n;
  const int64_t start = (blk - t.first[lo]) * kBlockElems;
  const int64_t stop = n < start + kBlockElems ? n : start + kBlockElems;
  const float beta = t.beta, coef = t.coef;

  int64_t scalar_from = start;
  if (((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(l) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const uint4* gp = reinterpret_cast<const uint4*>(g);
    const uint4* lp = reinterpret_cast<const uint4*>(l);
    uint4* op = reinterpret_cast<uint4*>(out);
    const int64_t p0 = start / kPack, p1 = stop / kPack;
    if (p1 - p0 == kThreads * kUnroll) {
      uint4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t p = p0 + u * kThreads + threadIdx.x;
        a[u] = __ldg(gp + p);
        b[u] = __ldg(lp + p);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        op[p0 + u * kThreads + threadIdx.x] =
            mix_pack(a[u], b[u], beta, coef, T());
    } else {
      for (int64_t p = p0 + threadIdx.x; p < p1; p += kThreads)
        op[p] = mix_pack(__ldg(gp + p), __ldg(lp + p), beta, coef, T());
    }
    scalar_from = p1 * kPack;
  }
  for (int64_t i = scalar_from + threadIdx.x; i < stop; i += kThreads)
    out[i] = from_f32<T>(mix(to_f32(g[i]), to_f32(l[i]), beta, coef));
  if (stop == n) {                  // the leaf's padding to 16 bytes
    const int64_t pad = (n + kPack - 1) / kPack * kPack;
    for (int64_t i = n + threadIdx.x; i < pad; i += kThreads)
      out[i] = from_f32<T>(0.f);
  }
}

// The launch's grid for ``count`` leaves of ``sizes`` elements: fills
// ``first`` (when given) with the block prefix and returns the blocks, or
// -1 when a size is not positive or the blocks pass the int range.
inline int64_t table_blocks(const int64_t* sizes, int count, int elem_bytes,
                            int* first) {
  const int64_t per = block_elems(elem_bytes);
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (sizes[i] < 1) return -1;
    if (first) first[i] = static_cast<int>(total);
    total += (sizes[i] + per - 1) / per;
    if (total > INT32_MAX) return -1;
  }
  if (first) first[count] = static_cast<int>(total);
  return total;
}

// ptrs: 3 per leaf (g, l, out) as integers; sizes: elements per leaf.
template <typename T>
int launch(int device, const int64_t* ptrs, const int64_t* sizes, int count,
           float beta, float coef, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1 || count > kMaxLeaves) return cudaErrorInvalidValue;
  Table t{};
  const int64_t blocks = table_blocks(sizes, count, sizeof(T), t.first);
  if (blocks < 0) return cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i)
    t.leaf[i] = Leaf{reinterpret_cast<const void*>(ptrs[3 * i]),
                     reinterpret_cast<const void*>(ptrs[3 * i + 1]),
                     reinterpret_cast<void*>(ptrs[3 * i + 2]), sizes[i]};
  t.count = count;
  t.beta = beta;
  t.coef = coef;
  weighted_agg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launches one table of 1..kMaxLeaves leaves and returns
// cudaGetLastError() after the launch (0 = launched).
int weighted_agg_f32(int device, const int64_t* ptrs, const int64_t* sizes,
                     int count, float beta, float coef, void* stream) {
  return launch<float>(device, ptrs, sizes, count, beta, coef, stream);
}

int weighted_agg_bf16(int device, const int64_t* ptrs, const int64_t* sizes,
                      int count, float beta, float coef, void* stream) {
  return launch<__nv_bfloat16>(device, ptrs, sizes, count, beta, coef,
                               stream);
}

// Host only: the grids of a merge of ``count`` leaves of ``sizes`` elements
// of elem_bytes bytes (4: f32, 2: bf16), one launch per kMaxLeaves leaves in
// order, as (x, y, z) triples in grids.  Launches nothing.
int weighted_agg_geometry(const int64_t* sizes, int count, int elem_bytes,
                          int64_t* grids) {
  if (elem_bytes != 4 && elem_bytes != 2) return cudaErrorInvalidValue;
  for (int c = 0; c * kMaxLeaves < count; ++c) {
    const int m = count - c * kMaxLeaves < kMaxLeaves
                      ? count - c * kMaxLeaves : kMaxLeaves;
    const int64_t blocks =
        table_blocks(sizes + c * kMaxLeaves, m, elem_bytes, nullptr);
    if (blocks < 0) return cudaErrorInvalidValue;
    grids[3 * c] = blocks;
    grids[3 * c + 1] = 1;
    grids[3 * c + 2] = 1;
  }
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
