// One-token GQA decode attention against a KV cache, for NVIDIA Hopper
// (sm_90a):
//
//     out[b, h] = softmax_t(q[b, h] . k[b, t, h/G] / sqrt(hd), t <= pos[b])
//                 @ v[b, :, h/G]
//
// q and out are [B, H, hd]; the caches k and v are [B, S, Kv, hd], read in
// that layout (no transposed copy); pos is an i32[B] device array; f32 or
// bf16 (exports decode_attention_f32 / decode_attention_bf16), computed in
// f32 with an online softmax (masked scores -1e30, denominator clamped at
// 1e-30, as the reference).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention_bkv
// (body _decode_kernel, pallas_call at :76).  That kernel sweeps the whole
// cache in sequential grid steps and carries (m, s, acc) in VMEM scratch,
// masking positions past pos.  GPU blocks run in parallel and in no order,
// so here the sequence is split into chunks: one block per (b, kv head,
// chunk) keeps its own online-softmax state for the G query heads, and a
// second kernel combines the chunks' partial states (flash-decoding).  A
// block whose chunk starts past pos[b] returns at once, and the last live
// chunk stops at pos[b]: positions past pos[b] have exactly zero weight in
// the reference, so the masked tail is never read.
//
// Bound: memory.  A step reads the live part of both caches once,
// 2 * B * Kv * (pos + 1) * hd elements, plus q and out; the operations are
// 4 * B * H * (pos + 1) * hd flops, G / (2 * elem bytes) per byte, far
// under the card's 20 flop/byte f32 ridge.  At B = 128, S = 32,768,
// Kv = 5, hd = 64 in bf16 with pos = S - 1 that is 5.37 GB (1.60 ms at
// 3.35 TB/s).
//
// Design (simple first): 128 threads per block.  hd / 8 neighbouring lanes
// share one cache row, each lane owning 8 of its elements (one or two
// 16-byte loads), so a warp reads 32 / (hd / 8) whole rows at a time,
// coalesced.  The partial dot products meet by xor-shuffles inside the lane
// group; each group keeps (m, l, acc[8]) per query head in registers and
// the block's groups are merged in shared memory at the end.  cp.async/TMA
// staging and wgmma are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// 8 consecutive elements as f32, from a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block: (b, kv head) = blockIdx.x, chunk = blockIdx.y.  With one
// chunk it writes out; otherwise it writes the chunk's partial state
// part[bkv][chunk][g] = (m, l, acc[HD]) for the combine kernel.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(T* __restrict__ out, float* __restrict__ part,
                    const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    int S, int Kv, int chunk, int n_chunks, float scale) {
  constexpr int L = HD / 8;                 // lanes per cache row
  constexpr int kRowsPerWarp = 32 / L;
  constexpr int kGroups = kWarps * kRowsPerWarp;
  __shared__ float sm_m[kGroups][G];
  __shared__ float sm_l[kGroups][G];
  __shared__ float sm_acc[kGroups][G][HD];

  const int bkv = blockIdx.x;
  const int b = bkv / Kv;
  const int kvh = bkv % Kv;
  const int H = Kv * G;
  const int p = pos[b];
  const int start = blockIdx.y * chunk;
  if (start > p) return;                    // nothing of this chunk is live
  int end = start + chunk;
  end = end < p + 1 ? end : p + 1;
  end = end < S ? end : S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / L;                 // row slot inside the warp
  const int sub = lane % L;                 // which 8 elements of the row
  const int group = warp * kRowsPerWarp + grp;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + (static_cast<int64_t>(b) * H + kvh * G + g) * HD + sub * 8,
          qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] *= scale;
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t base = (static_cast<int64_t>(b) * S * Kv + kvh) * HD + sub * 8;
  // warp-uniform trip count: every lane takes part in the shuffles
  for (int t0 = start + warp * kRowsPerWarp; t0 < end;
       t0 += kWarps * kRowsPerWarp) {
    const int t = t0 + grp;
    const bool live = t < end;
    float kx[8], vx[8];
    if (live) {
      load8(k + base + t * row_stride, kx);
      load8(v + base + t * row_stride, vx);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kx[e] = vx[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += qf[g][e] * kx[e];
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (live) {
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pw = expf(s - m_new);
        l[g] = l[g] * alpha + pw;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = acc[g][e] * alpha + pw * vx[e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      sm_m[group][g] = m[g];
      sm_l[group][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[group][g][sub * 8 + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mm = kNegInf;
    for (int j = 0; j < kGroups; ++j) mm = fmaxf(mm, sm_m[j][g]);
    float ll = 0.f, aa = 0.f;
    for (int j = 0; j < kGroups; ++j) {
      const float w = expf(sm_m[j][g] - mm);   // 0 for a group with no row
      ll += sm_l[j][g] * w;
      aa += sm_acc[j][g][d] * w;
    }
    if (n_chunks == 1) {
      store(out + (static_cast<int64_t>(b) * H + kvh * G + g) * HD + d,
            aa / fmaxf(ll, 1e-30f));
    } else {
      float* dst = part + ((static_cast<int64_t>(bkv) * n_chunks +
                            blockIdx.y) * G + g) * (HD + 2);
      if (d == 0) {
        dst[0] = mm;
        dst[1] = ll;
      }
      dst[2 + d] = aa;
    }
  }
}

// One block per (b, kv head): merges the partial states of the chunks that
// start at or before pos[b].
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(T* __restrict__ out, const float* __restrict__ part,
                      const int* __restrict__ pos, int Kv, int chunk,
                      int n_chunks) {
  const int bkv = blockIdx.x;
  const int b = bkv / Kv;
  const int kvh = bkv % Kv;
  const int H = Kv * G;
  const int p = pos[b];
  int live = p / chunk + 1;
  live = live < n_chunks ? live : n_chunks;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    const float* src = part + (static_cast<int64_t>(bkv) * n_chunks * G + g) *
                                  (HD + 2);
    const int64_t step = static_cast<int64_t>(G) * (HD + 2);
    float mm = kNegInf;
    for (int c = 0; c < live; ++c) mm = fmaxf(mm, src[c * step]);
    float ll = 0.f, aa = 0.f;
    for (int c = 0; c < live; ++c) {
      const float w = expf(src[c * step] - mm);
      ll += src[c * step + 1] * w;
      aa += src[c * step + 2 + d] * w;
    }
    store(out + (static_cast<int64_t>(b) * H + kvh * G + g) * HD + d,
          aa / fmaxf(ll, 1e-30f));
  }
}

// The launches' grids: the chunk kernel over (b * Kv + kv head, chunk);
// then, only when n_chunks > 1, the combine kernel over (b * Kv + kv head).
inline dim3 chunk_grid(int B, int Kv, int n_chunks) {
  return dim3(static_cast<unsigned>(B * Kv), static_cast<unsigned>(n_chunks));
}
inline dim3 combine_grid(int B, int Kv) {
  return dim3(static_cast<unsigned>(B * Kv));
}

template <typename T, int HD, int G>
cudaError_t launch_g(void* out, void* part, const void* q, const void* k,
                     const void* v, const int* pos, int B, int S, int Kv,
                     int chunk, int n_chunks, float scale,
                     cudaStream_t stream) {
  const dim3 grid = chunk_grid(B, Kv, n_chunks);
  decode_chunk_kernel<T, HD, G><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, S, Kv, chunk, n_chunks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  decode_combine_kernel<T, HD, G><<<combine_grid(B, Kv), kThreads, 0,
                                    stream>>>(
      static_cast<T*>(out), static_cast<const float*>(part), pos, Kv, chunk,
      n_chunks);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(int G, void* out, void* part, const void* q,
                      const void* k, const void* v, const int* pos, int B,
                      int S, int Kv, int chunk, int n_chunks, float scale,
                      cudaStream_t stream) {
#define DECODE_G(g)                                                        \
  case g:                                                                  \
    return launch_g<T, HD, g>(out, part, q, k, v, pos, B, S, Kv, chunk,    \
                              n_chunks, scale, stream);
  switch (G) {
    DECODE_G(1) DECODE_G(2) DECODE_G(3) DECODE_G(4)
    DECODE_G(5) DECODE_G(6) DECODE_G(7) DECODE_G(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_G
}

template <typename T>
int launch(int device, void* out, void* part, const void* q, const void* k,
           const void* v, const void* pos, int B, int S, int H, int Kv,
           int hd, int chunk, int n_chunks, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / Kv;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      err = launch_hd<T, 64>(G, out, part, q, k, v, p, B, S, Kv, chunk,
                             n_chunks, scale, s);
      break;
    case 128:
      err = launch_hd<T, 128>(G, out, part, q, k, v, p, B, S, Kv, chunk,
                              n_chunks, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each returns the CUDA error of its launches (0 = launched).  The caller
// guarantees contiguous q/out [B, H, hd] and k/v [B, S, Kv, hd], 16-byte
// aligned, hd in {64, 128}, H / Kv in 1..8, pos an i32[B] device array with
// pos[b] >= 0, and, when n_chunks > 1, an f32 scratch part of
// B * Kv * n_chunks * (H / Kv) * (hd + 2) elements.
int decode_attention_f32(int device, void* out, void* part, const void* q,
                         const void* k, const void* v, const void* pos, int B,
                         int S, int H, int Kv, int hd, int chunk, int n_chunks,
                         float scale, void* stream) {
  return launch<float>(device, out, part, q, k, v, pos, B, S, H, Kv, hd,
                       chunk, n_chunks, scale, stream);
}

int decode_attention_bf16(int device, void* out, void* part, const void* q,
                          const void* k, const void* v, const void* pos,
                          int B, int S, int H, int Kv, int hd, int chunk,
                          int n_chunks, float scale, void* stream) {
  return launch<__nv_bfloat16>(device, out, part, q, k, v, pos, B, S, H, Kv,
                               hd, chunk, n_chunks, scale, stream);
}

// Host only: the grids of one call's launches, as grids = (x, y, z) of the
// chunk kernel, then (x, y, z) of the combine kernel (all 0 when
// n_chunks == 1: it is not launched).  Launches nothing.
int decode_attention_geometry(int B, int Kv, int n_chunks, int64_t* grids) {
  const dim3 a = chunk_grid(B, Kv, n_chunks);
  const dim3 c = combine_grid(B, Kv);
  const bool combine = n_chunks > 1;
  grids[0] = a.x;
  grids[1] = a.y;
  grids[2] = a.z;
  grids[3] = combine ? c.x : 0;
  grids[4] = combine ? c.y : 0;
  grids[5] = combine ? c.z : 0;
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
