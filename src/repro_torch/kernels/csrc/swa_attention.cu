// Causal sliding-window flash-attention forward with GQA, for NVIDIA Hopper
// (sm_90a):
//
//     out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(hd)) @ v[b, j, h/G]
//     over the keys j with j <= i and i - j < window
//
// q and out are [B, S, H, hd]; k and v are [B, S, Kv, hd], read in that
// layout; f32 or bf16 (exports swa_attention_f32 / swa_attention_bf16),
// computed in f32 with an online softmax (denominator clamped at 1e-30, as
// the reference).  Any S and any window >= 1: the kernel masks its own
// tails.  window >= S is causal attention (the prefill path).
//
// Replaces the TPU kernel src/repro/kernels/swa_attention/kernel.py:
// swa_attention_bhsd (body _swa_kernel, pallas_call at :101).  That kernel
// walks the kv tiles of one query tile as sequential grid steps and carries
// (m, s, acc) in VMEM scratch; its index maps clip the walk to the tiles
// the window reaches and it asserts S % block == 0.  Here one block owns one
// 64-row query tile of one (b, head) and loops over exactly the 64-key
// tiles its window reaches, keeping the softmax state in registers: no
// state crosses blocks.  Masked scores get exactly zero weight (a tile in
// which a row sees no key leaves that row's state unchanged), which is what
// the reference's -1e30 scores give after the softmax.
//
// Bound: operations.  Causal with window >= S, the visible (i, j) pairs are
// B * H * S * (S + 1) / 2, each 4 * hd flops (scores and P @ V); at B = 1,
// S = 1024, H = 15, hd = 64 that is 2.0 GFLOP, 30 us at the card's 67
// TFLOP/s f32 (TF32 stays off) against 3 us for its bytes.
//
// Design (simple first): 256 threads as 16 x 16; thread (ty, tx) owns the
// scores of rows 4*ty .. 4*ty+3 and columns tx + 16*c of a 64 x 64 tile,
// and the same rows of the output at columns tx + 16*c.  Q, K, V and P
// tiles live in shared memory (rows padded by one float: no bank
// conflicts); row maxima and sums meet by xor-shuffles over the 16 lanes
// of a row.  CUDA cores in f32; wgmma tiles and TMA staging are later
// work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + 64) of a [S, stride]-strided matrix of HD-wide rows into
// shared memory with row pitch HD + 1, times ``mul``; rows >= S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int r0, int S,
                                          float mul) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load4(src + (r0 + r) * stride + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * (HD + 1) + c + e] = x[e] * mul;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
swa_kernel(T* __restrict__ out, const T* __restrict__ q,
           const T* __restrict__ k, const T* __restrict__ v, int S, int H,
           int Kv, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;               // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                         // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;                // [kBK][LD]
  float* Vs = Ks + kBK * LD;                // [kBK][LD]
  float* Ps = Vs + kBK * LD;                // [kBQ][kBK + 1]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kv);

  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  load_tile<T, HD>(Qs, q + (static_cast<int64_t>(b) * S * H + h) * HD,
                   q_stride, q0, S, scale);
  const T* kb = k + (static_cast<int64_t>(b) * S * Kv + kvh) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * S * Kv + kvh) * HD;

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  // the keys this tile's rows can see: [q0 - window + 1, q0 + 64)
  int lo = q0 - window + 1;
  lo = lo > 0 ? lo : 0;
  const int hi = q0 + kBQ < S ? q0 + kBQ : S;
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();                        // the last tiles are consumed
    load_tile<T, HD>(Ks, kb, kv_stride, k0, S, 1.f);
    load_tile<T, HD>(Vs, vb, kv_stride, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(ty * 4 + r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) ka[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qa[r] * ka[c];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        ok[c] = j <= i && i - j < window && j < S;
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= alpha;
    }
    __syncthreads();                        // P is complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) o[r][c] += pv[r] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = out + (static_cast<int64_t>(b) * S + i) * q_stride +
             static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(dst + tx + 16 * c, o[r][c] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(void* out, const void* q, const void* k, const void* v,
                      int B, int S, int H, int Kv, int window, float scale,
                      cudaStream_t stream) {
  constexpr int LD = HD + 1;
  constexpr size_t smem = sizeof(float) *
                          (static_cast<size_t>(kBQ + 2 * kBK) * LD +
                           kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  swa_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), S, H, Kv, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch(int device, void* out, const void* q, const void* k,
           const void* v, int B, int S, int H, int Kv, int hd, int window,
           float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      err = launch_hd<T, 64>(out, q, k, v, B, S, H, Kv, window, scale, s);
      break;
    case 128:
      err = launch_hd<T, 128>(out, q, k, v, B, S, H, Kv, window, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each returns the CUDA error of the launch (0 = launched).  The caller
// guarantees contiguous q/out [B, S, H, hd] and k/v [B, S, Kv, hd], 16-byte
// aligned (8-byte in bf16), hd in {64, 128}, H % Kv == 0, S >= 1 and
// window >= 1.
int swa_attention_f32(int device, void* out, const void* q, const void* k,
                      const void* v, int B, int S, int H, int Kv, int hd,
                      int window, float scale, void* stream) {
  return launch<float>(device, out, q, k, v, B, S, H, Kv, hd, window, scale,
                       stream);
}

int swa_attention_bf16(int device, void* out, const void* q, const void* k,
                       const void* v, int B, int S, int H, int Kv, int hd,
                       int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(device, out, q, k, v, B, S, H, Kv, hd, window,
                               scale, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
