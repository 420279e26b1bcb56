// Causal sliding-window flash-attention forward with GQA, for NVIDIA Hopper
// (sm_90a):
//
//     out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(hd)) @ v[b, j, h/G]
//     over the keys j with j <= i and i - j < window
//
// q and out are [B, S, H, hd]; k and v are [B, S, Kv, hd], read in that
// layout; f32 or bf16 (exports swa_attention_f32 / swa_attention_bf16), with
// an online softmax in f32 (denominator clamped at 1e-30, as the
// reference).  Any S and any window >= 1: the kernels mask their own tails.
// window >= S is causal attention (the prefill path).  Masked scores get
// exactly zero weight (a tile in which a row sees no key leaves that row's
// state unchanged), which is what the reference's -1e30 scores give after
// the softmax.
//
// Replaces the TPU kernel src/repro/kernels/swa_attention/kernel.py:
// swa_attention_bhsd (body _swa_kernel, pallas_call at :101).  That kernel
// walks the kv tiles of one query tile as sequential grid steps and carries
// (m, s, acc) in VMEM scratch; its index maps clip the walk to the tiles
// the window reaches and it asserts S % block == 0.  Here a block owns one
// query tile and loops over exactly the 64-key tiles its window reaches,
// keeping the softmax state in registers: no state crosses blocks.
//
// Bound: operations.  Causal with window >= S, the visible (i, j) pairs are
// B * H * S * (S + 1) / 2, each 4 * hd flops (scores and P @ V); at B = 1,
// S = 1024, H = 15, hd = 64 that is 2.0 GFLOP: 30 us at the card's 67
// TFLOP/s of f32 CUDA cores (TF32 stays off), 2 us at its 989 TFLOP/s of
// bf16 tensor cores, against 3 us (f32) or 1.5 us (bf16) for its bytes.
//
// f32 (swa_kernel): 256 threads as 16 x 16 over a 64-row query tile of one
// (b, head); thread (ty, tx) owns the scores of rows 4*ty .. 4*ty+3 and
// columns tx + 16*c of a 64 x 64 tile, and the same rows of the output at
// columns tx + 16*c.  Q, K, V and P tiles live in shared memory (rows
// padded by one float: no bank conflicts); row maxima and sums meet by
// xor-shuffles over the 16 lanes of a row.  CUDA cores: the tensor cores'
// TF32 would break the 2e-5 the f32 path is held to.
//
// bf16 (swa_mma_kernel): tensor cores through mma.sync m16n8k16 (bf16 in,
// f32 accumulate) fed by ldmatrix, chosen over wgmma because a warp's
// 16-row granule fits any G: the (position, head) rows of one kv head are
// packed in memory order (row r is position r / G, head kvh*G + r % G; the
// G heads of a position are adjacent in [B, S, H, hd]), 64 rows a block,
// 16 a warp, whatever G is, where wgmma would need 64-row warpgroup tiles.
// Each K/V tile is thus loaded once for all G heads.  A block of 4 warps:
//   - Q (64 rows), K and V (64 keys each) are staged in bf16 with cp.async,
//     16 bytes a thread, K and V double-buffered so the next tile loads
//     while this one is used; shared rows are padded by 16 bytes, so the
//     8 rows an ldmatrix reads fall in distinct banks.
//   - S = Q K^T: Q's A fragments stay in registers for the whole walk; K
//     feeds B fragments by ldmatrix (K rows are the "col" layout).
//   - The online softmax runs on S's f32 accumulator fragments, the
//     1/sqrt(hd) scale folded with log2(e) into the f32 scores (exp2); row
//     maxima meet over the 4 lanes of a quad.  P is rounded to bf16 in
//     registers and becomes P @ V's A operand (the plain version rounds its
//     softmax weights to bf16 as well); V feeds B by ldmatrix.trans.
//   - O stays in f32 registers, is divided by max(l, 1e-30) once and
//     rounded to bf16 once.
// Grid (ceil(S*G / 64), Kv, B), blocks dealt latest query rows first (the
// causal walk's longest), across every (kv head, batch row) before the
// next: at B 1, S 1024, G 3, Kv 5 that is 240 blocks on 132 SMs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;

// rows [r0, r0 + 64) of a [S, stride]-strided matrix of HD-wide rows into
// shared memory with row pitch HD + 1, times ``mul``; rows >= S are zero
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int r0, int S,
                                          float mul) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = *reinterpret_cast<const float4*>(
        src + (r0 + r) * stride + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = x.x * mul; d[1] = x.y * mul; d[2] = x.z * mul; d[3] = x.w * mul;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
swa_kernel(float* __restrict__ out, const float* __restrict__ q,
           const float* __restrict__ k, const float* __restrict__ v, int S,
           int H, int Kv, int window, float scale) {
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
  load_tile<HD>(Qs, q + (static_cast<int64_t>(b) * S * H + h) * HD,
                q_stride, q0, S, scale);
  const float* kb = k + (static_cast<int64_t>(b) * S * Kv + kvh) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * S * Kv + kvh) * HD;

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
    load_tile<HD>(Ks, kb, kv_stride, k0, S, 1.f);
    load_tile<HD>(Vs, vb, kv_stride, k0, S, 1.f);
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
    float* dst = out + (static_cast<int64_t>(b) * S + i) * q_stride +
                 static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = o[r][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBM = 16 * kMmaWarps;      // (position, head) rows per block
constexpr int kBN = 64;                  // keys per kv tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct MmaTiles {
  static constexpr int kPitch = HD + 8;  // bf16 per shared row: +16 bytes
  static constexpr int kQ = kBM * kPitch;
  static constexpr int kKV = kBN * kPitch;
  // Q, then K[2], then V[2]
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * (kQ + 4 * kKV);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared in flight; zero-filled when !valid (src is
// then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts of m16n8k16 (lane = 4 * gq + tq): an A or C row is gq
// (fragments 0-1) or gq + 8 (2-3); C columns 2 tq, 2 tq + 1.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
swa_mma_kernel(__nv_bfloat16* __restrict__ out,
               const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, int S, int H, int window,
               float scale_log2) {
  using Tiles = MmaTiles<HD>;
  constexpr int P = Tiles::kPitch;
  constexpr int kChunks = HD / 8;        // 16-byte chunks of a row
  constexpr int kKS = HD / 16;           // k-steps of Q K^T
  constexpr int kDT = HD / 8;            // 8-column tiles of O
  constexpr int kNT = kBN / 8;           // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + Tiles::kQ;
  __nv_bfloat16* Vs = Ks + 2 * Tiles::kKV;

  // latest rows first, across every (kv head, batch row) before the next
  const int tiles = gridDim.x, Kv = gridDim.y, B = gridDim.z;
  const int lin = blockIdx.x + tiles * (blockIdx.y + Kv * blockIdx.z);
  const int kvh = lin % Kv;
  const int b = (lin / Kv) % B;
  const int r0 = (tiles - 1 - lin / (Kv * B)) * kBM;
  const int G = H / Kv;
  const int rows = S * G;                // (position, head) rows, kv head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;

  const int64_t pos_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t head0 = (static_cast<int64_t>(b) * S * H +
                         static_cast<int64_t>(kvh) * G) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * S * Kv + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * S * Kv + kvh) * HD;

  for (int i = threadIdx.x; i < kBM * kChunks; i += kMmaThreads) {
    const int m = i / kChunks, c = (i % kChunks) * 8;
    const int r = r0 + m < rows ? r0 + m : 0;
    cp_async16(smem_addr(Qs + m * P + c),
               q + head0 + (r / G) * pos_stride + (r % G) * HD + c,
               r0 + m < rows);
  }
  auto load_kv = [&](int buf, int k0) {
    __nv_bfloat16* kd = Ks + buf * Tiles::kKV;
    __nv_bfloat16* vd = Vs + buf * Tiles::kKV;
    for (int i = threadIdx.x; i < kBN * kChunks; i += kMmaThreads) {
      const int j = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = k0 + j < S;
      const int64_t off = (ok ? k0 + j : 0) * kv_stride + c;
      cp_async16(smem_addr(kd + j * P + c), kb + off, ok);
      cp_async16(smem_addr(vd + j * P + c), vb + off, ok);
    }
  };

  // the block's positions and the keys their windows reach
  const int last_row = (r0 + kBM < rows ? r0 + kBM : rows) - 1;
  int lo = r0 / G - window + 1;
  lo = lo > 0 ? lo : 0;
  const int t_first = lo / kBN, t_last = (last_row / G) / kBN;
  // this warp's positions (none when its rows start past the last)
  const int wr0 = r0 + 16 * warp;
  const bool warp_live = wr0 < rows;
  const int wp_first = wr0 / G;
  const int wp_last = ((wr0 + 15 < rows ? wr0 + 15 : rows - 1)) / G;
  // this lane's two rows: gq and gq + 8 of the warp's 16
  int pos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + gq + 8 * h;
    row_ok[h] = r < rows;
    pos[h] = r / G;
  }

  uint32_t qf[kKS][4];
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  load_kv(0, t_first * kBN);
  cp_async_commit();                     // Q and the first kv tile
  for (int t = t_first; t <= t_last; ++t) {
    const int buf = (t - t_first) & 1;
    if (t < t_last) load_kv(buf ^ 1, (t + 1) * kBN);
    cp_async_commit();                   // (empty on the last tile)
    cp_async_wait<1>();                  // all but the newest: tile t
    __syncthreads();
    if (t == t_first) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        ldsm_x4(smem_addr(Qs + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2))
                              * P + 16 * kk + 8 * (lane / 16)), qf[kk]);
    }
    const int k0 = t * kBN;
    if (warp_live && k0 <= wp_last && k0 + kBN - 1 > wp_first - window) {
      const __nv_bfloat16* Kt = Ks + buf * Tiles::kKV;
      const __nv_bfloat16* Vt = Vs + buf * Tiles::kKV;
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 2) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t kf[4];               // k-steps kk and kk + 1 of 8 keys
          ldsm_x4(smem_addr(Kt + (8 * nt + lane % 8) * P + 16 * kk +
                            8 * (lane / 8)), kf);
          mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
          mma_bf16(s[nt], qf[kk + 1], kf[2], kf[3]);
        }
      }

      // online softmax on the f32 fragments, in log2 units
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int j = k0 + 8 * nt + 2 * tq + e % 2;
          const bool vis = row_ok[h] && j <= pos[h] && pos[h] - j < window;
          const float x = vis ? s[nt][e] * scale_log2 : -CUDART_INF_F;
          s[nt][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - m[e / 2]);   // masked: exactly 0
          s[nt][e] = p;
          l[e / 2] += p;
        }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

      // O += P V: P's bf16 A fragments straight from S's accumulators
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dt = 0; dt < kDT; dt += 2) {
          uint32_t vf[4];               // column tiles dt and dt + 1
          ldsm_x4_trans(smem_addr(Vt + (16 * kk + lane % 8 +
                                        8 * ((lane / 8) % 2)) * P +
                                  8 * dt + 8 * (lane / 16)), vf);
          mma_bf16(o[dt], pa, vf[0], vf[1]);
          mma_bf16(o[dt + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                     // buffer buf is free to refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wr0 + gq + 8 * h;
    if (!row_ok[h]) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst = out + head0 + (r / G) * pos_stride + (r % G) * HD;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt + 2 * tq) =
          __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The launch's grid.  f32 (elem_bytes 4): one block per (64-row query
// tile, head, batch row).  bf16 (2): one block per 64 (position, head) rows
// of a kv head, per kv head, per batch row.
inline dim3 grid_of(int B, int S, int H, int Kv, int elem_bytes) {
  if (elem_bytes == 2)
    return dim3(static_cast<unsigned>((S * (H / Kv) + kBM - 1) / kBM),
                static_cast<unsigned>(Kv), static_cast<unsigned>(B));
  return dim3(static_cast<unsigned>((S + kBQ - 1) / kBQ),
              static_cast<unsigned>(H), static_cast<unsigned>(B));
}

template <int HD>
cudaError_t launch_f32(void* out, const void* q, const void* k, const void* v,
                       int B, int S, int H, int Kv, int window, float scale,
                       cudaStream_t stream) {
  constexpr int LD = HD + 1;
  constexpr size_t smem = sizeof(float) *
                          (static_cast<size_t>(kBQ + 2 * kBK) * LD +
                           kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  swa_kernel<HD><<<grid_of(B, S, H, Kv, 4), kThreads, smem, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), S, H, Kv,
      window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(void* out, const void* q, const void* k,
                        const void* v, int B, int S, int H, int Kv,
                        int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = MmaTiles<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      swa_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  swa_mma_kernel<HD><<<grid_of(B, S, H, Kv, 2), kMmaThreads, smem, stream>>>(
      static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), S, H, window, scale * kLog2e);
  return cudaGetLastError();
}

template <bool kBf16>
int launch(int device, void* out, const void* q, const void* k,
           const void* v, int B, int S, int H, int Kv, int hd, int window,
           float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      err = kBf16 ? launch_bf16<64>(out, q, k, v, B, S, H, Kv, window, scale, s)
                  : launch_f32<64>(out, q, k, v, B, S, H, Kv, window, scale, s);
      break;
    case 128:
      err = kBf16
                ? launch_bf16<128>(out, q, k, v, B, S, H, Kv, window, scale, s)
                : launch_f32<128>(out, q, k, v, B, S, H, Kv, window, scale, s);
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
// aligned, hd in {64, 128}, H % Kv == 0, S >= 1 and window >= 1.
int swa_attention_f32(int device, void* out, const void* q, const void* k,
                      const void* v, int B, int S, int H, int Kv, int hd,
                      int window, float scale, void* stream) {
  return launch<false>(device, out, q, k, v, B, S, H, Kv, hd, window, scale,
                       stream);
}

int swa_attention_bf16(int device, void* out, const void* q, const void* k,
                       const void* v, int B, int S, int H, int Kv, int hd,
                       int window, float scale, void* stream) {
  return launch<true>(device, out, q, k, v, B, S, H, Kv, hd, window, scale,
                      stream);
}

// Host only: the grid launch<> computes for elements of elem_bytes bytes
// (4: f32, 2: bf16), as grid3 = (x, y, z).  Launches nothing.
int swa_attention_geometry(int B, int S, int H, int Kv, int elem_bytes,
                           int64_t* grid3) {
  if ((elem_bytes != 4 && elem_bytes != 2) || Kv < 1 || H % Kv)
    return cudaErrorInvalidValue;
  const dim3 g = grid_of(B, S, H, Kv, elem_bytes);
  grid3[0] = g.x;
  grid3[1] = g.y;
  grid3[2] = g.z;
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
