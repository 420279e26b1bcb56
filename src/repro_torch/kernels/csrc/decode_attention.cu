// One-token GQA decode attention against a KV cache, for NVIDIA Hopper
// (sm_90a):
//
//     out[b, h] = softmax_t(q[b, h] . k[b, t, h/G] / sqrt(hd), t <= pos[b])
//                 @ v[b, :, h/G]
//
// q and out are [B, H, hd]; the caches k and v are [B, S, Kv, hd], read in
// that layout (no transposed copy); pos is an i32[B] device array; f32 or
// bf16 (exports decode_attention_f32 / decode_attention_bf16), computed in
// f32 with an online softmax in log2 units (positions past pos get exactly
// zero weight, the denominator is clamped at 1e-30, as the reference).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention_bkv
// (body _decode_kernel, pallas_call at :76).  That kernel sweeps the whole
// cache in sequential grid steps and carries (m, s, acc) in VMEM scratch,
// masking positions past pos.  GPU blocks run in parallel and in no order,
// so here the live prefix is split: one block per (b, kv head, chunk) keeps
// its own online-softmax state for the G query heads of its kv head, and a
// second kernel combines the chunks' partial states (flash-decoding).
//
// Bound: memory.  A step reads the live part of both caches once,
// 2 * B * Kv * (pos + 1) * hd elements, plus q and out; the operations are
// 4 * B * H * (pos + 1) * hd flops, G / (2 * elem bytes) per byte, far
// under the card's ridges.  At B = 128, S = 32,768, Kv = 5, hd = 64 in
// bf16 with pos = S - 1 that is 5.37 GB (1.60 ms at 3.35 TB/s).
//
// Design:
//   - The split comes from pos, on the card.  The grid (B * Kv, n_chunks)
//     is a function of the shapes alone (the host never reads pos; the
//     wrapper picks n_chunks so the grid is several even waves of the
//     card).  Block (bkv, c) reads pos[b] and takes share c of the live
//     prefix [0, pos[b]]: shares of roundup(ceil(live / n_chunks), 64)
//     positions, so a row's live work is spread over all its blocks
//     whatever pos is (share_of; ops.chunk_bounds mirrors it).  A block
//     whose share is empty writes the neutral state (m = -1e30, l = 0,
//     acc = 0), so every block writes exactly its slot and the combine
//     kernel needs no live count.
//   - K and V stream through a ring of kStages tiles of 64 positions in
//     dynamic shared memory, filled by cp.async (16 bytes a thread, rows
//     past the share zero-filled and never read from memory): the block
//     computes on one tile while the next kStages - 1 are in flight.
//     bf16 keeps 5 stages (94 KB at hd 64: two blocks an SM, 64 KB in
//     flight each); f32 keeps 2 (70-74 KB: three blocks an SM), because its
//     short shares (one tile a block at the serve shape) gain more from a
//     third resident block than from a deeper ring.  Shared rows are
//     padded by 16 bytes, so the 8 rows an ldmatrix (or a quarter-warp's
//     16-byte loads) reads fall in distinct banks.
//   - 4 warps; each takes 16 positions of every tile and keeps its own
//     online state per query head, with one max and one rescale per tile;
//     the 4 states are merged in shared memory at the end.
//   - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//     accumulate), chosen over wgmma because decode has G <= 16 query rows,
//     not a warpgroup's 64.  The A operand holds the G query heads, padded
//     to 16 rows with zeros, in registers for the whole walk; K feeds B by
//     ldmatrix, V by ldmatrix.trans.  A thread keeps the online state of
//     fragment row gq and, at G 16 (llama3-405b's 128 heads over 8), of
//     row gq + 8 as well: both halves of the A operand are then heads.  The scores' f32 fragments take
//     log2(e) / sqrt(hd) and exp2; P is rounded to bf16 in registers and
//     becomes P @ V's A operand (the plain version rounds its weights to
//     bf16 too).  The helpers below are copies of swa_attention.cu's, kept
//     here so that each .cu stands alone (the build keys a library by its
//     one source file).
//   - f32: CUDA cores (TF32 would break the 2e-5 band).  Lane p + 16 h of
//     a warp takes the warp's position p and half h of the head dim for
//     every head's score (one xor-shuffle joins the halves), so the
//     softmax costs one exp2 per (position, head) and a 4-level shuffle
//     max per head per tile; the weights pass through shared memory to
//     the P @ V product, where each lane owns hd / 32 output columns.
//     A warp keeps G heads' states: at G 16 and hd 128 that is 64 output
//     registers a lane, so P @ V walks 4 V rows at a time and every head
//     under them (never G heads' weights at once).
//   - The combine kernel gives each head a warp for its chunk weights:
//     max(256, 32 G) threads (512 at G 16), and each thread sums every
//     kSplit-th chunk of 4 output columns.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // positions per kv tile and share
constexpr int kWarpRows = kTile / kWarps;  // a warp's positions per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxChunks = 256;            // chunks a combine block takes

// threads of a combine block: a warp per head, at least 256
template <int G>
__host__ __device__ constexpr int combine_threads() {
  return 32 * G > 256 ? 32 * G : 256;
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// Dynamic shared memory of one chunk block: the K ring, the V ring, Q, and
// (f32) each warp's weights of a tile.  After the walk the ring's start
// holds the warps' states m, l [kWarps][G] and o [kWarps][G][HD].
template <typename T, int HD, int G>
struct Smem {
  static constexpr int kStages = kBf16<T> ? 5 : 2;
  static constexpr int kPitch = HD + 16 / sizeof(T);  // elements; +16 bytes
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int kQRows = kBf16<T> ? 16 : G;    // mma A: 16 rows
  static constexpr size_t kRing = sizeof(T) * 2 * kStages * kTileElems;
  static constexpr size_t kQ = sizeof(T) * kQRows * kPitch;
  static constexpr size_t kP =
      kBf16<T> ? 0 : sizeof(float) * kWarps * G * kWarpRows;
  static constexpr size_t kBytes = kRing + kQ + kP;
  static_assert(sizeof(float) * kWarps * G * (HD + 2) <= kRing,
                "the warps' states fit in the ring");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared in flight; zero-filled when !valid (src is
// then not read, but must still be a mapped address).  The L2::128B hint
// has L2 fetch a whole 128-byte line from memory at its first sector
// miss: a cache row is read by 8 (bf16) or 16 (f32) neighbouring threads.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Share c of the live prefix of a row at position p: [start, end), empty
// when start >= end.  Shares are whole kv tiles (ops.chunk_bounds).
__device__ __forceinline__ void share_of(int p, int S, int n_chunks, int c,
                                         int& start, int& end) {
  const int live = p + 1 < S ? p + 1 : S;
  const int per = ((live + n_chunks - 1) / n_chunks + kTile - 1) / kTile *
                  kTile;
  start = c * per;
  end = start + per < live ? start + per : live;
}

// One block: (b, kv head) = blockIdx.x, chunk = blockIdx.y.  With one
// chunk it writes out; otherwise the chunk's partial state
// part[bkv][chunk][g] = (m, l, 0, 0, acc[HD]) for the combine kernel.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(T* __restrict__ out, float* __restrict__ part,
                    const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    int S, int Kv, int n_chunks, float scale_log2) {
  using L = Smem<T, HD, G>;
  constexpr int P = L::kPitch;
  constexpr int kVec = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int kChunks = HD / kVec;        // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + L::kStages * L::kTileElems;
  T* Qs = Vs + L::kStages * L::kTileElems;

  const int bkv = blockIdx.x;
  const int b = bkv / Kv;
  const int kvh = bkv % Kv;
  const int H = Kv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t head0 = (static_cast<int64_t>(b) * H + kvh * G) * HD;

  // Q first: it does not wait for pos
  for (int i = threadIdx.x; i < L::kQRows * kChunks; i += kThreads) {
    const int r = i / kChunks, e = (i % kChunks) * kVec;
    cp_async16(smem_addr(Qs + r * P + e),
               q + head0 + (r < G ? r : 0) * HD + e, r < G);
  }
  int start, end;
  share_of(pos[b], S, n_chunks, blockIdx.y, start, end);
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;

  const int64_t row_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t base = (static_cast<int64_t>(b) * S * Kv + kvh) * HD;
  auto load_tile = [&](int t) {
    T* kd = Ks + (t % L::kStages) * L::kTileElems;
    T* vd = Vs + (t % L::kStages) * L::kTileElems;
    const int t0 = start + t * kTile;
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
      const int j = i / kChunks, e = (i % kChunks) * kVec;
      const bool ok = t0 + j < end;
      const int64_t off = base + (ok ? t0 + j : start) * row_stride + e;
      cp_async16(smem_addr(kd + j * P + e), k + off, ok);
      cp_async16(smem_addr(vd + j * P + e), v + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();                      // Q rides in the first group
  }

  // per-warp online state.  bf16: the heads of fragment rows gq + 8 r, r <
  // kHeads (rows past G are padding: Q's zeros, never stored), their m and
  // l and the C fragments of O (c0, c1 row gq; c2, c3 row gq + 8).  f32:
  // every head, m the same in every lane, l over the lane's positions, and
  // the lane's kCols columns of O.
  constexpr int kHeads = kBf16<T> ? (G > 8 ? 2 : 1) : G;
  constexpr int kCols = HD / 32;
  float m[kHeads], l[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float ob[kBf16<T> ? HD / 8 : 1][4] = {};
  float of[kHeads][kBf16<T> ? 1 : kCols] = {};
  uint32_t qf[kBf16<T> ? HD / 16 : 1][4];    // bf16: Q's A fragments
  const int gq = lane / 4, tq = lane % 4;    // bf16 fragment coordinates

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<L::kStages - 2>();         // tile t (and Q) landed
    __syncthreads();                         // ... for every thread; and
    if (t + L::kStages - 1 < n_tiles)        // tile t - 1's stage is free
      load_tile(t + L::kStages - 1);
    cp_async_commit();
    const T* Kt = Ks + (t % L::kStages) * L::kTileElems + warp * kWarpRows * P;
    const T* Vt = Vs + (t % L::kStages) * L::kTileElems + warp * kWarpRows * P;
    const int w0 = start + t * kTile + warp * kWarpRows;  // warp's first
    if constexpr (kBf16<T>) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldsm_x4(smem_addr(Qs + (lane % 8 + 8 * ((lane / 8) % 2)) * P +
                            16 * kk + 8 * (lane / 16)), qf[kk]);
      }
      if (w0 < end) {
        // S = Q K^T over the warp's 16 positions: 2 tiles of 8
        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < HD / 16; kk += 2) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t kf[4];                  // k-steps kk, kk + 1
            ldsm_x4(smem_addr(Kt + (8 * nt + lane % 8) * P + 16 * kk +
                              8 * (lane / 8)), kf);
            mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
            mma_bf16(s[nt], qf[kk + 1], kf[2], kf[3]);
          }
        }
        // row gq + 8 r: positions w0 + 8 nt + 2 tq + e in s[nt][2 r + e]
        float x[kHeads][2][2];
#pragma unroll
        for (int r = 0; r < kHeads; ++r) {
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool vis = w0 + 8 * nt + 2 * tq + e < end;
              x[r][nt][e] = vis ? s[nt][2 * r + e] * scale_log2
                                : -CUDART_INF_F;
              mx = fmaxf(mx, x[r][nt][e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          const float alpha = exp2f(m[r] - m_new);
          m[r] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[r][nt][e] = exp2f(x[r][nt][e] - m_new);  // masked: exactly 0
              sum += x[r][nt][e];
            }
          l[r] = l[r] * alpha + sum;
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt) {
            ob[dt][2 * r] *= alpha;            // with one state, rows gq + 8
            ob[dt][2 * r + 1] *= alpha;        // are padding and stay 0
          }
        }
        // O += P V: P's bf16 A fragment straight from the scores (a1, a3
        // are rows gq + 8: zero unless they are heads)
        const uint32_t pa[4] = {
            pack_bf16(x[0][0][0], x[0][0][1]),
            kHeads > 1 ? pack_bf16(x[kHeads - 1][0][0], x[kHeads - 1][0][1])
                       : 0u,
            pack_bf16(x[0][1][0], x[0][1][1]),
            kHeads > 1 ? pack_bf16(x[kHeads - 1][1][0], x[kHeads - 1][1][1])
                       : 0u};
#pragma unroll
        for (int dt = 0; dt < HD / 8; dt += 2) {
          uint32_t vf[4];                    // column tiles dt, dt + 1
          ldsm_x4_trans(smem_addr(Vt + (lane % 8 + 8 * ((lane / 8) % 2)) *
                                       P + 8 * dt + 8 * (lane / 16)), vf);
          mma_bf16(ob[dt], pa, vf[0], vf[1]);
          mma_bf16(ob[dt + 1], pa, vf[2], vf[3]);
        }
      }
    } else {
      float* Pw = reinterpret_cast<float*>(Qs + L::kQRows * P) +
                  warp * G * kWarpRows;
      if (w0 < end) {
        const int p = lane % 16, half = lane / 16;
        // scores of position w0 + p, half `half` of the head dim
        float sc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = 0.f;
        const float* kr = Kt + p * P + half * (HD / 2);
        const float* qr = Qs + half * (HD / 2);
#pragma unroll
        for (int j = 0; j < HD / 2; j += 4) {
          const float4 kx = *reinterpret_cast<const float4*>(kr + j);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qx = *reinterpret_cast<const float4*>(qr + g * P + j);
            sc[g] += qx.x * kx.x + qx.y * kx.y + qx.z * kx.z + qx.w * kx.w;
          }
        }
        const bool vis = w0 + p < end;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 16);
          const float x = vis ? sc[g] * scale_log2 : -CUDART_INF_F;
          float mx = x;
#pragma unroll
          for (int off = 1; off < 16; off *= 2)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[g], mx);
          const float alpha = exp2f(m[g] - m_new);
          m[g] = m_new;
          sc[g] = exp2f(x - m_new);             // masked: exactly 0
          l[g] = l[g] * alpha + sc[g];          // this lane's positions
#pragma unroll
          for (int e = 0; e < kCols; ++e) of[g][e] *= alpha;
        }
        __syncwarp();                           // last tile's reads done
        if (half == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) Pw[g * kWarpRows + p] = sc[g];
        }
        __syncwarp();
        // O += P V over the warp's 16 positions; lane owns kCols columns.
        // 4 V rows at a time, then every head's 4 weights under them:
        // each head sums its rows in order
        const float* vr = Vt + lane * kCols;
#pragma unroll
        for (int r = 0; r < kWarpRows; r += 4) {
          float vx[4][kCols];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            if constexpr (kCols == 2) {
              const float2 a = *reinterpret_cast<const float2*>(
                  vr + (r + rr) * P);
              vx[rr][0] = a.x; vx[rr][1] = a.y;
            } else {
              const float4 a = *reinterpret_cast<const float4*>(
                  vr + (r + rr) * P);
              vx[rr][0] = a.x; vx[rr][1] = a.y; vx[rr][2] = a.z;
              vx[rr][3] = a.w;
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 pw =
                *reinterpret_cast<const float4*>(Pw + g * kWarpRows + r);
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              of[g][e] += pw.x * vx[0][e];
              of[g][e] += pw.y * vx[1][e];
              of[g][e] += pw.z * vx[2][e];
              of[g][e] += pw.w * vx[3][e];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring is free

  // the warps' states into shared memory, then merged per (head, column)
  float* Ms = reinterpret_cast<float*>(smem_raw);
  float* Ls = Ms + kWarps * G;
  float* Os = Ls + kWarps * G;
  if constexpr (kBf16<T>) {
#pragma unroll
    for (int r = 0; r < kHeads; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = gq + 8 * r;
      if (row < G) {
        if (tq == 0) {
          Ms[warp * G + row] = m[r];
          Ls[warp * G + row] = l[r];
        }
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          float* dst = Os + (warp * G + row) * HD + 8 * dt + 2 * tq;
          dst[0] = ob[dt][2 * r];
          dst[1] = ob[dt][2 * r + 1];
        }
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
      if (lane == 0) {
        Ms[warp * G + g] = m[g];
        Ls[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        Os[(warp * G + g) * HD + lane * kCols + e] = of[g][e];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, Ms[w * G + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(Ms[w * G + g] - mm);  // 0 for an idle warp
      ll += Ls[w * G + g] * wt;
      aa += Os[(w * G + g) * HD + d] * wt;
    }
    if (n_chunks == 1) {
      store(out + head0 + g * HD + d, aa / fmaxf(ll, 1e-30f));
    } else {
      float* dst = part + ((static_cast<int64_t>(bkv) * n_chunks +
                            blockIdx.y) * G + g) * (HD + 4);
      if (d == 0) {
        dst[0] = mm;
        dst[1] = ll;
        dst[2] = dst[3] = 0.f;              // pad: acc starts 16-byte aligned
      }
      dst[4 + d] = aa;
    }
  }
}

// One block per (b, kv head): merges the partial states of all its chunks
// (an empty share's neutral state weighs exactly 0).  Every chunk's (m, l)
// is read at once into shared memory; warp g takes head g's maximum and
// the chunks' weights; then kSplit threads per 4 output columns each sum
// every kSplit-th chunk, so the loads of all chunks are in flight together.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(combine_threads<G>())
decode_combine_kernel(T* __restrict__ out, const float* __restrict__ part,
                      int Kv, int n_chunks) {
  constexpr int kCombineThreads = combine_threads<G>();
  constexpr int kState = HD + 4;            // m, l, pad, pad, acc[HD]
  constexpr int kCols = G * HD / 4;         // float4 columns of the heads
  constexpr int kSplit = kCombineThreads / kCols;
  static_assert(kSplit >= 1 && kCombineThreads / 32 >= G, "block shape");
  __shared__ float ws[kMaxChunks * G];      // m, then the chunk's weight
  __shared__ float ls[kMaxChunks * G];
  __shared__ float lsum[G];
  __shared__ float4 red[kSplit][kCols];
  const int bkv = blockIdx.x;
  const int b = bkv / Kv;
  const int kvh = bkv % Kv;
  const int H = Kv * G;
  const float* src = part + static_cast<int64_t>(bkv) * n_chunks * G * kState;
  for (int i = threadIdx.x; i < n_chunks * G; i += kCombineThreads) {
    const float2 ml = *reinterpret_cast<const float2*>(
        src + static_cast<int64_t>(i) * kState);
    ws[i] = ml.x;
    ls[i] = ml.y;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < G) {
    float mm = kNegInf;
    for (int c = lane; c < n_chunks; c += 32) mm = fmaxf(mm, ws[c * G + warp]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const float w = exp2f(ws[c * G + warp] - mm);
      ws[c * G + warp] = w;
      ll += ls[c * G + warp] * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      ll += __shfl_xor_sync(0xffffffffu, ll, off);
    if (lane == 0) lsum[warp] = ll;
  }
  __syncthreads();
  const int col = threadIdx.x % kCols, r = threadIdx.x / kCols;
  const int g = col / (HD / 4), d = 4 * (col % (HD / 4));
  if (r < kSplit) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = src + g * kState + 4 + d;
#pragma unroll 4
    for (int c = r; c < n_chunks; c += kSplit) {
      const float w = ws[c * G + g];
      const float4 x = *reinterpret_cast<const float4*>(
          p + static_cast<int64_t>(c) * G * kState);
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    red[r][col] = a;
  }
  __syncthreads();
  if (r == 0) {
    float4 a = red[0][col];
#pragma unroll
    for (int j = 1; j < kSplit; ++j) {
      a.x += red[j][col].x;
      a.y += red[j][col].y;
      a.z += red[j][col].z;
      a.w += red[j][col].w;
    }
    const float inv = 1.f / fmaxf(lsum[g], 1e-30f);
    T* dst = out + (static_cast<int64_t>(b) * H + kvh * G + g) * HD + d;
    store(dst, a.x * inv);
    store(dst + 1, a.y * inv);
    store(dst + 2, a.z * inv);
    store(dst + 3, a.w * inv);
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
cudaError_t launch_g(int device, void* out, void* part, const void* q,
                     const void* k, const void* v, const int* pos, int B,
                     int S, int Kv, int n_chunks, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = Smem<T, HD, G>::kBytes;
  // the shared-memory opt-in, once per device (bit i: device i)
  static std::atomic<uint64_t> opted{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_chunk_kernel<T, HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  decode_chunk_kernel<T, HD, G><<<chunk_grid(B, Kv, n_chunks), kThreads,
                                  smem, stream>>>(
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, S, Kv, n_chunks, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  decode_combine_kernel<T, HD, G><<<combine_grid(B, Kv),
                                    combine_threads<G>(), 0, stream>>>(
      static_cast<T*>(out), static_cast<const float*>(part), Kv, n_chunks);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(int G, int device, void* out, void* part,
                      const void* q, const void* k, const void* v,
                      const int* pos, int B, int S, int Kv, int n_chunks,
                      float scale, cudaStream_t stream) {
#define DECODE_G(g)                                                        \
  case g:                                                                  \
    return launch_g<T, HD, g>(device, out, part, q, k, v, pos, B, S, Kv,   \
                              n_chunks, scale, stream);
  switch (G) {
    DECODE_G(1) DECODE_G(2) DECODE_G(3) DECODE_G(4)
    DECODE_G(5) DECODE_G(6) DECODE_G(7) DECODE_G(8)
    DECODE_G(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_G
}

template <typename T>
int launch(int device, void* out, void* part, const void* q, const void* k,
           const void* v, const void* pos, int B, int S, int H, int Kv,
           int hd, int n_chunks, float scale, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks < 1 || n_chunks > kMaxChunks) return cudaErrorInvalidValue;
  const int G = H / Kv;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      err = launch_hd<T, 64>(G, device, out, part, q, k, v, p, B, S, Kv,
                             n_chunks, scale, s);
      break;
    case 128:
      err = launch_hd<T, 128>(G, device, out, part, q, k, v, p, B, S, Kv,
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
// aligned, hd in {64, 128}, H / Kv in 1..8 or 16, pos an i32[B] device
// array with pos[b] >= 0, n_chunks in 1..256 and, when n_chunks > 1, an f32 scratch
// part of B * Kv * n_chunks * (H / Kv) * (hd + 4) elements.
int decode_attention_f32(int device, void* out, void* part, const void* q,
                         const void* k, const void* v, const void* pos, int B,
                         int S, int H, int Kv, int hd, int n_chunks,
                         float scale, void* stream) {
  return launch<float>(device, out, part, q, k, v, pos, B, S, H, Kv, hd,
                       n_chunks, scale, stream);
}

int decode_attention_bf16(int device, void* out, void* part, const void* q,
                          const void* k, const void* v, const void* pos,
                          int B, int S, int H, int Kv, int hd, int n_chunks,
                          float scale, void* stream) {
  return launch<__nv_bfloat16>(device, out, part, q, k, v, pos, B, S, H, Kv,
                               hd, n_chunks, scale, stream);
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
