// A deliberately racy CUDA kernel for NVIDIA Hopper (sm_90a): the race
// analyzer's negative fixture (F1).
//
//     out[u] = out[u] + sum_{r in tile i} x[r, u]     for every tile i
//
// over x f32 [R, U] in tiles of br rows, on an out f32 [U] the wrapper
// zeroes.  The plain read-modify-write of out[u] by every row tile of
// column u races: blocks of one launch run in parallel and in no order,
// so concurrent tiles of a column lose each other's updates.  With one row
// tile (R == br) there is one block per column and the result is defined:
// the column sums.
//
// Replaces the TPU fixture src/repro/check/fixtures/racy_kernel.py:racy_sum
// (pallas_call at :25), whose output block is indexed by the column axis
// alone, so the row-tile axis revisits it at non-consecutive grid steps
// (classification "racy" in repro.check.pallas_race).  Here block (i, u)
// of the grid (R / br, U) reduces its br x 1 tile in shared memory and
// thread 0 adds the sum into out[u] with a plain load and store, no atomic.
// repro_torch.check.grid_race classifies the declared geometry "racy" with
// revisit axis 0.
//
// Bound: memory.  The kernel reads x once (4 * R * U bytes) and writes out
// (4 * U bytes; a lost update writes no fewer).  Its time is reported, not
// tuned: a racy kernel's result is undefined.
//
// Design (simple first): 256 threads per block, each summing rows t,
// t + 256, ... of the tile (a column of a row-major x, so the loads are
// strided by U), then a tree reduction in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
racy_sum_kernel(float* out, const float* __restrict__ x, int64_t U,
                int64_t br) {
  __shared__ float part[kThreads];
  const int64_t i = blockIdx.x;           // row tile
  const int64_t u = blockIdx.y;           // column
  float s = 0.f;
  for (int64_t r = threadIdx.x; r < br; r += kThreads) {
    s += x[(i * br + r) * U + u];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // the race, on purpose: a plain load and a plain store
    volatile float* o = out;
    o[u] = o[u] + part[0];
  }
}

// The launch's grid: one block per (row tile, column).
inline dim3 grid_of(int64_t R, int64_t U, int64_t br) {
  return dim3(static_cast<unsigned>(R / br), static_cast<unsigned>(U));
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).  The caller
// guarantees contiguous x [R, U], R % br == 0, 1 <= U <= 65535 and a
// zeroed out [U].
int racy_sum_f32(int device, void* out, const void* x, int64_t R, int64_t U,
                 int64_t br, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  racy_sum_kernel<<<grid_of(R, U, br), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(x), U, br);
  return static_cast<int>(cudaGetLastError());
}

// Host only: the grid racy_sum_f32 computes, as grid3 = (x, y, z).
// Launches nothing.
int racy_sum_geometry(int64_t R, int64_t U, int64_t br, int64_t* grid3) {
  const dim3 g = grid_of(R, U, br);
  grid3[0] = g.x;
  grid3[1] = g.y;
  grid3[2] = g.z;
  return 0;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
