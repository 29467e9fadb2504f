// Fused replica mean + squared deviation, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/param_variance.py::mean_and_sqdev
// (_mean_sqdev_kernel).  For one stacked-replica buffer w viewed as a
// contiguous (R, N) f32 matrix it writes
//     mean[c] = (sum_r w[r, c]) / R                      (f32, N values)
//     sq      = sum_{r, c} (w[r, c] - mean[c])^2         (f32 scalar)
// in one pass over w.  The caller divides sq by R and sums it over the
// leaves of the parameter tree to get the ADPSGD variance probe S_k.
//
// Bound: bytes.  The work is one read of R*N*4 bytes and one write of N*4
// bytes, with about 4 flops per element read, far below the card's ratio
// of flops to bytes.  Each thread owns whole columns: it reads the R values
// of a column (coalesced across the warp, row by row), writes the mean and
// reads the same R values again for the deviations; the second read hits
// the L1/L2 lines the first one just brought in, so device memory sees w
// once.
//
// Determinism.  The Pallas kernel carries the scalar across a sequential
// grid; Hopper blocks run in no order, so the sum is split in two passes
// with no float atomics: pass 1 grid-strides over columns and reduces each
// block's squares in a fixed tree (warp shuffles, then one warp over the
// per-warp sums) into partials[blockIdx.x]; pass 2 is one block that sums
// the partials in the same fixed order.  The grid size is a function of N
// alone (set by the caller), so sq is bit-identical from run to run on one
// card.  ADPSGD moves its period on S_k thresholds, and a sum that changed
// with scheduling could flip a schedule.
//
// Offsets are 64-bit: an embedding leaf at R = 4 is 4 x 103M elements, and
// a flat multi-leaf buffer or a larger R passes 2^31.  The ragged edge is
// masked by the column loop's bound; nothing is padded.
//
// C interface for ctypes: pointers and the stream are void*, the return
// value is cudaGetLastError() after the launches (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
    v = warp_sum(v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
mean_sqdev_pass1(const float* __restrict__ w, float* __restrict__ mean,
                 float* __restrict__ partials, int64_t rows, int64_t cols) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const float n = static_cast<float>(rows);
  float acc = 0.0f;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < cols; c += stride) {
    float s = 0.0f;
    for (int64_t r = 0; r < rows; ++r) s += w[r * cols + c];
    const float m = s / n;
    mean[c] = m;
    for (int64_t r = 0; r < rows; ++r) {
      const float d = w[r * cols + c] - m;
      acc += d * d;
    }
  }
  const float block = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = block;
}

__global__ void __launch_bounds__(kThreads)
mean_sqdev_pass2(const float* __restrict__ partials, float* __restrict__ out,
                 int n) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) *out = total;
}

}  // namespace

extern "C" int repro_mean_sqdev_f32(const void* w, void* mean, void* partials,
                                    void* sq, long long rows, long long cols,
                                    int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mean_sqdev_pass1<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(mean),
      static_cast<float*>(partials), static_cast<int64_t>(rows),
      static_cast<int64_t>(cols));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mean_sqdev_pass2<<<1, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                          static_cast<float*>(sq), blocks);
  return static_cast<int>(cudaGetLastError());
}
