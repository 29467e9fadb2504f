// QSGD stochastic quantization, CUDA C++ for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of repro/kernels/qsgd_quant.py:
//   sqnorm     (_sqsum_kernel)    sq[t] = sum_i x_t[i]^2 for each tensor t of
//                                 a group, f32
//   quantize   (_quant_kernel)    levels[i] = int8(sign(x[i]) * (floor(y) + [u[i] < y - floor(y)]))
//                                 with y = |x[i]| / norm * s, s = 2^(bits-1) - 1,
//                                 and y = 0 where norm is 0
//   dequantize (_dequant_kernel)  out[i] = float(levels[i]) * (norm / s)
// over contiguous tensors of n elements viewed flat; and a keyed quantize,
// which replaces no Pallas kernel (the reference draws u with jax.random
// outside its kernel):
//   threefry quantize             quantize with u[i] drawn inside the kernel
//                                 from the key, as core/prng.py's uniform
// The caller takes norm = sqrt(sq) on the device; the quantize kernels and
// dequantize read it through a pointer, so there is no host round trip
// between the launches.
//
// Bound: bytes, but for the keyed quantize.  Per element sqnorm reads 4
// bytes, quantize reads 8 and writes 1, dequantize reads 1 and writes 4,
// each with a handful of f32 operations -- far below the card's ratio of
// operations to bytes.  Each thread walks a grid-stride range of scalar
// loads, neighbouring threads on neighbouring addresses; vector loads are
// left for later.
//
// The keyed quantize (threefry_quantize_kernel) replaces quantize on the
// main path.  quantize reads uniforms that core/prng.py::uniform drew
// first: the reference's threefry2x32 stream in int64 PyTorch tensors
// masked to 32 bits, some twenty full passes over every element, about
// 3 KB of traffic an element (2.6 s of a 2.8 s quantized sync of
// OLMo-1B at R = 2).  The stream is counter-based -- element i's uniform
// is threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)) -- so the keyed kernel
// takes the key's two words by value and draws each element's uniform in
// registers, bit for bit the one prng.uniform gives, then applies
// quantize's arithmetic unchanged.  It reads 4 bytes and writes 1 an
// element, and does about 75 32-bit integer operations an element: 20
// rounds of add, rotate and xor, 5 key injections, the bits of the
// float.  The 20 rotations and 21 xors (and the shift and or of the bits)
// run only on the integer ALU, 64 lanes an SM, while the adds may issue
// as IMAD beside them, so those 43 operations bound it: about 1.7x the
// time of its 5 bytes.  The hash stays in 32-bit registers (64-bit math
// only for the index and its split), rotations are funnel shifts and the
// rounds are unrolled; otherwise it walks the range as quantize does.
//
// Arithmetic that must match the plain version bit for bit.  quantize
// follows the jnp formula |x| / norm * s of repro/core/qsgd.py and
// repro/kernels/ref.py, which every parity test compares against, and not
// the Pallas body's |x| * (s / norm): the two round differently.  The
// library is built without --use_fast_math, so the division is IEEE
// round-to-nearest, as PyTorch's.  Before the cast the level is clamped to
// [-128, 127]: when |x| / norm rounds just above 1 a level of s + 1 = 128
// is reachable at 8 bits; XLA's cast saturates it to 127, while a C cast
// of 128.0f to int8 is undefined.  dequantize computes norm / s once and
// then one product, in the plain version's order.
//
// Determinism.  The Pallas sqnorm carries its sum across an in-order grid;
// Hopper blocks run in no order, so the sum takes two passes with no float
// atomics: pass 1 reduces each block's grid-stride range in a fixed tree
// into partials[blockIdx.x], pass 2 gives each tensor one block that sums
// its partials in a fixed order.  A tensor's block count is a function of
// its n alone (set by the caller), so sq repeats bit for bit, and is the
// same whether the tensor is summed alone or in a group.  It sets the
// levels, the levels set the exchange's S_k, and ADPSGD moves its period
// on S_k thresholds.
//
// Groups.  The paths take the norms of many tensors at once (the R deltas
// of a leaf in a quantized sync, the leaves of one replica's gradient in a
// qsgd step).  One launch covers up to kMaxGroup tensors: the table of
// (pointer, n, first block) goes to both kernels by value as a kernel
// parameter, so there is no host-to-device copy; pass 1 runs over all the
// group's blocks, each finding its tensor by a binary search of the table.
// A call costs one host round of launch overhead, not one per tensor: on
// the small leaves that overhead, not the card, was the sum's time.
//
// Offsets are 64-bit: the embedding leaf alone is 103M elements.
//
// C interface for ctypes: pointers and the stream are void*, each entry
// point returns cudaGetLastError() after its launches (0 = success).

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

__device__ __forceinline__ int64_t first_index() {
  return static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * kThreads;
}

constexpr int kMaxGroup = 64;   // tensors per sqnorm launch (MAX_GROUP in qsgd_quant.py)

struct Group {
  const float* x[kMaxGroup];
  long long n[kMaxGroup];
  int first[kMaxGroup + 1];   // first block of tensor t; first[count] = all blocks
  int count;
};

// Tensor t of the group, blocks first[t] ... first[t + 1] - 1, each walking
// the grid-stride range that a launch over tensor t alone would give it.
__global__ void __launch_bounds__(kThreads)
sqnorm_pass1(const Group g, float* __restrict__ partials) {
  const int block = static_cast<int>(blockIdx.x);
  int lo = 0, hi = g.count - 1;          // the last t with first[t] <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (g.first[mid] <= block) lo = mid; else hi = mid - 1;
  }
  const float* __restrict__ x = g.x[lo];
  const int64_t n = g.n[lo];
  const int64_t stride =
      static_cast<int64_t>(g.first[lo + 1] - g.first[lo]) * kThreads;
  float acc = 0.0f;
  for (int64_t i = static_cast<int64_t>(block - g.first[lo]) * kThreads
                   + threadIdx.x;
       i < n; i += stride) {
    const float v = x[i];
    acc += v * v;
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[block] = total;
}

// One block per tensor: the sum of its partials.
__global__ void __launch_bounds__(kThreads)
sqnorm_pass2(const Group g, const float* __restrict__ partials,
             float* __restrict__ out) {
  const int t = blockIdx.x;
  const float* p = partials + g.first[t];
  const int n = g.first[t + 1] - g.first[t];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += p[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[t] = total;
}

// One element's level, the plain version's arithmetic: both quantize
// kernels call this.
__device__ __forceinline__ int8_t level_of(float v, float u, float nrm,
                                           float scale) {
  const float scaled = nrm > 0.0f ? fabsf(v) / nrm * scale : 0.0f;
  const float floor_v = floorf(scaled);
  const float mag = floor_v + (u < scaled - floor_v ? 1.0f : 0.0f);
  const float sign = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  const float level = fminf(fmaxf(sign * mag, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(level));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ norm, int8_t* __restrict__ levels,
                int64_t n, int s) {
  const float nrm = *norm;
  const float scale = static_cast<float>(s);
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    levels[i] = level_of(x[i], u[i], nrm, scale);
  }
}

// Threefry-2x32, 20 rounds, of the counter pair (i >> 32, i & 0xFFFFFFFF)
// under the key (k0, k1), as core/prng.py::threefry2x32: returns the
// uniform in [0, 1) that prng.uniform gives element i, bit for bit.
__device__ __forceinline__ float threefry_uniform(uint32_t k0, uint32_t k1,
                                                  uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
#define REPRO_ROUND(r)                  \
  x0 += x1;                             \
  x1 = __funnelshift_l(x1, x1, (r));    \
  x1 ^= x0;
#define REPRO_ROUNDS_A REPRO_ROUND(13) REPRO_ROUND(15) REPRO_ROUND(26) REPRO_ROUND(6)
#define REPRO_ROUNDS_B REPRO_ROUND(17) REPRO_ROUND(29) REPRO_ROUND(16) REPRO_ROUND(24)
  REPRO_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  REPRO_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  REPRO_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  REPRO_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  REPRO_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef REPRO_ROUNDS_B
#undef REPRO_ROUNDS_A
#undef REPRO_ROUND
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// quantize with u[i] = threefry_uniform(k0, k1, start + i).
__global__ void __launch_bounds__(kThreads)
threefry_quantize_kernel(const float* __restrict__ x,
                         const float* __restrict__ norm,
                         int8_t* __restrict__ levels, int64_t n, int s,
                         uint32_t k0, uint32_t k1, uint64_t start) {
  const float nrm = *norm;
  const float scale = static_cast<float>(s);
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    levels[i] = level_of(x[i], threefry_uniform(
        k0, k1, start + static_cast<uint64_t>(i)), nrm, scale);
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ levels,
                  const float* __restrict__ norm, float* __restrict__ out,
                  int64_t n, int s) {
  const float step = *norm / static_cast<float>(s);
  for (int64_t i = first_index(); i < n; i += grid_stride()) {
    out[i] = static_cast<float>(levels[i]) * step;
  }
}

}  // namespace

// count <= kMaxGroup tensors: x[t] (device pointers), n[t] elements and
// blocks[t] pass-1 blocks each; partials holds sum(blocks) floats and sq
// count floats.
extern "C" int repro_qsgd_sqnorm_many_f32(const void* const* x,
                                          const long long* n,
                                          const int* blocks, int count,
                                          void* partials, void* sq,
                                          void* stream) {
  if (count < 1 || count > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Group g;
  g.count = count;
  g.first[0] = 0;
  for (int t = 0; t < count; ++t) {
    g.x[t] = static_cast<const float*>(x[t]);
    g.n[t] = n[t];
    g.first[t + 1] = g.first[t] + blocks[t];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sqnorm_pass1<<<g.first[count], kThreads, 0, st>>>(
      g, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sqnorm_pass2<<<count, kThreads, 0, st>>>(
      g, static_cast<const float*>(partials), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_qsgd_quantize_f32(const void* x, const void* u,
                                       const void* norm, void* levels,
                                       long long n, int s, int blocks,
                                       void* stream) {
  quantize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(norm), static_cast<int8_t*>(levels),
      static_cast<int64_t>(n), s);
  return static_cast<int>(cudaGetLastError());
}

// The keyed quantize: x, norm and levels device pointers, n elements,
// the key's words k0, k1, and the counter of element 0 (0 on the main
// path: a leaf's element i is counter i).
extern "C" int repro_qsgd_threefry_quantize_f32(const void* x,
                                                const void* norm,
                                                void* levels, long long n,
                                                int s, unsigned int k0,
                                                unsigned int k1,
                                                unsigned long long start,
                                                int blocks, void* stream) {
  threefry_quantize_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(norm),
      static_cast<int8_t*>(levels), static_cast<int64_t>(n), s, k0, k1,
      start);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_qsgd_dequantize_i8(const void* levels, const void* norm,
                                        void* out, long long n, int s,
                                        int blocks, void* stream) {
  dequantize_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(levels), static_cast<const float*>(norm),
      static_cast<float*>(out), static_cast<int64_t>(n), s);
  return static_cast<int>(cudaGetLastError());
}
