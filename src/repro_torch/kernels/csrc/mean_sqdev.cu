// Fused replica mean + squared deviation over a whole parameter tree, CUDA
// C++ for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/param_variance.py::mean_and_sqdev
// (_mean_sqdev_kernel), which the reference runs once per leaf.  For every
// leaf l of a tree, its stacked-replica buffer w_l viewed as a contiguous
// (R, N_l) f32 matrix, one pass over w_l gives
//     mean[c] = (((w[0, c] + w[1, c]) + ...) + w[R-1, c]) / R
//     sq[l]   = sum_{r, c} (w[r, c] - mean[c])^2
// and, after the leaves, S_k = (sum_l sq[l]) / R, the ADPSGD variance
// probe.  What the pass writes is the mode:
//     mean   the mean into an output buffer (the reference's contract);
//     sync   the mean back into all R rows of w, in place (the sync);
//     delta  mean - w[r, c] into an output buffer of w's size (DaSGD's
//            snapshot), w only read.
// The mean sums the replicas in index order and divides by R with a true
// division, as kernels/ref.py::mean_and_sqdev_ref does, so it is bitwise
// the plain version's.
//
// Bound: bytes.  A sync reads R*N*4 bytes and writes R*N*4 (sync, delta)
// or N*4 (mean), with about 4 flops per element read, far below the card's
// ratio of flops to bytes.  So the design moves each byte once and keeps
// enough of them in flight:
//   * One launch for all leaves.  A tile is a fixed-width run of columns of
//     one leaf (tile_cols, a function of R alone); the wrapper builds the
//     list of tiles (the leaf of each) and a table of the leaves (address,
//     columns, first tile, output offset, 16-byte flag) once per tree.  A
//     persistent grid walks the tiles, tile t in block t mod G, so small
//     leaves (biases, norms) share the grid with large ones instead of
//     paying a launch and a host round-trip each.
//   * A thread reads the R values of its columns into registers, then
//     writes: no second read, and in sync mode the mean goes back over the
//     values it came from (no other thread touches those columns).
//   * 16-byte loads and stores (float4) on a leaf whose N_l % 4 == 0 (so
//     every row is 16-byte aligned), 4-byte ones on the others; R in
//     {2, 4, 8, 16} is a template parameter, so the values stay in
//     registers, and a tile gives each thread 8 (R <= 8) or 16 (R = 16)
//     independent 16-byte loads to keep in flight.  Any other R takes a
//     loop that reads each column twice (the second read from L1/L2).
//
// Determinism.  Hopper blocks run in no order, so the sums are split in
// two passes with no float atomics: pass 1 reduces each tile's squares in
// a fixed tree (warp shuffles, then one warp over the per-warp sums) into
// partials[tile], whatever block runs it; pass 2 is one block that sums
// each leaf's partials in a fixed order into sq[l] and the sq[l] in leaf
// order into S_k.  So S_k is bit-identical from run to run on one card.
// ADPSGD moves its period on S_k thresholds, and a sum that changed with
// scheduling could flip a schedule.
//
// Offsets are 64-bit: an embedding leaf at R = 4 is 4 x 103M elements.
// The ragged edge of a leaf is masked by the column bound; nothing is
// padded in w.
//
// C interface for ctypes: pointers and the stream are void*, the return
// value is cudaGetLastError() after the launches (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode : int { kMean = 0, kSync = 1, kDelta = 2 };

// One row of the leaf table: five int64, as the wrapper packs them.
struct Leaf {
  long long w;           // address of the leaf's (R, cols) f32 buffer
  long long cols;        // columns per replica, N_l
  long long first_tile;  // index of the leaf's first tile
  long long out_off;     // columns before the leaf in a mean buffer (each
                         // leaf rounded up to 4); R times that in delta mode
  long long vec;         // 1: 16-byte loads and stores
};

// Columns of one tile per replica: 32 KB of w for R <= 8, 64 KB at R = 16.
__host__ __device__ constexpr long long tile_cols_for(int rows) {
  return 1024LL * (rows > 0 && 8 / rows > 1 ? 8 / rows : 1);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ float4 sub(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float div(float a, float n) { return a / n; }
__device__ __forceinline__ float4 div(float4 a, float n) {
  return make_float4(a.x / n, a.y / n, a.z / n, a.w / n);
}
__device__ __forceinline__ float sq_add(float acc, float d) {
  return acc + d * d;
}
__device__ __forceinline__ float sq_add(float acc, float4 d) {
  acc += d.x * d.x;
  acc += d.y * d.y;
  acc += d.z * d.z;
  return acc + d.w * d.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of v over the block in a fixed order; the result is valid in thread
// 0.  Callers alternate between two buffers of kWarps floats: a warp can
// only write a buffer again after the next call's barrier, which warp 0
// reaches after it has read this one.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
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

// Writes of column c (in V units, rows of `cols` V's) given its mean m and
// its value x in row r.
template <int MODE, typename V>
__device__ __forceinline__ void put(V* w, V* out, int64_t cols, int64_t c,
                                    int r, V m, V x) {
  if (MODE == kSync) w[r * cols + c] = m;
  if (MODE == kDelta) out[r * cols + c] = sub(m, x);
}

// One tile with R fixed: thread t takes the V-columns c0 + t + k*kThreads,
// k < PER, reads all of their R values, then writes.  Returns the thread's
// sum of squared deviations.
template <int R, int MODE, typename V, int PER>
__device__ __forceinline__ float tile_fixed(V* w, V* out, int64_t cols,
                                            int64_t c0) {
  V v[PER][R];
  bool ok[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int64_t c = c0 + threadIdx.x + k * kThreads;
    ok[k] = c < cols;
    if (ok[k]) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[k][r] = w[r * cols + c];
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (!ok[k]) continue;
    const int64_t c = c0 + threadIdx.x + k * kThreads;
    V s = v[k][0];
#pragma unroll
    for (int r = 1; r < R; ++r) s = add(s, v[k][r]);
    const V m = div(s, static_cast<float>(R));
#pragma unroll
    for (int r = 0; r < R; ++r) acc = sq_add(acc, sub(v[k][r], m));
    if (MODE == kMean) out[c] = m;
#pragma unroll
    for (int r = 0; r < R; ++r) put<MODE>(w, out, cols, c, r, m, v[k][r]);
  }
  return acc;
}

// One tile with R a run-time value: the sum, then a second read of each
// value for the deviations and the writes.  Not inlined: inlined into the
// tile loop, ptxas spilled a few bytes of it in two of the modes.
template <int MODE, typename V>
__device__ __noinline__ float tile_any(V* w, V* out, int64_t cols,
                                       int64_t c0, int64_t width,
                                       int rows) {
  const float n = static_cast<float>(rows);
  float acc = 0.0f;
  const int64_t end = c0 + width < cols ? c0 + width : cols;
  for (int64_t c = c0 + threadIdx.x; c < end; c += kThreads) {
    V s = w[c];
    for (int r = 1; r < rows; ++r) s = add(s, w[r * cols + c]);
    const V m = div(s, n);
    if (MODE == kMean) out[c] = m;
    for (int r = 0; r < rows; ++r) {
      const V x = w[r * cols + c];
      acc = sq_add(acc, sub(x, m));
      put<MODE>(w, out, cols, c, r, m, x);
    }
  }
  return acc;
}

template <int R, int MODE, typename V>
__device__ __forceinline__ float tile(float* w, float* out, int64_t cols,
                                      int64_t start, int rows) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  V* wv = reinterpret_cast<V*>(w);
  V* ov = reinterpret_cast<V*>(out);
  if constexpr (R == 0) {
    return tile_any<MODE, V>(wv, ov, cols / kWidth, start / kWidth,
                             tile_cols_for(rows) / kWidth, rows);
  } else {
    constexpr int kPer =
        static_cast<int>(tile_cols_for(R) / kWidth / kThreads);
    return tile_fixed<R, MODE, V, kPer>(wv, ov, cols / kWidth,
                                        start / kWidth);
  }
}

// Pass 1: the tiles, tile t in block t mod gridDim.x.  `table` null means
// one leaf, `single`, whose tiles are all of them.
template <int R, int MODE>
__global__ void __launch_bounds__(kThreads)
mean_sqdev_tiles(const Leaf* __restrict__ table,
                 const int* __restrict__ tile_leaf, Leaf single, float* out,
                 float* __restrict__ partials, long long n_tiles, int rows) {
  __shared__ float warp_sums[2][kWarps];
  const long long tile_cols = tile_cols_for(R > 0 ? R : rows);
  int parity = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    long long addr = single.w, cols = single.cols, first = 0, off = 0;
    long long vec = single.vec;
    if (table != nullptr) {
      const Leaf* leaf = table + tile_leaf[t];
      addr = leaf->w;
      cols = leaf->cols;
      first = leaf->first_tile;
      off = leaf->out_off;
      vec = leaf->vec;
    }
    const int64_t start = (t - first) * tile_cols;
    float* w = reinterpret_cast<float*>(addr);
    float* o = out == nullptr
                   ? nullptr
                   : out + (MODE == kDelta ? rows * off : off);
    const float acc = vec ? tile<R, MODE, float4>(w, o, cols, start, rows)
                          : tile<R, MODE, float>(w, o, cols, start, rows);
    const float s = block_sum(acc, warp_sums[parity]);
    if (threadIdx.x == 0) partials[t] = s;
    parity ^= 1;
  }
}

// Pass 2, one block: sq[l] is the sum of leaf l's partials (thread-strided,
// then the fixed tree), S_k the sum of the sq[l] in leaf order over R.
__global__ void __launch_bounds__(kThreads)
mean_sqdev_leaves(const Leaf* __restrict__ table,
                  const float* __restrict__ partials, float* __restrict__ sq,
                  float* __restrict__ s_k, int n_leaves, long long n_tiles,
                  int rows) {
  __shared__ float warp_sums[2][kWarps];
  float total = 0.0f;
  for (int l = 0; l < n_leaves; ++l) {
    const long long lo = table != nullptr ? table[l].first_tile : 0;
    const long long hi = table != nullptr && l + 1 < n_leaves
                             ? table[l + 1].first_tile
                             : n_tiles;
    float acc = 0.0f;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      acc += partials[i];
    }
    const float s = block_sum(acc, warp_sums[l & 1]);
    if (threadIdx.x == 0) {
      sq[l] = s;
      total += s;
    }
  }
  if (threadIdx.x == 0) *s_k = total / static_cast<float>(rows);
}

template <int MODE>
void launch_tiles(int rows, const Leaf* table, const int* tile_leaf,
                  const Leaf& single, float* out, float* partials,
                  long long n_tiles, int blocks, cudaStream_t s) {
  switch (rows) {
    case 2:
      mean_sqdev_tiles<2, MODE><<<blocks, kThreads, 0, s>>>(
          table, tile_leaf, single, out, partials, n_tiles, rows);
      break;
    case 4:
      mean_sqdev_tiles<4, MODE><<<blocks, kThreads, 0, s>>>(
          table, tile_leaf, single, out, partials, n_tiles, rows);
      break;
    case 8:
      mean_sqdev_tiles<8, MODE><<<blocks, kThreads, 0, s>>>(
          table, tile_leaf, single, out, partials, n_tiles, rows);
      break;
    case 16:
      mean_sqdev_tiles<16, MODE><<<blocks, kThreads, 0, s>>>(
          table, tile_leaf, single, out, partials, n_tiles, rows);
      break;
    default:
      mean_sqdev_tiles<0, MODE><<<blocks, kThreads, 0, s>>>(
          table, tile_leaf, single, out, partials, n_tiles, rows);
  }
}

int run(const Leaf* table, const int* tile_leaf, const Leaf& single,
        int n_leaves, long long n_tiles, int rows, int mode,
        long long tile_cols, float* out, float* partials, float* sq,
        float* s_k, int blocks, cudaStream_t s) {
  if (rows < 1 || n_leaves < 1 || n_tiles < 1 || blocks < 1 ||
      tile_cols != tile_cols_for(rows) || (mode != kSync && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case kMean:
      launch_tiles<kMean>(rows, table, tile_leaf, single, out, partials,
                          n_tiles, blocks, s);
      break;
    case kSync:
      launch_tiles<kSync>(rows, table, tile_leaf, single, nullptr, partials,
                          n_tiles, blocks, s);
      break;
    case kDelta:
      launch_tiles<kDelta>(rows, table, tile_leaf, single, out, partials,
                           n_tiles, blocks, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mean_sqdev_leaves<<<1, kThreads, 0, s>>>(table, partials, sq, s_k,
                                           n_leaves, n_tiles, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All leaves of a tree in one pass: `table` (n_leaves rows of five int64,
// on the device) and `tile_leaf` (the leaf of each of the n_tiles tiles,
// int32, on the device) as the wrapper builds them; `out` the mean (mode 0)
// or delta (mode 2) buffer, null for the sync (mode 1); `partials` n_tiles
// floats of scratch; `sq` n_leaves floats; `s_k` one float.
extern "C" int repro_mean_sqdev_many_f32(
    const void* table, const void* tile_leaf, int n_leaves,
    long long n_tiles, int rows, int mode, long long tile_cols, void* out,
    void* partials, void* sq, void* s_k, int blocks, void* stream) {
  if (table == nullptr || tile_leaf == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Leaf none{};
  return run(static_cast<const Leaf*>(table),
             static_cast<const int*>(tile_leaf), none, n_leaves, n_tiles,
             rows, mode, tile_cols, static_cast<float*>(out),
             static_cast<float*>(partials), static_cast<float*>(sq),
             static_cast<float*>(s_k), blocks, static_cast<cudaStream_t>(stream));
}

// The one-leaf case of the same kernels (mode mean), the leaf passed by
// value instead of through a table: w (rows, cols) -> mean (cols), sq,
// s_k = sq / rows.
extern "C" int repro_mean_sqdev_f32(const void* w, void* mean, void* partials,
                                    void* sq, void* s_k, int rows,
                                    long long cols, int vec,
                                    long long tile_cols, long long n_tiles,
                                    int blocks, void* stream) {
  const Leaf single{reinterpret_cast<long long>(w), cols, 0, 0, vec};
  return run(nullptr, nullptr, single, 1, n_tiles, rows, kMean, tile_cols,
             static_cast<float*>(mean), static_cast<float*>(partials),
             static_cast<float*>(sq), static_cast<float*>(s_k), blocks,
             static_cast<cudaStream_t>(stream));
}
