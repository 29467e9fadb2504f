// Causal / sliding-window grouped-query attention, forward only, with an
// online softmax: CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas kernel of repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel, pallas_call at :85):
//   o[b, i, h] = sum_j softmax_j(s[i, j]) * v[b, j, h / G]
//   s[i, j]    = (q[b, i, h] . k[b, j, h / G]) / sqrt(d)  where the mask holds,
//                -1e30 where it does not
//   mask       = (j <= i if causal) and (j > i - window if window > 0),
//                positions aligned at the top left as in the reference,
// with q (B, Sq, H, d), k and v (B, Sk, K, d), G = H / K, the output in q's
// type (f32 or bf16) and the softmax in f32.  The normaliser is clamped at
// 1e-30 before the final division, as in the reference.
//
// Two instances:
//   * flash_fwd_wgmma, bf16 at head dims 64 and 128 (serving and
//     prefill_32k): the tensor cores, after FlashAttention-3's forward pass
//     in a simple form (below);
//   * flash_fwd_simt, f32 at head dims 32, 64 and 128, and bf16 at d = 32:
//     f32 FMAs on the CUDA cores.  f32 stays there on purpose: the f32
//     tolerance against the plain version (2e-5) is beyond tf32 or bf16
//     tensor-core products.
//
// Layout.  Both read q, k, v and write o in the model's (B, S, H, d) layout
// through its strides (d contiguous); kv head h / G is index arithmetic (a
// TMA coordinate in the wgmma instance).  Nothing is transposed or repeated
// in device memory, as the reference's transpose + jnp.repeat
// (flash_attention.py:77-79) would.
//
// Skipped tiles (both instances, each with its own q tile).  A k tile wholly
// above the causal diagonal gives p = 0 and alpha = 1 for every row of the
// q tile, so the loop stops before it.  A k tile wholly outside the window,
// before the first valid key, is wiped by alpha = 0 once a valid key
// arrives, so the loop starts after it.  Both hold when every row of the q
// tile has a valid key (always so for causal without a window; with a
// window, when the tile's rows lie inside the key range); otherwise every
// tile is visited, as the reference does.  Keys past Sk (the ragged last
// tile) score -inf and so weigh nothing at all, unlike a masked key's -1e30.
//
// The wgmma instance.  Bound: operations.  At the OLMo-1B prefill layer
// (B 4, S 2048, H 16, d 128, causal) a call does 6.9e10 FLOPs against 134 MB
// of bf16 traffic, 0.0695 ms at the bf16 tensor-core peak.
//   Threads.  384 per block: two consumer warpgroups and one producer
//     warpgroup, whose one issuing thread needs few registers: it gives
//     them up (setmaxnreg.dec to 40) and the consumers take them
//     (setmaxnreg.inc to 232), as FlashAttention-3 does.  A block owns one
//     (b, h, 128-row q tile); consumer warpgroup w computes rows 64 w ...
//     64 w + 63 and loops over 128-key tiles.  The grid puts the q tile on
//     its slow axis, longest rows first, for every head.
//   Loads.  One producer thread issues TMA loads (cp.async.bulk.tensor) from
//     host-built tensor maps: Q once, then K and V tiles into a 2-stage ring,
//     each stage with a "full" mbarrier (expect-tx bytes) and an "empty" one
//     (an arrival from each of the 256 consumer threads once the p.v product
//     that reads the stage has completed).  Tiles are 128 rows of 128-byte
//     swizzled boxes, 64 bf16 columns each, so d = 128 is two boxes; rows
//     past S arrive as zeros.
//   S = Q.K^T.  wgmma m64n128k16, bf16 x bf16 -> f32, both operands from
//     shared memory (K-major, 128-byte swizzle: 8-row groups 1024 B apart, a
//     k-step 32 B along the row).
//   Softmax.  On the accumulator fragments in registers: scores scaled by
//     log2(e) / sqrt(d) and exponentiated with exp2f; row max over a quad by
//     shuffles; the -1e30 mask and the -inf of keys past Sk applied only on
//     tiles that cross the diagonal, the window's edge or Sk.
//   O += P.V.  The reference multiplies the f32 P by V.  wgmma takes bf16
//     operands, so P goes in as two parts, hi = bf16(P) and lo = bf16(P -
//     hi) (P - hi is exact in f32), each the register A operand of its own
//     wgmma m64n{d}k16 into the same f32 accumulator: P enters at about 16
//     mantissa bits instead of 8, and V, a bf16 input, is exact.  Both
//     parts are packed before the first product is issued, so the f32
//     scores die first: two packings of 32 registers hold no more than
//     the 64 of S did.  Each k-step issues hi's product, then lo's, on the
//     same V descriptor; all go in one commit group.  The second packing
//     is what took the consumers past the 168 registers a thread that
//     ptxas allows a 288- or 384-thread block (it spilled), hence the
//     producer's registers above.  V is the shared-memory B
//     operand, MN-major (the transpose bit); the normaliser sums the f32 p.
//   Epilogue.  o / max(l, 1e-30) in bf16, rows past Sq not written.
//
// The SIMT instance.  One block of 128 threads owns one (b, h, 64-row q
// tile) and loops over 64-key tiles; m, l and the accumulator stay in
// registers.  The threads form 8 row groups x 16 column groups: each owns 8
// q rows, 4 keys of a tile and d / 16 output columns, so a q row lives in
// the 16 lanes of one half-warp and its max and sum are reduced with
// shuffles in a fixed order.  Per k tile: K^T and V go to shared memory as
// f32, each thread computes its 8 x 4 scores from Q^T and K^T, the online
// softmax runs in registers, P^T is written where K^T was, and each thread
// accumulates its 8 x d/16 outputs from P^T and V.  expf, no fast math.
//
// Determinism: no atomics, no split over k, a fixed reduction order; a call
// repeats bit for bit and is one launch.  Offsets are 64-bit.
//
// C interface for ctypes: pointers and the stream are void*; the entry
// point returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a head dim or type it has no instance for (or a
// tensor map the driver refuses).

#include <cuda.h>   // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Sk;
  int64_t q_sb, q_ss, q_sh;   // strides of q, in elements
  int64_t k_sb, k_ss, k_sh;   // strides of k and v
  int64_t o_sb, o_ss, o_sh;   // strides of o
  float scale;
  int causal, window;
};

// ---------------------------------------------------------------------------
// The SIMT instance: f32, and bf16 at d = 32.
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kTile = 64;          // q rows of a block; keys of a k tile
constexpr int kRows = 8;           // q rows per thread (kTile / 8 row groups)
constexpr int kKeys = 4;           // keys per thread (kTile / 16 column groups)
constexpr int kLd = kTile + 4;     // row length of a transposed tile (16-byte rows)

// A 16-byte chunk of a row in device memory, widened to f32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// rows [row0, row0 + kTile) of a (rows, D) slab with row stride `stride`,
// transposed into dst[c * kLd + r] as f32; rows at or past n_rows are 0.
// Neighbouring lanes take neighbouring rows, so the shared stores do not
// collide.
template <typename T, int D>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src,
                                                int64_t stride, int row0,
                                                int n_rows, float* dst) {
  constexpr int kCh = Chunk<T>::n;
  for (int c = threadIdx.x; c < kTile * (D / kCh); c += kThreads) {
    const int r = c % kTile;
    const int col = (c / kTile) * kCh;
    float v[kCh];
    if (row0 + r < n_rows) {
      Chunk<T>::load(src + (row0 + r) * stride + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < kCh; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kCh; ++e) dst[(col + e) * kLd + r] = v[e];
  }
}

// The same rows kept row-major: dst[r * D + c].
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int64_t stride, int row0,
                                          int n_rows, float* dst) {
  constexpr int kCh = Chunk<T>::n;
  for (int c = threadIdx.x; c < kTile * (D / kCh); c += kThreads) {
    const int r = c / (D / kCh);
    const int col = (c % (D / kCh)) * kCh;
    float v[kCh];
    if (row0 + r < n_rows) {
      Chunk<T>::load(src + (row0 + r) * stride + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < kCh; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kCh; e += 4) {
      *reinterpret_cast<float4*>(dst + r * D + col + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  }
}

// n consecutive f32 values of shared memory (n = 2 or a multiple of 4).
template <int N>
__device__ __forceinline__ void load_shared(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else {
    static_assert(N == 2, "columns per thread must be 2 or a multiple of 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// The 16 lanes of a half-warp hold one q row: xor offsets below 16 stay
// inside it.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr size_t shared_bytes(int d) {
  // Q^T [d][kLd], K^T (later P^T [kTile][kLd]) [max(d, kTile)][kLd], V [kTile][d]
  return (static_cast<size_t>(d) * kLd
          + static_cast<size_t>(d > kTile ? d : kTile) * kLd
          + static_cast<size_t>(kTile) * d) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_simt(const Args a) {
  constexpr int kCols = D / 16;    // output columns per thread
  extern __shared__ float4 shared4[];
  float* qt = reinterpret_cast<float*>(shared4);            // Q^T
  float* kt = qt + D * kLd;                                 // K^T, then P^T
  float* vs = kt + (D > kTile ? D : kTile) * kLd;           // V

  const int n_qtiles = (a.Sq + kTile - 1) / kTile;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.x)) * kTile;  // long rows first
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int kh = h / a.G;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.k_sb + kh * a.k_sh;

  const int rg = threadIdx.x >> 4;   // row group: q rows rg * 8 ...
  const int cg = threadIdx.x & 15;   // column group: keys cg * 4 ..., columns cg * kCols ...

  load_transposed<T, D>(qb, a.q_ss, q0, a.Sq, qt);

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + kTile, a.Sq) - 1;
  int k_begin = 0, k_end = a.Sk;
  if (a.window == 0 || q_last < a.Sk) {   // every row has a valid key
    if (a.causal) k_end = min(a.Sk, q_last + 1);
    if (a.window) k_begin = max(0, q0 - a.window + 1) / kTile * kTile;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the last tile's P^T and V are consumed
    load_transposed<T, D>(kb, a.k_ss, k0, a.Sk, kt);
    load_rows<T, D>(vb, a.k_ss, k0, a.Sk, vs);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
      load_shared<kRows>(qt + d * kLd + rg * kRows, qv);
      load_shared<kKeys>(kt + d * kLd + cg * kKeys, kv);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + rg * kRows + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kp = k0 + cg * kKeys + j;
        bool ok = true;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window) ok = ok && kp > qp - a.window;
        const float x = ok ? s[i][j] * a.scale : kMasked;
        s[i][j] = kp < a.Sk ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();   // every thread is done with K^T: P^T takes its place
    float* pt = kt;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int i = 0; i < kRows; i += 4) {
        *reinterpret_cast<float4*>(pt + (cg * kKeys + j) * kLd + rg * kRows + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[kRows], vv[kCols];
      load_shared<kRows>(pt + kk * kLd + rg * kRows, pv);
      load_shared<kCols>(vs + kk * D + cg * kCols, vv);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + cg * kCols;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg * kRows + i;
    if (qp >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float out[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = acc[i][c] / denom;
    T* orow = ob + qp * a.o_ss;
    if constexpr (kCols % Chunk<T>::n == 0) {
#pragma unroll
      for (int c = 0; c < kCols; c += Chunk<T>::n) Chunk<T>::store(orow + c, out + c);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if constexpr (sizeof(T) == 4) {
          orow[c] = out[c];
        } else {
          orow[c] = __float2bfloat16_rn(out[c]);
        }
      }
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = shared_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kTile - 1) / kTile, B * a.H);
  flash_fwd_simt<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16 at head dims 64 and 128.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 128;     // and one producer warpgroup
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kBM = 128;       // q rows of a block, 64 per consumer warpgroup
constexpr int kBN = 128;       // keys of a k tile
constexpr int kStages = 2;     // depth of the K / V ring
constexpr int kBoxCols = 64;   // bf16 columns of one 128-byte swizzled row
constexpr int kBoxBytes = kBN * 128;   // one TMA box: 128 rows x 128 bytes
static_assert(kBM == kBN, "one box shape serves the Q and the K / V tiles");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: Q, then K and V of each
// stage, each a 128-row tile of D / 64 boxes; then the mbarriers.
template <int D>
struct Smem {
  static constexpr int kTile = D / kBoxCols * kBoxBytes;
  static constexpr int kK = kTile;                  // + stage * 2 * kTile
  static constexpr int kV = 2 * kTile;              // + stage * 2 * kTile
  static constexpr int kBars = (1 + 2 * kStages) * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.  Rows outside the
// tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins registers in program order around the asynchronous wgmma: the
// compiler may not move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// What pack_bf16(x0, x1) left out: bf16(x - bf16(x)) of each, given the
// packed pair.  x - bf16(x) is exact in f32.
__device__ __forceinline__ uint32_t pack_bf16_rest(float x0, float x1,
                                                   uint32_t packed) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

#define REPRO_ACC8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (+)= Q·Kᵀ, both from shared memory (K-major): m64n128k16, bf16 -> f32.
// accumulate = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16),
        REPRO_ACC8(d, 24), REPRO_ACC8(d, 32), REPRO_ACC8(d, 40),
        REPRO_ACC8(d, 48), REPRO_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P·V, P as bf16 pairs in registers, V from shared memory with the
// key axis strided (MN-major, the transpose bit): m64n128k16.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16),
        REPRO_ACC8(d, 24), REPRO_ACC8(d, 32), REPRO_ACC8(d, 40),
        REPRO_ACC8(d, 48), REPRO_ACC8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The same at d = 64: m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16),
        REPRO_ACC8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef REPRO_ACC8

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<D>;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;                  // full[s] at + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;        // empty[s] at + 8 s

  const int n_qtiles = (a.Sq + kBM - 1) / kBM;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.y)) * kBM;  // long rows first
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int kh = h / a.G;

  // The k tiles to visit: the SIMT instance's rule, for this 128-row tile.
  const int q_last = min(q0 + kBM, a.Sq) - 1;
  int k_begin = 0, k_end = a.Sk;
  if (a.window == 0 || q_last < a.Sk) {   // every row has a valid key
    if (a.causal) k_end = min(a.Sk, q_last + 1);
    if (a.window) k_begin = max(0, q0 - a.window + 1) / kBN * kBN;
  }
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    // Producer: one thread issues every TMA load.  Stage s of k tile t is
    // refilled once all consumer threads have released tile t - kStages.
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load(base + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t kv = base + s * 2 * L::kTile;
        const int k0 = k_begin + t * kBN;
        mbar_expect_tx(full, 2 * L::kTile);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(kv + L::kK + c * kBoxBytes, &tk, full, c * kBoxCols, kh, k0, b);
          tma_load(kv + L::kV + c * kBoxBytes, &tv, full, c * kBoxCols, kh, k0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
  // Consumers.  Warpgroup wg owns q rows wq0 ... wq0 + 63; in the m64nN
  // fragments a thread holds rows `row` and `row + 8` (register e of
  // column block i: row + 8 (e / 2), column 8 i + col + e % 2).
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int col = 2 * (lane & 3);
  const int wq0 = q0 + wg * 64;
  const float log2_scale = a.scale * kLog2e;   // scores in the log2 domain
  const uint32_t q_addr = base + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.0f, 0.0f};                // this thread's columns only

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = k_begin + t * kBN;
    const uint32_t k_addr = base + L::kK + s * 2 * L::kTile;
    const uint32_t v_addr = base + L::kV + s * 2 * L::kTile;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);

    // S = Q·Kᵀ: D / 16 k-steps of 16 columns, 32 bytes along a swizzled row.
    float sc[kBN / 2];
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * kBoxBytes + kk % 4 * 32;
      wgmma_ss_n128(sc, sw128_desc(q_addr + off, 16, 1024),
                    sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    reg_fence(sc);

    // Scale; mask only where the tile crosses the diagonal, the window's
    // edge or the end of the keys.
    const bool edge = (a.causal && k0 + kBN - 1 > wq0)
                      || (a.window && k0 <= wq0 + 63 - a.window)
                      || k0 + kBN > a.Sk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = wq0 + row + (e / 2) * 8;
          const int kp = k0 + 8 * i + col + (e & 1);
          bool ok = true;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window) ok = ok && kp > qp - a.window;
          const float x = ok ? sc[4 * i + e] * log2_scale : kMasked;
          sc[4 * i + e] = kp < a.Sk ? x : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] *= log2_scale;
    }

    // Online softmax on the fragments: a row's four threads are one quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * i + 2 * r + e] - mx);
          sc[4 * i + 2 * r + e] = p;
          sum += p;
        }
      }
      l[r] = alpha * l[r] + sum;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i + 2 * r] *= alpha;
        o[4 * i + 2 * r + 1] *= alpha;
      }
    }

    // O += P·V as hi·V + lo·V.  Each part in bf16: the S fragment's
    // consecutive pairs are the A fragment of the product, 4 registers per
    // 16 keys; 16 keys per k-step, two 8-row groups of the V tile (1024 B
    // apart); the second 64 columns lie one box further on.  Both parts are
    // packed before the first product, so the f32 scores are dead while
    // the products run: the two packings hold as many registers as S did.
    // hi and lo of one k-step share its V descriptor, issued back to back,
    // so no descriptor outlives its k-step.
    uint32_t hi[kBN / 4], lo[kBN / 4];
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j) {
      hi[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
      lo[j] = pack_bf16_rest(sc[2 * j], sc[2 * j + 1], hi[j]);
    }
    reg_fence(o);
    reg_fence(hi);
    reg_fence(lo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const uint64_t dv = sw128_desc(v_addr + j * 16 * 128, kBoxBytes, 1024);
      if constexpr (D == 128) {
        wgmma_rs_n128(o, hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3], dv);
        wgmma_rs_n128(o, lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3], dv);
      } else {
        wgmma_rs_n64(o, hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3], dv);
        wgmma_rs_n64(o, lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3], dv);
      }
    }
    wgmma_commit();
    wgmma_wait();
    reg_fence(o);
    reg_fence(hi);
    reg_fence(lo);
    mbar_arrive(empty0 + 8 * s);             // this thread is done with stage s
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh + col;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = wq0 + row + 8 * r;
    if (qp >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + qp * a.o_ss;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] / denom, o[4 * i + 2 * r + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The model's (B, S, heads, d) bf16 layout as a 4-d map, innermost first
// (d, heads, S, B) with its strides; one box is 64 columns x 1 head x 128
// rows, one 128-byte swizzled row per row.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int heads, int S, int B, int64_t s_h, int64_t s_s,
              int64_t s_b) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  const int K = a.H / a.G;
  if (!make_map(encode, &tq, a.q, D, a.H, a.Sq, B, a.q_sh, a.q_ss, a.q_sb)
      || !make_map(encode, &tk, a.k, D, K, a.Sk, B, a.k_sh, a.k_ss, a.k_sb)
      || !make_map(encode, &tv, a.v, D, K, a.Sk, B, a.k_sh, a.k_ss, a.k_sb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Smem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.Sq + kBM - 1) / kBM);
  flash_fwd_wgmma<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype 0 = f32, 1 = bf16.  Strides are in elements; v has k's strides.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int H, int K, int Sq, int Sk, int d,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          float scale, int causal, int window, void* stream) {
  const Args a{q, k, v, o, H, H / K, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, o_sb, o_ss, o_sh,
               scale, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, d, s);
  if (dtype == 1 && d == 128) return tc::launch<128>(a, B, s);
  if (dtype == 1 && d == 64) return tc::launch<64>(a, B, s);
  if (dtype == 1 && d == 32) return launch<__nv_bfloat16, 32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
