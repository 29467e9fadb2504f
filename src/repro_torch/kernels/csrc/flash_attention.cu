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
// type (f32 or bf16) and the arithmetic in f32.  The normaliser is clamped
// at 1e-30 before the final division, as in the reference.
//
// Layout.  The kernel reads q, k, v and writes o in the model's (B, S, H, d)
// layout through the strides it is given (d contiguous); kv head h / G is
// index arithmetic.  Nothing is transposed or repeated in device memory, as
// the reference's transpose + jnp.repeat (flash_attention.py:77-79) would.
//
// Threads.  One block of 128 threads owns one (b, h, 64-row q tile).  The
// TPU's sequential k grid axis becomes a loop inside the block over 64-key
// tiles; the running max m, normaliser l and accumulator stay in registers.
// The threads form 8 row groups x 16 column groups: each owns 8 q rows,
// 4 keys of a tile and d / 16 output columns, so a q row lives in the 16
// lanes of one half-warp and its max and sum are reduced with shuffles in
// a fixed order.  Per k tile: K^T and V go to shared memory as f32, each
// thread computes its 8 x 4 scores from Q^T and K^T, the online-softmax
// update runs in registers, P^T is written where K^T was, and each thread
// accumulates its 8 x d/16 outputs from P^T and V.  Transposed tiles keep
// a thread's 8 rows (or 4 keys) contiguous, so the inner loops read
// shared memory as float4.
//
// Bound: operations.  At the OLMo-1B prefill layer (B 4, S 2048, H 16,
// d 128, causal) a call does 6.9e10 multiply-adds' worth of FLOPs against
// 134 MB of bf16 traffic.  This first kernel runs them as f32 FMAs on the
// CUDA cores (67 TFLOP/s peak), not on the bf16 tensor cores (989 TFLOP/s),
// so it can reach at best about 7 % of the card's bound for the same work;
// wgmma tiles are the redesign this kernel leaves open.  expf, not __expf,
// and no --use_fast_math: a simple kernel that is right first.
//
// Skipped tiles.  A k tile wholly above the causal diagonal gives p = 0
// and alpha = 1 for every row of the q tile, so the loop stops before it.
// A k tile wholly outside the window, before the first valid key, is
// wiped by alpha = 0 once a valid key arrives, so the loop starts after
// it.  Both hold when every row of the q tile has a valid key (always so
// for causal without a window; with a window, when the tile's rows lie
// inside the key range); otherwise every tile is visited, as the
// reference does.  Keys past Sk (the ragged last tile) score -inf and so
// weigh nothing at all, unlike a masked key's -1e30.
//
// Determinism: no atomics, fixed reduction order; a call repeats bit for
// bit.  Offsets are 64-bit.
//
// C interface for ctypes: pointers and the stream are void*; the entry
// point returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a head dim or type it has no instance for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // q rows of a block; keys of a k tile
constexpr int kRows = 8;           // q rows per thread (kTile / 8 row groups)
constexpr int kKeys = 4;           // keys per thread (kTile / 16 column groups)
constexpr int kLd = kTile + 4;     // row length of a transposed tile (16-byte rows)
constexpr float kMasked = -1e30f;  // the reference's mask value

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(const Args a) {
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
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kTile - 1) / kTile, B * a.H);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(a);
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
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
