// K9: blocked causal (or full) attention with online softmax, f32 arithmetic.
//
// Replaces the reference package's TPU kernel `flash_attention` /
// `_kernel` (src/repro/kernels/flashattn.py), and on the serving path the
// XLA scan `models/layers.flash_attention` that the reference's
// `causal_attention` takes for prompts longer than `flash_block`.
//
//   out[b, i, h, :] = Σ_j softmax_j(scale · q[b,i,h,:] · k[b,j,h,:]) v[b,j,h,:]
//   over j <= i when causal (top-left aligned, as the reference's positions).
//
// Arithmetic, as the reference's: q, k, v widened to f32 as they are loaded;
// q scaled before the product; masked scores set to NEG_INF = -1e30; per KV
// tile m_new = max(m, rowmax s), p = exp(s - m_new) zeroed where masked (after
// the exp), l = l·exp(m - m_new) + Σ p, acc = acc·exp(m - m_new) + p·v; the
// output is acc / max(l, 1e-20), rounded once to the output's type.  P stays
// f32 (no bf16 rounding of P, no tensor cores): every product is a plain f32
// FMA.
//
// Layout: q, k, v and out are (B, S, H, D) read by their batch, sequence and
// head strides (unit stride along D); no transposed copy is made.  D = 64 and
// D = 128 are template instances.
//
// Tiles: one thread block of 256 threads per (batch·head, 64-row query tile).
// A loop inside the block walks 64-row KV tiles and, when causal, stops at the
// tile holding the diagonal: the TPU grid's sequential KV axis becomes that
// loop, and the causal skip its bound.  Query tiles are issued heaviest
// first.  Q (scaled, transposed), K (transposed), V and P are f32 tiles in
// dynamic shared memory (113 KB at D = 128, which admits two blocks per SM);
// each thread holds a 4 x 4 block of S and a 4 x D/16 block of the
// accumulator, with its rows' running max and sum, in registers.  Row
// reductions are shuffles across the 16 threads that share a row.  Ragged
// Sq and Skv are handled by bounds checks (zeros loaded, scores masked,
// rows past Sq not stored).
//
// What bounds it: at the serving path's shape (1, 4096, 32, 128) causal, the
// work is 4·D·H·S(S+1)/2 = 137.5 GFLOP, half in S = QKᵀ and half in P·V.
// S is a product of bf16 inputs, which the bf16 tensor cores (989 TFLOP/s)
// compute exactly with f32 accumulation; P·V multiplies the f32 P, which the
// reference keeps in f32, so it needs the f32 rate outside the tensor cores
// (67 TFLOP/s).  That bound is 0.07 + 1.03 = 1.10 ms; all in f32 it is
// 2.05 ms, all on the tensor cores 0.139 ms, and the bytes of q, k, v and
// out in bf16 take 0.040 ms.  This design does both products as f32 FMAs,
// so its own floor is the 2.05 ms: it keeps every operand of the inner
// loops in shared memory or registers (16-byte shared loads feeding 16 or
// 32 FMAs) so that the loop is limited by FMA issue, not by loads.  S on
// the tensor cores (wgmma) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // KV rows per tile
constexpr int THREADS = 256;        // 16 x 16: ty owns rows, tx owns columns
constexpr int PS = BK + 4;          // P row stride, padded against conflicts
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {                    // element strides of (B, S, H); D is unit
  long long b, s, h;
};

template <int D>
constexpr int smem_floats() {
  return D * BQ + D * BK + BK * D + BQ * PS;
}

// rows [0, R) of a (R, D) tile starting at sequence row `row0`, written to
// shared memory transposed (dst[d * R + r]), times `mul`; zeros past `rows`
template <typename T, int D, int R>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long stride_s, int row0,
                                                int rows, float mul) {
  for (int e = threadIdx.x; e < R * (D / 4); e += THREADS) {
    const int r = e % R, c = (e / R) * 4;
    const int row = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows) {
      const T* p = src + row * stride_s + c;
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = widen(p[u]) * mul;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(c + u) * R + r] = x[u];
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
          int Skv, Strides sq, Strides sk, Strides sv, Strides so,
          float scale) {
  constexpr int NC = D / 64;        // 64-column groups of the accumulator
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [D][BQ], scaled
  float* kT = qT + D * BQ;                       // [D][BK]
  float* vs = kT + D * BK;                       // [BK][D]
  float* ps = vs + BK * D;                       // [BQ][PS]

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - blockIdx.x) * BQ;     // heaviest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_transposed<T, D, BQ>(qT, qb, sq.s, q0, Sq, scale);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (Skv + BK - 1) / BK;
  if (CAUSAL) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * BK;
    load_transposed<T, D, BK>(kT, kb, sk.s, kv0, Skv, 1.f);
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int t = e / D, d = e % D;
      vs[e] = kv0 + t < Skv ? widen(vb[(kv0 + t) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // S = (scale · Q) Kᵀ for rows ty*4+i, columns tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * BQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax over this tile, per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx * 4 + j;
        ok[j] = col < Skv && (!CAUSAL || row >= col);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * PS + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // acc += P V for rows ty*4+i, columns g*64 + tx*4 + j
#pragma unroll 2
    for (int t = 0; t < BK; t += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * PS + t);
        pr[i][0] = x.x; pr[i][1] = x.y; pr[i][2] = x.z; pr[i][3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 y = *reinterpret_cast<const float4*>(
              vs + (t + u) * D + g * 64 + tx * 4);
          const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][g * 4 + j] = fmaf(pr[i][u], yv[j], acc[i][g * 4 + j]);
        }
      }
    }
    __syncthreads();
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ob[row * so.s + g * 64 + tx * 4 + j] =
            narrow<T>(acc[i][g * 4 + j] / den);
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const T* q, const T* k, const T* v, T* out, int B, int H, int Sq,
           int Skv, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, cudaStream_t stream) {
  auto kernel = flash_fwd<T, D, CAUSAL>;
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, bytes, stream>>>(q, k, v, out, H, Sq, Skv, sq, sk,
                                           sv, so, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Sq, int Skv, int D, const long long* st, float scale,
             int causal, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  auto s = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const T*>(q), K = static_cast<const T*>(k),
       V = static_cast<const T*>(v);
  auto O = static_cast<T*>(out);
  if (D == 64 && causal)
    return launch<T, 64, true>(Q, K, V, O, B, H, Sq, Skv, sq, sk, sv, so,
                               scale, s);
  if (D == 64)
    return launch<T, 64, false>(Q, K, V, O, B, H, Sq, Skv, sq, sk, sv, so,
                                scale, s);
  if (D == 128 && causal)
    return launch<T, 128, true>(Q, K, V, O, B, H, Sq, Skv, sq, sk, sv, so,
                                scale, s);
  if (D == 128)
    return launch<T, 128, false>(Q, K, V, O, B, H, Sq, Skv, sq, sk, sv, so,
                                 scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: (B, S, H, D) with unit stride along D; `strides` holds the
// (batch, sequence, head) element strides of q, k, v and out, in that order.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int flashattn_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int H, int Sq, int Skv, int D,
                             const long long* strides, float scale,
                             int causal, void* stream) {
  return dispatch<float>(q, k, v, out, B, H, Sq, Skv, D, strides, scale,
                         causal, stream);
}

extern "C" int flashattn_bf16(const void* q, const void* k, const void* v,
                              void* out, int B, int H, int Sq, int Skv, int D,
                              const long long* strides, float scale,
                              int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Sq, Skv, D, strides,
                                 scale, causal, stream);
}
