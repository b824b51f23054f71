// K9-bwd: the gradient of K9 (flashattn.cu) with respect to q, k and v.
//
// The reference package has no backward for its TPU kernel
// `flash_attention` (src/repro/kernels/flashattn.py has no custom_vjp): its
// training path differentiates the XLA scan `models/layers.flash_attention`
// with `jax.value_and_grad`.  This kernel computes that gradient for the
// function K9 computes, from K9's output O and its row statistic
// lse = m + log(l) (written by the forward when training asks for it):
//
//   S = scale · Q Kᵀ under the mask;  P = exp(S - lse) (0 where masked)
//   Dᵢ = Σ_d dOᵢ · Oᵢ;  dV = Pᵀ dO;  dP = dO Vᵀ;  dS = P ⊙ (dP - Dᵢ)
//   dQ = scale · dS K;  dK = scale · dSᵀ Q
//
// Causal masking is top-left aligned (query i sees keys j <= i); Sq == Skv.
// q, k, v, o, dO and the three outputs are (B, S, H, D), read and written by
// their (batch, sequence, head) strides with unit stride along D; lse and
// the scratch D are contiguous f32 (B, H, S).  D = 64 and 128 are template
// instances; f32 and bf16 inputs (bf16 is widened on load, and each output
// is rounded once, at the store).
//
// Three launches per call, no atomics, so every run gives the same bits:
//   1. `delta`: Dᵢ, one warp per row.
//   2. `dkdv`: one block per (batch·head, 64 KV rows).  K and V stay in
//      shared memory; a loop walks the 64-row Q tiles that see them (from
//      the diagonal on, when causal), recomputes Sᵀ and P from lse, and
//      accumulates dV += Pᵀ dO and dK += dSᵀ (scale · Q) in registers.
//   3. `dq`: one block per (batch·head, 64 Q rows).  Q and dO stay in
//      shared memory; a loop walks the KV tiles they see, recomputes S, P
//      and dP, and accumulates dQ += dS K; dQ is scaled once at the end.
// Every product is an f32 FMA loop on the CUDA cores, register-blocked: 256
// threads as 16 x 16, each owning a 4 x 4 block of a 64 x 64 score tile
// (rows ty + 16 b, columns tx + 16 a: a quarter-warp's 16-byte loads of
// rows padded to D + 4 floats land on distinct banks) and 4 rows x D/16
// columns of its accumulators.
//
// What bounds it: the function is five products of D·H·S(S+1) operations
// each (causal), 343.7 GFLOP at qwen3-4b's (1, 4096, 32, 128): 0.35 ms on
// the bf16 tensor cores, 5.1 ms at the 67 TFLOP/s of f32 FMAs outside
// them.  This design runs seven products (S and dP in both kernels) at the
// FMA rate, from shared memory, with one block of 8 warps per SM at D = 128
// (170 KB of shared memory): it is bound by its operations on the CUDA
// cores and by shared-memory bandwidth.  `wgmma` with TMA staging, as K9's
// forward has, is the redesign that would reach the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;              // resident rows per block
constexpr int BT = 64;              // streamed rows per tile
constexpr int THREADS = 256;        // 16 x 16
constexpr int LW = BT + 4;          // row stride of a score tile, floats

template <int D>
struct Tile {
  static constexpr int LD = D + 4;  // row stride of a (rows, D) tile, floats
  static constexpr int FLOATS = BR * LD;
};

struct Strides {                    // element strides of (B, S, H); D is unit
  long long b, s, h;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of a (S, D) slice, widened and times `mul`, into a
// shared tile of row stride D + 4; zeros past row `rows`
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride_s, int row0,
                                          int rows, float mul) {
  for (int e = threadIdx.x; e < BR * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * Tile<D>::LD + d] =
        row < rows ? widen(src[row * stride_s + d]) * mul : 0.f;
  }
}

// acc[b][a] = Σ_d X[ty + 16 b][d] · Y[tx + 16 a][d], X and Y shared tiles
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* X,
                                         const float* Y, int tx, int ty) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[b][a] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[b] = *reinterpret_cast<const float4*>(X + (ty + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      y[a] = *reinterpret_cast<const float4*>(Y + (tx + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[b][a] = fmaf(x[b].x, y[a].x, acc[b][a]);
        acc[b][a] = fmaf(x[b].y, y[a].y, acc[b][a]);
        acc[b][a] = fmaf(x[b].z, y[a].z, acc[b][a]);
        acc[b][a] = fmaf(x[b].w, y[a].w, acc[b][a]);
      }
  }
}

// out[b][4 g + c] += Σ_t W[ty + 16 b][t] · Z[t][64 g + 4 tx + c]: W a score
// tile (row stride LW), Z a shared (rows, D) tile
template <int D>
__device__ __forceinline__ void acc_tile(float (&out)[4][D / 16],
                                         const float* W, const float* Z,
                                         int tx, int ty) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll 2
  for (int t = 0; t < BT; t += 4) {
    float w[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 x =
          *reinterpret_cast<const float4*>(W + (ty + 16 * b) * LW + t);
      w[b][0] = x.x; w[b][1] = x.y; w[b][2] = x.z; w[b][3] = x.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 z = *reinterpret_cast<const float4*>(
            Z + (t + u) * LD + 64 * g + 4 * tx);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          out[b][4 * g + 0] = fmaf(w[b][u], z.x, out[b][4 * g + 0]);
          out[b][4 * g + 1] = fmaf(w[b][u], z.y, out[b][4 * g + 1]);
          out[b][4 * g + 2] = fmaf(w[b][u], z.z, out[b][4 * g + 2]);
          out[b][4 * g + 3] = fmaf(w[b][u], z.w, out[b][4 * g + 3]);
        }
      }
  }
}

// the thread's 4 rows x D/16 columns of a (rows, D) output, rounded once
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, Strides st,
                                           const float (&acc)[4][D / 16],
                                           int row0, int rows, float mul,
                                           int tx, int ty) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int row = row0 + ty + 16 * b;
    if (row >= rows) continue;
    T* p = dst + row * st.s;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[64 * g + 4 * tx + c] = narrow<T>(acc[b][4 * g + c] * mul);
  }
}

// Dᵢ = Σ_d dOᵢ · Oᵢ, one warp per (b, i, h) row, into (B, H, S)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int H, int S, Strides so,
             Strides sd) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * S * H) return;
  const int lane = threadIdx.x % 32;
  const int h = static_cast<int>(row % H);
  const int i = static_cast<int>(row / H % S);
  const int b = static_cast<int>(row / H / S);
  const T* orow = o + b * so.b + i * so.s + h * so.h;
  const T* drow = dout + b * sd.b + i * sd.s + h * sd.h;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    sum = fmaf(widen(drow[d]), widen(orow[d]), sum);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * S + i] = sum;
}

struct Args {                       // q, k, v, o, dO, dq, dk, dv strides
  Strides q, k, v, o, d, dq, dk, dv;
  explicit Args(const long long* st)
      : q{st[0], st[1], st[2]}, k{st[3], st[4], st[5]},
        v{st[6], st[7], st[8]}, o{st[9], st[10], st[11]},
        d{st[12], st[13], st[14]}, dq{st[15], st[16], st[17]},
        dk{st[18], st[19], st[20]}, dv{st[21], st[22], st[23]} {}
};

// dK and dV for 64 KV rows of one (batch, head); the KV tile with the
// most Q tiles after it first
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int S, Args a,
            float scale) {
  constexpr int F = Tile<D>::FLOATS;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // resident K rows
  float* vs = ks + F;                            // resident V rows
  float* qs = vs + F;                            // scale · Q, streamed
  float* ds = qs + F;                            // dO, streamed
  float* pw = ds + F;                            // Pᵀ [kv row][q row]
  float* sw = pw + BR * LW;                      // dSᵀ
  float* ls = sw + BR * LW;                      // lse of the Q tile
  float* dl = ls + BT;                           // D of the Q tile

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kv0 = blockIdx.y * BR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* lrow = lse + static_cast<long long>(blockIdx.x) * S;
  const float* drow = delta + static_cast<long long>(blockIdx.x) * S;
  const T* qb = q + b * a.q.b + h * a.q.h;
  const T* db = dout + b * a.d.b + h * a.d.h;

  load_rows<T, D>(ks, k + b * a.k.b + h * a.k.h, a.k.s, kv0, S, 1.f);
  load_rows<T, D>(vs, v + b * a.v.b + h * a.v.h, a.v.s, kv0, S, 1.f);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int nq = (S + BT - 1) / BT;
  for (int qt = CAUSAL ? kv0 / BT : 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    load_rows<T, D>(qs, qb, a.q.s, q0, S, scale);
    load_rows<T, D>(ds, db, a.d.s, q0, S, 1.f);
    if (threadIdx.x < BT) {
      const int i = q0 + threadIdx.x;
      ls[threadIdx.x] = i < S ? lrow[i] : 0.f;
      dl[threadIdx.x] = i < S ? drow[i] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, ks, qs, tx, ty);              // Sᵀ[j][i]
    dot_tile<D>(dp, vs, ds, tx, ty);             // dPᵀ[j][i]
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int j = kv0 + ty + 16 * bb;
#pragma unroll
      for (int aa = 0; aa < 4; ++aa) {
        const int it = tx + 16 * aa, i = q0 + it;
        const bool seen = i < S && j < S && (!CAUSAL || i >= j);
        const float p = seen ? expf(s[bb][aa] - ls[it]) : 0.f;
        pw[(ty + 16 * bb) * LW + it] = p;
        sw[(ty + 16 * bb) * LW + it] = p * (dp[bb][aa] - dl[it]);
      }
    }
    __syncthreads();
    acc_tile<D>(dva, pw, ds, tx, ty);            // dV += Pᵀ dO
    acc_tile<D>(dka, sw, qs, tx, ty);            // dK += dSᵀ (scale · Q)
    __syncthreads();
  }
  store_rows<T, D>(dk + b * a.dk.b + h * a.dk.h, a.dk, dka, kv0, S, 1.f, tx,
                   ty);
  store_rows<T, D>(dv + b * a.dv.b + h * a.dv.h, a.dv, dva, kv0, S, 1.f, tx,
                   ty);
}

// dQ for 64 Q rows of one (batch, head); the heaviest Q tiles first
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int S, Args a, float scale) {
  constexpr int F = Tile<D>::FLOATS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // resident scale · Q
  float* ds = qs + F;                            // resident dO
  float* ks = ds + F;                            // K, streamed
  float* vs = ks + F;                            // V, streamed
  float* sw = vs + F;                            // dS [q row][kv row]
  float* ls = sw + BR * LW;                      // lse of the Q rows
  float* dl = ls + BR;                           // D of the Q rows

  const int nq = (S + BR - 1) / BR;
  const int q0 = (nq - 1 - blockIdx.y) * BR;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * a.k.b + h * a.k.h;
  const T* vb = v + b * a.v.b + h * a.v.h;

  load_rows<T, D>(qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, S, scale);
  load_rows<T, D>(ds, dout + b * a.d.b + h * a.d.h, a.d.s, q0, S, 1.f);
  if (threadIdx.x < BR) {
    const int i = q0 + threadIdx.x;
    const long long at = static_cast<long long>(blockIdx.x) * S + i;
    ls[threadIdx.x] = i < S ? lse[at] : 0.f;
    dl[threadIdx.x] = i < S ? delta[at] : 0.f;
  }

  float dqa[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[r][c] = 0.f;

  int n_kv = (S + BT - 1) / BT;
  if (CAUSAL) n_kv = min(n_kv, (q0 + BR - 1) / BT + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * BT;
    load_rows<T, D>(ks, kb, a.k.s, kv0, S, 1.f);
    load_rows<T, D>(vs, vb, a.v.s, kv0, S, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks, tx, ty);              // S[i][j]
    dot_tile<D>(dp, ds, vs, tx, ty);             // dP[i][j]
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int it = ty + 16 * bb, i = q0 + it;
#pragma unroll
      for (int aa = 0; aa < 4; ++aa) {
        const int j = kv0 + tx + 16 * aa;
        const bool seen = i < S && j < S && (!CAUSAL || i >= j);
        const float p = seen ? expf(s[bb][aa] - ls[it]) : 0.f;
        sw[it * LW + tx + 16 * aa] = p * (dp[bb][aa] - dl[it]);
      }
    }
    __syncthreads();
    acc_tile<D>(dqa, sw, ks, tx, ty);            // dQ += dS K
    __syncthreads();
  }
  store_rows<T, D>(dq + b * a.dq.b + h * a.dq.h, a.dq, dqa, q0, S, scale,
                   tx, ty);
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int S, const Args& a,
           float scale, cudaStream_t stream) {
  constexpr int F = Tile<D>::FLOATS;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), THREADS, 0,
                       stream>>>(static_cast<const T*>(o),
                                 static_cast<const T*>(dout), delta, B, H, S,
                                 a.o, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(B * H, (S + BR - 1) / BR);
  auto kv_kernel = dkdv_kernel<T, D, CAUSAL>;
  const int kv_bytes = (4 * F + 2 * BR * LW + 2 * BT) * sizeof(float);
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<grid, THREADS, kv_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, a, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kernel = dq_kernel<T, D, CAUSAL>;
  const int q_bytes = (4 * F + BR * LW + 2 * BR) * sizeof(float);
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, THREADS, q_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, S, a, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int H, int S, int D,
             const long long* strides, float scale, int causal,
             void* stream) {
  const Args a(strides);
  auto s = static_cast<cudaStream_t>(stream);
  auto L = static_cast<const float*>(lse);
  auto Dl = static_cast<float*>(delta);
  if (D == 64 && causal)
    return launch<T, 64, true>(q, k, v, o, dout, L, Dl, dq, dk, dv, B, H, S,
                               a, scale, s);
  if (D == 64)
    return launch<T, 64, false>(q, k, v, o, dout, L, Dl, dq, dk, dv, B, H, S,
                                a, scale, s);
  if (D == 128 && causal)
    return launch<T, 128, true>(q, k, v, o, dout, L, Dl, dq, dk, dv, B, H,
                                S, a, scale, s);
  if (D == 128)
    return launch<T, 128, false>(q, k, v, o, dout, L, Dl, dq, dk, dv, B, H,
                                 S, a, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o (K9's output), dout, dq, dk, dv: (B, S, H, D) with unit stride
// along D; `strides` holds the (batch, sequence, head) element strides of
// q, k, v, o, dout, dq, dk and dv, in that order.  lse: K9's row statistic,
// contiguous f32 (B, H, S); delta: f32 (B, H, S) scratch.  Three launches
// on `stream`; returns cudaGetLastError() after the last (0 when every one
// was accepted).
extern "C" int flashattn_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int S,
                                 int D, const long long* strides,
                                 float scale, int causal, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, S,
                         D, strides, scale, causal, stream);
}

// As flashattn_bwd_f32, on bf16 tensors (the gradients rounded once to
// bf16; lse and delta stay f32).
extern "C" int flashattn_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv,
                                  int B, int H, int S, int D,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 B, H, S, D, strides, scale, causal, stream);
}
