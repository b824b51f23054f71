// K9: blocked causal (or full) attention with online softmax.
//
// Replaces the reference package's TPU kernel `flash_attention` /
// `_kernel` (src/repro/kernels/flashattn.py), and on the serving path the
// XLA scan `models/layers.flash_attention` that the reference's
// `causal_attention` takes for prompts longer than `flash_block`.
//
//   out[b, i, h, :] = Σ_j softmax_j(scale · q[b,i,h,:] · k[b,j,h,:]) v[b,j,h,:]
//   over j <= i when causal (top-left aligned, as the reference's positions).
//
// Arithmetic, as the reference's: q, k, v widened to f32; scores scaled;
// masked scores set to NEG_INF = -1e30; per KV tile m_new = max(m, rowmax s),
// p = exp(s - m_new) zeroed where masked (after the exp),
// l = l·exp(m - m_new) + Σ p with the f32 p, acc = acc·exp(m - m_new) + p·v;
// the output is acc / max(l, 1e-20), rounded once to the output's type.
// Where the caller passes a row-statistic buffer (training: the backward
// kernel K9-bwd, flashattn_bwd.cu, recomputes P from it), each row also
// writes lse = m + log(max(l, 1e-20)) in natural-log units of the scaled
// scores, f32, at (B, H, Sq); serving passes null and writes nothing more.
//
// Layout: q and k are (B, S, H, Dq), v and out (B, S, H, Dv), read by their
// batch, sequence and head strides (unit stride along the head dim); no
// transposed copy is made.  The (Dq, Dv) pairs are template instances:
// (64, 64), (128, 128) and (192, 128), the last for deepseek-v3's latent
// attention (models/mla.py: 128 + 64 rope columns in q and k, 128 in v),
// which the reference runs through the same XLA scan, written for Dq != Dv.
// Two designs, one per entry point:
//
// flashattn_bf16 (Hopper: wgmma + TMA).  One CTA of 384 threads per
// (batch·head, 128-row query tile); a loop walks 128-row KV tiles and, when
// causal, stops at the tile holding the diagonal.
// The tile order (tile_order.cuh): the grid is linear, and the (batch,
// head) pairs go in groups of `heads_per_group`, which `launch` picks: the
// largest divisor of B·H whose K and V, S·(Dq + Dv) bf16 values a pair,
// fit 16 MiB, well inside the 50 MB L2.  A group's CTAs run the heaviest
// query tiles first, pair by pair within a tile rank, so the CTAs resident
// at one time (one per SM) hold the query tiles of a few heads, which walk
// the same K and V tiles while L2 holds them.  The grid before, (B·H,
// tiles) with the pairs on x, is one group of every pair: at deepseek-v3's
// 128 heads one wave held one tile of nearly every head, no two resident
// CTAs shared K or V, and a CTA read its K and V up to the diagonal from
// HBM: Σ_t (t + 1) · 128 rows · 640 B · 128 heads = 5.54 GB at (1, 4096,
// 128, 192 / 128), against 0.34 GB read once.  With groups of 4 heads
// (10.5 MB of K and V) the 132 resident CTAs hold a group's 128 tiles, and
// those bytes are read about once (a reckoning: no DRAM counter was read).
// Warpgroup 0 is the producer: after `setmaxnreg` hands its registers to
// the consumers, one thread loads Q once and K, V per tile with TMA
// (`cp.async.bulk.tensor`, a 4-D map over (D, H, S, B) with the operand's
// strides, 64-column boxes with 128-byte swizzle) into stages of shared
// memory, with one `mbarrier` per stage and operand for arrival and one
// per stage for release by both consumers, once their P·V on it has
// landed.  At (128, 128) three stages: Q 32 KB, K and V 3 x 32 KB each,
// 224 KB.  At (192, 128) three would need Q 48 KB + K 3 x 48 KB + V 3 x 32
// KB = 288 KB, over the 227 KB a block may use, so that instance keeps
// two: 208 KB.  There one release for both let the producer load K_{t+1}
// only when P_{t-1}·V_{t-1} had landed, half a tile before S_{t+1} needed
// it; so with two stages a K stage has a release of its own, once both
// consumers' S on it has landed, the producer issues K one tile ahead of
// V, and K_{t+1} is asked for two tiles ahead, V_t one and a half.  The
// order and the early K are each worth a seventh of the time alone, and a
// third together: at (1, 4096, 128, 192 / 128) on an H100 80GB HBM3 at
// 700 W the kernel without either took 2.31 ms, with the order alone
// 1.99, with the early K alone 1.96, with both 1.53 (PERF.md §6).  With three stages, where
// the lead was enough, releasing apart was up to 4 % slower.  Warpgroups 1
// and 2 own 64 query rows each, with their rows' m, l and output
// accumulator in registers:
//   - S = QKᵀ is `wgmma m64n128k16 .f32.bf16.bf16` from shared memory (Q as
//     A, K as a K-major B), Dq / 16 k-steps over Dq / 64 TMA boxes (12 over
//     3 at Dq = 192): exact products of the bf16 inputs, accumulated
//     in f32.  The scale (times log2 e, for exp2) multiplies S in f32 after
//     the product, where the reference scales q before it: they differ by
//     f32 roundings only.
//   - Softmax in registers; row max and sum are shuffles over the 4 threads
//     that share a row in the accumulator layout.  Only tiles that reach
//     the causal diagonal or a ragged Skv carry mask arithmetic; TMA fills
//     rows past the tensor's end with zeros, and their scores are masked
//     all the same.
//   - P·V keeps P to f32 grade on the bf16 tensor cores: P is split in
//     registers into P_hi = bf16(P) and P_lo = bf16(P - P_hi), which sum to
//     P within 2^-17·|P| (round to nearest: half an ulp of the residual),
//     and `wgmma m64nDvk16` with A from registers (the f32 accumulator
//     layout of S is the bf16 A-fragment layout of P: no shared-memory
//     round trip) and V as an N-major B (transpose bit) adds P_hi·V, then
//     P_lo·V, into one f32 accumulator.  Products of bf16 values are exact
//     in f32.  The split's error is far under one bf16 rounding of the
//     output (2^-8), which is what rounding P to bf16 once costs.
//   - Tile t issues S_t, then P_{t-1}·V_{t-1} behind it, waits for S_t
//     only, and runs its softmax while that product is in flight; O is
//     rescaled once the product has landed, which frees its V stage.
//   - The epilogue divides by max(l, 1e-20), rounds once to bf16 and stores
//     rows < Sq through the output strides.
// What bounds it: at the serving path's shape (1, 4096, 32, 128) causal, the
// function is 4·D·H·S(S+1)/2 = 137.5 GFLOP; with P·V in two passes that is
// three bf16 tensor-core passes of 68.7 GFLOP at 989 TFLOP/s: 0.209 ms.
// The 268 M exps take about 0.065 ms on the special-function units, beside
// the tensor cores; the bytes take 0.040 ms.  No FMA loop over D or over
// the KV tile is left: both products are on `wgmma`; the softmax of one
// tile hides behind the P·V of the one before, and the two consumer
// warpgroups interleave as the scheduler finds them ready.  Ordering them
// (ping-pong on named barriers, each issuing in turn) was built and
// measured slower (1.65 against 1.54 ms at (192, 128) on the same card),
// so it is not kept.  Left: on the diagonal tile the lower 64 rows
// compute 64 columns that are all masked for them, and each CTA's first
// loads and last P·V run with nothing beside them.  At deepseek-v3's
// prefill, (1, 4096, 128, 192 / 128): the function is 2·(Dq + Dv)·H·T =
// 687.3 GFLOP (T = S(S+1)/2 pairs a head); the design's one pass for S and
// two for P·V are (2·Dq + 4·Dv)·H·T = 962.3 GFLOP, 0.973 ms at 989 TFLOP/s;
// the exps take 0.257 ms and the bytes (0.67 GB) 0.20 ms.  A 128 x 128
// CTA-tile there does 179 FLOP of its passes per byte of K and V it loads,
// so the tensor cores' peak needs 5.5 TB/s of K and V into the SMs, which
// only L2 can give.  The output accumulator and P·V run at Dv, so a
// consumer holds as many registers as at (128, 128).
//
// flashattn_f32 (f32 q, k, v: the bf16 tensor cores would round them).  One
// block of 256 threads per (batch·head, 64-row query tile), 64-row KV tiles;
// Q (scaled before the product, as the reference), K (both transposed), V
// and P are f32 tiles in Dq·64 + Dq·64 + 64·Dv + 64·68 floats of dynamic
// shared memory (113 KB at (128, 128), so two blocks share an SM; 145 KB at
// (192, 128), so one block is resident per SM); each thread holds a 4 x 4
// block of S and a 4 x Dv/16 block of the accumulator; both products
// are register-blocked f32 FMAs (16-byte shared loads feeding 16 or 32 FMAs)
// at the f32 rate outside the tensor cores, 67 TFLOP/s; row reductions are
// shuffles across the 16 threads of a row.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_order.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {                    // element strides of (B, S, H); D is unit
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32: register-blocked FMAs
// ---------------------------------------------------------------------------
namespace f32k {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // KV rows per tile
constexpr int THREADS = 256;        // 16 x 16: ty owns rows, tx owns columns
constexpr int PS = BK + 4;          // P row stride, padded against conflicts

template <int DQ, int DV>
constexpr int smem_floats() {
  return DQ * BQ + DQ * BK + BK * DV + BQ * PS;
}

// rows [0, R) of a (R, D) tile starting at sequence row `row0`, written to
// shared memory transposed (dst[d * R + r]), times `mul`; zeros past `rows`
template <int D, int R>
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                long long stride_s, int row0,
                                                int rows, float mul) {
  for (int e = threadIdx.x; e < R * (D / 4); e += THREADS) {
    const int r = e % R, c = (e / R) * 4;
    const int row = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows) {
      const float* p = src + row * stride_s + c;
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = p[u] * mul;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(c + u) * R + r] = x[u];
  }
}

// the bound asks for registers enough for two blocks an SM (128 a thread);
// at (192, 128) the shared memory lets only one be resident
template <int DQ, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int H, int Sq,
          int Skv, Strides sq, Strides sk, Strides sv, Strides so,
          float scale, float* __restrict__ lse) {
  constexpr int NC = DV / 64;       // 64-column groups of the accumulator
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [DQ][BQ], scaled
  float* kT = qT + DQ * BQ;                      // [DQ][BK]
  float* vs = kT + DQ * BK;                      // [BK][DV]
  float* ps = vs + BK * DV;                      // [BQ][PS]

  const int nq = (Sq + BQ - 1) / BQ;
  // B * H on grid axis x (up to 2^31 - 1), the query tiles on y
  const int q0 = (nq - 1 - blockIdx.y) * BQ;     // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_transposed<DQ, BQ>(qT, qb, sq.s, q0, Sq, scale);

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
    load_transposed<DQ, BK>(kT, kb, sk.s, kv0, Skv, 1.f);
    for (int e = threadIdx.x; e < BK * DV; e += THREADS) {
      const int t = e / DV, d = e % DV;
      vs[e] = kv0 + t < Skv ? vb[(kv0 + t) * sv.s + d] : 0.f;
    }
    __syncthreads();

    // S = (scale · Q) Kᵀ for rows ty*4+i, columns tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQ; ++d) {
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
              vs + (t + u) * DV + g * 64 + tx * 4);
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

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    if (lse != nullptr && tx == 0)
      lse[static_cast<long long>(blockIdx.x) * Sq + row] = m[i] + logf(den);
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ob[row * so.s + g * 64 + tx * 4 + j] = acc[i][g * 4 + j] / den;
  }
}

template <int DQ, int DV>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int H, int Sq, int Skv, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, bool causal, float* lse,
           cudaStream_t stream) {
  auto kernel =
      causal ? &flash_fwd<DQ, DV, true> : &flash_fwd<DQ, DV, false>;
  const int bytes = smem_floats<DQ, DV>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>(q, k, v, out, H, Sq, Skv, sq, sk,
                                           sv, so, scale, lse);
  return cudaGetLastError();
}

}  // namespace f32k

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
namespace bf16k {

constexpr int BQ = 128;             // query rows per CTA: 2 consumers x 64
constexpr int BK = 128;             // KV rows per tile (wgmma_ss's N)
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;      // threads that release a stage
constexpr int ROW_BYTES = 128;      // one 64-column box row, swizzled
constexpr float LOG2E = 1.4426950408889634f;
constexpr double LN2_F64 = 0.6931471805599453;

template <int DQ, int DV>
struct Smem {                       // byte offsets from a 1024-aligned base
  // K/V tiles in flight: three where they fit, two at (192, 128)
  static constexpr int STAGES = DQ + DV <= 256 ? 3 : 2;
  static constexpr int Q = BQ * DQ * 2;          // one Q tile
  static constexpr int K = BK * DQ * 2;          // one K stage
  static constexpr int V = BK * DV * 2;          // one V stage
  static constexpr int K0 = Q, V0 = Q + STAGES * K;
  static constexpr int BARS = V0 + STAGES * V;   // 1 + 4 · STAGES mbarriers
  static constexpr int BYTES = BARS + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "a block's shared memory on Hopper");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; completion counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; N-major: between 64-column boxes), stride
// byte offset (between groups of 8 rows: 8 x 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(8 * ROW_BYTES >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most `N` committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// the accumulator is read and written by the asynchronous product: keep the
// compiler from moving its uses across the fence / wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// an A fragment stays in its registers until the product reading it has
// landed: the compiler must not reuse them while it is in flight
template <int N>
__device__ __forceinline__ void frag_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define REGS64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = [d +] A B: A (64 x 16) and B (16 x 128, K-major)
// from shared memory; `accumulate` = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A B: A (64 x 16 bf16) from registers in the wgmma
// fragment layout, B (16 x N) from shared memory N-major (transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// hi = bf16(x), lo = bf16(x - hi), for x and y: x - hi is exact in f32, and
// hi + lo is within 2^-17·|x| of x
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

template <int DQ, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          __nv_bfloat16* __restrict__ out, int BH, int H, int Sq, int Skv,
          Strides so, float scale_log2, float* __restrict__ lse,
          int per_group) {
  using L = Smem<DQ, DV>;
  constexpr int STAGES = L::STAGES;
  constexpr int QBOXES = DQ / 64;   // 64-column TMA boxes per row of Q, K
  constexpr int VBOXES = DV / 64;   // and of V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::BARS;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  // with two stages a K stage is released apart from its V (see the
  // header); with three, one release for both once P·V has landed
  constexpr bool APART = STAGES == 2;
  auto k_free = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto v_free = [&](int s) {
    return APART ? q_full + 8 * (1 + 3 * STAGES + s) : k_free(s);
  };

  const int nq = (Sq + BQ - 1) / BQ;
  const tile_order::TileAt at =
      tile_order::tile_at(blockIdx.x, BH, nq, per_group);
  const int q0 = (nq - 1 - at.rank) * BQ;        // heaviest rank first
  const int b = at.bh / H, h = at.bh % H;
  int n_kv = (Skv + BK - 1) / BK;
  if (CAUSAL) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(k_full(s), 1);
      bar_init(v_full(s), 1);
      bar_init(k_free(s), CONSUMERS);
      if (APART) bar_init(v_free(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // producer: one thread issues every copy; with K released apart, K one
    // tile ahead of V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      auto load_k = [&](int kt) {
        const int s = kt % STAGES;
        bar_wait(k_free(s), ((kt / STAGES) & 1) ^ 1);
        bar_expect(k_full(s), L::K);
        for (int c = 0; c < QBOXES; ++c)
          tma_load(base + L::K0 + s * L::K + c * BK * ROW_BYTES, &tk,
                   k_full(s), 64 * c, h, kt * BK, b);
      };
      bar_expect(q_full, L::Q);
      for (int c = 0; c < QBOXES; ++c)
        tma_load(base + c * BQ * ROW_BYTES, &tq, q_full, 64 * c, h, q0, b);
      if (APART) load_k(0);
      for (int kt = 0; kt < n_kv; ++kt) {
        if (!APART)
          load_k(kt);
        else if (kt + 1 < n_kv)
          load_k(kt + 1);
        const int s = kt % STAGES;
        bar_wait(v_free(s), ((kt / STAGES) & 1) ^ 1);
        bar_expect(v_full(s), L::V);
        for (int c = 0; c < VBOXES; ++c)
          tma_load(base + L::V0 + s * L::V + c * BK * ROW_BYTES, &tv,
                   v_full(s), 64 * c, h, kt * BK, b);
      }
    }
  } else {
    // consumer: 64 query rows, rows r and r + 8 of each warp's 16 per thread
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = group - 1, t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q0 + 64 * cw;              // first row of this group
    const int row = row_lo + 16 * (t / 32) + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);  // column of d[0] in each 8-column group
    const uint32_t qa = base + cw * 64 * ROW_BYTES;

    float o[DV / 2], s[BK / 2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    // accumulator index i: row + 8 · ((i / 2) % 2), column 8 · (i / 4) +
    // col + i % 2; a row sees the columns below `end`
    int end[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      end[r] = CAUSAL ? min(Skv, row + 8 * r + 1) : Skv;

    // Tile t: S_t = Q K_tᵀ is issued, then O += P_{t-1} V_{t-1} behind it;
    // the softmax of S_t runs while that product is in flight, and O is
    // rescaled once it has landed.
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    auto pv = [&](uint32_t vs) {      // O += P_hi V + P_lo V, 16 V rows a step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DV>(o, p_hi[kk],
                    sw128_desc(vs + kk * 16 * ROW_BYTES, BK * ROW_BYTES));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DV>(o, p_lo[kk],
                    sw128_desc(vs + kk * 16 * ROW_BYTES, BK * ROW_BYTES));
    };
    auto v_stage = [&](int kt) { return base + L::V0 + kt % STAGES * L::V; };

    bar_wait(q_full, 0);
    for (int kt = 0; kt < n_kv; ++kt) {
      const int st = kt % STAGES, phase = (kt / STAGES) & 1;
      const int kv0 = kt * BK;
      const uint32_t ks = base + L::K0 + st * L::K;

      // S = Q Kᵀ, k-steps of 16 columns: 32 bytes inside a 128-byte box row
      bar_wait(k_full(st), phase);
      reg_fence(s);
      reg_fence(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(qa + (kk / 4) * BQ * ROW_BYTES + off, 16),
                 sw128_desc(ks + (kk / 4) * BK * ROW_BYTES + off, 16), kk > 0);
      }
      wg_commit();
      if (kt > 0) {
        pv(v_stage(kt - 1));
        wg_commit();
        wg_wait<1>();                        // S_t has landed
      } else {
        wg_wait<0>();
      }
      reg_fence(s);
      if (APART) bar_arrive(k_free(st));

      // online softmax in the log2 domain: t = scale · log2(e) · S (the
      // row max of S times the scale is the row max of t); only a tile that
      // reaches the diagonal or Skv carries the masks
      const bool edge =
          kv0 + BK > Skv || (CAUSAL && kv0 + BK - 1 > row_lo);
      float mx[2] = {NEG_INF, NEG_INF};
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const bool seen = kv0 + 8 * (i / 4) + col + i % 2 < end[(i / 2) % 2];
          s[i] = seen ? s[i] * scale_log2 : NEG_INF;
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        mx[0] *= scale_log2;
        mx[1] *= scale_log2;
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const bool seen = kv0 + 8 * (i / 4) + col + i % 2 < end[(i / 2) % 2];
          s[i] = seen ? exp2f(s[i] - m[(i / 2) % 2]) : 0.f;
          l[(i / 2) % 2] += s[i];            // this thread's part of the sum
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] = exp2f(fmaf(s[i], scale_log2, -m[(i / 2) % 2]));
          l[(i / 2) % 2] += s[i];
        }
      }

      // P_{t-1} V_{t-1} has landed: its stage is free, O and the P
      // fragments may be written
      wg_wait<0>();
      reg_fence(o);
      frag_fence(p_hi);
      frag_fence(p_lo);
      if (kt > 0) bar_arrive(v_free((kt - 1) % STAGES));
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // P = P_hi + P_lo in the A-fragment layout: k-step kk holds
      // accumulator columns 16 kk .. 16 kk + 15, i.e. s[8 kk .. 8 kk + 7]
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], p_hi[kk][j],
                     p_lo[kk][j]);
      bar_wait(v_full(st), phase);
    }
    // the last tile's P V
    reg_fence(o);
    wg_fence();
    pv(v_stage(n_kv - 1));
    wg_commit();
    wg_wait<0>();
    reg_fence(o);

    // epilogue: the row's sum over its 4 threads, one rounding to bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-20f);
    }
    __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = row + 8 * r;
      if (qrow >= Sq) continue;
      // m is in log2 units of the scaled scores; lse is taken in f64 and
      // rounded once: at deepseek-v3's scores, in the thousands, m times
      // the f32 ln 2 and the f32 sum would move it by up to 3e-4, and
      // K9-bwd's P = exp(S − lse) by that factor
      if (lse != nullptr && lane % 4 == 0)
        lse[static_cast<long long>(at.bh) * Sq + qrow] =
            static_cast<float>(m[r] * LN2_F64 + log(static_cast<double>(
                                                    l[r])));
      __nv_bfloat16* orow = ob + qrow * so.s + col;
#pragma unroll
      for (int g = 0; g < DV / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g) =
            __floats2bfloat162_rn(o[4 * g + 2 * r] / l[r],
                                  o[4 * g + 2 * r + 1] / l[r]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (CUDA driver API), found through the runtime, so
// that the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over (D, H, S, B) of a bf16 (B, S, H, D) tensor, boxes of 64
// columns x `rows` sequence rows, 128-byte swizzle, zeros past the edges.
// The strides of dimensions of size 1 are never followed; they are given
// as 128 bytes, which TMA takes.  Returns 0 or the CUresult, negated.
int make_map(CUtensorMap* map, const void* x, int B, int S, int H, int D,
             Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  auto bytes = [](long long stride, int n) {
    return static_cast<cuuint64_t>(n > 1 ? stride * 2 : ROW_BYTES);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st.h, H), bytes(st.s, S),
                                 bytes(st.b, B)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

template <int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Sq, int Skv, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, bool causal, float* lse,
           cudaStream_t stream) {
  const long long ctas =
      static_cast<long long>(B) * H * ((Sq + BQ - 1) / BQ);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Sq, H, DQ, sq, BQ);
  if (err == 0) err = make_map(&tk, k, B, Skv, H, DQ, sk, BK);
  if (err == 0) err = make_map(&tv, v, B, Skv, H, DV, sv, BK);
  if (err != 0) return err;
  auto kernel =
      causal ? &flash_fwd<DQ, DV, true> : &flash_fwd<DQ, DV, false>;
  const int bytes = Smem<DQ, DV>::BYTES;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ctas), THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B * H, H, Sq, Skv, so,
      scale * LOG2E, lse, tile_order::heads_per_group(B * H, Skv, DQ, DV));
  return cudaGetLastError();
}

}  // namespace bf16k

// (batch, sequence, head) strides of q, k, v and out, in that order
struct Args {
  Strides sq, sk, sv, so;
  explicit Args(const long long* st)
      : sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
        sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]} {}
};

}  // namespace

// q, k: (B, S, H, Dq), v, out: (B, S, H, Dv), each with unit stride along
// its head dim; `strides` holds the (batch, sequence, head) element strides
// of q, k, v and out, in that order.  (Dq, Dv) is (64, 64), (128, 128) or
// (192, 128).  `lse`: null, or a contiguous f32 (B, H, Sq) buffer for each
// row's log-sum-exp.  Returns cudaGetLastError() after the launch (0 when it
// was accepted), cudaErrorInvalidValue for another pair.
extern "C" int flashattn_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int H, int Sq, int Skv, int Dq,
                             int Dv, const long long* strides, float scale,
                             int causal, void* stream, void* lse) {
  const Args a(strides);
  auto L = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const float*>(q), K = static_cast<const float*>(k),
       V = static_cast<const float*>(v);
  auto O = static_cast<float*>(out);
  auto run = [&](auto launch) {
    return launch(Q, K, V, O, B, H, Sq, Skv, a.sq, a.sk, a.sv, a.so, scale,
                  causal != 0, L, s);
  };
  if (Dq == 64 && Dv == 64) return run(f32k::launch<64, 64>);
  if (Dq == 128 && Dv == 128) return run(f32k::launch<128, 128>);
  if (Dq == 192 && Dv == 128) return run(f32k::launch<192, 128>);
  return cudaErrorInvalidValue;
}

// As flashattn_f32; besides, q, k and v must start on a 16-byte boundary
// and their strides be multiples of 8 elements (TMA), along dimensions of
// more than one row, and B·H times the query tiles be at most 2^31 - 1.
// A negative return is the CUresult of building a tensor map, negated.
extern "C" int flashattn_bf16(const void* q, const void* k, const void* v,
                              void* out, int B, int H, int Sq, int Skv,
                              int Dq, int Dv, const long long* strides,
                              float scale, int causal, void* stream,
                              void* lse) {
  const Args a(strides);
  auto L = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return launch(q, k, v, out, B, H, Sq, Skv, a.sq, a.sk, a.sv, a.so, scale,
                  causal != 0, L, s);
  };
  if (Dq == 64 && Dv == 64) return run(bf16k::launch<64, 64>);
  if (Dq == 128 && Dv == 128) return run(bf16k::launch<128, 128>);
  if (Dq == 192 && Dv == 128) return run(bf16k::launch<192, 128>);
  return cudaErrorInvalidValue;
}
