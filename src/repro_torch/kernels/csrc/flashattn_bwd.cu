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
// q, dq, k and dk are (B, S, H, Dq); v, o, dO and dv are (B, S, H, Dv);
// all are read and written by their (batch, sequence, head) strides with
// unit stride along the head dim.  The (Dq, Dv) pairs are template
// instances: (64, 64), (128, 128) and (192, 128), the last for
// deepseek-v3's latent attention (models/mla.py: 128 + 64 rope columns in
// q and k, 128 in v), which the reference differentiates through the same
// XLA scan.  S = QKᵀ, dQ and dK run over Dq; dP = dO·Vᵀ, dV and Dᵢ over
// Dv.  Every sum is in f32 and each output is rounded once, at the store.
//
// Three launches per call, no atomics, so every run gives the same bits:
//   1. `stats_kernel`: the row statistics both other kernels read, f32 in
//      two planes of (B·H, Sp), Sp = S rounded up to a multiple of 128:
//      lse·log2(e) (+inf past S, so P is 0 on the rows a tile reads past
//      the end; the bf16 entry multiplies in f64 and rounds once) and
//      Dᵢ = Σ_d dOᵢ·Oᵢ (0 past S).  Dᵢ is the diagonal of O dOᵀ taken on
//      the tensor cores by the very product dkdv forms V dOᵀ with (dq's
//      dO Vᵀ has the same products in the same order), so that dP − D is
//      exactly 0 where Oᵢ = Vⱼ, as in exact arithmetic: at S = 1, where the
//      true dQ and dK are 0, a D summed in another order leaves them at the
//      noise of two different f32 sums, over the bound's floor.
//   2. `dkdv_kernel`: one CTA per (batch·head, KV tile), the tile with the
//      most Q tiles after it first.  K and V stay resident; a loop walks
//      the Q tiles that see them (from the diagonal on, when causal),
//      recomputes Sᵀ = K Qᵀ, dPᵀ = V dOᵀ and Pᵀ from lse, and accumulates
//      dV += Pᵀ dO and dK += dSᵀ Q in registers.
//   3. `dq_kernel`: one CTA per (batch·head, Q tile), the heaviest first.
//      Q and dO stay resident; a loop walks the KV tiles they see,
//      recomputes S and dP, and accumulates dQ += dS K.
// S and dP are computed twice (in dkdv and in dq): seven products where
// the function has five.  That is the price of identical bits: the atomic
// dQ of FlashAttention-2/3 adds each KV tile's part in the order the CTAs
// happen to finish.  The f32 entry's grids are (B·H, tiles) with the
// (batch, head) pairs on x; the bf16 entry's are linear, in K9's tile
// order (tile_order.cuh: groups of heads whose streamed operands fit L2,
// each group's heaviest tiles first), which took `dkdv_kernel` at
// deepseek-v3's (1, 4096, 128, 192 / 128) from 4.00 to 3.56 ms once the
// CTA no longer held it (PERF.md §6).
//
// flashattn_bwd_bf16 (Hopper: wgmma + TMA).  CTAs of 384 threads:
// warpgroup 0 is the producer (after `setmaxnreg` gives its registers to
// the consumers, one thread issues every copy), warpgroups 1 and 2 the
// consumers, at 240 registers.  The resident operands are loaded once by
// TMA (a 4-D map over (D, H, S, B) with the operand's strides, 64-row by
// 64-column boxes with 128-byte swizzle; zeros past S); the streamed ones
// (64 rows a tile) run through three `mbarrier` stages, with the Q tile's
// two row statistics beside them (`cp.async.bulk`, 256 bytes each) in
// dkdv.  Score products are `wgmma m64n64k16` (the resident rows as A,
// the streamed tile as a K-major B, exactly the forward's S = QKᵀ): exact
// products of bf16 inputs, summed in f32, S in one accumulator over its
// k-steps, as K9 sums it, and scaled by K9's f32 scale·log2 e, so P is the
// softmax K9's lse was taken of (the tensor cores round their f32 sums
// toward zero, and at deepseek-v3's scores, in the thousands, a more
// exact S here would miss that lse by about 2e-4).  P and dS are split
// into bf16 hi + lo terms (hi = bf16(x), lo = bf16(x − hi): within
// 2^-17·|x|) and each register-A product is issued once per term,
// `wgmma m64n64k16` with the streamed tile as an N-major B, one 64-column
// box at a time, the f32 accumulator layout of a score tile being the
// bf16 A-fragment layout.  Without the split P and dS would be rounded to
// bf16 inside the sums, a second rounding beside the output's (for P in
// dV too: tests/test_torch_kernels_attn_bwd.py).  Each box's eight
// k-steps (four of hi, four of lo) go into a fresh f32 accumulator, its
// first k-step overwriting it, which is added to the running dV, dK or dQ
// in f32: one running accumulator that took every tile's k-steps came out
// low by a common factor, 1e-5 to 2e-5 of qwen3-4b's gradients.
//
// `dkdv_kernel`, 64 resident KV rows a CTA, one consumer per product
// group, so that the accumulators of one row block are split between two
// warpgroups' registers:
//   - warpgroup 1 takes Sᵀ, Pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e),
//     masked on the diagonal tile, and dV += Pᵀ dO; it hands Pᵀ in f32 to
//     warpgroup 2 through shared memory (three 16 KB buffers, named barriers
//     READY and EMPTY);
//   - warpgroup 2 takes dPᵀ, dSᵀ = Pᵀ (dPᵀ − Dᵢ) and dK += dSᵀ Q.
// Each issues tile t+1's score product before tile t's register-A boxes and
// forms tile t+1's Pᵀ or dSᵀ while they are in flight, as K9 hides its
// softmax behind P·V.  Registers at (192, 128): warpgroup 1 dV 64, Sᵀ 32,
// P's fragments 32, the box 32; warpgroup 2 dK 96, dPᵀ 32, dS's fragments
// 32, the box 32, Pᵀ read back 32: no spill (the parent design, each
// warpgroup holding dK and dV of its own 64 of 128 rows, spilled 484 bytes
// there).  Shared memory at (192, 128): K 24 KB and
// V 16 KB resident, three stages of Q (72 KB) and dO (48 KB) and their
// statistics, the exchange 48 KB, 215 608 bytes in all.
// `dq_kernel`, 128 resident Q rows a CTA, 64 a consumer: S and dP in two
// groups (P formed while dP is in flight), then dQ += dS K box by box.
// Built, measured and not kept (PERF.md §6): two boxes in flight (each
// warpgroup's longer queue of products holds the other's back: slower in
// both kernels), four stages at (128, 128), K and V held as register
// fragments for the score products (so shared memory's bandwidth is not
// what holds dkdv_kernel), and in dq_kernel one consumer per product group
// (dS's fragments handed through shared memory) and the next tile's S and
// dP issued before the boxes.
// What bounds it: the function is five products, (3·Dq + 2·Dv)·H·S(S+1)
// operations (causal), 343.7 GFLOP at qwen3-4b's (1, 4096, 32, 128) and
// 1 787.2 at deepseek-v3's (1, 4096, 128, 192 / 128): 0.35 and 1.81 ms on
// the bf16 tensor cores.  This design runs ten bf16 passes (S, dP twice,
// dV, dK, dQ in two terms each): 0.69 and 3.61 ms at the peak rate, the
// floor of this design; fewer passes would take dQ in the dkdv pass (S and
// dP formed once), which needs a deterministic sum of dQ across KV tiles,
// not built.
//
// flashattn_bwd_f32 (the inputs must not be rounded): the same two kernels
// on the TF32 tensor cores at f32 grade.  Each operand x is split into
// x_hi = tf32(x) and x_lo = tf32(x − x_hi) (round to nearest), and each
// product a·b is taken as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi in an f32
// accumulator (`mma.sync m16n8k8 .tf32`; the dropped a_lo·b_lo is about
// 2^-22 of |a·b|, CUTLASS's "fast f32").  CTAs of 4 warps, each warp 16 of
// the 64 resident rows against 64-row streamed tiles; operands are f32
// tiles in shared memory padded to D + 4 floats a row (the fragment loads
// of a warp land on 32 distinct banks), streamed tiles double-buffered by
// `cp.async` (4-byte copies: operands are read at any 4-byte alignment,
// by strides).  S and dP take each k-step's three products, and dV, dK
// and dQ each tile's, in a fresh accumulator added in f32 (`xyt`, `az`:
// the tensor cores' own f32 sums round toward zero).  The accumulator of S is the A fragment of the
// product that follows it with the k index permuted (physical column 2t,
// 2t + 1 taken as logical t, t + 4); the B fragment reads its rows in the
// same order.  At (192, 128) the resident tiles (64 x (196 + 132) floats)
// and two buffers of 64-row streamed ones would need 252 928 bytes of
// shared memory, over the 232 448 a block may use, and a warp's dK grows
// by half: that instance streams 32-row tiles (two buffers, 168 448
// bytes), which also halves S and dP.  What bounds it: at repro-100m's (8, 1024, 10, 64) causal the
// function is 26.87 GFLOP, 0.40 ms at 67 TFLOP/s f32 outside the tensor
// cores; this design runs seven products in three TF32 passes each, 112.8
// GFLOP, 0.23 ms at 495 TFLOP/s TF32, and issues one or two shared loads
// and the split's conversions beside every three `mma.sync`.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_order.cuh"

namespace {

constexpr int PAD = 128;            // the statistics' rows: S rounded up to it
constexpr float LOG2E = 1.4426950408889634f;
constexpr double LOG2E_F64 = 1.4426950408889634;

struct Strides {                    // element strides of (B, S, H); D is unit
  long long b, s, h;
};

struct Args {                       // q, k, v, o, dO, dq, dk, dv strides
  Strides q, k, v, o, d, dq, dk, dv;
  explicit Args(const long long* st)
      : q{st[0], st[1], st[2]}, k{st[3], st[4], st[5]},
        v{st[6], st[7], st[8]}, o{st[9], st[10], st[11]},
        d{st[12], st[13], st[14]}, dq{st[15], st[16], st[17]},
        dk{st[18], st[19], st[20]}, dv{st[21], st[22], st[23]} {}
};

__host__ __device__ constexpr int padded(int S) {
  return (S + PAD - 1) / PAD * PAD;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
namespace bf16k {

constexpr int BM = 64;              // dkdv_kernel's resident rows per CTA
constexpr int BMQ = 128;            // dq_kernel's: 64 per consumer
constexpr int BN = 64;              // streamed rows per tile (wgmma_ss's N)
constexpr int STAGES = 3;           // streamed tiles in flight (four measured
                                    // slower at (128, 128), PERF.md §6)
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;      // threads that release a stage
constexpr int ROW_BYTES = 128;      // one 64-column box row, swizzled
// one tile handed from one consumer warpgroup to the other: 32 words a
// thread, in NXCH buffers (three measured 1-2 % faster than two)
constexpr int XCH = 128 * 32 * 4, NXCH = 3;
// named barriers over the two consumer warpgroups (0 is __syncthreads):
// READY + b, buffer b holds a tile; EMPTY + b, it has been read
constexpr int READY = 1, EMPTY = READY + NXCH;

template <int DQ, int DV>
struct Smem {                       // byte offsets from a 1024-aligned base
  static constexpr int RES_X = BM * DQ * 2;      // resident K / Q
  static constexpr int RES_Y = BM * DV * 2;      // resident V / dO
  static constexpr int TILE_U = BN * DQ * 2;     // one streamed Q / K
  static constexpr int TILE_W = BN * DV * 2;     // one streamed dO / V
  static constexpr int STAT = 2 * BN * 4;        // lse·log2 e and D, dkdv
  static constexpr int X = 0, Y = RES_X;
  static constexpr int U = RES_X + RES_Y;        // streamed: Q / K
  static constexpr int W = U + STAGES * TILE_U;  // streamed: dO / V
  static constexpr int ST = W + STAGES * TILE_W;
  static constexpr int XB = ST + STAGES * STAT;  // the exchange's buffers
  static constexpr int BARS = XB + NXCH * XCH;   // 1 + 2 · STAGES
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "a block's shared memory on Hopper");
};

// dq_kernel's: 2 x 64 resident Q and dO rows, no exchange
template <int DQ, int DV>
struct SmemQ {
  static constexpr int RES_X = BMQ * DQ * 2, RES_Y = BMQ * DV * 2;
  static constexpr int TILE_U = BN * DQ * 2, TILE_W = BN * DV * 2;
  static constexpr int X = 0, Y = RES_X, U = RES_X + RES_Y;
  static constexpr int W = U + STAGES * TILE_U;
  static constexpr int BARS = W + STAGES * TILE_W;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
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

// `bytes` contiguous bytes (16-byte aligned both sides) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// d (64 x 64, f32) = [d +] A B: A (64 x 16) and B (16 x 64, K-major) from
// shared memory; `accumulate` = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) = [d +] A B: A (64 x 16 bf16) from registers in the
// wgmma fragment layout, B (16 x 64) from shared memory N-major
// (transposed); `accumulate` = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
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

// d (64 x 64, f32) = A Bᵀ over D columns: A dkdv_kernel's 64 resident rows,
// B a streamed 64-row tile, both in 64-column boxes (K-major); one
// committed group, the k-steps in order, the forward's S = QKᵀ.  The first
// k-step overwrites d: no instruction writes an accumulator while other
// products are in flight, which would make ptxas serialise them.
template <int D>
__device__ __forceinline__ void score_product(float (&d)[32], uint32_t a,
                                              uint32_t b) {
  reg_fence(d);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(d, sw128_desc(a + (kk / 4) * BM * ROW_BYTES + off, 16),
             sw128_desc(b + (kk / 4) * BN * ROW_BYTES + off, 16), kk > 0);
  }
  wg_commit();
}

// dq_kernel's two 64 x 64 score tiles of a consumer warpgroup: s = X Uᵀ
// over DQ, dp = Y Wᵀ over DV, X and Y its 64 of the 128 resident rows,
// U and W a streamed stage; two groups, s first, so that wg_wait<1> waits
// for s alone
template <int DQ, int DV>
__device__ __forceinline__ void score_products(float (&s)[32],
                                               float (&dp)[32], uint32_t xa,
                                               uint32_t ya, uint32_t u,
                                               uint32_t w) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  reg_fence(s);
  reg_fence(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DQ / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(xa + (kk / 4) * BMQ * ROW_BYTES + off, 16),
             sw128_desc(u + (kk / 4) * BN * ROW_BYTES + off, 16), kk > 0);
  }
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(dp, sw128_desc(ya + (kk / 4) * BMQ * ROW_BYTES + off, 16),
             sw128_desc(w + (kk / 4) * BN * ROW_BYTES + off, 16), kk > 0);
  }
  wg_commit();
}

// Box c (64 columns) of A·Z, A = hi + lo in registers (64 x 64, k-steps of
// 16 columns) and Z a streamed stage (64 rows x N, N-major B): the tile's
// eight k-steps (hi, then lo) in the fresh accumulator f, one committed
// group.  The tensor cores round their f32 sums toward zero, so a running
// accumulator that took every tile's k-steps came out low by a common
// factor (1e-5 to 2e-5 at (128, 128)); f is added to the running sum in
// f32, rounded to nearest (`finish_boxes`).
__device__ __forceinline__ void box_issue(float (&f)[32],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          uint32_t z, int c) {
  const uint32_t box = z + c * BN * ROW_BYTES;
  reg_fence(f);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(f, hi[kk], sw128_desc(box + kk * 16 * ROW_BYTES, BN * ROW_BYTES),
             kk > 0);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(f, lo[kk], sw128_desc(box + kk * 16 * ROW_BYTES, BN * ROW_BYTES),
             1);
  wg_commit();
}

// acc (64 x N) += A·Z box by box, one box in flight: `issue_boxes` starts
// box 0, one committed group, and `finish_boxes` waits for each box, adds
// it to acc and starts the next in the registers it frees.  Groups retire
// in the order they were committed, so a group committed before the boxes
// (the next tile's score product) has landed once `wg_wait<1>` returns.
// Two boxes in flight measured slower (PERF.md §6): one warpgroup's long
// queue of products holds back the other's.
template <int N>
__device__ __forceinline__ void issue_boxes(float (&f)[32],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t z) {
  static_assert(N % 64 == 0 && N <= 192, "64, 128 or 192 columns");
  box_issue(f, hi, lo, z, 0);
}

template <int N>
__device__ __forceinline__ void finish_boxes(float (&acc)[N / 2],
                                             float (&f)[32],
                                             uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4],
                                             uint32_t z) {
#pragma unroll
  for (int c = 0; c < N / 64; ++c) {
    wg_wait<0>();
    reg_fence(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * c + i] += f[i];
    if (c + 1 < N / 64) box_issue(f, hi, lo, z, c + 1);
  }
  frag_fence(hi);
  frag_fence(lo);
}

// The exchange: a consumer thread's 32 f32 values in one buffer of XCH
// bytes, value w at 16-byte group w / 4 of the thread, so that a warp's
// accesses are 512 contiguous bytes.  The two warpgroups' accumulators of
// a 64 x 64 tile have one layout, so thread t of one reads what thread t
// of the other wrote.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void put_tile(float4* buf, int t,
                                         const float (&x)[32]) {
#pragma unroll
  for (int g = 0; g < 8; ++g)
    buf[g * 128 + t] =
        make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]);
}

__device__ __forceinline__ void get_tile(const float4* buf, int t,
                                         float (&x)[32]) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 v = buf[g * 128 + t];
    x[4 * g] = v.x;
    x[4 * g + 1] = v.y;
    x[4 * g + 2] = v.z;
    x[4 * g + 3] = v.w;
  }
}

// x = x_hi + x_lo in the A-fragment layout: k-step kk holds accumulator
// columns 16 kk .. 16 kk + 15, i.e. x[8 kk .. 8 kk + 7]
__device__ __forceinline__ void split_tile(const float (&x)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1], hi[kk][j],
                 lo[kk][j]);
}

// the rows `row` and `row + 8` of a 64 x N accumulator times `mul`, rounded
// once to bf16, where they lie below S
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, Strides st,
                                           const float (&acc)[N / 2],
                                           int row, int col, int S,
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = row + 8 * r;
    if (at >= S) continue;
    __nv_bfloat16* p = dst + at * st.s + col;
#pragma unroll
    for (int g = 0; g < N / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * g) = __floats2bfloat162_rn(
          acc[4 * g + 2 * r] * mul, acc[4 * g + 2 * r + 1] * mul);
  }
}

// The row statistics of 64 rows of one (batch, head), up to Sp:
// lse·log2 e (+inf past S) and Dᵢ = Σ_d dOᵢ·Oᵢ (0 past S: TMA reads
// zeros), Dᵢ as the diagonal of O dOᵀ by the product dkdv forms V dOᵀ with
// (wgmma_ss, O as A, dO as a K-major B, the same k-steps over DV): where
// Oᵢ = Vⱼ, as at S = 1, dPᵀ[j][i] − Dᵢ is exactly 0 (and dP[i][j] in dq,
// the same products with A and B exchanged), as it is in exact arithmetic.
// lse·log2 e is taken in f64 and rounded once: lse near 4300 (deepseek-v3)
// times the f32 log2 e, itself 1.3e-8 low, would put every row's P high by
// a common 6e-5.
template <int DV>
__global__ void __launch_bounds__(128)
stats_kernel(const __grid_constant__ CUtensorMap to,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, float* __restrict__ stats, int H,
             int S) {
  constexpr int BOXES = DV / 64;
  constexpr int TILE = BN * DV * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + 2 * TILE;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * BN;
  const int Sp = padded(S);
  float* lrow = stats + static_cast<long long>(bh) * Sp;
  float* drow = lrow + static_cast<long long>(gridDim.x) * Sp;
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(bar, 2 * TILE);
    for (int c = 0; c < BOXES; ++c) {
      tma_load(base + c * BN * ROW_BYTES, &to, bar, 64 * c, h, r0, b);
      tma_load(base + TILE + c * BN * ROW_BYTES, &tdo, bar, 64 * c, h, r0,
               b);
    }
  }
  if (threadIdx.x < BN) {
    const int i = r0 + threadIdx.x;
    lrow[i] = i < S ? static_cast<float>(
                          lse[static_cast<long long>(bh) * S + i] * LOG2E_F64)
                    : __int_as_float(0x7f800000);
  }
  bar_wait(bar, 0);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  reg_fence(d);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(d, sw128_desc(base + (kk / 4) * BN * ROW_BYTES + off, 16),
             sw128_desc(base + TILE + (kk / 4) * BN * ROW_BYTES + off, 16),
             kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(d);
  // d[i] is row 16 w + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
  // 2 (lane % 4) + i % 2: the diagonal of rows r and r + 8 lies with the
  // lane whose lane % 4 is (lane / 4) / 2, at i = 8 w + e and 8 w + 6 + e
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane % 4 == lane / 8) {
    const int e = (lane / 4) % 2, row = r0 + 16 * w + lane / 4;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i == 8 * w + e) d0 = d[i];
      if (i == 8 * w + 6 + e) d1 = d[i];
    }
    drow[row] = d0;
    drow[row + 8] = d1;
  }
}

// A loop body that issues the next tile's products, or (the last tile)
// does not: a compile-time flag, so that no product is issued in one branch
// and waited for after it (ptxas would then serialise every product).
template <bool B>
struct Next {
  static constexpr bool value = B;
};

struct Maps {                       // resident X, Y; streamed U, W
  CUtensorMap x, y, u, w;
};

// dK and dV for 64 KV rows of one (batch, head).  X, Y = K, V (resident);
// U, W = Q, dO (streamed, from the diagonal on when causal).  Warpgroup 1
// forms Sᵀ = K Qᵀ and Pᵀ, hands Pᵀ to warpgroup 2 and takes dV += Pᵀ dO;
// warpgroup 2 forms dPᵀ = V dOᵀ and dSᵀ, and takes dK += dSᵀ Q.
template <int DQ, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ Maps maps,
            const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, int BH, int H, int S,
            Strides sdk, Strides sdv, float scale, float scale_log2,
            int group) {
  using L = Smem<DQ, DV>;
  constexpr int XBOXES = DQ / 64, YBOXES = DV / 64;  // 64-column TMA boxes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t res_full = base + L::BARS;
  auto full = [&](int s) { return res_full + 8 * (1 + s); };
  auto free_ = [&](int s) { return res_full + 8 * (1 + STAGES + s); };

  // the KV tile with the most Q tiles after it first (tile_order.cuh)
  const int n = (S + BM - 1) / BM;
  const tile_order::TileAt at = tile_order::tile_at(blockIdx.x, BH, n, group);
  const int bh = at.bh, b = bh / H, h = bh % H;
  const int kv0 = at.rank * BM;
  const int Sp = padded(S);
  const int qt0 = CAUSAL ? kv0 / BN : 0;
  const int nt = (S + BN - 1) / BN - qt0;           // the Q tiles it sees
  const int role = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(free_(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      const float* lrow = stats + static_cast<long long>(bh) * Sp;
      const float* drow = lrow + static_cast<long long>(BH) * Sp;
      bar_expect(res_full, L::RES_X + L::RES_Y);
      for (int c = 0; c < XBOXES; ++c)
        tma_load(base + L::X + c * BM * ROW_BYTES, &maps.x, res_full, 64 * c,
                 h, kv0, b);
      for (int c = 0; c < YBOXES; ++c)
        tma_load(base + L::Y + c * BM * ROW_BYTES, &maps.y, res_full, 64 * c,
                 h, kv0, b);
      for (int it = 0; it < nt; ++it) {
        const int s = it % STAGES, q0 = (qt0 + it) * BN;
        bar_wait(free_(s), ((it / STAGES) & 1) ^ 1);
        bar_expect(full(s), L::TILE_U + L::TILE_W + L::STAT);
        for (int c = 0; c < XBOXES; ++c)
          tma_load(base + L::U + s * L::TILE_U + c * BN * ROW_BYTES, &maps.u,
                   full(s), 64 * c, h, q0, b);
        for (int c = 0; c < YBOXES; ++c)
          tma_load(base + L::W + s * L::TILE_W + c * BN * ROW_BYTES, &maps.w,
                   full(s), 64 * c, h, q0, b);
        bulk_load(base + L::ST + s * L::STAT, lrow + q0, BN * 4, full(s));
        bulk_load(base + L::ST + s * L::STAT + BN * 4, drow + q0, BN * 4,
                  full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row = kv0 + 16 * (t / 32) + lane / 4;     // and row + 8
  const int col = 2 * (lane % 4);  // column of d[0] in each 8-column group
  float4* xp = reinterpret_cast<float4*>(gbase + L::XB);
  auto stage_u = [&](int it) { return base + L::U + it % STAGES * L::TILE_U; };
  auto stage_w = [&](int it) { return base + L::W + it % STAGES * L::TILE_W; };
  auto wait_full = [&](int it) {
    bar_wait(full(it % STAGES), (it / STAGES) & 1);
  };
  float f[32];
  bar_wait(res_full, 0);
  wait_full(0);

  if (role == 1) {
    // Sᵀ, Pᵀ and dV.  Tile it+1's Sᵀ is issued before tile it's dV boxes,
    // and its Pᵀ formed while they are in flight.
    float dva[DV / 2], s[32];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
    uint32_t p_hi[4][4], p_lo[4][4];
    // Pᵀ[j][i] of tile it from its Sᵀ in s: rows j KV rows, columns i Q
    // rows; Q rows past S read lse·log2 e = +inf, so P is 0 there.  Then
    // into exchange buffer it % NXCH for warpgroup 2.
    auto probabilities = [&](int it) {
      const int q0 = (qt0 + it) * BN;
      const float* lse2 = reinterpret_cast<const float*>(
          gbase + L::ST + it % STAGES * L::STAT);
      const bool edge = CAUSAL && q0 < kv0 + BM;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + col + i % 2;
        const float p = exp2f(fmaf(s[i], scale_log2, -lse2[c]));
        s[i] = edge && q0 + c < row + 8 * ((i / 2) % 2) ? 0.f : p;
      }
      if (it >= NXCH) named_sync(EMPTY + it % NXCH);
      put_tile(xp + it % NXCH * (XCH / 16), t, s);
      named_arrive(READY + it % NXCH);
    };
    auto body = [&](int it, auto next) {
      split_tile(s, p_hi, p_lo);
      if constexpr (decltype(next)::value) {
        wait_full(it + 1);
        score_product<DQ>(s, base + L::X, stage_u(it + 1));
      }
      const uint32_t w = stage_w(it);
      issue_boxes<DV>(f, p_hi, p_lo, w);             // dV += Pᵀ dO
      if constexpr (decltype(next)::value) {
        wg_wait<1>();
        reg_fence(s);
        probabilities(it + 1);
      }
      finish_boxes<DV>(dva, f, p_hi, p_lo, w);
      bar_arrive(free_(it % STAGES));
    };
    score_product<DQ>(s, base + L::X, stage_u(0));    // Sᵀ = K Qᵀ
    wg_wait<0>();
    reg_fence(s);
    probabilities(0);
    for (int it = 0; it + 1 < nt; ++it) body(it, Next<true>{});
    body(nt - 1, Next<false>{});
    store_rows<DV>(dv + b * sdv.b + h * sdv.h, sdv, dva, row, col, S, 1.f);
  } else {
    // dPᵀ, dSᵀ and dK.  Tile it+1's dPᵀ is issued before tile it's dK
    // boxes, and its dSᵀ formed while they are in flight.
    float dka[DQ / 2], dp[32];
#pragma unroll
    for (int i = 0; i < DQ / 2; ++i) dka[i] = 0.f;
    uint32_t d_hi[4][4], d_lo[4][4];
    // dSᵀ of tile it into dp (in place), from its dPᵀ and warpgroup 1's Pᵀ
    auto scores_grad = [&](int it) {
      const float* dl = reinterpret_cast<const float*>(
          gbase + L::ST + it % STAGES * L::STAT) + BN;
      named_sync(READY + it % NXCH);
      float p[32];
      get_tile(xp + it % NXCH * (XCH / 16), t, p);
      if (it + NXCH < nt) named_arrive(EMPTY + it % NXCH);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = p[i] * (dp[i] - dl[8 * (i / 4) + col + i % 2]);
    };
    auto body = [&](int it, auto next) {
      split_tile(dp, d_hi, d_lo);
      if constexpr (decltype(next)::value) {
        wait_full(it + 1);
        score_product<DV>(dp, base + L::Y, stage_w(it + 1));
      }
      const uint32_t u = stage_u(it);
      issue_boxes<DQ>(f, d_hi, d_lo, u);             // dK += dSᵀ Q
      if constexpr (decltype(next)::value) {
        wg_wait<1>();
        reg_fence(dp);
        scores_grad(it + 1);
      }
      finish_boxes<DQ>(dka, f, d_hi, d_lo, u);
      bar_arrive(free_(it % STAGES));
    };
    score_product<DV>(dp, base + L::Y, stage_w(0));   // dPᵀ = V dOᵀ
    wg_wait<0>();
    reg_fence(dp);
    scores_grad(0);
    for (int it = 0; it + 1 < nt; ++it) body(it, Next<true>{});
    body(nt - 1, Next<false>{});
    store_rows<DQ>(dk + b * sdk.b + h * sdk.h, sdk, dka, row, col, S,
                   scale);
  }
}

// dQ for 128 Q rows of one (batch, head), the heaviest Q tiles first.
// X, Y = Q, dO (resident, 64 rows a consumer warpgroup); U, W = K, V
// (streamed, up to the diagonal when causal).  Each consumer forms S = Q Kᵀ,
// dP = dO Vᵀ, P and dS for its rows and takes dQ += dS K, two boxes in
// flight; where the registers allow (Dq <= 128) the next tile's S and dP
// are issued before them.
template <int DQ, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ stats,
          __nv_bfloat16* __restrict__ dq, int BH, int H, int S, Strides sdq,
          float scale, float scale_log2, int group) {
  using L = SmemQ<DQ, DV>;
  constexpr int XBOXES = DQ / 64, YBOXES = DV / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t res_full = base + L::BARS;
  auto full = [&](int s) { return res_full + 8 * (1 + s); };
  auto free_ = [&](int s) { return res_full + 8 * (1 + STAGES + s); };

  const int n = (S + BMQ - 1) / BMQ;
  const tile_order::TileAt at = tile_order::tile_at(blockIdx.x, BH, n, group);
  const int bh = at.bh, b = bh / H, h = bh % H;
  const int q0 = (n - 1 - at.rank) * BMQ;
  const int Sp = padded(S);
  int n_kv = (S + BN - 1) / BN;
  if (CAUSAL) n_kv = min(n_kv, (q0 + BMQ - 1) / BN + 1);
  const int role = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(free_(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      bar_expect(res_full, L::RES_X + L::RES_Y);
      for (int half = 0; half < 2; ++half) {       // 64-row boxes
        for (int c = 0; c < XBOXES; ++c)
          tma_load(base + L::X + (2 * c + half) * BN * ROW_BYTES, &maps.x,
                   res_full, 64 * c, h, q0 + BN * half, b);
        for (int c = 0; c < YBOXES; ++c)
          tma_load(base + L::Y + (2 * c + half) * BN * ROW_BYTES, &maps.y,
                   res_full, 64 * c, h, q0 + BN * half, b);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % STAGES;
        bar_wait(free_(s), ((kt / STAGES) & 1) ^ 1);
        bar_expect(full(s), L::TILE_U + L::TILE_W);
        for (int c = 0; c < XBOXES; ++c)
          tma_load(base + L::U + s * L::TILE_U + c * BN * ROW_BYTES, &maps.u,
                   full(s), 64 * c, h, kt * BN, b);
        for (int c = 0; c < YBOXES; ++c)
          tma_load(base + L::W + s * L::TILE_W + c * BN * ROW_BYTES, &maps.w,
                   full(s), 64 * c, h, kt * BN, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int cw = role - 1, t = threadIdx.x % 128, lane = t % 32;
  const int row_lo = q0 + 64 * cw;                 // this warpgroup's rows
  const int row = row_lo + 16 * (t / 32) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const uint32_t xa = base + L::X + cw * 64 * ROW_BYTES;
  const uint32_t ya = base + L::Y + cw * 64 * ROW_BYTES;
  auto stage_u = [&](int kt) { return base + L::U + kt % STAGES * L::TILE_U; };
  auto stage_w = [&](int kt) { return base + L::W + kt % STAGES * L::TILE_W; };
  // the rows' statistics (rows past S: +inf and 0, so P is 0 there)
  const float* lrow = stats + static_cast<long long>(bh) * Sp;
  const float* drow = lrow + static_cast<long long>(BH) * Sp;
  const float lse2[2] = {lrow[row], lrow[row + 8]};
  const float dl[2] = {drow[row], drow[row + 8]};

  float dqa[DQ / 2], s[32], dp[32], f[32];
#pragma unroll
  for (int i = 0; i < DQ / 2; ++i) dqa[i] = 0.f;
  uint32_t d_hi[4][4], d_lo[4][4];
  bar_wait(res_full, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * BN;
    bar_wait(full(kt % STAGES), (kt / STAGES) & 1);
    score_products<DQ, DV>(s, dp, xa, ya, stage_u(kt), stage_w(kt));
    // P while dP is still in flight; KV rows past S were read as zeros:
    // masked like the causal cells
    wg_wait<1>();
    reg_fence(s);
    const bool edge = kv0 + BN > S || (CAUSAL && kv0 + BN - 1 > row_lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2, c = kv0 + 8 * (i / 4) + col + i % 2;
      const float p = exp2f(fmaf(s[i], scale_log2, -lse2[r]));
      s[i] = edge && (c >= S || (CAUSAL && c > row + 8 * r)) ? 0.f : p;
    }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
    split_tile(dp, d_hi, d_lo);
    const uint32_t u = stage_u(kt);
    issue_boxes<DQ>(f, d_hi, d_lo, u);              // dQ += dS K
    finish_boxes<DQ>(dqa, f, d_hi, d_lo, u);
    bar_arrive(free_(kt % STAGES));
  }
  store_rows<DQ>(dq + b * sdq.b + h * sdq.h, sdq, dqa, row, col, S, scale);
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


template <int DQ, int DV, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* stats, void* dq,
           void* dk, void* dv, int B, int H, int S, const Args& a,
           float scale, cudaStream_t stream) {
  // every operand in boxes of 64 rows (BM = BN): one map each
  static_assert(BM == BN, "resident and streamed tiles share the maps");
  CUtensorMap to, tq, tk, tv, tdo;
  int err = make_map(&to, o, B, S, H, DV, a.o, BN);
  if (err == 0) err = make_map(&tq, q, B, S, H, DQ, a.q, BN);
  if (err == 0) err = make_map(&tk, k, B, S, H, DQ, a.k, BN);
  if (err == 0) err = make_map(&tv, v, B, S, H, DV, a.v, BN);
  if (err == 0) err = make_map(&tdo, dout, B, S, H, DV, a.d, BN);
  if (err != 0) return err;
  const Maps kv{tk, tv, tq, tdo}, qd{tq, tdo, tk, tv};
  const int stat_bytes = 2 * BN * DV * 2 + 8 + 1024;
  err = cudaFuncSetAttribute(stats_kernel<DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             stat_bytes);
  if (err != cudaSuccess) return err;
  stats_kernel<DV><<<dim3(B * H, padded(S) / BN), 128, stat_bytes,
                     stream>>>(to, tdo, lse, stats, H, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a linear grid in K9's tile order: groups of heads whose streamed
  // operands fit L2, the heaviest tiles first
  const int BH = B * H;
  const int group = tile_order::heads_per_group(BH, S, DQ, DV);
  const dim3 grid(BH * ((S + BM - 1) / BM));
  const int bytes = Smem<DQ, DV>::BYTES;
  auto kv_kernel = dkdv_kernel<DQ, DV, CAUSAL>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<grid, THREADS, bytes, stream>>>(
      kv, stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), BH, H, S, a.dk, a.dv, scale,
      scale * LOG2E, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kernel = dq_kernel<DQ, DV, CAUSAL>;
  const int q_bytes = SmemQ<DQ, DV>::BYTES;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3(BH * ((S + BMQ - 1) / BMQ)), THREADS, q_bytes, stream>>>(
      qd, stats, static_cast<__nv_bfloat16*>(dq), BH, H, S, a.dq, scale,
      scale * LOG2E, group);
  return cudaGetLastError();
}

}  // namespace bf16k

// ---------------------------------------------------------------------------
// f32: split-TF32 mma.sync
// ---------------------------------------------------------------------------
namespace f32k {

constexpr int BM = 64;              // resident rows per CTA: 4 warps x 16
constexpr int THREADS = 128;

// a shared tile's row stride in floats: the fragment loads of a warp land
// on 32 distinct banks
__host__ __device__ constexpr int ld(int D) { return D + 4; }

template <int DQ, int DV>
struct Smem {                       // offsets in floats
  // rows of a streamed tile: 64, or 32 at (192, 128), where two buffers of
  // 64 rows beside the resident tiles would need 252 928 bytes
  static constexpr int BN = DQ == DV ? 64 : 32;
  static constexpr int TILE_U = BN * ld(DQ);     // one streamed Q / K
  static constexpr int TILE_W = BN * ld(DV);     // one streamed dO / V
  static constexpr int X = 0;                    // resident: K / Q
  static constexpr int Y = BM * ld(DQ);          //   V / dO
  static constexpr int U = Y + BM * ld(DV);      // streamed, two buffers:
  static constexpr int W = U + 2 * TILE_U;       //   Q, dO / K, V
  static constexpr int ST = W + 2 * TILE_W;      // lse·log2 e and D (dkdv)
  static constexpr int BYTES = (ST + 2 * 2 * BN) * 4;
  static_assert(BYTES <= 232448, "a block's shared memory on Hopper");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, or zeros when `in` is false (src is then not read)
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// until at most `N` committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (S, D) slice into a shared tile of row
// stride ld(D) at `dst`; zeros past S
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          long long stride_s, int row0,
                                          int S) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, d = e % D, row = row0 + r;
    const bool in = row < S;
    cp4(dst + 4 * (r * ld(D) + d), in ? src + row * stride_s + d : src, in);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both TF32 (round to nearest): x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b at f32 grade: the cross terms a_lo·b_hi and a_hi·b_lo (in that
// order, or the other with SWAP), then a_hi·b_hi
template <bool SWAP>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  if (SWAP) {
    mma(d, ah, bl0, bl1);
    mma(d, al, bh0, bh1);
  } else {
    mma(d, al, bh0, bh1);
    mma(d, ah, bl0, bl1);
  }
  mma(d, ah, bh0, bh1);
}

// acc (16 x 8 NT) = X Yᵀ over D: X the warp's 16 rows, Y 8 NT rows, both
// (rows, D) in shared memory.  acc[nt][e] is row g + 8 (e / 2), column
// 8 nt + 2 t + e % 2 (the mma.sync accumulator layout).  SWAP: the order of
// the cross terms (mma3).  Each k-step's three products go to a fresh
// accumulator, added to acc by an f32 add: the tensor cores round their f32
// sums toward zero, so D / 8 k-steps summed in one accumulator bias a
// large score low by several ulps, and P = exp(S − lse), lse from K9's
// correctly rounded sums, low with it (at reduced deepseek-v3's scores,
// |S| up to 170, every gradient came out low, over the card-vs-CPU step's
// grad-norm bound).
template <int D, int NT, bool SWAP>
__device__ __forceinline__ void xyt(float (&acc)[NT][4], const float* X,
                                    const float* Y, int g, int t) {
  constexpr int LD = ld(D);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(X[g * LD + k0 + t], ah[0], al[0]);
    split_tf32(X[(g + 8) * LD + k0 + t], ah[1], al[1]);
    split_tf32(X[g * LD + k0 + t + 4], ah[2], al[2]);
    split_tf32(X[(g + 8) * LD + k0 + t + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* y = Y + (8 * nt + g) * LD + k0;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma3<SWAP>(part, ah, al, y[t], y[t + 4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
    }
  }
}

// out (16 x D) += A Z: A (16 x BN) an accumulator (xyt's layout), Z a
// BN-row tile (rows, D).  The accumulator is the A fragment with the k
// index permuted: the thread's columns 2t and 2t + 1 of each 8 stand for
// k = t and t + 4, so B reads Z's rows 2t and 2t + 1 for them.  Each
// 8-column block of out takes the tile's products in a fresh accumulator,
// added by an f32 add: summed on the tensor cores over every tile of a
// sequence, dV and dK came out low (round toward zero, as in xyt).
template <int D, int BN>
__device__ __forceinline__ void az(float (&out)[D / 8][4],
                                   const float (&a)[BN / 8][4],
                                   const float* Z, int g, int t) {
  constexpr int LD = ld(D);
  uint32_t ah[BN / 8][4], al[BN / 8][4];
#pragma unroll                      // a[ks] must stay in registers
  for (int ks = 0; ks < BN / 8; ++ks) {
    split_tf32(a[ks][0], ah[ks][0], al[ks][0]);
    split_tf32(a[ks][2], ah[ks][1], al[ks][1]);
    split_tf32(a[ks][1], ah[ks][2], al[ks][2]);
    split_tf32(a[ks][3], ah[ks][3], al[ks][3]);
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks) {
      const float* z = Z + (8 * ks + 2 * t) * LD + g;
      mma3<false>(part, ah[ks], al[ks], z[8 * dn], z[LD + 8 * dn]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[dn][e] += part[e];
  }
}

// the rows `row` and `row + 8` of a 16 x D accumulator times `mul`, where
// they lie below S
template <int D>
__device__ __forceinline__ void store_rows(float* dst, Strides st,
                                           const float (&acc)[D / 8][4],
                                           int row, int t, int S, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = row + 8 * r;
    if (at >= S) continue;
    float* p = dst + at * st.s + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      p[8 * dn] = acc[dn][2 * r] * mul;
      p[8 * dn + 1] = acc[dn][2 * r + 1] * mul;
    }
  }
}

// The row statistics of 64 rows of one (batch, head), up to Sp:
// lse·log2 e (+inf past S) and Dᵢ = Σ_d dOᵢ·Oᵢ (0 past S), Dᵢ as the
// diagonal of O dOᵀ in the arithmetic dkdv forms V dOᵀ with (xyt over DV,
// O as X, the same term order): where Oᵢ = Vⱼ, as at S = 1, dP − D is
// exactly 0.
template <int DV>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ stats, int H,
             int S, Strides so, Strides sd) {
  constexpr int LD = ld(DV), Y = 64 * LD;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const uint32_t sbase = smem_addr(sm);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * 64;
  const int Sp = padded(S);
  float* lrow = stats + static_cast<long long>(bh) * Sp;
  float* drow = lrow + static_cast<long long>(gridDim.x) * Sp;
  load_tile<DV, 64>(sbase, o + b * so.b + h * so.h, so.s, r0, S);
  load_tile<DV, 64>(sbase + 4 * Y, dout + b * sd.b + h * sd.h, sd.s, r0, S);
  cp_commit();
  if (threadIdx.x < 64) {
    const int i = r0 + threadIdx.x;
    lrow[i] = i < S ? lse[static_cast<long long>(bh) * S + i] * LOG2E
                    : __int_as_float(0x7f800000);
  }
  cp_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[2][4];                  // the warp's 16 O rows x its 16 dO rows
  xyt<DV, 2, false>(acc, sm + 16 * warp * LD, sm + Y + 16 * warp * LD, g, t);
  if (t == g / 2) {                 // the diagonal: acc[nt][e] is column
    const int row = r0 + 16 * warp + g;   // 8 nt + 2 t + e % 2
    drow[row] = g % 2 ? acc[0][1] : acc[0][0];
    drow[row + 8] = g % 2 ? acc[1][3] : acc[1][2];
  }
}

// dK and dV for 64 KV rows of one (batch, head); the KV tile with the most
// Q tiles after it first
template <int DQ, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, DQ == 64 ? 2 : 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ stats, float* __restrict__ dk,
            float* __restrict__ dv, int H, int S, Args a, float scale,
            float scale_log2) {
  using L = Smem<DQ, DV>;
  constexpr int BN = L::BN;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const uint32_t sbase = smem_addr(sm);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.y * BM;
  const int Sp = padded(S);
  const int nq = (S + BN - 1) / BN, qt0 = CAUSAL ? kv0 / BN : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* qb = q + b * a.q.b + h * a.q.h;
  const float* db = dout + b * a.d.b + h * a.d.h;
  const float* lrow = stats + static_cast<long long>(bh) * Sp;
  const float* drow = lrow + static_cast<long long>(gridDim.x) * Sp;

  load_tile<DQ, BM>(sbase + 4 * L::X, k + b * a.k.b + h * a.k.h, a.k.s, kv0,
                    S);
  load_tile<DV, BM>(sbase + 4 * L::Y, v + b * a.v.b + h * a.v.h, a.v.s, kv0,
                    S);
  auto load_stage = [&](int it) {
    const int buf = it % 2, q0 = (qt0 + it) * BN;
    load_tile<DQ, BN>(sbase + 4 * (L::U + buf * L::TILE_U), qb, a.q.s, q0, S);
    load_tile<DV, BN>(sbase + 4 * (L::W + buf * L::TILE_W), db, a.d.s, q0, S);
    if (threadIdx.x < BN / 2) {       // BN / 4 x 16 bytes of each statistic
      const int plane = threadIdx.x / (BN / 4), part = threadIdx.x % (BN / 4);
      cp16(sbase + 4 * (L::ST + buf * 2 * BN + plane * BN + 4 * part),
           (plane ? drow : lrow) + q0 + 4 * part);
    }
  };
  load_stage(0);
  cp_commit();

  float dka[DQ / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int dn = 0; dn < DQ / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = 0.f;
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[dn][e] = 0.f;
  const float* xs = sm + L::X + 16 * warp * ld(DQ);  // this warp's K rows
  const float* ys = sm + L::Y + 16 * warp * ld(DV);  // and V rows
  const int row = kv0 + 16 * warp + g;               // and row + 8
  const int n = nq - qt0;
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      load_stage(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = it % 2, q0 = (qt0 + it) * BN;
    const float* us = sm + L::U + buf * L::TILE_U;  // Q
    const float* ws = sm + L::W + buf * L::TILE_W;  // dO
    const float* lse2 = sm + L::ST + buf * 2 * BN;
    const float* dl = lse2 + BN;
    float s[BN / 8][4], dp[BN / 8][4];
    xyt<DQ, BN / 8, false>(s, xs, us, g, t);      // Sᵀ = K Qᵀ
    xyt<DV, BN / 8, false>(dp, ys, ws, g, t);     // dPᵀ = V dOᵀ
    // rows are KV rows j, columns Q rows i; Q rows past S read +inf
    const bool edge = CAUSAL && q0 < kv0 + BM;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + e % 2;
        float p = exp2f(fmaf(s[nt][e], scale_log2, -lse2[c]));
        if (edge && q0 + c < row + 8 * (e / 2)) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[c]);
        s[nt][e] = p;
      }
    az<DV, BN>(dva, s, ws, g, t);                 // dV += Pᵀ dO
    az<DQ, BN>(dka, dp, us, g, t);                // dK += dSᵀ Q
    __syncthreads();
  }
  store_rows<DQ>(dk + b * a.dk.b + h * a.dk.h, a.dk, dka, row, t, S, scale);
  store_rows<DV>(dv + b * a.dv.b + h * a.dv.h, a.dv, dva, row, t, S, 1.f);
}

// dQ for 64 Q rows of one (batch, head); the heaviest Q tiles first
template <int DQ, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, DQ == 64 ? 2 : 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ stats, float* __restrict__ dq, int H,
          int S, Args a, float scale, float scale_log2) {
  using L = Smem<DQ, DV>;
  constexpr int BN = L::BN;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const uint32_t sbase = smem_addr(sm);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nqt = (S + BM - 1) / BM;
  const int q0 = (nqt - 1 - blockIdx.y) * BM;
  const int Sp = padded(S);
  int n_kv = (S + BN - 1) / BN;
  if (CAUSAL) n_kv = min(n_kv, (q0 + BM - 1) / BN + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* kb = k + b * a.k.b + h * a.k.h;
  const float* vb = v + b * a.v.b + h * a.v.h;

  load_tile<DQ, BM>(sbase + 4 * L::X, q + b * a.q.b + h * a.q.h, a.q.s, q0,
                    S);
  load_tile<DV, BM>(sbase + 4 * L::Y, dout + b * a.d.b + h * a.d.h, a.d.s,
                    q0, S);
  auto load_stage = [&](int kt) {
    const int buf = kt % 2;
    load_tile<DQ, BN>(sbase + 4 * (L::U + buf * L::TILE_U), kb, a.k.s,
                      kt * BN, S);
    load_tile<DV, BN>(sbase + 4 * (L::W + buf * L::TILE_W), vb, a.v.s,
                      kt * BN, S);
  };
  load_stage(0);
  cp_commit();

  const int row = q0 + 16 * warp + g;             // and row + 8
  // the rows' statistics (rows past S: +inf and 0, so P is 0 there)
  const float* lrow = stats + static_cast<long long>(bh) * Sp;
  const float* drow = lrow + static_cast<long long>(gridDim.x) * Sp;
  const float lse2[2] = {lrow[row], lrow[row + 8]};
  const float dl[2] = {drow[row], drow[row + 8]};
  float dqa[DQ / 8][4];
#pragma unroll
  for (int dn = 0; dn < DQ / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.f;
  const float* xs = sm + L::X + 16 * warp * ld(DQ);  // this warp's Q rows
  const float* ys = sm + L::Y + 16 * warp * ld(DV);  // and dO rows
  for (int kt = 0; kt < n_kv; ++kt) {
    if (kt + 1 < n_kv) {
      load_stage(kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = kt % 2, kv0 = kt * BN;
    const float* us = sm + L::U + buf * L::TILE_U;  // K
    const float* ws = sm + L::W + buf * L::TILE_W;  // V
    float s[BN / 8][4], dp[BN / 8][4];
    xyt<DQ, BN / 8, false>(s, xs, us, g, t);      // S = Q Kᵀ
    // dO Vᵀ with V as B: the cross terms in the order of dkdv's V dOᵀ, so
    // that dP[i][j] is the same bits as dPᵀ[j][i] and as Dᵢ where Oᵢ = Vⱼ
    xyt<DV, BN / 8, true>(dp, ys, ws, g, t);      // dP = dO Vᵀ
    // KV rows past S were read as zeros: masked like the causal cells
    const bool edge = kv0 + BN > S || (CAUSAL && kv0 + BN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, c = kv0 + 8 * nt + 2 * t + e % 2;
        float p = exp2f(fmaf(s[nt][e], scale_log2, -lse2[r]));
        if (edge && (c >= S || (CAUSAL && c > row + 8 * r))) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[r]);
      }
    az<DQ, BN>(dqa, dp, us, g, t);                // dQ += dS K
    __syncthreads();
  }
  store_rows<DQ>(dq + b * a.dq.b + h * a.dq.h, a.dq, dqa, row, t, S, scale);
}

template <int DQ, int DV, bool CAUSAL>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* stats, float* dq,
           float* dk, float* dv, int B, int H, int S, const Args& a,
           float scale, cudaStream_t stream) {
  const int stat_bytes = 2 * 64 * ld(DV) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stat_bytes);
  if (err != cudaSuccess) return err;
  stats_kernel<DV><<<dim3(B * H, padded(S) / 64), THREADS, stat_bytes,
                     stream>>>(o, dout, lse, stats, H, S, a.o, a.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bytes = Smem<DQ, DV>::BYTES;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  auto kv_kernel = dkdv_kernel<DQ, DV, CAUSAL>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<grid, THREADS, bytes, stream>>>(q, k, v, dout, stats, dk, dv,
                                              H, S, a, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kernel = dq_kernel<DQ, DV, CAUSAL>;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, THREADS, bytes, stream>>>(q, k, v, dout, stats, dq, H, S,
                                             a, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace f32k

}  // namespace

// q, k, v, o (K9's output), dout, dq, dk, dv: (B, S, H, Dq) for q, k, dq
// and dk, (B, S, H, Dv) for v, o, dout and dv, with unit stride along the
// head dim; (Dq, Dv) is (64, 64), (128, 128) or (192, 128).  `strides`
// holds the (batch, sequence, head) element strides of q, k, v, o, dout,
// dq, dk and dv, in that order.  lse: K9's row statistic, contiguous f32
// (B, H, S); stats: f32 scratch of 2 · B · H · Sp floats, Sp = S rounded
// up to a multiple of 128.  Three launches on `stream`; returns
// cudaGetLastError() after the last (0 when every one was accepted).
extern "C" int flashattn_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* stats, void* dq,
                                 void* dk, void* dv, int B, int H, int S,
                                 int Dq, int Dv, const long long* strides,
                                 float scale, int causal, void* stream) {
  const Args a(strides);
  auto s = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const float*>(q), K = static_cast<const float*>(k),
       V = static_cast<const float*>(v), O = static_cast<const float*>(o),
       dO = static_cast<const float*>(dout);
  auto L = static_cast<const float*>(lse);
  auto st = static_cast<float*>(stats), dQ = static_cast<float*>(dq),
       dK = static_cast<float*>(dk), dV = static_cast<float*>(dv);
  auto run = [&](auto causal_launch, auto full_launch) {
    return (causal ? causal_launch : full_launch)(Q, K, V, O, dO, L, st, dQ,
                                                  dK, dV, B, H, S, a, scale,
                                                  s);
  };
  if (Dq == 64 && Dv == 64)
    return run(f32k::launch<64, 64, true>, f32k::launch<64, 64, false>);
  if (Dq == 128 && Dv == 128)
    return run(f32k::launch<128, 128, true>, f32k::launch<128, 128, false>);
  if (Dq == 192 && Dv == 128)
    return run(f32k::launch<192, 128, true>, f32k::launch<192, 128, false>);
  return cudaErrorInvalidValue;
}

// As flashattn_bwd_f32, on bf16 tensors (the gradients rounded once to
// bf16; lse and stats stay f32); besides, q, k, v, o and dout must start on
// a 16-byte boundary and their strides be multiples of 8 elements (TMA),
// along dimensions of more than one row.  A negative return is the
// CUresult of building a tensor map, negated.
extern "C" int flashattn_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* stats, void* dq, void* dk, void* dv,
                                  int B, int H, int S, int Dq, int Dv,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  const Args a(strides);
  auto s = static_cast<cudaStream_t>(stream);
  auto L = static_cast<const float*>(lse);
  auto st = static_cast<float*>(stats);
  auto run = [&](auto causal_launch, auto full_launch) {
    return (causal ? causal_launch : full_launch)(q, k, v, o, dout, L, st, dq,
                                                  dk, dv, B, H, S, a, scale,
                                                  s);
  };
  if (Dq == 64 && Dv == 64)
    return run(bf16k::launch<64, 64, true>, bf16k::launch<64, 64, false>);
  if (Dq == 128 && Dv == 128)
    return run(bf16k::launch<128, 128, true>, bf16k::launch<128, 128, false>);
  if (Dq == 192 && Dv == 128)
    return run(bf16k::launch<192, 128, true>, bf16k::launch<192, 128, false>);
  return cudaErrorInvalidValue;
}
