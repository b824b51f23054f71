// Masked matrix products for Hopper (sm_90a):
//
//   sddmm_prep      the exactness flag, bf16 operand copies and the
//                   occupancy of the mask's 128 x 128 tiles, one launch
//                   (K6's and K7's first step)
//   matreduce_tc    Σ_{i,j} mask[i,j] · (lhs @ rhsᵀ)[i,j]   (K6) on the bf16
//                   tensor cores: TMA + wgmma, a reducing epilogue
//   matreduce_f32   the same on f32 FMAs (K6's route for f32 operands the
//                   tensor cores would round)
//   sddmm_tc        out[i,j] = mask[i,j] · (lhs @ rhsᵀ)[i,j]   (K7) on the
//                   bf16 tensor cores, the same mainloop, a storing epilogue
//   sddmm_f32       the same on f32 FMAs (K7's FMA route)
//   matreduce_stack_prep, matreduce_tilelist_tc, matreduce_tilelist_f32
//                   K6 over a stack of 128 x 128 tiles and a list of tile
//                   products per output tile (block-sparse triangles): the
//                   flag and bf16 copy of the stack, then one CTA per output
//                   tile on the tensor cores, or on f32 FMAs
//
// over lhs (M, K), rhs (N, K) and an f32 mask (M, N), each with unit column
// stride and a row stride of its own.  They replace the reference package's
// TPU kernels matreduce (src/repro/kernels/matreduce.py), the fused triangle
// count Σ A ⊙ (A @ A) behind the compiler's Intersect node and, per tile,
// behind the block-sparse triangle count, and sddmm
// (src/repro/kernels/sddmm.py), the wedge-closing product.  K6 never
// writes the (M, N) product out; sddmm writes only its masked cells' values,
// once, in the epilogue.
//
// Port hazard of K6, and what this design does about it: the TPU kernel
// carries ONE f32 scalar through its grid, which runs in order on one core
// ("last value wins").  A CUDA grid runs in parallel, and one f32 scalar
// also rounds once the sum passes 2^24 (a triangle count of 6·T > 2^24 does
// at n = 8192).  Here every thread folds its masked cells into an f64
// register (acc · mask in f64: exact, 24 + 24 mantissa bits), each thread
// block reduces those by a fixed tree and writes ONE f64 into `partials`,
// and the caller sums that buffer in f64.  No atomics: two runs give the
// same bits.  A block whose route is not its own writes a zero partial, so
// the caller sums the tensor-core and FMA launches' partials together
// without knowing which route ran.  K7 has no cross-block state: the TPU
// kernel carries its f32 accumulator over the sequential K steps of the
// grid, and here the K loop runs inside the thread block.
//
// The arithmetic contract of K6 and K7: two routes, chosen on the device by
// the data.
//   exact (the tensor cores): every value of lhs and rhs is a finite
//     integer with |v| <= 256 and K · max|lhs| · max|rhs| <= 2^24.  Then
//     bf16 holds every value, every product is exact, and every f32 partial
//     sum of products is an integer below 2^24, exact in any order: the f32
//     result of the tensor cores equals the f32 product's, bit for bit.  K7
//     multiplies by the mask in f32 as the reference does, K6 in f64.  bf16
//     operands take this route whatever their values (K7 only: K6 reads
//     f32), as the reference's MXU product with an f32 accumulator does.
//   FMA: f32 operands that fail the test; plain f32 fused multiply-adds, no
//     tensor cores and no TF32 (TF32 keeps 10 mantissa bits and rounds
//     counts).
// sddmm_prep writes the flag's inputs to a small int32 state on the card
// (a violation bit, max|lhs| and max|rhs| by integer atomicMax on the
// magnitudes, which is order-free, and a sign bit); the tensor-core and FMA
// kernels both read it and each returns at once when the route is not its
// own, so the host never waits for the flag.  The tensor-core kernel also
// writes the flag to the state for the caller.  Under the exact flag, with
// no operand value of negative sign, a CTA whose 128 x 256 mask tile holds
// no non-zero value (NaN counts as non-zero; two occupancy words of 128 x
// 128) skips its product: acc = 0 is then the exact product up to the sign
// of zero, and acc · mask has the reference's bits (finite operands: 0 ·
// inf = NaN never arises from a skipped tile, whose mask values are all
// ±0).  K6's tile list uses the same flag with K = 128 × its longest list.
//
// What bounds them on this card.  The FMA routes: 2·M·N·K f32 operations
// from (M + N)·K + M·N values (K7 also writes M·N), so the f32 rate outside
// the tensor cores (67 TFLOP/s) for the dense algorithm.  The design is the
// classic register-blocked product: a thread block owns a 128 x 128 output
// tile, stages 8-deep slices of lhs and rhs in shared memory (k-major, so a
// thread reads four neighbouring rows as one 16-byte load), and each of its
// 256 threads keeps an 8 x 8 sub-tile in registers: per k step 4 shared
// loads feed 64 fused multiply-adds.  The mask is read once, in the
// epilogue.  No double buffering.
// The tensor-core kernel: 2·M·N·K bf16 operations on the tensor cores (989
// TFLOP/s), less the skipped tiles'.  One CTA of 384 threads per 128 x 256
// output tile (two occupancy words; 256 columns, not 128, because the
// tensor cores then need half the shared-memory reads of lhs per
// operation, and K7's kernel ran 1.53 instead of 1.86 ms on an H100 80GB
// HBM3 at 700 W for the R-MAT adjacency at n = 8192, chip_smoke.py's K7 row
// in PERF.md), tiles grouped 16 row tiles at a time so that
// CTAs in flight share their lhs and rhs panels in L2.  Warpgroup 0 is
// the producer: after `setmaxnreg` hands its registers on, one thread
// keeps a ring of four k-slices (64 bf16 of 128 rows of lhs and 256 rows
// of rhs, 128-byte swizzle, 48 KB a stage) in flight by TMA, one
// `mbarrier` per stage for arrival and one for release.  Warpgroups 1
// and 2 each own 64 output rows: per slice four
// `wgmma.m64n256k16.f32.bf16.bf16` from shared memory (lhs as A, rhs as a
// K-major B) into 128 f32 accumulators a thread, one slice's group kept
// in flight while the previous one's stage is released.  TMA zero-fills
// ragged M, N and K.  The epilogue is a template argument of the mainloop:
// MaskedStore (K7: acc · mask, written once) or MaskedReduce (K6: acc ·
// mask folded in f64 per thread, a shuffle tree per warp, the eight warp
// sums added in order by one thread after a named barrier over the 256
// consumer threads — the producer warpgroup has left, so __syncthreads
// would wait for it forever).  So is the schedule: Dense walks the K of one
// output tile; TileList walks a list of tile products, two 64-wide
// k-slices a tile, its boxes read from one 2-D map over the (T·128, 128)
// bf16 stack at row tile · 128, with an N = 128 instance of the mainloop
// (`wgmma.m64n128k16`, 64 accumulators a thread, six stages of 32 KB).  On
// the R-MAT adjacency's tiles that is 0.73 TFLOP of tile products in one
// launch, where a launch per output tile with a host sync each took
// seconds.  Left: a CTA per tile, so a tile's epilogue does not overlap the
// next tile's loads.  sddmm_prep reads lhs, rhs (once when they are the
// same tensor) and the mask once and writes the bf16 copies: bound by those
// bytes.  On operands that fail the test, its operand blocks stop once the
// violation bit is set (the copies are then of no use), so the FMA route
// pays little more than the mask's read before its product.
//
// Ragged edges are masked in the loads and the epilogues.  Launches go to
// the stream the caller passes and never synchronise.  Plain C interface,
// loaded with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 128      // output rows and columns per thread block
#define DEPTH 8       // k per shared-memory slice (FMA template)
#define THREADS 256   // 16 x 16 threads, 8 x 8 cells each (FMA template)

// The flag's state on the card (int32): what sddmm_prep found, the flag,
// then one occupancy word per 128 x 128 output tile, row-major over the
// tiles
#define ST_BAD 0      // a value that is not a finite integer with |v| <= 256
#define ST_MAXL 1     // max |lhs| (257 for a bad value)
#define ST_MAXR 2     // max |rhs|
#define ST_NEG 3      // a value with its sign bit set
#define ST_EXACT 4    // the flag, written by the tensor-core kernel
#define ST_HEAD 8     // the first occupancy word
#define EXACT_VALUE 256
#define EXACT_SUM (1 << 24)

__device__ __forceinline__ bool sddmm_exact(const int* st, int K, int same)
{
    if (st[ST_BAD]) return false;
    const long long l = st[ST_MAXL], r = same ? l : st[ST_MAXR];
    return (long long)K * l * r <= EXACT_SUM;
}

// -- the f32 FMA template: K6's and K7's FMA routes, K6's tile list ----------------

// c += the 128 x 128 tile at (m0, n0) of lhs @ rhsᵀ over k in [0, K), in
// 8-deep slices staged in As / Bs
__device__ __forceinline__ void fma_tile(float (&c)[8][8],
                                         float (&As)[DEPTH][TILE],
                                         float (&Bs)[DEPTH][TILE],
                                         const float* __restrict__ lhs,
                                         const float* __restrict__ rhs,
                                         int M, int N, int K, long long lda,
                                         long long ldb, int m0, int n0)
{
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    // what this thread loads per slice: 4 consecutive k of one row
    const int lr = tid / 2, lk = (tid % 2) * 4;
    for (int k0 = 0; k0 < K; k0 += DEPTH) {
        {
            const int row = m0 + lr, col = n0 + lr;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int k = k0 + lk + q;
                As[lk + q][lr] = (row < M && k < K)
                    ? lhs[(size_t)row * lda + k] : 0.0f;
                Bs[lk + q][lr] = (col < N && k < K)
                    ? rhs[(size_t)col * ldb + k] : 0.0f;
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DEPTH; ++k) {
            const float4 a0 = *(const float4*)&As[k][ty * 4];
            const float4 a1 = *(const float4*)&As[k][64 + ty * 4];
            const float4 b0 = *(const float4*)&Bs[k][tx * 4];
            const float4 b1 = *(const float4*)&Bs[k][64 + tx * 4];
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    c[i][j] = fmaf(a[i], b[j], c[i][j]);
        }
        __syncthreads();
    }
}

// K6's FMA epilogue: the thread's cells of the tile at (m0, n0) times the
// mask, each product in f64, folded per thread, then by a fixed tree
// (shuffles within a warp, thread 0 adding the warp sums in order).  The
// block's sum, valid in thread 0.
__device__ __forceinline__ double fma_masked_sum(const float (&c)[8][8],
                                                 const float* __restrict__ mask,
                                                 long long ldm, int M, int N,
                                                 int m0, int n0)
{
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (row >= M) continue;
        const float* mrow = mask + (size_t)row * ldm;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            if (col < N) acc += (double)c[i][j] * (double)mrow[col];
        }
    }
    __shared__ double warp_sum[THREADS / 32];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, d);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
    __syncthreads();
    double total = 0.0;
    if (tid == 0) {
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
    }
    return total;
}

// WRITE = false: K6, one f64 partial per thread block into `partials`.
// WRITE = true:  K7, the masked product into `out` (row stride ldo).
// With a state, the kernel returns at once when that state's flag says the
// tensor-core route took the product (K6's blocks first write a zero
// partial).
template <bool WRITE>
__global__ void __launch_bounds__(THREADS)
masked_product_kernel(const float* __restrict__ lhs,
                      const float* __restrict__ rhs,
                      const float* __restrict__ mask, int M, int N, int K,
                      long long lda, long long ldb, long long ldm,
                      double* __restrict__ partials, float* __restrict__ out,
                      long long ldo, const int* __restrict__ state, int same)
{
    const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    if (state != nullptr && sddmm_exact(state, K, same)) {
        if (!WRITE && threadIdx.x == 0) partials[block] = 0.0;
        return;
    }
    __shared__ __align__(16) float As[DEPTH][TILE];
    __shared__ __align__(16) float Bs[DEPTH][TILE];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;

    float c[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
    fma_tile(c, As, Bs, lhs, rhs, M, N, K, lda, ldb, m0, n0);

    if constexpr (WRITE) {
        // epilogue of K7: each cell times its mask value, written once
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
            if (row >= M) continue;
            const float* mrow = mask + (size_t)row * ldm;
            float* orow = out + (size_t)row * ldo;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
                if (col < N) orow[col] = c[i][j] * mrow[col];
            }
        }
        return;
    }

    const double total = fma_masked_sum(c, mask, ldm, M, N, m0, n0);
    if (tid == 0) partials[block] = total;
}

template <bool WRITE>
static int launch(const void* lhs, const void* rhs, const void* mask, int M,
                  int N, int K, long long lda, long long ldb, long long ldm,
                  void* partials, void* out, long long ldo, const void* state,
                  int same, void* stream)
{
    if (M < 1 || N < 1 || K < 0 || lda < K || ldb < K || ldm < N
            || (WRITE && ldo < N))
        return (int)cudaErrorInvalidValue;
    const unsigned gx = (unsigned)((N + TILE - 1) / TILE);
    const unsigned gy = (unsigned)((M + TILE - 1) / TILE);
    if (gy > 65535u) return (int)cudaErrorInvalidValue;
    masked_product_kernel<WRITE>
        <<<dim3(gx, gy), THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)lhs, (const float*)rhs, (const float*)mask, M, N, K,
            lda, ldb, ldm, (double*)partials, (float*)out, ldo,
            (const int*)state, same);
    return (int)cudaGetLastError();
}

// K6's tile list on f32 FMAs: block o sums, over its list p in
// [k_ptr[o], k_ptr[o + 1]), the products of the 128 x 128 tiles
// stack[lhs_idx[p]] @ stack[rhs_idx[p]]ᵀ, masks them with stack[out_idx[o]]
// and writes one f64 partial.  It returns at once (a zero partial) when the
// state's flag says the tensor-core launch took the list.
__global__ void __launch_bounds__(THREADS, 1)
tilelist_fma_kernel(const float* __restrict__ stack,
                    const int* __restrict__ out_idx,
                    const int* __restrict__ k_ptr,
                    const int* __restrict__ lhs_idx,
                    const int* __restrict__ rhs_idx, int kflag,
                    double* __restrict__ partials,
                    const int* __restrict__ state)
{
    const int o = blockIdx.x;
    if (sddmm_exact(state, kflag, 1)) {
        if (threadIdx.x == 0) partials[o] = 0.0;
        return;
    }
    __shared__ __align__(16) float As[DEPTH][TILE];
    __shared__ __align__(16) float Bs[DEPTH][TILE];
    const size_t cells = (size_t)TILE * TILE;
    float c[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;
    for (int p = k_ptr[o]; p < k_ptr[o + 1]; ++p)
        fma_tile(c, As, Bs, stack + lhs_idx[p] * cells,
                 stack + rhs_idx[p] * cells, TILE, TILE, TILE, TILE, TILE, 0,
                 0);
    const double total = fma_masked_sum(c, stack + out_idx[o] * cells, TILE,
                                        TILE, TILE, 0, 0);
    if (threadIdx.x == 0) partials[o] = total;
}

// -- sddmm_prep ---------------------------------------------------------------------

#define PREP_THREADS 256
#define PREP_ROWS 4           // operand rows per prep block

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x)
{
    return __bfloat162float(x);
}

// the largest of every thread's `v`, valid in thread 0
__device__ __forceinline__ unsigned block_max(unsigned v)
{
    __shared__ unsigned warp_max[PREP_THREADS / 32];
    v = __reduce_max_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < PREP_THREADS / 32; ++w) v = max(v, warp_max[w]);
    return v;
}

// rows [row0, row0 + PREP_ROWS) of one operand: the exactness test of each
// value, and its bf16 copy where `dst` is given.  Once a value fails the
// test the flag is false, and the copies and maxima are of no use: a block
// that finds the violation bit set when it starts leaves at once, and a
// block stops after the first row that fails.
template <typename T>
__device__ void prep_rows(const T* __restrict__ x, long long ld, int rows,
                          int K, int row0, __nv_bfloat16* __restrict__ dst,
                          long long ldc, int* state, int max_slot)
{
    __shared__ int failed;
    if (threadIdx.x == 0) failed = *(volatile int*)(state + ST_BAD);
    __syncthreads();
    if (failed) return;
    int bad = 0, neg = 0;
    unsigned mag = 0;
    const int end = min(row0 + PREP_ROWS, rows);
    for (int r = row0; r < end && !bad; ++r) {
        const T* src = x + (size_t)r * ld;
#pragma unroll 4
        for (int k = threadIdx.x; k < K; k += PREP_THREADS) {
            const float v = as_float(src[k]);
            if (dst != nullptr) dst[(size_t)r * ldc + k] = __float2bfloat16_rn(v);
            const float a = fabsf(v);
            // false for NaN, and for inf (> 256)
            const bool ok = a <= (float)EXACT_VALUE && v == rintf(v);
            bad |= !ok;
            mag = max(mag, ok ? (unsigned)a : (unsigned)EXACT_VALUE + 1);
            neg |= (int)(__float_as_uint(v) >> 31);
        }
        bad = __syncthreads_or(bad);
    }
    neg = __syncthreads_or(neg);
    mag = block_max(mag);
    if (threadIdx.x == 0) {
        if (bad) atomicOr(state + ST_BAD, 1);
        if (neg) atomicOr(state + ST_NEG, 1);
        if (mag) atomicMax(state + max_slot, (int)mag);
    }
}

// one 128 x 128 tile of the mask: its occupancy word, 1 when any value is
// non-zero (NaN included)
__device__ void prep_tile(const float* __restrict__ mask, long long ldm, int M,
                          int N, int tile, int* state)
{
    const int n_tn = (N + TILE - 1) / TILE;
    const int r0 = (tile / n_tn) * TILE, j = (tile % n_tn) * TILE
                   + threadIdx.x % TILE;
    const int r_end = min(r0 + TILE, M);
    int any = 0;
    if (j < N) {
#pragma unroll 8
        for (int r = r0 + threadIdx.x / TILE; r < r_end;
             r += PREP_THREADS / TILE)
            any |= __ldg(mask + (size_t)r * ldm + j) != 0.0f;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) state[ST_HEAD + tile] = any;
}

struct PrepArgs {
    const void* lhs;
    const void* rhs;
    const float* mask;
    int M, N, K;
    long long lda, ldb, ldm;
    __nv_bfloat16* lhs16;   // the copies (f32 operands), row stride ldc
    __nv_bfloat16* rhs16;
    long long ldc;
    int* state;
    int lhs_blocks, rhs_blocks;   // blocks: lhs rows, rhs rows, mask tiles
};

template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(PrepArgs p)
{
    const int b = blockIdx.x;
    if (b < p.lhs_blocks)
        prep_rows<T>((const T*)p.lhs, p.lda, p.M, p.K, b * PREP_ROWS, p.lhs16,
                     p.ldc, p.state, ST_MAXL);
    else if (b < p.lhs_blocks + p.rhs_blocks)
        prep_rows<T>((const T*)p.rhs, p.ldb, p.N, p.K,
                     (b - p.lhs_blocks) * PREP_ROWS, p.rhs16, p.ldc, p.state,
                     ST_MAXR);
    else
        prep_tile(p.mask, p.ldm, p.M, p.N, b - p.lhs_blocks - p.rhs_blocks,
                  p.state);
}


// -- the tensor-core kernel: TMA + wgmma ----------------------------------------------
// The mbarrier, TMA and wgmma helpers follow csrc/flashattn.cu's.

namespace tc {

constexpr int BM = 128;             // output rows per CTA: 2 consumers x 64
constexpr int BK = 64;              // k per stage: one 128-byte swizzled row
constexpr int CTA_THREADS = 384;    // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;      // threads that release a stage
constexpr int PRODUCERS = CTA_THREADS - CONSUMERS;
constexpr int ROW_BYTES = 128;
constexpr int GROUP_M = 16;         // row tiles swept together (L2 reuse)
constexpr int A_BYTES = BM * ROW_BYTES;
static_assert(BM == TILE, "whole occupancy words, whole tiles of a stack");

// an instance with BN output columns a CTA (wgmma's N): its ring of stages
template <int BN>
struct Plan {
  static constexpr int STAGES = BN == 256 ? 4 : 6;   // k-slices in flight
  static constexpr int STAGE_BYTES = A_BYTES + BN * ROW_BYTES;
  static constexpr int BARS = STAGES * STAGE_BYTES;  // 2 · STAGES mbarriers
  static constexpr int SMEM = BARS + 8 * 2 * STAGES + 1024;
  static constexpr int ACC = BN / 2;                 // f32 accumulators a thread
  static constexpr int WORDS = BN / TILE;            // occupancy words a CTA
  static_assert(SMEM <= 232448, "a block's shared memory on Hopper");
  static_assert(BN % TILE == 0, "whole occupancy words");
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

// one box of a 2-D tensor map at (c0, c1), innermost first, into shared
// memory at `dst`; completion counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: start
// address, leading byte offset (unused), stride byte offset (between
// groups of 8 rows: 8 x 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
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
template <int ACC>
__device__ __forceinline__ void reg_fence(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define REGS128                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (64 x 256, f32) += A B: A (64 x 16) and B (16 x 256, K-major) from
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
        ACC8(104), ACC8(112), ACC8(120)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A B: A (64 x 16) and B (16 x 128, K-major) from
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b), "r"(1));
}

struct Args {
  int K;        // the flag's K: the length of the longest sum of products
  int* state;
  int gate;     // f32 operands: run only under the exact flag
  int same;     // lhs and rhs are one tensor (one maximum)
};

// what one CTA computes: `n_k` k-slices (none when `skip`) into the output
// tile whose first row and column are `row0`, `col0` (the epilogue's
// coordinates); `p0` the first entry of a tile list
struct Work {
  int n_k;
  bool skip;
  int row0, col0, p0;
};

// lhs (M, K) @ rhs (N, K)ᵀ: one 128 x BN output tile a CTA, in groups of
// GROUP_M row tiles, column by column inside a group.  Under the exact
// flag, with no operand of negative sign, a tile whose occupancy words
// are all 0 is skipped.
struct Dense {
  int M, N, K;

  template <int BN>
  __device__ Work work(const int* state, bool exact) const {
    const int n_tm = (M + BM - 1) / BM, n_tn = (N + BN - 1) / BN;
    const int per_group = GROUP_M * n_tn;
    const int first = (blockIdx.x / per_group) * GROUP_M;
    const int rows_in_group = min(n_tm - first, GROUP_M);
    const int in_group = blockIdx.x % per_group;
    const int tm = first + in_group % rows_in_group;
    const int tn = in_group / rows_in_group;
    // the tile's occupancy words, 128 columns each
    const int words = (N + TILE - 1) / TILE;
    bool skip = exact && !state[ST_NEG];
#pragma unroll
    for (int c = 0; c < Plan<BN>::WORDS; ++c) {
      const int w = tn * Plan<BN>::WORDS + c;
      skip = skip && (w >= words || state[ST_HEAD + tm * words + w] == 0);
    }
    return {(K + BK - 1) / BK, skip, tm * BM, tn * BN, 0};
  }

  // slice kt's boxes: (k, row) of lhs, then of rhs
  __device__ int4 slice(const Work& w, int kt) const {
    return make_int4(kt * BK, w.row0, kt * BK, w.col0);
  }
};

// K6's tile list over a stack of 128 x 128 tiles, one 2-D map over its
// (T·128, 128) rows: CTA o sums, over p in [k_ptr[o], k_ptr[o + 1]),
// stack[lhs_idx[p]] @ stack[rhs_idx[p]]ᵀ, two 64-wide k-slices a tile, and
// hands the sum to the epilogue at the rows of stack[out_idx[o]].
struct TileList {
  const int* out_idx;
  const int* k_ptr;
  const int* lhs_idx;
  const int* rhs_idx;

  static constexpr int SLICES = TILE / BK;

  template <int BN>
  __device__ Work work(const int*, bool) const {
    static_assert(BN == TILE, "one output tile a CTA");
    const int o = blockIdx.x, p0 = k_ptr[o];
    return {SLICES * (k_ptr[o + 1] - p0), false, out_idx[o] * TILE, 0, p0};
  }

  __device__ int4 slice(const Work& w, int kt) const {
    const int p = w.p0 + kt / SLICES, k = (kt % SLICES) * BK;
    return make_int4(k, lhs_idx[p] * TILE, k, rhs_idx[p] * TILE);
  }
};

// K7: acc · mask, written once.  Thread t of a consumer warpgroup holds
// rows `row` and `row + 8`, columns col + 8 g + {0, 1} for g < BN / 8 (the
// wgmma accumulator layout: d[4 g + 2 r + e] is row + 8 r, column col +
// 8 g + e)
struct MaskedStore {
  const float* mask;
  long long ldm;
  float* out;
  long long ldo;
  int M, N;

  __device__ __forceinline__ void refused() const {}

  template <int ACC>
  __device__ __forceinline__ void operator()(const float (&d)[ACC], int row,
                                             int col) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      if (i >= M) continue;
      const float* mrow = mask + (size_t)i * ldm;
      float* orow = out + (size_t)i * ldo;
#pragma unroll
      for (int g = 0; g < ACC / 4; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col + 8 * g + e;
          if (j < N) orow[j] = d[4 * g + 2 * r + e] * __ldg(mrow + j);
        }
    }
  }
};

// K6: Σ acc · mask over the CTA's tile, one f64 into partials[blockIdx.x].
// Each thread folds its cells' products in f64 (exact: 24 + 24 mantissa
// bits), each warp by a fixed shuffle tree, then the first consumer thread
// adds the eight warp sums in order, after a named barrier over the 256
// consumer threads (the producer warpgroup has left).  A CTA the gate
// refuses writes 0.
struct MaskedReduce {
  const float* mask;
  long long ldm;
  double* partials;
  int M, N;

  __device__ __forceinline__ void refused() const {
    if (threadIdx.x == 0) partials[blockIdx.x] = 0.0;
  }

  template <int ACC>
  __device__ __forceinline__ void operator()(const float (&d)[ACC], int row,
                                             int col) const {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      if (i >= M) continue;
      const float* mrow = mask + (size_t)i * ldm;
#pragma unroll
      for (int g = 0; g < ACC / 4; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col + 8 * g + e;
          if (j < N)
            s += (double)d[4 * g + 2 * r + e] * (double)__ldg(mrow + j);
        }
    }
    __shared__ double warp_sum[CONSUMERS / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    const int t = threadIdx.x - PRODUCERS;
    if ((t & 31) == 0) warp_sum[t >> 5] = s;
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    if (t == 0) {
      double total = 0.0;
#pragma unroll
      for (int w = 0; w < CONSUMERS / 32; ++w) total += warp_sum[w];
      partials[blockIdx.x] = total;
    }
  }
};

// The schedule's products for one CTA, handed to `epi` in the accumulator
// layout; a skipped tile hands over acc = 0
template <int BN, class Sched, class Epi>
__global__ void __launch_bounds__(CTA_THREADS, 1)
product_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, Args a, Sched sched,
               Epi epi) {
  using P = Plan<BN>;
  const bool exact = sddmm_exact(a.state, a.K, a.same);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.state[ST_EXACT] = exact;
  if (a.gate && !exact) {                 // the whole CTA, before any barrier
    epi.refused();
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  auto full = [&](int s) { return base + P::BARS + 8 * s; };
  auto empty = [&](int s) { return base + P::BARS + 8 * (P::STAGES + s); };

  const Work w = sched.template work<BN>(a.state, exact);
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0 && !w.skip) {
      for (int kt = 0; kt < w.n_k; ++kt) {
        const int4 c = sched.slice(w, kt);   // in flight during the wait
        const int s = kt % P::STAGES;
        bar_wait(empty(s), ((kt / P::STAGES) & 1) ^ 1);
        bar_expect(full(s), P::STAGE_BYTES);
        tma_load(base + s * P::STAGE_BYTES, &ta, full(s), c.x, c.y);
        tma_load(base + s * P::STAGE_BYTES + A_BYTES, &tb, full(s), c.z,
                 c.w);
      }
    }
  } else {
    // consumer: 64 output rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = group - 1, t = threadIdx.x % 128, lane = t % 32;
    float d[P::ACC];
#pragma unroll
    for (int i = 0; i < P::ACC; ++i) d[i] = 0.f;
    if (!w.skip) {
      for (int kt = 0; kt < w.n_k; ++kt) {
        const int s = kt % P::STAGES;
        const uint32_t as = base + s * P::STAGE_BYTES + cw * 64 * ROW_BYTES;
        const uint32_t bs = base + s * P::STAGE_BYTES + A_BYTES;
        bar_wait(full(s), (kt / P::STAGES) & 1);
        reg_fence(d);
        wg_fence();
        // k-steps of 16 columns: 32 bytes inside a 128-byte box row
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss(d, sw128_desc(as + kk * 32), sw128_desc(bs + kk * 32));
        wg_commit();
        wg_wait<1>();                        // slice kt - 1 has landed
        reg_fence(d);
        if (kt > 0) bar_arrive(empty((kt - 1) % P::STAGES));
      }
      wg_wait<0>();
      reg_fence(d);
    }
    epi(d, w.row0 + 64 * cw + 16 * (t / 32) + lane / 4,
        w.col0 + 2 * (lane % 4));
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

// a 2-D map over (K, rows) of a bf16 (rows, K) operand with row stride ld
// elements, boxes of 64 k x box_rows rows, 128-byte swizzle, zeros past the
// edges.  Returns 0 or the CUresult, negated.
int make_map(CUtensorMap* map, const void* x, int rows, int K, long long ld,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * 2)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

template <int BN, class Sched, class Epi>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, long long ctas,
           Args args, Sched sched, Epi epi, cudaStream_t stream) {
  if (ctas < 1 || ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = product_kernel<BN, Sched, Epi>;
  const int err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<BN>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)ctas, CTA_THREADS, Plan<BN>::SMEM, stream>>>(
      ta, tb, args, sched, epi);
  return cudaGetLastError();
}

// lhs (M, K) @ rhs (N, K)ᵀ in 128 x 256 tiles, handed to `epi`
template <class Epi>
int launch_dense(const void* lhs, long long lda, const void* rhs,
                 long long ldb, int M, int N, int K, int* state, int gate,
                 int same, Epi epi, cudaStream_t stream) {
  constexpr int BN = 256;
  CUtensorMap ta, tb;
  int err = make_map(&ta, lhs, M, K, lda, BM);
  if (err == 0) err = make_map(&tb, rhs, N, K, ldb, BN);
  if (err != 0) return err;
  const long long ctas = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return launch<BN>(ta, tb, ctas, Args{K, state, gate, same},
                    Dense{M, N, K}, epi, stream);
}

}  // namespace tc

// the stack's rows for the tile-list entries: checked by the caller
static bool stack_args_ok(int rows, int n_out, int kflag)
{
    return rows >= TILE && rows % TILE == 0 && n_out >= 1 && kflag >= 1;
}

extern "C" {

int matreduce_tile() { return TILE; }
int matreduce_tc_columns() { return 256; }
int sddmm_state_head() { return ST_HEAD; }
int sddmm_exact_slot() { return ST_EXACT; }

// K6's first launch is sddmm_prep (below).  Its second, on the tensor
// cores: a, b as sddmm_tc takes them; mask f32 (M, N), row stride ldm;
// partials: ceil(M / 128) * ceil(N / 256) doubles, one per CTA; gate: 1
// for f32 operands (the CTAs write 0 and return unless the exact flag
// holds).  A negative return is the CUresult of building a tensor map,
// negated.
int matreduce_tc(const void* a, long long lda, const void* b, long long ldb,
                 const void* mask, long long ldm, void* partials, int M,
                 int N, int K, void* state, int gate, int same, void* stream)
{
    if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || lda % 8 || ldb % 8
        || ldm < N || ((uintptr_t)a & 15) || ((uintptr_t)b & 15))
        return (int)cudaErrorInvalidValue;
    tc::MaskedReduce epi{(const float*)mask, ldm, (double*)partials, M, N};
    return tc::launch_dense(a, lda, b, ldb, M, N, K, (int*)state, gate, same,
                            epi, (cudaStream_t)stream);
}

// K6's third launch, on f32 FMAs: `partials` holds ceil(N / TILE) *
// ceil(M / TILE) doubles; with a state, every block writes 0 and returns
// when its exact flag holds.
int matreduce_f32(const void* lhs, const void* rhs, const void* mask,
                  int M, int N, int K, long long lda, long long ldb,
                  long long ldm, void* partials, const void* state, int same,
                  void* stream)
{
    return launch<false>(lhs, rhs, mask, M, N, K, lda, ldb, ldm, partials,
                         nullptr, 0, state, same, stream);
}

// K7's first launch, and K6's.  lhs, rhs: f32 (bf16 = 0) or bf16 (bf16 =
// 1), row strides lda, ldb; same: lhs and rhs are one tensor (read once);
// f32 operands are copied to bf16 at lhs16 / rhs16 (row stride ldc; rhs16
// is not written when same); state: sddmm_state_head() + tiles int32,
// zeroed by the caller, tiles = ceil(M / 128) * ceil(N / 128).
int sddmm_prep(const void* lhs, const void* rhs, const void* mask, int M,
               int N, int K, long long lda, long long ldb, long long ldm,
               int bf16, int same, void* lhs16, void* rhs16, long long ldc,
               void* state, void* stream)
{
    if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || ldm < N
        || (!bf16 && ldc < K) || (same && M != N))
        return (int)cudaErrorInvalidValue;
    PrepArgs p;
    p.lhs = lhs; p.rhs = rhs; p.mask = (const float*)mask;
    p.M = M; p.N = N; p.K = K; p.lda = lda; p.ldb = ldb; p.ldm = ldm;
    p.lhs16 = bf16 ? nullptr : (__nv_bfloat16*)lhs16;
    p.rhs16 = bf16 ? nullptr : (__nv_bfloat16*)rhs16;
    p.ldc = ldc; p.state = (int*)state;
    const long long tiles = (long long)((M + TILE - 1) / TILE)
                            * ((N + TILE - 1) / TILE);
    const long long lb = (M + PREP_ROWS - 1) / PREP_ROWS;
    const long long rb = same ? 0 : (N + PREP_ROWS - 1) / PREP_ROWS;
    if (tiles + lb + rb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.lhs_blocks = (int)lb; p.rhs_blocks = (int)rb;
    const unsigned grid = (unsigned)(tiles + lb + rb);
    if (bf16)
        prep_kernel<__nv_bfloat16><<<grid, PREP_THREADS, 0,
                                     (cudaStream_t)stream>>>(p);
    else
        prep_kernel<float><<<grid, PREP_THREADS, 0,
                             (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// K7 on the tensor cores.  a, b: bf16 (M, K) and (N, K) with unit column
// stride, a 16-byte aligned start and row strides lda, ldb that are
// multiples of 8 (TMA); mask: f32 (M, N), row stride ldm; out: f32, row
// stride ldo; state: as sddmm_prep left it; gate: 1 for f32 operands (the
// kernel returns at once unless the exact flag holds).  A negative return
// is the CUresult of building a tensor map, negated.
int sddmm_tc(const void* a, long long lda, const void* b, long long ldb,
             const void* mask, long long ldm, void* out, long long ldo, int M,
             int N, int K, void* state, int gate, int same, void* stream)
{
    if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || lda % 8 || ldb % 8
        || ldm < N || ldo < N || ((uintptr_t)a & 15) || ((uintptr_t)b & 15))
        return (int)cudaErrorInvalidValue;
    tc::MaskedStore epi{(const float*)mask, ldm, (float*)out, ldo, M, N};
    return tc::launch_dense(a, lda, b, ldb, M, N, K, (int*)state, gate, same,
                            epi, (cudaStream_t)stream);
}

// K7 on f32 FMAs: `out` is an f32 (M, N) buffer with row stride ldo >= N;
// returns at once on the card when `state`'s exact flag holds.
int sddmm_f32(const void* lhs, const void* rhs, const void* mask, int M,
              int N, int K, long long lda, long long ldb, long long ldm,
              void* out, long long ldo, const void* state, int same,
              void* stream)
{
    return launch<true>(lhs, rhs, mask, M, N, K, lda, ldb, ldm, nullptr, out,
                        ldo, state, same, stream);
}

// K6's tile list, first launch: the exactness flag's inputs of an f32
// stack read as (rows, K) with row stride ld (any view of its values: the
// test is per value), and its bf16 copy (row stride ldc); state:
// sddmm_state_head() int32, zeroed by the caller.  No occupancy words.
int matreduce_stack_prep(const void* x, int rows, int K, long long ld,
                         void* x16, long long ldc, void* state, void* stream)
{
    if (rows < 1 || K < 1 || ld < K || ldc < K)
        return (int)cudaErrorInvalidValue;
    PrepArgs p;
    p.lhs = x; p.rhs = x; p.mask = nullptr;
    p.M = rows; p.N = rows; p.K = K; p.lda = ld; p.ldb = ld; p.ldm = 0;
    p.lhs16 = (__nv_bfloat16*)x16; p.rhs16 = nullptr;
    p.ldc = ldc; p.state = (int*)state;
    const long long lb = (rows + PREP_ROWS - 1) / PREP_ROWS;
    if (lb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.lhs_blocks = (int)lb; p.rhs_blocks = 0;
    prep_kernel<float><<<(unsigned)lb, PREP_THREADS, 0,
                         (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// K6's tile list on the tensor cores: x16, the bf16 copy of the stack as
// (rows, 128) with row stride 128 (rows = 128 · tiles, 16-byte aligned);
// stack, the f32 stack (the masks); out_idx (n_out), k_ptr (n_out + 1),
// lhs_idx and rhs_idx (k_ptr[n_out]): int32 on the card, every index a
// tile of the stack; kflag: 128 × the longest list; partials: n_out
// doubles; state: as matreduce_stack_prep left it.  Gated: a CTA writes 0
// and returns unless the exact flag holds.
int matreduce_tilelist_tc(const void* x16, int rows, const void* stack,
                          const void* out_idx, const void* k_ptr,
                          const void* lhs_idx, const void* rhs_idx,
                          int n_out, int kflag, void* partials, void* state,
                          void* stream)
{
    if (!stack_args_ok(rows, n_out, kflag) || ((uintptr_t)x16 & 15))
        return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    const int err = tc::make_map(&map, x16, rows, TILE, TILE, TILE);
    if (err != 0) return err;
    tc::MaskedReduce epi{(const float*)stack, TILE, (double*)partials, rows,
                         TILE};
    tc::TileList list{(const int*)out_idx, (const int*)k_ptr,
                      (const int*)lhs_idx, (const int*)rhs_idx};
    return tc::launch<TILE>(map, map, n_out, tc::Args{kflag, (int*)state, 1, 1},
                            list, epi, (cudaStream_t)stream);
}

// K6's tile list on f32 FMAs, the same arguments less the bf16 copy;
// every block writes 0 and returns when the state's exact flag holds.
int matreduce_tilelist_f32(const void* stack, int rows, const void* out_idx,
                           const void* k_ptr, const void* lhs_idx,
                           const void* rhs_idx, int n_out, int kflag,
                           void* partials, const void* state, void* stream)
{
    if (!stack_args_ok(rows, n_out, kflag))
        return (int)cudaErrorInvalidValue;
    tilelist_fma_kernel<<<(unsigned)n_out, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float*)stack, (const int*)out_idx, (const int*)k_ptr,
        (const int*)lhs_idx, (const int*)rhs_idx, kflag, (double*)partials,
        (const int*)state);
    return (int)cudaGetLastError();
}

}  // extern "C"
