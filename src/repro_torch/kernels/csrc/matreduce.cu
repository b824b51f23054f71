// Masked matrix products for Hopper (sm_90a), one template, two epilogues:
//
//   matreduce_f32   Σ_{i,j} mask[i,j] · (lhs @ rhsᵀ)[i,j]      (K6)
//   sddmm_f32       out[i,j] = mask[i,j] · (lhs @ rhsᵀ)[i,j]   (K7)
//   sddmm_bf16      the same with bf16 lhs and rhs, widened to f32 at load
//
// over lhs (M, K), rhs (N, K) and an f32 mask (M, N), each with unit column
// stride and a row stride of its own.  They replace the reference package's
// TPU kernels matreduce (src/repro/kernels/matreduce.py), the fused triangle
// count Σ A ⊙ (A @ A) behind the compiler's Intersect node, and sddmm
// (src/repro/kernels/sddmm.py), the wedge-closing product.  matreduce never
// writes the (M, N) product out; sddmm writes only its masked cells' values,
// once, in the epilogue.
//
// Port hazard of K6, and what this design does about it: the TPU kernel
// carries ONE f32 scalar through its grid, which runs in order on one core
// ("last value wins").  A CUDA grid runs in parallel, and one f32 scalar
// also rounds once the sum passes 2^24 (a triangle count of 6·T > 2^24 does
// at n = 8192).  Here every thread folds its masked cells into an f64
// register, each thread block reduces those by a fixed tree and writes ONE
// f64 into `partials`, and the caller sums that buffer in f64.  No atomics:
// two runs give the same bits.  K7 has no cross-block state: the TPU kernel
// carries its f32 accumulator over the sequential K steps of the grid, and
// here the K loop runs inside the thread block.
//
// Arithmetic: the product is plain f32 fused multiply-adds on the CUDA
// cores, no tensor cores and no TF32 (TF32 keeps 10 mantissa bits and is
// inexact on counts).  For 0/1 inputs every product cell is an integer at
// most K, exact in f32 while K <= 2^24; K6 takes cell times mask in f64,
// K7 in f32 as the reference does (exact for a 0/1 mask).
//
// What bounds them on this card: 2·M·N·K f32 operations from (M + N)·K +
// M·N values (K7 also writes M·N), so operations for the dense algorithm.
// The design is the classic register-blocked product: a thread block owns a
// 128 x 128 output tile, stages 8-deep slices of lhs and rhs in shared
// memory (k-major, so a thread reads four neighbouring rows as one 16-byte
// load), and each of its 256 threads keeps an 8 x 8 sub-tile in registers:
// per k step 4 shared loads feed 64 fused multiply-adds.  The mask is read
// once, in the epilogue.  Ragged edges are masked in the loads and the
// epilogue; nothing is padded or copied.  There is no double buffering yet.
//
// Launches go to the stream the caller passes and never synchronise.
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define TILE 128      // output rows and columns per thread block
#define DEPTH 8       // k per shared-memory slice
#define THREADS 256   // 16 x 16 threads, 8 x 8 cells each

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x)
{
    return __bfloat162float(x);
}

// WRITE = false: K6, one f64 partial per thread block into `partials`.
// WRITE = true:  K7, the masked product into `out` (row stride ldo).
template <typename T, bool WRITE>
__global__ void __launch_bounds__(THREADS)
masked_product_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                      const float* __restrict__ mask, int M, int N, int K,
                      long long lda, long long ldb, long long ldm,
                      double* __restrict__ partials, float* __restrict__ out,
                      long long ldo)
{
    __shared__ __align__(16) float As[DEPTH][TILE];
    __shared__ __align__(16) float Bs[DEPTH][TILE];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
    // what this thread loads per slice: 4 consecutive k of one row
    const int lr = tid / 2, lk = (tid % 2) * 4;

    float c[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += DEPTH) {
        {
            const int row = m0 + lr, col = n0 + lr;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int k = k0 + lk + q;
                As[lk + q][lr] = (row < M && k < K)
                    ? widen(lhs[(size_t)row * lda + k]) : 0.0f;
                Bs[lk + q][lr] = (col < N && k < K)
                    ? widen(rhs[(size_t)col * ldb + k]) : 0.0f;
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

    // epilogue of K6: mask the cells this thread holds, fold them into f64
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

    // fixed-tree block reduction: shuffles within a warp, then thread 0
    // adds the warp sums in order
    __shared__ double warp_sum[THREADS / 32];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, d);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
        double total = 0.0;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
        partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
}

template <typename T, bool WRITE>
static int launch(const void* lhs, const void* rhs, const void* mask, int M,
                  int N, int K, long long lda, long long ldb, long long ldm,
                  void* partials, void* out, long long ldo, void* stream)
{
    if (M < 1 || N < 1 || K < 0 || lda < K || ldb < K || ldm < N
            || (WRITE && ldo < N))
        return (int)cudaErrorInvalidValue;
    const unsigned gx = (unsigned)((N + TILE - 1) / TILE);
    const unsigned gy = (unsigned)((M + TILE - 1) / TILE);
    if (gy > 65535u) return (int)cudaErrorInvalidValue;
    masked_product_kernel<T, WRITE>
        <<<dim3(gx, gy), THREADS, 0, (cudaStream_t)stream>>>(
            (const T*)lhs, (const T*)rhs, (const float*)mask, M, N, K, lda,
            ldb, ldm, (double*)partials, (float*)out, ldo);
    return (int)cudaGetLastError();
}

extern "C" {

int matreduce_tile() { return TILE; }

// `partials` holds ceil(N / TILE) * ceil(M / TILE) doubles.
int matreduce_f32(const void* lhs, const void* rhs, const void* mask,
                  int M, int N, int K, long long lda, long long ldb,
                  long long ldm, void* partials, void* stream)
{
    return launch<float, false>(lhs, rhs, mask, M, N, K, lda, ldb, ldm,
                                partials, nullptr, 0, stream);
}

// `out` is an f32 (M, N) buffer with row stride ldo >= N.
int sddmm_f32(const void* lhs, const void* rhs, const void* mask, int M,
              int N, int K, long long lda, long long ldb, long long ldm,
              void* out, long long ldo, void* stream)
{
    return launch<float, true>(lhs, rhs, mask, M, N, K, lda, ldb, ldm,
                               nullptr, out, ldo, stream);
}

int sddmm_bf16(const void* lhs, const void* rhs, const void* mask, int M,
               int N, int K, long long lda, long long ldb, long long ldm,
               void* out, long long ldo, void* stream)
{
    return launch<__nv_bfloat16, true>(lhs, rhs, mask, M, N, K, lda, ldb,
                                       ldm, nullptr, out, ldo, stream);
}

}  // extern "C"
