// Packed-bitset intersection counts for Hopper (sm_90a):
//
//   bitset_rows    out[e] = popcount(a[e, :] & b[e, :])
//                  over two (E, W) tables of packed 32-bit words
//   bitset_edges   out[e] = popcount(table[u_e, :] & table[v_e, :])
//                  over one (N, W) table and an (E, 2) int64 edge list
//
// They replace the reference package's TPU kernel bitset_intersect
// (src/repro/kernels/bitset.py), the paper's set-intersection inner loop:
// with the table holding each vertex's neighbour set (bit j of word w is
// column 32·w + j), bitset_edges gives every edge's common-neighbour count.
// The TPU kernel takes the two (E, W) row copies its caller gathered on the
// host (kernels/ops.py common_neighbors); bitset_edges gathers inside the
// kernel instead, so the packed table is the only bulk input: 8 MiB at
// N = 8192, which stays in the 50 MB L2, where the two gathered copies of
// an 80 000-edge graph would be 160 MB.
//
// Words arrive as int32 with the bits of uint32 (PyTorch's uint32 has few
// operators) and are read here as uint32_t; __popc counts all 32 bits.  The
// TPU kernel's SWAR popcount on int32 words is not copied: its right shifts
// are arithmetic on words with bit 31 set.
//
// What bounds it on this card: bytes (one AND and one popcount per word
// read).  One warp per row: lane l reads words l, l + 32, ... (neighbouring
// lanes on neighbouring words, so the loads coalesce), adds its counts in a
// register, and the warp sums its 32 lanes by shuffles; lane 0 writes the
// row's count.  No shared memory, no atomics.  A row of W words costs
// W / 32 loads a lane; at W = 256 that is 8, and the kernel is bound by the
// launch and by the edge list's latency more than by bandwidth.
//
// Launches go to the stream the caller passes and never synchronise.
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                 // 8 warps, one row each
#define ROWS (THREADS / 32)

__device__ __forceinline__ int warp_sum(int x)
{
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    return x;
}

__device__ __forceinline__ int row_count(const uint32_t* __restrict__ a,
                                         const uint32_t* __restrict__ b,
                                         int W, int lane)
{
    int cnt = 0;
    for (int w = lane; w < W; w += 32) cnt += __popc(a[w] & b[w]);
    return warp_sum(cnt);
}

__global__ void __launch_bounds__(THREADS)
bitset_rows_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, long long E, int W,
                   long long lda, long long ldb, int* __restrict__ out)
{
    const long long e = (long long)blockIdx.x * ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (e >= E) return;               // whole warps leave together
    const int cnt = row_count(a + e * lda, b + e * ldb, W, lane);
    if (lane == 0) out[e] = cnt;
}

__global__ void __launch_bounds__(THREADS)
bitset_edges_kernel(const uint32_t* __restrict__ table, int W, long long ldt,
                    const long long* __restrict__ edges, long long E,
                    int* __restrict__ out)
{
    const long long e = (long long)blockIdx.x * ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (e >= E) return;
    const long long u = edges[2 * e], v = edges[2 * e + 1];
    const int cnt = row_count(table + u * ldt, table + v * ldt, W, lane);
    if (lane == 0) out[e] = cnt;
}

static long long blocks(long long E) { return (E + ROWS - 1) / ROWS; }
static bool bad_rows(long long E) { return E < 1 || blocks(E) > 2147483647LL; }

extern "C" {

// a, b: (E, W) words with row strides lda, ldb >= W; out: E int32.
int bitset_rows(const void* a, const void* b, long long E, int W,
                long long lda, long long ldb, void* out, void* stream)
{
    if (bad_rows(E) || W < 0 || lda < W || ldb < W)
        return (int)cudaErrorInvalidValue;
    const unsigned g = (unsigned)blocks(E);
    bitset_rows_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, E, W, lda, ldb, (int*)out);
    return (int)cudaGetLastError();
}

// table: (N, W) words with row stride ldt >= W; edges: (E, 2) contiguous
// int64, every entry in [0, N) (the caller checks); out: E int32.
int bitset_edges(const void* table, int W, long long ldt, const void* edges,
                 long long E, void* out, void* stream)
{
    if (bad_rows(E) || W < 0 || ldt < W)
        return (int)cudaErrorInvalidValue;
    const unsigned g = (unsigned)blocks(E);
    bitset_edges_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, W, ldt, (const long long*)edges, E,
        (int*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
