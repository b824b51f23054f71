// Packed-bitset intersection counts for Hopper (sm_90a):
//
//   bitset_pack    out[r, w] = Σ_j [adj[r, 32·w + j] != 0] << j
//                  (R, N) bytes (bool or uint8) -> (R, ⌈N/32⌉) 32-bit words
//   bitset_rows    out[e] = popcount(a[e, :] & b[e, :])
//                  over two (E, W) tables of packed 32-bit words
//   bitset_edges   out[e] = popcount(table[u_e, :] & table[v_e, :])
//                  over one (N, W) table and an (E, 2) int64 edge list;
//                  a pair outside [0, N) gets 0 and raises a flag word
//
// They replace the reference package's TPU kernel bitset_intersect
// (src/repro/kernels/bitset.py), the paper's set-intersection inner loop:
// with the table holding each vertex's neighbour set (bit j of word w is
// column 32·w + j), bitset_edges gives every edge's common-neighbour count.
// The TPU kernel takes the two (E, W) row copies its caller gathered on the
// host (kernels/ops.py common_neighbors), from a table its caller packed on
// the host; here the table is packed on the card (bitset_pack) and
// bitset_edges gathers inside the kernel, so the packed table is the only
// bulk input: 8 MiB at N = 8192, which stays in the 50 MB L2.
//
// Words arrive as int32 with the bits of uint32 (PyTorch's uint32 has few
// operators) and are read here as uint32_t; __popc counts all 32 bits.  The
// TPU kernel's SWAR popcount on int32 words is not copied: its right shifts
// are arithmetic on words with bit 31 set.
//
// What bounds them on this card: bytes.
//
// bitset_pack reads R·N bytes and writes R·W words: a thread builds one
// word from its 32 bytes, loaded as two 16-byte vectors where every row
// starts on a 16-byte boundary (else byte by byte; the last word of a row
// whose N is no multiple of 32 is always built byte by byte).  Four bytes
// become four bits without a branch: an OR-fold puts "byte != 0" in bit 0
// of each byte, and one multiply gathers bits 0, 8, 16, 24 into 24..27.
//
// bitset_edges, the vector entry (W a multiple of 4, table base and row
// stride 16-byte aligned, W <= 1024): Graph stores its edges sorted by
// (u, v), so consecutive edges share u in runs as long as u's degree.  A
// warp takes CHUNK = 8 consecutive edges (lane j loads pair j once, the
// warp reads them back by shuffles), holds row u in registers (lane l
// holds 16-byte vectors l, l + 32, ...: 2 a lane at W = 256) and reloads
// it only when u changes, so an edge of a run reads row v alone: on R-MAT
// (3714 u-runs over 79 494 edges, 9937 chunks) at most 79 494 + 3714 +
// 9937 row reads of 1 KB through L2 instead of 2 · 79 494.  Row v of U
// edges is loaded before any of them is counted, so INFLIGHT = 4 16-byte
// loads of each lane are in flight together (U = INFLIGHT / K).  Longer
// chunks reuse row u further but leave fewer warps to hide L2's latency:
// on R-MAT 32-edge chunks were slower than 8 on the card, and 8 loads in
// flight slower than 4 (more registers, fewer resident warps); skipping
// the vectors of row v where row u is zero was slower too (the loads
// then wait for row u).  An
// unsorted list stays exact: row u is reused only while u equals the held
// row.  The word entry (any W, any stride: one warp per edge, lane l on
// words l, l + 32, ...) keeps the design of the first port.
//
// Launches go to the stream the caller passes and never synchronise.
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                 // 8 warps
#define WARPS (THREADS / 32)
#define CHUNK 8                     // edges a warp takes (vector entry)
#define INFLIGHT 4                  // 16-byte row-v loads in flight a lane
#define MAX_VEC_LANE 8              // 16-byte vectors of row u a lane holds

__device__ __forceinline__ int warp_sum(int x)
{
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    return x;
}

// -- bitset_pack ------------------------------------------------------------

// bits 0..3 of the result: [byte k of x != 0] for k = 0..3
__device__ __forceinline__ uint32_t nibble(uint32_t x)
{
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;
    return ((x & 0x01010101u) * 0x01020408u) >> 24 & 0xFu;
}

__device__ __forceinline__ uint32_t nibbles(uint4 a, int shift)
{
    return nibble(a.x) << shift | nibble(a.y) << (shift + 4) |
           nibble(a.z) << (shift + 8) | nibble(a.w) << (shift + 12);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const uint8_t* __restrict__ adj, long long R, long long N,
            long long ld, int W, int* __restrict__ out)
{
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= R * W) return;
    const long long r = idx / W;
    const long long c0 = 32LL * (idx - r * W);
    const uint8_t* row = adj + r * ld;
    uint32_t word = 0;
    if (VEC && c0 + 32 <= N) {
        const uint4* p = reinterpret_cast<const uint4*>(row + c0);
        word = nibbles(__ldg(p), 0) | nibbles(__ldg(p + 1), 16);
    } else {
        const int len = (int)(N - c0 < 32 ? N - c0 : 32);
        for (int j = 0; j < len; ++j)
            word |= (uint32_t)(__ldg(row + c0 + j) != 0) << j;
    }
    out[idx] = (int)word;
}

// -- bitset_rows ------------------------------------------------------------

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
    const long long e = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (e >= E) return;               // whole warps leave together
    const int cnt = row_count(a + e * lda, b + e * ldb, W, lane);
    if (lane == 0) out[e] = cnt;
}

// -- bitset_edges -----------------------------------------------------------

__device__ __forceinline__ bool in_table(long long u, long long v,
                                         long long N)
{
    return u >= 0 && u < N && v >= 0 && v < N;
}

// the word entry: one warp per edge
__global__ void __launch_bounds__(THREADS)
edges_word_kernel(const uint32_t* __restrict__ table, int W, long long ldt,
                  long long N, const long long* __restrict__ edges,
                  long long E, int* __restrict__ out, int* __restrict__ flag)
{
    const long long e = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (e >= E) return;
    const long long u = edges[2 * e], v = edges[2 * e + 1];
    if (!in_table(u, v, N)) {
        if (lane == 0) { out[e] = 0; *flag = 1; }
        return;
    }
    const int cnt = row_count(table + u * ldt, table + v * ldt, W, lane);
    if (lane == 0) out[e] = cnt;
}

__device__ __forceinline__ int popc_and(uint4 a, uint4 b)
{
    return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
           __popc(a.w & b.w);
}

// the vector entry: a warp per CHUNK consecutive edges, row u held in
// registers (K vectors a lane, W4 = W / 4 <= 32 K), rows v of U edges
// loaded together
template <int K, int U>
__global__ void __launch_bounds__(THREADS)
edges_vec_kernel(const uint4* __restrict__ table, int W4, long long ldt4,
                 long long N, const long long* __restrict__ edges,
                 long long E, int* __restrict__ out, int* __restrict__ flag)
{
    const int lane = threadIdx.x % 32;
    const long long e0 =
        ((long long)blockIdx.x * WARPS + threadIdx.x / 32) * CHUNK;
    if (e0 >= E) return;
    const int len = (int)(E - e0 < CHUNK ? E - e0 : CHUNK);
    long long my_u = -1, my_v = -1;
    if (lane < len) {
        my_u = edges[2 * (e0 + lane)];
        my_v = edges[2 * (e0 + lane) + 1];
    }
    long long held = -1;              // the row in hu (-1: none)
    uint4 hu[K];
#pragma unroll
    for (int k = 0; k < K; ++k) hu[k] = make_uint4(0, 0, 0, 0);

    for (int j0 = 0; j0 < len; j0 += U) {
        long long u[U], v[U];
        bool ok[U];
        uint4 rv[U][K];
#pragma unroll
        for (int t = 0; t < U; ++t) {
            u[t] = __shfl_sync(0xffffffffu, my_u, (j0 + t) & 31);
            v[t] = __shfl_sync(0xffffffffu, my_v, (j0 + t) & 31);
            ok[t] = j0 + t < len && in_table(u[t], v[t], N);
            const uint4* row = table + (ok[t] ? v[t] : 0) * ldt4;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int i = lane + 32 * k;
                rv[t][k] = ok[t] && i < W4 ? __ldg(row + i)
                                           : make_uint4(0, 0, 0, 0);
            }
        }
#pragma unroll
        for (int t = 0; t < U; ++t) {
            if (j0 + t >= len) break;
            if (!ok[t]) {
                if (lane == 0) { out[e0 + j0 + t] = 0; *flag = 1; }
                continue;
            }
            if (u[t] != held) {       // a new run: reload row u
                const uint4* row = table + u[t] * ldt4;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int i = lane + 32 * k;
                    hu[k] = i < W4 ? __ldg(row + i) : make_uint4(0, 0, 0, 0);
                }
                held = u[t];
            }
            int cnt = 0;
#pragma unroll
            for (int k = 0; k < K; ++k) cnt += popc_and(hu[k], rv[t][k]);
            cnt = warp_sum(cnt);
            if (lane == 0) out[e0 + j0 + t] = cnt;
        }
    }
}

template <int K, int U>
static void launch_vec(const void* table, int W, long long ldt, long long N,
                       const void* edges, long long E, void* out, void* flag,
                       cudaStream_t stream)
{
    const long long warps = (E + CHUNK - 1) / CHUNK;
    const unsigned g = (unsigned)((warps + WARPS - 1) / WARPS);
    edges_vec_kernel<K, U><<<g, THREADS, 0, stream>>>(
        (const uint4*)table, W / 4, ldt / 4, N, (const long long*)edges, E,
        (int*)out, (int*)flag);
}

static long long blocks(long long E) { return (E + WARPS - 1) / WARPS; }

// Whether the vector entry can read this table (kernels/bitset.py
// edges_entry picks the entry)
static bool vec_entry(const void* table, int W, long long ldt)
{
    return W > 0 && W % 4 == 0 && W <= 128 * MAX_VEC_LANE && ldt % 4 == 0 &&
           (uintptr_t)table % 16 == 0;
}
static bool bad_rows(long long E) { return E < 1 || blocks(E) > 2147483647LL; }

extern "C" {

// adj: (R, N) bytes with row stride ld >= N and unit column stride; out:
// (R, W) int32 words, W = ⌈N / 32⌉, contiguous.
int bitset_pack(const void* adj, long long R, long long N, long long ld,
                int W, void* out, void* stream)
{
    if (R < 1 || N < 1 || ld < N || (long long)W * 32 < N ||
        (long long)W * 32 >= N + 32)
        return (int)cudaErrorInvalidValue;
    const long long g = (R * W + THREADS - 1) / THREADS;
    if (g > 2147483647LL) return (int)cudaErrorInvalidValue;
    const bool vec = (uintptr_t)adj % 16 == 0 && ld % 16 == 0;
    if (vec)
        pack_kernel<true><<<(unsigned)g, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)adj, R, N, ld, W, (int*)out);
    else
        pack_kernel<false><<<(unsigned)g, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)adj, R, N, ld, W, (int*)out);
    return (int)cudaGetLastError();
}

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
// int64; out: E int32; flag: one int32 the caller zeroed, set to 1 when a
// pair lies outside [0, N) (that pair's count is 0); vec: 1 for the
// vector entry (refused where it cannot read the table), 0 for the word
// entry.
int bitset_edges(const void* table, int W, long long ldt, long long N,
                 const void* edges, long long E, void* out, void* flag,
                 int vec, void* stream)
{
    if (bad_rows(E) || W < 0 || ldt < W || N < 1 ||
        (vec && !vec_entry(table, W, ldt)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
        const int W4 = W / 4;
        if (W4 <= 32)
            launch_vec<1, INFLIGHT>(table, W, ldt, N, edges, E, out, flag, s);
        else if (W4 <= 64)
            launch_vec<2, INFLIGHT / 2>(table, W, ldt, N, edges, E, out,
                                        flag, s);
        else if (W4 <= 128)
            launch_vec<4, INFLIGHT / 4>(table, W, ldt, N, edges, E, out,
                                        flag, s);
        else
            launch_vec<8, 1>(table, W, ldt, N, edges, E, out, flag, s);
    } else {
        edges_word_kernel<<<(unsigned)blocks(E), THREADS, 0, s>>>(
            (const uint32_t*)table, W, ldt, N, (const long long*)edges, E,
            (int*)out, (int*)flag);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
