// The |cut| = 3 decomposition join for Hopper (sm_90a), on the two routes
// that do not walk the n^3 grid:
//
//   trijoin_path      no factor spans all three cut axes and at most two of
//                     the pairs (0,1), (1,2), (0,2) are spanned: an O(n^2)
//                     function, bound by the bytes of its factors
//   trijoin_triangle  all three pairs spanned: Σ C′ ⊙ (A′·B′ᵀ), a matrix
//                     product on the f64 tensor cores with a masked-reduce
//                     epilogue, bound by operations
//
// Both replace, for those factor mixes of the scalar join, the reference
// package's TPU kernel _trijoin_tiles (src/repro/kernels/matreduce.py),
// which takes every mix through the n^3 grid; mixes with a factor over all
// three axes, and every keep-axis join, keep that walk (cutjoin.cu, the
// dense route).  kernels/matreduce.py decides the route from the factors' axes
// alone (tri_route), lays the factors out as two or three operands and
// gives each kernel one factor table: pointers and per-operand (row,
// column) element strides, 0 on an axis a factor does not span, so that
// vectors and scalars are applied as the operand is read and nothing O(n^2)
// is materialised beyond the f64 row vectors and the partials.
//
// Arithmetic (both kernels): products and sums in f64.  Factors are
// integer-valued; products and sums of integers are exact in f64 while
// they stay below 2^53, which the f64 fold of the chunked kernels already
// requires of the whole join (n^3 · Π max|F_i| < 2^53).  Every sum runs in
// a fixed order and no kernel uses atomics: two runs give the same bits.
//
// Path (the middle axis m, ends a and c; A on (a, m), B on (m, c); g the
// global index that a and c share):
//   Σ_distinct = Σ_m [ r_A[m] r_B[m] − Σ_{a≠m} A[a,m] B[m,c(a)] ],
//   r_A[m] = Σ_{a≠m} A[a,m], r_B[m] = Σ_{c≠m} B[m,c], c(a) the c with
//   global index g_a.  Unmasked: no exclusions.
//   Pass 1 (path_cols) reads every A and B cell once through 32 x 32
//   shared tiles whose loads run along each operand's unit stride, so both
//   the A[a,m] and the transposed B[m,c(a)] reads are coalesced, and writes
//   per-split partials of r_A, r_B and the back term per m; pass 2
//   (path_finish) sums the splits and forms the bracket.  Bound: the bytes
//   of the factors read once.
//
// Triangle (x outer, y inner, z outer; A′ on (x, y), B′ on (z, y), C′ on
// (x, z), each the product of its factors with the global diagonal zeroed
// when the join is masked):
//   Σ_{x,z} C′[x,z] Σ_y A′[x,y] B′[z,y].
//   Persistent CTAs, one an SM, walk the 128 x 128 (x, z) tiles in the
//   grouped raster of tri_order.cuh, one f64 partial a tile at its index.
//   The wrapper hands A′ and B′ as one factor each that TMA reads in place
//   (unit stride along y or along the rows, an even other stride, a
//   16-byte base): where an operand has other factors (a vector on y, a
//   second pair factor) or a lead factor TMA cannot read, it writes the
//   operand's f64 product into a buffer first, as sddmm copies views TMA
//   cannot read.  A CTA is three warpgroups.  Warpgroup 2, the producer,
//   hands its registers to the consumers (setmaxnreg) and one of its
//   threads fills a ring of 6 stages of 16 of y (A′ and B′ rows, 32 KB)
//   on full / empty mbarriers with TMA loads through f64 tensor maps with
//   a 128-byte swizzle (unit stride along y: one box of 16 k x 128 rows;
//   along the rows: eight of 16 rows x 16 k).  Warpgroups 0 and 1, the
//   consumers, are 8 warps of 64 x 32 cells; each waits for a stage,
//   reads its fragments by the lane maps of tri_order.cuh (no bank
//   conflict; every address a lane base XOR a constant plus an
//   immediate), issues 16 mma.sync.aligned.m16n8k16.row.col.f64 (sm_90:
//   a quarter of the instructions of m16n8k4 for the same products) and
//   releases the stage; no barrier spans the CTA.  The diagonal zero is a
//   compare of the lane's row less its k with one scalar a stage, in a
//   copy of the stage taken only where a stage holds a diagonal cell, so
//   the common stage holds no code for it.  The epilogue multiplies the
//   accumulators by C′ (vectors on x and z, scalars and the (x, z)
//   factors, read in place) and reduces the tile in a fixed order: the
//   (x, z) product is never written.
//   Why f64 tensor cores: factors are integers up to the guard's 2^24 per
//   chunk, bf16 holds integers exactly only to 256, and f32 FMAs would need
//   the chunked f32 -> f64 fold; f64 products and sums of these integers
//   are exact below 2^53.  H100 SXM does 67 TFLOP/s in f64 on its tensor
//   cores, the same rate as f32 outside them, so 2 n^3 operations at
//   67 TFLOP/s stays the bound.
//
// Ragged edges are masked here; nothing is padded.  Launches go to the
// stream the caller passes and never synchronise.  Plain C interface,
// loaded with ctypes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_order.cuh"

#define MAXF 8        // factor-table capacity; the wrapper folds surplus factors

struct Table {
    const double* ptr[MAXF];
    long long sr[MAXF], sc[MAXF];   // strides along operand rows / cols
    int nf;                         // factors in all, grouped [A | B | C]
    int na, nb;                     // A: [0, na), B: [na, na + nb), C: rest
};

// Π of factors [f0, f1) at operand cell (r, c).
__device__ __forceinline__ double eval(const Table& T, int f0, int f1,
                                       long long r, long long c)
{
    double v = 1.0;
    for (int f = f0; f < f1; ++f) v *= T.ptr[f][r * T.sr[f] + c * T.sc[f]];
    return v;
}

static Table make_table(const void* const* ptrs, const long long* strides,
                        int nf, int na, int nb)
{
    Table T;
    for (int f = 0; f < MAXF; ++f) {
        T.ptr[f] = nullptr;
        T.sr[f] = T.sc[f] = 0;
    }
    for (int f = 0; f < nf; ++f) {
        T.ptr[f] = (const double*)ptrs[f];
        T.sr[f] = strides[2 * f];
        T.sc[f] = strides[2 * f + 1];
    }
    T.nf = nf; T.na = na; T.nb = nb;
    return T;
}

// Whether the factors [f0, f1) are best read with the lanes of a warp
// along the operand's rows: some factor has unit row stride and none has
// unit column stride.
static bool lanes_on_rows(const Table& T, int f0, int f1)
{
    bool row = false;
    for (int f = f0; f < f1; ++f) {
        if (T.sc[f] == 1) return false;
        row = row || T.sr[f] == 1;
    }
    return row;
}

// ---------------------------------------------------------------------------
// path
// ---------------------------------------------------------------------------
namespace path {

constexpr int T = 32;                 // tile edge
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / T;     // 8 warps
constexpr int PER = T / ROWS;         // tile rows per warp
constexpr int FINISH = 256;           // threads of a finishing block

// s[i][j] = X(r0 + i, c0 + j) for the operand of factors [f0, f1), 0
// outside [0, nr) x [0, nc); the lanes run along rows or along columns.
__device__ __forceinline__ void load_tile(double (*s)[T + 1], const Table& tb,
                                          int f0, int f1, long long r0,
                                          int nr, long long c0, int nc,
                                          bool rows)
{
    const int lane = threadIdx.x % T, w = threadIdx.x / T;
    double v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = rows ? lane : w + ROWS * k;
        const int j = rows ? w + ROWS * k : lane;
        const long long r = r0 + i, c = c0 + j;
        v[k] = (r >= 0 && r < nr && c >= 0 && c < nc)
                   ? eval(tb, f0, f1, r, c) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = rows ? lane : w + ROWS * k;
        const int j = rows ? w + ROWS * k : lane;
        s[i][j] = v[k];
    }
}

// Pass 1: per m, over the g tiles blockIdx.y, blockIdx.y + gridDim.y, ...:
// r_A, r_B and the back term (MASK).  part holds (gridDim.y, 3, n_m)
// doubles.
template <bool MASK>
__global__ void __launch_bounds__(THREADS)
path_cols(const __grid_constant__ Table tb, int n_a, int n_m, int n_c,
          int off_a, int off_m, int off_c, int g_lo, int g_tiles,
          bool a_rows, bool b_rows, double* __restrict__ part)
{
    __shared__ double sA[T][T + 1];   // sA[g][m] = A(a(g), m)
    __shared__ double sB[T][T + 1];   // sB[m][g] = B(m, c(g))
    __shared__ double red[3][ROWS][T];
    const int m0 = blockIdx.x * T;
    const int mi = threadIdx.x % T, w = threadIdx.x / T;
    const long long gm = (long long)m0 + mi + off_m;
    double rA = 0.0, rB = 0.0, bk = 0.0;
    for (int t = blockIdx.y; t < g_tiles; t += gridDim.y) {
        const long long g0 = (long long)g_lo + (long long)t * T;
        load_tile(sA, tb, 0, tb.na, g0 - off_a, n_a, m0, n_m, a_rows);
        load_tile(sB, tb, tb.na, tb.nf, m0, n_m, g0 - off_c, n_c, b_rows);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int gi = w * PER + k;
            const bool live = !MASK || g0 + gi != gm;
            const double b = live ? sB[mi][gi] : 0.0;
            const double a = live ? sA[gi][mi] : 0.0;
            rB += b;
            rA += a;
            if (MASK) bk += a * b;
        }
        __syncthreads();
    }
    red[0][w][mi] = rA;
    red[1][w][mi] = rB;
    red[2][w][mi] = bk;
    __syncthreads();
    if (threadIdx.x < 3 * T) {
        const int q = threadIdx.x / T, j = threadIdx.x % T;
        double s = 0.0;
#pragma unroll
        for (int v = 0; v < ROWS; ++v) s += red[q][v][j];
        if (m0 + j < n_m)
            part[((size_t)blockIdx.y * 3 + q) * n_m + m0 + j] = s;
    }
}

// Pass 2: the splits summed in order; per m the bracket into out[m].
template <bool MASK>
__global__ void __launch_bounds__(FINISH)
path_finish(const double* __restrict__ part, int splits, int n_m,
            double* __restrict__ out)
{
    const int m = blockIdx.x * FINISH + threadIdx.x;
    if (m >= n_m) return;
    double rA = 0.0, rB = 0.0, bk = 0.0;
    for (int s = 0; s < splits; ++s) {
        const double* p = part + (size_t)s * 3 * n_m;
        rA += p[m];
        rB += p[n_m + m];
        bk += p[2 * n_m + m];
    }
    out[m] = MASK ? rA * rB - bk : rA * rB;
}

template <bool MASK>
static int run(const Table& tb, int n_a, int n_m, int n_c, int off_a,
               int off_m, int off_c, int split, double* scratch, double* out,
               cudaStream_t st)
{
    const bool a_rows = lanes_on_rows(tb, 0, tb.na);
    const bool b_rows = lanes_on_rows(tb, tb.na, tb.nf);
    const long long lo = off_a < off_c ? off_a : off_c;
    const long long hi = (long long)off_a + n_a > (long long)off_c + n_c
                             ? (long long)off_a + n_a : (long long)off_c + n_c;
    const int g_tiles = (int)((hi - lo + T - 1) / T);
    const dim3 grid1((n_m + T - 1) / T, split);
    path_cols<MASK><<<grid1, THREADS, 0, st>>>(
        tb, n_a, n_m, n_c, off_a, off_m, off_c, (int)lo, g_tiles, a_rows,
        b_rows, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    path_finish<MASK><<<(n_m + FINISH - 1) / FINISH, FINISH, 0, st>>>(
        scratch, split, n_m, out);
    return (int)cudaGetLastError();
}

}  // namespace path

// ---------------------------------------------------------------------------
// triangle
// ---------------------------------------------------------------------------
namespace tri {

using tri_order::BK;
using tri_order::TILE_X;
using tri_order::WM;
using tri_order::WN;

constexpr int TILE_Z = 128;           // z of a CTA tile: WN a warp pair
constexpr int STAGES = 6;             // stages in the ring
constexpr int CONSUMER_WARPS = 2 * TILE_Z / WN;      // 2 along x: 8
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int PRODUCERS = 128;        // a warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers a thread: the launch gives each of the 384 threads 168 (a
// sub-partition's 16K registers over its three warps); setmaxnreg hands
// the producers' on to the consumers, which hold 128 accumulators
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS =
    ((65536 / THREADS) / 8 * 8 * THREADS - CONSUMER_REGS * CONSUMERS)
    / PRODUCERS / 8 * 8;
constexpr int OP_A = TILE_X * BK, OP_B = TILE_Z * BK;  // doubles a stage
constexpr int STAGE = OP_A + OP_B;
constexpr int RING_BYTES = STAGES * STAGE * 8;
constexpr int SMEM = RING_BYTES + 2 * STAGES * 8 + 2 * CONSUMER_WARPS * 8
                     + 1024;
static_assert(CONSUMER_WARPS % 4 == 0 && PRODUCER_REGS >= 24,
              "whole warpgroups; setmaxnreg's least count");
static_assert(SMEM <= 232448, "a block's shared memory on Hopper");

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity)
{
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// one box of a 2-D tensor map at (c0, c1), innermost first, into shared
// memory at `dst`; completion counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1) : "memory");
}

// A stage of an operand's ROWS rows by TMA: one 16 k x ROWS box k-inner,
// 16 row x 16 k boxes row-inner (a 128-byte swizzle takes boxes of 128
// bytes a line).
template <bool KIN, int ROWS>
__device__ __forceinline__ void tma_stage(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int k0)
{
    if (KIN) {
        tma_load(dst, map, bar, k0, r0);
        return;
    }
#pragma unroll
    for (int b = 0; b < ROWS / 16; ++b)
        tma_load(dst + b * 16 * BK * 8, map, bar, r0 + 16 * b, k0);
}

__device__ __forceinline__ void lds128(double& lo, double& hi, uint32_t a)
{
    asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
                 : "=d"(lo), "=d"(hi) : "r"(a));
}

__device__ __forceinline__ double lds64(uint32_t a)
{
    double v;
    asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
    return v;
}

// Lane column t's four values of y at the lane's row r0 + d of the stage
// at byte `stage`, whose first row r0 gives the lane's base
// (tri_order::frag_base): two by one 16-byte load k-inner, one by an
// 8-byte load row-inner, each at the base XOR a constant plus a constant.
template <bool KIN>
__device__ __forceinline__ void load_frag(double (&v)[4], uint32_t stage,
                                          uint32_t base, int d)
{
#pragma unroll
    for (int q = 0; q < 4; q += KIN ? 2 : 1) {
        const uint32_t at = stage + ((base ^ tri_order::frag_xor(KIN, d, q))
                                     + tri_order::frag_add(KIN, d, q));
        if constexpr (KIN)
            lds128(v[q], v[q + 1], at);
        else
            v[q] = lds64(at);
    }
}

// On a stage that holds a diagonal cell of the warp's rows: zero the
// values of lane column t at the warp's row r whose k makes r - k = d.
__device__ __forceinline__ void zero_diag(double (&v)[4], int r, int t, int d)
{
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (r - tri_order::kappa(t, q) == d) v[q] = 0.0;
}

// d += A·Bᵀ over a stage's 16 k for one 16 x 8 block: a[h][q] holds rows
// g + 8h, b[q] column g, both at k = kappa(t, q); mma.sync's f64 m16n8k16
// (sm_90; a quarter of the instructions of m16n8k4 for the same products,
// and faster here than m16n8k8 or m16n8k4 on an H100, PERF.md) lays
// a_{2j+h} at (g + 8h, t + 4j) and b_j at (t + 4j, g).
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[2][4],
                                    const double (&b)[4])
{
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0][0]), "d"(a[1][0]), "d"(a[0][1]), "d"(a[1][1]),
          "d"(a[0][2]), "d"(a[1][2]), "d"(a[0][3]), "d"(a[1][3]), "d"(b[0]),
          "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// One stage of y for a consumer warp: acc += A′·B′ᵀ over the stage's 16 k
// for its 64 x 32 block, the A′ stage at byte `as`, B′ at `bs`.  DIAG: the
// stage holds a diagonal cell of the warp's rows of A′ (where row - k is
// da, if diag_a) or of B′ (db, diag_b), zeroed as the fragments are read;
// the common stage holds no code for it.
template <bool KIN_A, bool KIN_B, bool DIAG>
__device__ __forceinline__ void stage(double (&acc)[WM / 16][WN / 8][4],
                                      uint32_t as, uint32_t bs,
                                      uint32_t lane_a, uint32_t lane_b, int g,
                                      int t, bool diag_a, int da, bool diag_b,
                                      int db)
{
    double b[WN / 8][4];
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
        load_frag<KIN_B>(b[j], bs, lane_b, 8 * j);
        if (DIAG && diag_b)
            zero_diag(b[j], tri_order::b_row(KIN_B, j, g), t, db);
    }
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) {
        double a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            load_frag<KIN_A>(a[h], as, lane_a, 16 * i + 8 * h);
            if (DIAG && diag_a)
                zero_diag(a[h], tri_order::a_row(KIN_A, i, h, g), t, da);
        }
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) mma(acc[i][j], a, b[j]);
    }
}

// The ring's mbarriers after its stages: slot s full, slot s empty.
__device__ __forceinline__ uint32_t full_bar(uint32_t ring, int s)
{
    return ring + RING_BYTES + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t ring, int s)
{
    return ring + RING_BYTES + 8 * (STAGES + s);
}

template <bool KIN_A, bool KIN_B>
__global__ void __launch_bounds__(THREADS, 1)
tri_mma(const __grid_constant__ Table tb,
        const __grid_constant__ CUtensorMap map_a,
        const __grid_constant__ CUtensorMap map_b, int nx, int ny, int nz,
        int ox, int oy, int oz, int masked, double* __restrict__ part)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t ring = (raw + 1023) & ~1023u;
    double* const red = reinterpret_cast<double*>(
        smem_raw + (ring - raw) + RING_BYTES + 16 * STAGES);
    const int tiles_x = (nx + TILE_X - 1) / TILE_X;
    const int tiles_z = (nz + TILE_Z - 1) / TILE_Z;
    const int n_tiles = tiles_x * tiles_z;    // below 2^31 (the host checks)
    const int nk = (ny + BK - 1) / BK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            bar_init(full_bar(ring, s), 1);
            bar_init(empty_bar(ring, s), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= CONSUMER_WARPS) {
        // the producer: one thread issues every TMA load, the ring's stage
        // j into slot j % STAGES once its consumers released stage
        // j - STAGES
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        if (threadIdx.x != CONSUMERS) return;
        int j = 0;
        for (int idx = blockIdx.x; idx < n_tiles; idx += gridDim.x) {
            const tri_order::Tile tl =
                tri_order::tile_at(idx, tiles_x, tiles_z);
            const int x0 = tl.tx * TILE_X, z0 = tl.tz * TILE_Z;
            for (int kc = 0; kc < nk; ++kc, ++j) {
                const int s = j % STAGES;
                const uint32_t sa = ring + s * STAGE * 8, full = full_bar(ring, s);
                bar_wait(empty_bar(ring, s), ((j / STAGES) & 1) ^ 1);
                bar_expect(full, STAGE * 8);
                tma_stage<KIN_A, TILE_X>(sa, &map_a, full, x0, kc * BK);
                tma_stage<KIN_B, TILE_Z>(sa + OP_A * 8, &map_b, full, z0,
                                         kc * BK);
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

    // consumers: warp cw holds the 64 x 32 (x, z) block at (wm, wn)
    const int cw = warp, g = lane >> 2, t = lane & 3;
    const int wm = cw / (TILE_Z / WN) * WM, wn = cw % (TILE_Z / WN) * WN;
    const uint32_t lane_a =
        tri_order::frag_base(KIN_A, wm + tri_order::rho(KIN_A, g), t);
    const uint32_t lane_b =
        tri_order::frag_base(KIN_B, wn + tri_order::rho(KIN_B, g), t);
    int it = 0, round = 0;
    for (int idx = blockIdx.x; idx < n_tiles; idx += gridDim.x) {
        const tri_order::Tile tl = tri_order::tile_at(idx, tiles_x, tiles_z);
        const int x0 = tl.tx * TILE_X, z0 = tl.tz * TILE_Z;
        double acc[WM / 16][WN / 8][4];
#pragma unroll
        for (int i = 0; i < WM / 16; ++i)
#pragma unroll
            for (int j = 0; j < WN / 8; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

        for (int kc = 0; kc < nk; ++kc, ++it) {
            const int s = it % STAGES, k0 = kc * BK;
            const uint32_t as = ring + s * STAGE * 8, bs = as + OP_A * 8;
            // a cell of the warp's row r and the stage's k lies on the
            // diagonal where r - k is da (A′) or db (B′)
            const long long da = (long long)k0 + oy - ox - x0 - wm;
            const long long db = (long long)k0 + oy - oz - z0 - wn;
            const bool diag_a = masked && da > -BK && da < WM;
            const bool diag_b = masked && db > -BK && db < WN;
            bar_wait(full_bar(ring, s), (it / STAGES) & 1);
            if (diag_a || diag_b)
                stage<KIN_A, KIN_B, true>(acc, as, bs, lane_a, lane_b, g, t,
                                          diag_a, (int)da, diag_b, (int)db);
            else
                stage<KIN_A, KIN_B, false>(acc, as, bs, lane_a, lane_b, g, t,
                                           false, 0, false, 0);
            __syncwarp();
            if (lane == 0) bar_arrive(empty_bar(ring, s));
        }

        // epilogue: × C′(x, z), reduced in a fixed order
        double v = 0.0;
#pragma unroll
        for (int i = 0; i < WM / 16; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int x = x0 + wm + tri_order::acc_x(KIN_A, i, c, g);
                if (x >= nx) continue;
#pragma unroll
                for (int j = 0; j < WN / 8; ++j) {
                    const int z = z0 + wn + tri_order::acc_z(KIN_B, j, c, t);
                    const bool diag =
                        masked && (long long)x + ox == (long long)z + oz;
                    if (z < nz && !diag)
                        v += acc[i][j][c] * eval(tb, 2, tb.nf, x, z);
                }
            }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, d);
        double* const slot = red + (round & 1) * CONSUMER_WARPS;
        if (lane == 0) slot[cw] = v;
        asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
        if (cw == 0 && lane == 0) {
            double total = 0.0;
#pragma unroll
            for (int w = 0; w < CONSUMER_WARPS; ++w) total += slot[w];
            part[idx] = total;
        }
        ++round;
    }
}

// Whether TMA reads factor f in place as the operand's (rows, k): unit
// stride along one axis, the other stride a multiple of 16 bytes, at
// least that axis's extent (lines that do not overlap) and in TMA's
// range, the base 16-byte aligned.  The wrapper hands the kernel only
// such factors (kernels/matreduce.py _tri_tma_operand).
static bool tma_reads(const Table& tb, int f, bool kin, int rows, int nk)
{
    const long long unit = kin ? tb.sc[f] : tb.sr[f];
    const long long other = kin ? tb.sr[f] : tb.sc[f];
    return unit == 1 && other % 2 == 0 && other >= (kin ? nk : rows)
           && other < (1LL << 37) && ((unsigned long long)tb.ptr[f] & 15) == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (CUDA driver API), found through the runtime, so
// that the library needs no -lcuda
static EncodeTiled encode_tiled()
{
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// The f64 map of lead factor f as the operand's (rows, k): boxes of 16 k
// x box_rows rows k-inner, 16 rows x 16 k row-inner, 128-byte swizzle,
// zeros past the edges.  Returns 0 or the CUresult, negated.
static int make_map(CUtensorMap* map, const Table& tb, int f, bool kin,
                    int rows, int nk, int box_rows)
{
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
    const long long other = kin ? tb.sr[f] : tb.sc[f];
    const cuuint64_t dims[2] = {(cuuint64_t)(kin ? nk : rows),
                                (cuuint64_t)(kin ? rows : nk)};
    const cuuint64_t strides[1] = {(cuuint64_t)other * 8};
    const cuuint32_t box[2] = {kin ? (cuuint32_t)BK : 16u,
                               kin ? (cuuint32_t)box_rows : (cuuint32_t)BK};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, (void*)tb.ptr[f], dims,
        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : -(int)res;
}

template <bool KIN_A, bool KIN_B>
static int run(const Table& tb, int nx, int ny, int nz, int ox, int oy,
               int oz, int masked, double* part, cudaStream_t st)
{
    if (!tma_reads(tb, 0, KIN_A, nx, ny) || !tma_reads(tb, 1, KIN_B, nz, ny))
        return (int)cudaErrorInvalidValue;
    auto kernel = tri_mma<KIN_A, KIN_B>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap map_a{}, map_b{};
    if (const int e = make_map(&map_a, tb, 0, KIN_A, nx, ny, TILE_X)) return e;
    if (const int e = make_map(&map_b, tb, 1, KIN_B, nz, ny, TILE_Z)) return e;
    kernel<<<tri_order::grid(tri_order::tiles(nx, nz, TILE_Z), sms), THREADS,
             SMEM, st>>>(tb, map_a, map_b, nx, ny, nz, ox, oy, oz, masked,
                         part);
    return (int)cudaGetLastError();
}

}  // namespace tri

extern "C" {

int trijoin_path_tile() { return path::T; }
int trijoin_triangle_tile() { return tri::TILE_X; }
int trijoin_triangle_tile_z() { return tri::TILE_Z; }

// The path route.  Factors [0, na) form A on (a, m), the rest B on (m, c);
// strides are (row, column) per factor.  out = the (n_m,) brackets, whose
// sum is the join; scratch holds split * 3 * n_m doubles.
int trijoin_path(const void* const* ptrs, const long long* strides, int nf,
                 int na, int n_a, int n_m, int n_c, int off_a, int off_m,
                 int off_c, int masked, int split, void* scratch, void* out,
                 void* stream)
{
    if (nf < 0 || nf > MAXF || na < 0 || na > nf || split < 1
        || split > 65535 || n_a < 1 || n_m < 1 || n_c < 1)
        return (int)cudaErrorInvalidValue;
    const Table tb = make_table(ptrs, strides, nf, na, nf - na);
    auto run = masked ? &path::run<true> : &path::run<false>;
    return run(tb, n_a, n_m, n_c, off_a, off_m, off_c, split,
               (double*)scratch, (double*)out, (cudaStream_t)stream);
}

// The triangle route.  Factor 0 is A′ on (x, y), factor 1 B′ on (z, y),
// each one factor that TMA reads in place (na = nb = 1: the wrapper
// multiplies an operand's other factors in); the rest C′ on (x, z).
// partials: one double per (x, z) tile.
int trijoin_triangle(const void* const* ptrs, const long long* strides,
                     int nf, int na, int nb, int nx, int ny, int nz, int ox,
                     int oy, int oz, int masked, void* partials,
                     void* stream)
{
    if (nf < 2 || nf > MAXF || na != 1 || nb != 1 || nx < 1 || ny < 1
        || nz < 1)
        return (int)cudaErrorInvalidValue;
    const Table tb = make_table(ptrs, strides, nf, na, nb);
    // row-inner where the factor runs along rows with unit stride
    const bool kin_a = !(tb.sr[0] == 1 && tb.sc[0] != 1);
    const bool kin_b = !(tb.sr[1] == 1 && tb.sc[1] != 1);
    auto run = kin_a
        ? (kin_b ? &tri::run<true, true> : &tri::run<true, false>)
        : (kin_b ? &tri::run<false, true> : &tri::run<false, false>);
    return run(tb, nx, ny, nz, ox, oy, oz, masked, (double*)partials,
               (cudaStream_t)stream);
}

}  // extern "C"
