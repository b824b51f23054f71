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
//   A CTA of 256 threads owns a 128 x 128 (x, z) tile; 8 warps of 64 x 32
//   run mma.sync.aligned.m16n8k4.row.col.f64 (the f64 shape sm_90 added)
//   over k-steps of 4: one instruction does the 16 x 8 x 4 product that
//   takes two of the sm_80 shape m8n8k4 sharing one B fragment.  A′ and
//   B′ tiles of 128 x 16 are staged in shared memory by
//   cp.async in 4 stages, two neighbours per 16-byte copy where the lead
//   factor allows it (unit stride, even other stride, 16-byte aligned
//   base), one per 8-byte copy elsewhere; the factor with unit stride
//   decides whether a tile is stored k-inner or row-inner (both read by
//   the fragments without bank conflicts).  The operand's other factors
//   (a vector on y, a second pair factor) and the diagonal are applied by
//   each thread to the cells it copied, after its own copies have landed
//   and before the stage is read, only on stages that need it.  The
//   epilogue multiplies the accumulators by C′ (vectors on x and z,
//   scalars and the (x, z) factors, read in place) and reduces the tile:
//   the (x, z) product is never written.  One f64 partial per CTA.
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

#include <cuda_runtime.h>

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

constexpr int BM = 128;               // CTA tile: 128 x 128 of (x, z)
constexpr int BK = 16;                // k (y) per stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;          // 8 warps: 2 along x, 4 along z
constexpr int WM = 64, WN = 32;       // warp tile
constexpr int PAD = 4;                // doubles of padding per smem row
constexpr int GROUP = 8;              // x tiles per raster group
constexpr int PER = BM * BK / THREADS;   // cells one thread copies per stage

// A stage of one operand, 128 rows x 16 k: k-inner ([row][k]) when the
// operand's lead factor has unit stride along k, row-inner ([k][row]) when
// along rows.  Either way a fragment load (8 rows x 4 k per half-warp
// pair) and a copy (16 or 32 consecutive doubles) hit distinct banks.
template <bool KIN>
struct Lay {
    static constexpr int size = KIN ? BM * (BK + PAD) : BK * (BM + PAD);
    static __device__ __forceinline__ int at(int r, int k)
    {
        return KIN ? r * (BK + PAD) + k : k * (BM + PAD) + r;
    }
    // the cell a thread copies in its i-th slot: one at a time, or (vec)
    // in pairs along the unit-stride axis
    static __device__ __forceinline__ void cell(int i, bool vec, int& r,
                                                int& k)
    {
        const int t = threadIdx.x;
        if (vec) {
            const int j = i / 2, e = i % 2;
            if (KIN) {
                k = 2 * (t % (BK / 2)) + e;
                r = t / (BK / 2) + THREADS / (BK / 2) * j;
            } else {
                r = 2 * (t % (BM / 2)) + e;
                k = t / (BM / 2) + THREADS / (BM / 2) * j;
            }
        } else if (KIN) {
            k = t % BK;
            r = t / BK + THREADS / BK * i;
        } else {
            r = t % BM;
            k = t / BM + THREADS / BM * i;
        }
    }
};

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(double* dst, const double* src,
                                           int bytes)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// (d0; d1) += (a0; a1) · b on the f64 tensor cores: one 16 x 8 x 4
// product per warp; d0 and a0 hold rows lr, d1 and a1 rows lr + 8.
__device__ __forceinline__ void dmma(double (&d0)[2], double (&d1)[2],
                                     double a0, double a1, double b)
{
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d0[0]), "+d"(d0[1]), "+d"(d1[0]), "+d"(d1[1])
        : "d"(a0), "d"(a1), "d"(b));
}

// Copy the (rows r0.., k k0..) stage of an operand whose lead factor is
// base (strides sr, sk); cells outside [0, nr) x [0, nk) are zero-filled.
// With vec, two neighbours along the unit-stride axis per 16-byte copy
// (the host grants it where every pair is 16-byte aligned).
template <bool KIN>
__device__ __forceinline__ void load_stage(double* s, const double* base,
                                           long long sr, long long sk,
                                           int r0, int nr, int k0, int nk,
                                           bool vec)
{
    if (vec) {
#pragma unroll
        for (int i = 0; i < PER; i += 2) {
            int r, k;
            Lay<KIN>::cell(i, true, r, k);
            const int gr = r0 + r, gk = k0 + k;
            const bool first = gr < nr && gk < nk;
            const bool second = KIN ? gk + 1 < nk : gr + 1 < nr;
            cp_async16(s + Lay<KIN>::at(r, k),
                       first ? base + gr * sr + gk * sk : base,
                       first ? (second ? 16 : 8) : 0);
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        int r, k;
        Lay<KIN>::cell(i, false, r, k);
        const int gr = r0 + r, gk = k0 + k;
        const bool ok = gr < nr && gk < nk;
        cp_async8(s + Lay<KIN>::at(r, k),
                  ok ? base + gr * sr + gk * sk : base, ok);
    }
}

// The operand's other factors [f0, f1) and, with diag, the zero where the
// global row meets the global k (goff = row offset − k offset), applied to
// the cells this thread copied.
template <bool KIN>
__device__ __forceinline__ void fix_stage(double* s, const Table& tb, int f0,
                                          int f1, int r0, int nr, int k0,
                                          int nk, long long goff, bool diag,
                                          bool vec)
{
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        int r, k;
        Lay<KIN>::cell(i, vec, r, k);
        const int gr = r0 + r, gk = k0 + k;
        if (gr < nr && gk < nk) {
            double v = s[Lay<KIN>::at(r, k)] * eval(tb, f0, f1, gr, gk);
            if (diag && gr + goff == gk) v = 0.0;
            s[Lay<KIN>::at(r, k)] = v;
        }
    }
}

// Whether [a, a + na) and [b, b + nb) share a global index.
__device__ __forceinline__ bool overlap(long long a, int na, long long b,
                                        int nb)
{
    return a < b + nb && b < a + na;
}

template <bool KIN_A, bool KIN_B>
__global__ void __launch_bounds__(THREADS, 1)
tri_mma(const __grid_constant__ Table tb, int nx, int ny, int nz, int ox,
        int oy, int oz, int masked, bool vec_a, bool vec_b,
        double* __restrict__ part)
{
    extern __shared__ __align__(16) double smem[];
    double* const sa = smem;                              // STAGES A stages
    double* const sb = smem + STAGES * Lay<KIN_A>::size;  // STAGES B stages

    // grouped raster: GROUP x tiles share their B panels in L2
    const int tiles_x = (nx + BM - 1) / BM, tiles_z = (nz + BM - 1) / BM;
    const int per_group = GROUP * tiles_z;
    const int pid = blockIdx.x;
    const int first = (pid / per_group) * GROUP;
    const int gsize = min(tiles_x - first, GROUP);
    const int tx = first + (pid % per_group) % gsize;
    const int tz = (pid % per_group) / gsize;
    const int x0 = tx * BM, z0 = tz * BM;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / (BM / WN) * WM, wn = warp % (BM / WN) * WN;
    const int lr = lane >> 2, lc = lane & 3;

    const double* const baseA = tb.ptr[0];
    const long long sAr = tb.sr[0], sAk = tb.sc[0];
    const double* const baseB = tb.ptr[tb.na];
    const long long sBr = tb.sr[tb.na], sBk = tb.sc[tb.na];
    const bool extraA = tb.na > 1, extraB = tb.nb > 1;

    double acc[WM / 8][WN / 8][2];
#pragma unroll
    for (int i = 0; i < WM / 8; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

    const int nk = (ny + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) {
            load_stage<KIN_A>(sa + s * Lay<KIN_A>::size, baseA, sAr, sAk, x0,
                              nx, s * BK, ny, vec_a);
            load_stage<KIN_B>(sb + s * Lay<KIN_B>::size, baseB, sBr, sBk, z0,
                              nz, s * BK, ny, vec_b);
        }
        cp_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
        cp_wait<STAGES - 2>();
        const int st = kc % STAGES, k0 = kc * BK;
        double* const as = sa + st * Lay<KIN_A>::size;
        double* const bs = sb + st * Lay<KIN_B>::size;
        const bool diagA = masked && overlap((long long)x0 + ox, BM,
                                             (long long)k0 + oy, BK);
        const bool diagB = masked && overlap((long long)z0 + oz, BM,
                                             (long long)k0 + oy, BK);
        if (extraA || diagA)
            fix_stage<KIN_A>(as, tb, 1, tb.na, x0, nx, k0, ny,
                             (long long)ox - oy, diagA, vec_a);
        if (extraB || diagB)
            fix_stage<KIN_B>(bs, tb, tb.na + 1, tb.na + tb.nb, z0, nz, k0,
                             ny, (long long)oz - oy, diagB, vec_b);
        __syncthreads();
        const int nxt = kc + STAGES - 1;
        if (nxt < nk) {
            const int sn = nxt % STAGES;
            load_stage<KIN_A>(sa + sn * Lay<KIN_A>::size, baseA, sAr, sAk,
                              x0, nx, nxt * BK, ny, vec_a);
            load_stage<KIN_B>(sb + sn * Lay<KIN_B>::size, baseB, sBr, sBk,
                              z0, nz, nxt * BK, ny, vec_b);
        }
        cp_commit();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            double a[WM / 8], b[WN / 8];
#pragma unroll
            for (int i = 0; i < WM / 8; ++i)
                a[i] = as[Lay<KIN_A>::at(wm + i * 8 + lr, kk + lc)];
#pragma unroll
            for (int j = 0; j < WN / 8; ++j)
                b[j] = bs[Lay<KIN_B>::at(wn + j * 8 + lr, kk + lc)];
#pragma unroll
            for (int i = 0; i < WM / 8; i += 2)
#pragma unroll
                for (int j = 0; j < WN / 8; ++j)
                    dmma(acc[i][j], acc[i + 1][j], a[i], a[i + 1], b[j]);
        }
    }

    // epilogue: × C′(x, z), reduced; acc[i][j][e] is the cell
    // (x0 + wm + 8i + lr, z0 + wn + 8j + 2 lc + e)
    const int cf = tb.na + tb.nb;
    double v = 0.0;
#pragma unroll
    for (int i = 0; i < WM / 8; ++i) {
        const int x = x0 + wm + i * 8 + lr;
        if (x >= nx) continue;
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int z = z0 + wn + j * 8 + 2 * lc + e;
                const bool diag =
                    masked && (long long)x + ox == (long long)z + oz;
                if (z < nz && !diag)
                    v += acc[i][j][e] * eval(tb, cf, tb.nf, x, z);
            }
    }
    cp_wait<0>();
    __syncthreads();                  // the pipeline's smem is free now
    double* const red = smem;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, d);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        double total = 0.0;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) total += red[w];
        part[blockIdx.x] = total;
    }
}

// Whether the lead factor f can be copied in 16-byte pairs along its unit
// stride: the base 16-byte aligned and the other stride even.
static bool pairs(const Table& tb, int f, bool kin)
{
    const long long unit = kin ? tb.sc[f] : tb.sr[f];
    const long long other = kin ? tb.sr[f] : tb.sc[f];
    return unit == 1 && other % 2 == 0
           && ((unsigned long long)tb.ptr[f] & 15) == 0;
}

template <bool KIN_A, bool KIN_B>
static int run(const Table& tb, int nx, int ny, int nz, int ox, int oy,
               int oz, int masked, double* part, cudaStream_t st)
{
    auto kernel = tri_mma<KIN_A, KIN_B>;
    const int bytes =
        STAGES * (Lay<KIN_A>::size + Lay<KIN_B>::size) * (int)sizeof(double);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const long long blocks =
        (long long)((nx + BM - 1) / BM) * ((nz + BM - 1) / BM);
    kernel<<<(unsigned)blocks, THREADS, bytes, st>>>(
        tb, nx, ny, nz, ox, oy, oz, masked, pairs(tb, 0, KIN_A),
        pairs(tb, tb.na, KIN_B), part);
    return (int)cudaGetLastError();
}

}  // namespace tri

extern "C" {

int trijoin_path_tile() { return path::T; }
int trijoin_triangle_tile() { return tri::BM; }

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

// The triangle route.  Factors [0, na) form A′ on (x, y), [na, na + nb)
// B′ on (z, y), the rest C′ on (x, z); A′ and B′ lead with a factor that
// spans both their axes.  partials: one double per CTA.
int trijoin_triangle(const void* const* ptrs, const long long* strides,
                     int nf, int na, int nb, int nx, int ny, int nz, int ox,
                     int oy, int oz, int masked, void* partials,
                     void* stream)
{
    if (nf < 2 || nf > MAXF || na < 1 || nb < 1 || na + nb > nf || nx < 1
        || ny < 1 || nz < 1)
        return (int)cudaErrorInvalidValue;
    const Table tb = make_table(ptrs, strides, nf, na, nb);
    // row-inner only where the lead factor runs along rows with unit stride
    const bool kin_a = !(tb.sr[0] == 1 && tb.sc[0] != 1);
    const bool kin_b = !(tb.sr[na] == 1 && tb.sc[na] != 1);
    auto run = kin_a
        ? (kin_b ? &tri::run<true, true> : &tri::run<true, false>)
        : (kin_b ? &tri::run<false, true> : &tri::run<false, false>);
    return run(tb, nx, ny, nz, ox, oy, oz, masked, (double*)partials,
               (cudaStream_t)stream);
}

}  // extern "C"
