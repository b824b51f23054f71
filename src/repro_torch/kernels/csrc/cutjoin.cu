// Decomposition-join kernels for Hopper (sm_90a): the fused masked
// product-reduce behind the compiler's CutJoin node.
//
//   cutjoin_vec   Σ_x Π_i F_i[x]                              (|cut| = 1)
//   cutjoin_pair  Σ_{x,y} [gx != gy] Π_i F_i[x,y]             (|cut| = 2)
//   cutjoin_tri   Σ_{x,y,z pairwise distinct} Π_i F_i[...]    (|cut| = 3,
//                 dense route: a factor spans all three axes)
//
// and their keep forms, which leave one cut axis as the output vector:
//
//   cutjoin_pair_keep_rows  out[w] = Σ_{v != w} Π_i F_i      (|cut| = 2,
//                           the reduced axis has unit stride)
//   cutjoin_pair_keep       the same, any strides              (|cut| = 2)
//   cutjoin_tri_keep_slab   out[w] = Σ over the other two axes (|cut| = 3,
//                           the kept axis is not the unit-stride axis)
//   cutjoin_tri_keep        the same, the kept axis has unit stride
//
// They replace the reference package's TPU kernels _vecjoin_kernel,
// _pairjoin_kernel, _pairjoin_keep_kernel and _trijoin_kernel (also run
// by tri_reduce_keep) in src/repro/kernels/matreduce.py.
//
// Arithmetic contract.  Factors are integer-valued f64.  Two instances:
//   f32 (what the exact_block guard certifies): each value is converted
//     to f32 in registers, the product is taken in f32, and an f32 partial
//     sum accumulates at most `block` cells before it is folded into an
//     f64 register.  `block` is a loop bound here, not a tile shape;
//     exact while Π max|F_i| · block <= 2^24.
//   f64 (cutjoin_vec and the pair keep forms, with f64 = 1): products and
//     sums in f64, no chunks; exact while cells · Π max|F_i| <= 2^53, where
//     cells is the reduced length (n for cutjoin_vec, the reduced axis for
//     a keep form) — what exact_f64 in kernels/matreduce.py checks.  The
//     joins are bound by the bytes of their f64 factors, so the f64
//     instance moves the same bytes as the f32 one.
// Every sum is taken in a fixed order and nothing is summed by atomics:
// two runs give the same bits.
//
// cutjoin_vec: one launch to the final value.  Each thread walks the
// vectors with a grid stride (16-byte double2 loads when every factor has
// unit stride and a 16-byte aligned start), each CTA reduces its threads
// by a fixed tree and writes one partial to a scratch buffer, and the last
// CTA to arrive (a __threadfence, then an atomic ticket on a counter at the
// head of that buffer) sums the partials in index order, writes the one
// f64 result and resets the counter for the next launch.  The wrapper
// keeps one zeroed scratch buffer per device and stream.
//
// cutjoin_pair_keep_rows: one warp per kept row.  Its lanes walk the row
// along its unit stride, 16-byte double2 loads where every factor's start
// and row stride allow it, else 8-byte loads; each lane folds its cells as
// the contract says, the warp adds its lanes by a fixed shuffle tree, and
// lane 0 writes out[row]: one launch, no partials.  The wrapper takes this
// entry when the reduced axis has unit stride in the lead factor (keep=0
// on row-major factors, the anchored reads' case).
//
// cutjoin_tri_keep_slab: S CTAs per kept index w (grid (n_keep, S)), each
// walking its share of the rows of the n_v x n_u slab of the two reduced
// axes.  The lanes run along the reduced axis u that has the smallest
// stride in the lead factor (the factor over the most axes): a warp reads
// one row of the slab, 16-byte double2 loads where every factor read per
// cell has unit stride along u, even strides elsewhere and a 16-byte
// aligned start, else 8-byte loads.  Factors are read by what they span:
// over u and v (with or without w) per cell; over u alone (with or
// without w, as (0,2) at keep=0) once per CTA into a row of f32 products
// in shared memory; over v alone once per slab row into the row's scalar;
// over w alone (or nothing) once per CTA.  The mask compares global
// indices: the row with g_v == g_w is skipped, and the cells g_u == g_w
// and g_u == g_v add 0.  Each lane folds its cells as the contract says,
// the CTA adds its threads by a fixed tree, and thread 0 writes one f64 to
// partials[split * n_keep + w]; the caller sums dim 0 of that (S, n_keep)
// buffer.  The wrapper takes this entry unless the kept axis is the
// lead factor's unit-stride axis (tri_keep_entry in kernels/matreduce.py).
//
// The other entries are one template over "k factors, three index axes,
// per-factor strides (0 on an axis the factor does not span), per-axis
// global offsets"; the pair tier leaves axis 0 at size 1.  In a keep form
// the kept cut axis is kernel axis 2, the thread axis: the wrapper puts it
// there by permuting the strides it passes, and every thread writes its
// own f64 row partial to partials[(blockIdx.z * gridDim.y + blockIdx.y)
// * n2 + i2] instead of joining the block reduction; the caller sums dim 0
// of that (gz * gy, n2) buffer.  Otherwise every thread block reduces its
// f64 registers by a fixed tree and writes ONE f64 into `partials`; the
// caller sums that buffer.  The f32 partial folds the same <= `block`
// cells either way, so exact_block certifies every form alike.
//
// What bounds them on this card: the vector and pair tiers read every
// factor cell once (8 bytes) and do a handful of operations on it, so they
// are bound by memory bytes.  The template gives every thread one column,
// so a warp reads 256 contiguous bytes per row, and splits the rows over
// gridDim.z so that the grid fills the card; a keep form whose kept axis
// has unit stride (keep=1 on row-major factors) reads coalesced there.
// The scalar tri tier here is the tri join's dense route only: a factor
// spans all three cut axes, so the n^3 cells are read once from n^3 bytes
// and the route is bound by bytes (kernels/matreduce.py sends the scalar
// join's mixes of pairs and vectors to trijoin.cu: the path route, an
// O(n^2) function bound by the bytes of its factors, and the triangle
// route, a matrix product bound by f64 tensor-core operations).  The tri
// keep form takes every mix here; on a mix without a factor over all three
// axes it walks n^3 cells of O(n^2) bytes and is bound by f32 operations.
// The design loads the factors that do not span axis 0 once per (y, z) and
// reuses them for TX rows of x, hoists the factors that span axis 0 but not
// the chunk axis (and the x-against-z part of the mask) out of the loop,
// and walks the remaining factors with register pointers that step by a
// stride.  The tri keep form takes the template (cutjoin_tri_keep) only
// when its kept axis is the unit-stride axis, which then lies on the
// threads and reads coalesced; otherwise it takes the slab entry, whose
// lanes walk the unit stride.  The slab entry reads each cell of its
// per-cell factors once and the rest once per CTA or per row, so on the
// anchored joins' mixes (a factor over all three axes) it is bound by the
// bytes of those factors; on a mix without one it walks n^3 cells of
// O(n^2) bytes and is bound by f32 operations.
//
// Ragged edges are masked here; nothing is padded and nothing is
// allocated.  Launches go to the stream the caller passes and never
// synchronise.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#define MAXF 8        // factor-table capacity; the wrapper folds surplus factors
#define THREADS 256
#define WARPS (THREADS / 32)
#define VEC_MAX_GRID 256    // CTAs of cutjoin_vec at most (partials in scratch)
#define VEC_CELLS 8         // cells per thread cutjoin_vec aims at
#define UNROLL 4            // double2 steps a thread loads before it folds

// the product type of each arithmetic
template <bool F64> struct Arith { typedef float T; };
template <> struct Arith<true> { typedef double T; };

// One thread's sum under the arithmetic contract: f64 straight, or f32
// partials of at most `block` cells folded into f64.
template <bool F64>
struct Fold {
    typedef typename Arith<F64>::T T;
    double a64 = 0.0;
    float a32 = 0.0f;
    int left, block;
    __device__ explicit Fold(int b) : left(b), block(b) {}
    __device__ __forceinline__ void add(T p)
    {
        if constexpr (F64) {
            a64 += p;
        } else {
            a32 += p;
            if (--left == 0) {
                a64 += (double)a32;
                a32 = 0.0f;
                left = block;
            }
        }
    }
    __device__ __forceinline__ double total() const
    {
        return F64 ? a64 : a64 + (double)a32;
    }
};

__device__ __forceinline__ double warp_sum(double v)
{
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    return v;
}

// Fixed-tree block sum: shuffles within a warp, then thread 0 adds the warp
// sums in order.  The result is valid in thread 0 only.
__device__ __forceinline__ double block_sum(double v)
{
    __shared__ double warp_total[WARPS];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = v;
    __syncthreads();
    double total = 0.0;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += warp_total[w];
    }
    return total;
}

// -- one strided line: cutjoin_vec and cutjoin_pair_keep_rows ---------------------

struct LineTable {
    const double* ptr[MAXF];   // start of the line per factor
    long long step[MAXF];      // element stride along the line
    long long lead[MAXF];      // element stride between lines (rows entry)
    int nf;
};

// Fold Π_f F_f[j] into `acc` for the cells j = first, first + stride, ...
// < n of one line (base[f] its start in factor f, step[f] its stride);
// the cell j == skip (the mask's diagonal, -1 for none) adds 0.  NF > 0:
// the factor count at compile time; NF == 0: any count, read per cell.
// V2: unit steps and 16-byte aligned starts, the cells taken in pairs by
// one double2 load per factor, UNROLL pairs loaded before any is folded;
// the odd last cell goes to the thread whose first cell is 0.
template <int NF, bool F64, bool V2>
__device__ __forceinline__ void walk_line(const double* const* base,
                                          const long long* step, int nf,
                                          long long n, long long first,
                                          long long stride, long long skip,
                                          Fold<F64>& acc)
{
    typedef typename Arith<F64>::T T;
    const int nfr = NF > 0 ? NF : nf;
    if constexpr (V2) {
        const long long pairs = n >> 1;
        for (long long q0 = first; q0 < pairs; q0 += UNROLL * stride) {
            T lo[UNROLL], hi[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const long long q = q0 + u * stride;
                lo[u] = T(0);
                hi[u] = T(0);
                if (q < pairs) {
                    const double2 v0 =
                        __ldg(reinterpret_cast<const double2*>(base[0]) + q);
                    lo[u] = (T)v0.x;
                    hi[u] = (T)v0.y;
#pragma unroll
                    for (int f = 1; f < (NF > 0 ? NF : MAXF); ++f) {
                        if (NF == 0 && f >= nfr) break;
                        const double2 v = __ldg(
                            reinterpret_cast<const double2*>(base[f]) + q);
                        lo[u] *= (T)v.x;
                        hi[u] *= (T)v.y;
                    }
                    if (2 * q == skip) lo[u] = T(0);
                    if (2 * q + 1 == skip) hi[u] = T(0);
                }
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (q0 + u * stride < pairs) {
                    acc.add(lo[u]);
                    acc.add(hi[u]);
                }
            }
        }
        if ((n & 1) && first == 0) {
            const long long j = n - 1;
            T p = (T)__ldg(base[0] + j);
#pragma unroll
            for (int f = 1; f < (NF > 0 ? NF : MAXF); ++f) {
                if (NF == 0 && f >= nfr) break;
                p *= (T)__ldg(base[f] + j);
            }
            acc.add(j == skip ? T(0) : p);
        }
    } else {
        for (long long j = first; j < n; j += stride) {
            T p = (T)__ldg(base[0] + j * step[0]);
#pragma unroll
            for (int f = 1; f < (NF > 0 ? NF : MAXF); ++f) {
                if (NF == 0 && f >= nfr) break;
                p *= (T)__ldg(base[f] + j * step[f]);
            }
            acc.add(j == skip ? T(0) : p);
        }
    }
}

template <int NF, bool F64, bool V2>
__global__ void __launch_bounds__(THREADS)
vec_kernel(LineTable T, long long n, int block, double* __restrict__ scratch,
           double* __restrict__ out)
{
    const double* base[MAXF];
    long long step[MAXF];
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
        base[f] = T.ptr[f];
        step[f] = T.step[f];
    }
    Fold<F64> acc(block);
    walk_line<NF, F64, V2>(base, step, T.nf, n,
                           (long long)blockIdx.x * THREADS + threadIdx.x,
                           (long long)gridDim.x * THREADS, -1, acc);
    const double part = block_sum(acc.total());
    if (threadIdx.x != 0) return;
    if (gridDim.x == 1) {
        out[0] = part;
        return;
    }
    // scratch: an unsigned counter in the first double, then one partial
    // per CTA; the last CTA to take a ticket finishes the sum
    unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
    double* partials = scratch + 1;
    partials[blockIdx.x] = part;
    __threadfence();
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
        __threadfence();
        double total = 0.0;
        for (unsigned b = 0; b < gridDim.x; ++b) total += __ldcg(partials + b);
        out[0] = total;
        *ticket = 0u;                   // ready for the next launch
    }
}

// One warp per kept row: out[row] = Σ_j [g_row != g_j] Π_f F_f[row, j].
template <int NF, bool F64, bool MASK, bool V2>
__global__ void __launch_bounds__(THREADS)
keep_rows_kernel(LineTable T, int m, int n, int block, int off_keep,
                 int off_red, double* __restrict__ out)
{
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= m) return;              // the whole warp leaves together
    const double* base[MAXF];
    long long step[MAXF];
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
        base[f] = T.ptr[f] + (long long)row * T.lead[f];
        step[f] = T.step[f];
    }
    // the reduced index whose global vertex is the row's
    const long long skip = MASK ? (long long)row + off_keep - off_red : -1;
    Fold<F64> acc(block);
    walk_line<NF, F64, V2>(base, step, T.nf, n, lane, 32, skip, acc);
    const double v = warp_sum(acc.total());
    if (lane == 0) out[row] = v;
}

// -- the slab entry of the tri keep form -------------------------------------------

#define SLAB_MAX_U 8192     // floats of the staged u row: 32 KB of shared memory

struct SlabTable {
    const double* ptr[MAXF];
    long long sk[MAXF], sv[MAXF], su[MAXF];   // element strides along w, v, u
    int nf;   // factors in all, ordered [cells | u rows | v rows | w scalars]
    int nc;   // span u and v                 (read per cell)
    int nu;   // span u, not v                (staged once per CTA)
    int nv;   // span v, not u                (read once per slab row)
};

// One slab row of one lane: Σ_u pin · row_u[u] · Π_f F_f[u] into `acc`,
// the cells skip_w and skip_v adding 0.  NC >= 0: the per-cell factor
// count at compile time; NC < 0: any count, `nc` at run time.  V2: unit
// strides and 16-byte aligned rows, the cells taken in pairs.
template <int NC, bool V2>
__device__ __forceinline__ void walk_slab_row(const double* const* base,
                                              const long long* su, int nc,
                                              const float* row_u, int n,
                                              int lane, float pin,
                                              long long skip_w,
                                              long long skip_v,
                                              Fold<false>& acc)
{
    constexpr int NCM = NC >= 0 ? NC : MAXF;
    if constexpr (V2) {
        const int pairs = n >> 1;
        for (int q0 = lane; q0 < pairs; q0 += UNROLL * 32) {
            float lo[UNROLL], hi[UNROLL];
#pragma unroll
            for (int s = 0; s < UNROLL; ++s) {
                const int q = q0 + s * 32;
                lo[s] = 0.0f;
                hi[s] = 0.0f;
                if (q < pairs) {
                    const float2 r = reinterpret_cast<const float2*>(row_u)[q];
                    lo[s] = pin * r.x;
                    hi[s] = pin * r.y;
#pragma unroll
                    for (int f = 0; f < NCM; ++f) {
                        if (NC < 0 && f >= nc) break;
                        const double2 x = __ldg(
                            reinterpret_cast<const double2*>(base[f]) + q);
                        lo[s] *= (float)x.x;
                        hi[s] *= (float)x.y;
                    }
                    const long long j = 2 * (long long)q;
                    if (j == skip_w || j == skip_v) lo[s] = 0.0f;
                    if (j + 1 == skip_w || j + 1 == skip_v) hi[s] = 0.0f;
                }
            }
#pragma unroll
            for (int s = 0; s < UNROLL; ++s) {
                if (q0 + s * 32 < pairs) {
                    acc.add(lo[s]);
                    acc.add(hi[s]);
                }
            }
        }
        if ((n & 1) && lane == 0) {
            const int j = n - 1;
            float p = pin * row_u[j];
#pragma unroll
            for (int f = 0; f < NCM; ++f) {
                if (NC < 0 && f >= nc) break;
                p *= (float)__ldg(base[f] + j);
            }
            acc.add(j == skip_w || j == skip_v ? 0.0f : p);
        }
    } else {
        for (int j = lane; j < n; j += 32) {
            float p = pin * row_u[j];
#pragma unroll
            for (int f = 0; f < NCM; ++f) {
                if (NC < 0 && f >= nc) break;
                p *= (float)__ldg(base[f] + j * su[f]);
            }
            acc.add(j == skip_w || j == skip_v ? 0.0f : p);
        }
    }
}

// out[w] partials: CTA (w, split) walks rows v in [split * span, ...) of
// the (n_v, n_u) slab of kept index w, a warp per row.
template <int NC, bool MASK, bool V2>
__global__ void __launch_bounds__(THREADS)
slab_kernel(SlabTable T, int n_k, int n_u, int n_v, int span, int block,
            int off_k, int off_u, int off_v, double* __restrict__ partials)
{
    extern __shared__ float row_u[];          // Π of the u-row factors at w
    constexpr int NCM = NC > 0 ? NC : (NC == 0 ? 1 : MAXF);
    const int w = blockIdx.x;
    const int v_end = min((int)blockIdx.y * span + span, n_v);
    const int urows = T.nc + T.nu, vrows = urows + T.nv;
    for (int u = threadIdx.x; u < n_u; u += THREADS) {
        float p = 1.0f;
        for (int f = T.nc; f < urows; ++f)
            p *= (float)__ldg(T.ptr[f] + w * T.sk[f] + u * T.su[f]);
        row_u[u] = p;
    }
    float scalar = 1.0f;
    for (int f = vrows; f < T.nf; ++f)
        scalar *= (float)__ldg(T.ptr[f] + w * T.sk[f]);
    long long su[NCM];
#pragma unroll
    for (int f = 0; f < NCM; ++f) su[f] = T.su[f];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long gw = (long long)w + off_k;
    const long long skip_w = MASK ? gw - off_u : -1;   // the u with g_u == g_w
    Fold<false> acc(block);
    for (int v = blockIdx.y * span + (threadIdx.x >> 5); v < v_end;
         v += WARPS) {
        const long long gv = (long long)v + off_v;
        if (MASK && gv == gw) continue;
        float pin = scalar;
        for (int f = urows; f < vrows; ++f)
            pin *= (float)__ldg(T.ptr[f] + w * T.sk[f] + v * T.sv[f]);
        const double* base[NCM];
#pragma unroll
        for (int f = 0; f < NCM; ++f)
            base[f] = T.ptr[f] + w * T.sk[f] + v * T.sv[f];
        walk_slab_row<NC, V2>(base, su, T.nc, row_u, n_u, lane, pin, skip_w,
                              MASK ? gv - off_u : -1, acc);
    }
    const double part = block_sum(acc.total());
    if (threadIdx.x == 0)
        partials[(size_t)blockIdx.y * n_k + w] = part;
}

// -- the strided template: cutjoin_pair, cutjoin_tri and their keep forms --------

struct FactorTable {
    const double* ptr[MAXF];
    long long s0[MAXF], s1[MAXF], s2[MAXF];   // element strides per axis
    int nf;   // factors in all, ordered [A | B | C]
    int na;   // A: do not span axis 0            (loaded once per (i1, i2))
    int nb;   // B: span axis 0 and axis 1        (loaded per cell)
              // C: span axis 0 but not axis 1    (hoisted out of the i1 loop)
};

// MASK 0: none; 1: g1 != g2; 2: g0, g1, g2 pairwise distinct.
// NB >= 0: the count of B factors is known at compile time, so their row
// pointers live in registers and step by a stride per cell instead of being
// recomputed from three 64-bit products; NB < 0: any count, read from the
// table per cell.  KEEP: write one f64 per thread (the kept axis is axis 2)
// instead of one per thread block.  F64: the f64 instance (no chunks).
template <int TX, int MASK, int NB, bool KEEP, bool F64>
__global__ void __launch_bounds__(THREADS)
cutjoin_kernel(FactorTable T, int n0, int n1, int n2, int span1, int block,
               int off0, int off1, int off2, double* __restrict__ partials)
{
    typedef typename Arith<F64>::T R;
    const int i2 = blockIdx.x * THREADS + threadIdx.x;
    const int x0 = blockIdx.y * TX;
    const int nrow = min(TX, n0 - x0);          // rows of axis 0 that exist
    const int y_begin = blockIdx.z * span1;
    const int y_end = min(y_begin + span1, n1);
    double acc64 = 0.0;

    if (i2 < n2) {
        const int g2 = i2 + off2;
        const int nab = T.na + T.nb;
        // per row of axis 0: the C factors, and the part of the mask that
        // does not depend on axis 1
        R hoist[TX];
#pragma unroll
        for (int t = 0; t < TX; ++t) {
            R h = R(1);
            if (t < nrow) {
                const int i0 = x0 + t;
                for (int f = nab; f < T.nf; ++f)
                    h *= (R)T.ptr[f][i0 * T.s0[f] + i2 * T.s2[f]];
                if (MASK == 2 && i0 + off0 == g2) h = R(0);
            }
            hoist[t] = h;
        }
        constexpr int NBR = NB > 0 ? NB : 1;
        const double* row[NBR];                 // B factors at (x0, i1, i2)
        long long sb0[NBR], sb1[NBR];
        if (NB > 0) {
#pragma unroll
            for (int f = 0; f < NBR; ++f) {
                const int g = T.na + f;
                sb0[f] = T.s0[g];
                sb1[f] = T.s1[g];
                row[f] = T.ptr[g] + x0 * sb0[f] + y_begin * sb1[f]
                         + i2 * T.s2[g];
            }
        }
        for (int c = y_begin; c < y_end; c += block) {
            R acc[TX];
#pragma unroll
            for (int t = 0; t < TX; ++t) acc[t] = R(0);
            const int c_end = min(c + block, y_end);
            for (int i1 = c; i1 < c_end; ++i1) {
                R pin = R(1);
                for (int f = 0; f < T.na; ++f)
                    pin *= (R)T.ptr[f][i1 * T.s1[f] + i2 * T.s2[f]];
                const int g1 = i1 + off1;
                if (MASK != 0 && g1 == g2) pin = R(0);
                const int d01 = g1 - off0 - x0;   // the row t with g0 == g1
                const double* q[NBR];
                if (NB > 0) {
#pragma unroll
                    for (int f = 0; f < NBR; ++f) {
                        q[f] = row[f];
                        row[f] += sb1[f];
                    }
                }
#pragma unroll
                for (int t = 0; t < TX; ++t) {
                    if (t < nrow) {
                        R p = pin * hoist[t];
                        if (NB > 0) {
#pragma unroll
                            for (int f = 0; f < NBR; ++f) {
                                p *= (R)(*q[f]);
                                q[f] += sb0[f];
                            }
                        } else if (NB < 0) {
                            const int i0 = x0 + t;
                            for (int f = T.na; f < nab; ++f)
                                p *= (R)T.ptr[f][i0 * T.s0[f]
                                                 + i1 * T.s1[f]
                                                 + i2 * T.s2[f]];
                        }
                        if (MASK == 2 && t == d01) p = R(0);
                        acc[t] += p;
                    }
                }
            }
#pragma unroll
            for (int t = 0; t < TX; ++t) acc64 += (double)acc[t];
        }
    }

    if constexpr (KEEP) {      // every thread of the block takes this branch
        if (i2 < n2)
            partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * n2 + i2]
                = acc64;
        return;
    }

    const double total = block_sum(acc64);
    if (threadIdx.x == 0)
        partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                 + blockIdx.x] = total;
}

static FactorTable make_table(const void* const* ptrs, const long long* strides,
                              int nf, int na, int nb)
{
    FactorTable T;
    for (int f = 0; f < MAXF; ++f) {
        T.ptr[f] = nullptr;
        T.s0[f] = T.s1[f] = T.s2[f] = 0;
    }
    for (int f = 0; f < nf; ++f) {
        T.ptr[f] = (const double*)ptrs[f];
        T.s0[f] = strides[3 * f + 0];
        T.s1[f] = strides[3 * f + 1];
        T.s2[f] = strides[3 * f + 2];
    }
    T.nf = nf; T.na = na; T.nb = nb;
    return T;
}

// Rows of axis 0 per thread.  The vector and pair tiers have no axis 0.
#define TX_FLAT 1
#define TX_TRI 8

template <int TX, int MASK, int NB, bool KEEP, bool F64>
static int launch_nb(const FactorTable& T, int n0, int n1, int n2, int span1,
                     int block, int off0, int off1, int off2, void* partials,
                     dim3 grid, void* stream)
{
    cutjoin_kernel<TX, MASK, NB, KEEP, F64>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        T, n0, n1, n2, span1, block, off0, off1, off2, (double*)partials);
    return (int)cudaGetLastError();
}

#define LAUNCH_NB(NB)                                                         \
    launch_nb<TX, MASK, NB, KEEP, F64>(T, n0, n1, n2, span1, block, off0,     \
                                       off1, off2, partials, grid, stream)

template <int TX, int MASK, bool KEEP, bool F64 = false>
static int launch(const void* const* ptrs, const long long* strides, int nf,
                  int na, int nb, int n0, int n1, int n2, int span1, int block,
                  int off0, int off1, int off2, void* partials,
                  int gx, int gy, int gz, void* stream)
{
    if (nf < 1 || nf > MAXF || na < 0 || nb < 0 || na + nb > nf || block < 1
        || span1 < 1)
        return (int)cudaErrorInvalidValue;
    FactorTable T = make_table(ptrs, strides, nf, na, nb);
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
    if constexpr (TX == 1) {                // no axis 0, hence no B factors
        return nb == 0 ? LAUNCH_NB(0) : (int)cudaErrorInvalidValue;
    } else {
        switch (nb) {
            case 0: return LAUNCH_NB(0);
            case 1: return LAUNCH_NB(1);
            case 2: return LAUNCH_NB(2);
            default: return LAUNCH_NB(-1);
        }
    }
}

#define CUTJOIN_ARGS                                                          \
    const void* const* ptrs, const long long* strides, int nf, int na, int nb, \
    int n0, int n1, int n2, int span1, int block, int masked,                 \
    int off0, int off1, int off2, void* partials, int gx, int gy, int gz,     \
    void* stream
#define CUTJOIN_PASS                                                          \
    ptrs, strides, nf, na, nb, n0, n1, n2, span1, block, off0, off1, off2,    \
    partials, gx, gy, gz, stream

// -- launchers of the line kernels -------------------------------------------------

// table: the nf factors' addresses, then per factor (step along the line,
// stride between lines), as 64-bit integers (one array from the caller);
// returns false when the table is out of range
static bool make_lines(const long long* table, int nf, LineTable& T,
                       bool& v2)
{
    if (nf < 1 || nf > MAXF) return false;
    const long long* strides = table + nf;
    v2 = true;
    for (int f = 0; f < MAXF; ++f) {
        T.ptr[f] = f < nf ? (const double*)table[f] : nullptr;
        T.step[f] = f < nf ? strides[2 * f] : 0;
        T.lead[f] = f < nf ? strides[2 * f + 1] : 0;
        if (f < nf)
            v2 = v2 && T.step[f] == 1 && (T.lead[f] & 1) == 0
                 && ((unsigned long long)T.ptr[f] & 15) == 0;
    }
    T.nf = nf;
    return true;
}

template <int NF, bool F64, bool V2>
static int launch_vec(const LineTable& T, long long n, int block, int grid,
                      void* scratch, void* out, void* stream)
{
    vec_kernel<NF, F64, V2><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        T, n, block, (double*)scratch, (double*)out);
    return (int)cudaGetLastError();
}

template <bool F64, bool V2>
static int launch_vec_nf(const LineTable& T, long long n, int block, int grid,
                         void* scratch, void* out, void* stream)
{
    switch (T.nf) {
        case 1: return launch_vec<1, F64, V2>(T, n, block, grid, scratch, out, stream);
        case 2: return launch_vec<2, F64, V2>(T, n, block, grid, scratch, out, stream);
        case 3: return launch_vec<3, F64, V2>(T, n, block, grid, scratch, out, stream);
        case 4: return launch_vec<4, F64, V2>(T, n, block, grid, scratch, out, stream);
        default: return launch_vec<0, F64, V2>(T, n, block, grid, scratch, out, stream);
    }
}

template <int NF, bool F64, bool MASK, bool V2>
static int launch_rows(const LineTable& T, int m, int n, int block,
                       int off_keep, int off_red, void* out, void* stream)
{
    const unsigned grid = (unsigned)((m + WARPS - 1) / WARPS);
    keep_rows_kernel<NF, F64, MASK, V2>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        T, m, n, block, off_keep, off_red, (double*)out);
    return (int)cudaGetLastError();
}

template <bool F64, bool MASK, bool V2>
static int launch_rows_nf(const LineTable& T, int m, int n, int block,
                          int off_keep, int off_red, void* out, void* stream)
{
    switch (T.nf) {
        case 1: return launch_rows<1, F64, MASK, V2>(T, m, n, block, off_keep, off_red, out, stream);
        case 2: return launch_rows<2, F64, MASK, V2>(T, m, n, block, off_keep, off_red, out, stream);
        case 3: return launch_rows<3, F64, MASK, V2>(T, m, n, block, off_keep, off_red, out, stream);
        case 4: return launch_rows<4, F64, MASK, V2>(T, m, n, block, off_keep, off_red, out, stream);
        default: return launch_rows<0, F64, MASK, V2>(T, m, n, block, off_keep, off_red, out, stream);
    }
}

template <bool F64>
static int launch_rows_mask(const LineTable& T, bool v2, int masked, int m,
                            int n, int block, int off_keep, int off_red,
                            void* out, void* stream)
{
    if (masked)
        return v2 ? launch_rows_nf<F64, true, true>(T, m, n, block, off_keep, off_red, out, stream)
                  : launch_rows_nf<F64, true, false>(T, m, n, block, off_keep, off_red, out, stream);
    return v2 ? launch_rows_nf<F64, false, true>(T, m, n, block, off_keep, off_red, out, stream)
              : launch_rows_nf<F64, false, false>(T, m, n, block, off_keep, off_red, out, stream);
}

template <int NC, bool MASK, bool V2>
static int launch_slab(const SlabTable& T, int n_k, int n_u, int n_v,
                       int splits, int span, int block, int off_k, int off_u,
                       int off_v, void* partials, void* stream)
{
    slab_kernel<NC, MASK, V2><<<dim3((unsigned)n_k, (unsigned)splits),
                                THREADS, n_u * sizeof(float),
                                (cudaStream_t)stream>>>(
        T, n_k, n_u, n_v, span, block, off_k, off_u, off_v,
        (double*)partials);
    return (int)cudaGetLastError();
}

#define LAUNCH_SLAB(NC, MASK, V2)                                             \
    launch_slab<NC, MASK, V2>(T, n_k, n_u, n_v, splits, span, block, off_k,   \
                              off_u, off_v, partials, stream)

template <bool MASK, bool V2>
static int launch_slab_nc(const SlabTable& T, int n_k, int n_u, int n_v,
                          int splits, int span, int block, int off_k,
                          int off_u, int off_v, void* partials, void* stream)
{
    switch (T.nc) {
        case 0: return LAUNCH_SLAB(0, MASK, V2);
        case 1: return LAUNCH_SLAB(1, MASK, V2);
        case 2: return LAUNCH_SLAB(2, MASK, V2);
        default: return LAUNCH_SLAB(-1, MASK, V2);
    }
}

extern "C" {

int cutjoin_tx_tri() { return TX_TRI; }
int cutjoin_slab_max_u() { return SLAB_MAX_U; }
int cutjoin_max_factors() { return MAXF; }
int cutjoin_threads() { return THREADS; }
// doubles of the scratch buffer cutjoin_vec takes: its counter, then one
// partial per CTA
int cutjoin_vec_scratch() { return 1 + VEC_MAX_GRID; }

// |cut| = 1: Σ_x Π_f F_f[x] over n cells into out[0], in one launch.
// table: the factors' addresses, then per factor (element stride, 0);
// scratch: cutjoin_vec_scratch() doubles, zeroed once by the caller and
// left zeroed by every launch; f64: the f64 instance (block unused).  A
// single vertex is always injective, so there is no mask.
int cutjoin_vec(const long long* table, int nf, long long n, int block,
                int f64, void* scratch, void* out, void* stream)
{
    LineTable T;
    bool v2;
    if (!make_lines(table, nf, T, v2) || n < 1 || block < 1)
        return (int)cudaErrorInvalidValue;
    const long long want = (n + (long long)THREADS * VEC_CELLS - 1)
                           / ((long long)THREADS * VEC_CELLS);
    const int grid = (int)(want < VEC_MAX_GRID ? want : VEC_MAX_GRID);
    if (f64)
        return v2 ? launch_vec_nf<true, true>(T, n, block, grid, scratch, out, stream)
                  : launch_vec_nf<true, false>(T, n, block, grid, scratch, out, stream);
    return v2 ? launch_vec_nf<false, true>(T, n, block, grid, scratch, out, stream)
              : launch_vec_nf<false, false>(T, n, block, grid, scratch, out, stream);
}

// |cut| = 2: n0 = 1, axis 1 is the row (chunk) axis, axis 2 the column axis.
int cutjoin_pair(CUTJOIN_ARGS)
{
    return masked ? launch<TX_FLAT, 1, false>(CUTJOIN_PASS)
                  : launch<TX_FLAT, 0, false>(CUTJOIN_PASS);
}

// |cut| = 3: axes (0, 1, 2) are the three cut axes; axis 1 is the chunk axis.
int cutjoin_tri(CUTJOIN_ARGS)
{
    return masked ? launch<TX_TRI, 2, false>(CUTJOIN_PASS)
                  : launch<TX_TRI, 0, false>(CUTJOIN_PASS);
}

// The pair keep form, one warp per kept row: out[r] for r < m over the n
// cells of the reduced axis.  table: the factors' addresses, then per
// factor (reduced-axis stride, kept-axis stride); off_keep / off_red: the
// global offsets of the kept and the reduced axis (the mask compares
// r + off_keep with j + off_red); out: m doubles; f64: the f64 instance.
int cutjoin_pair_keep_rows(const long long* table, int nf, int m, int n,
                           int block, int masked, int off_keep, int off_red,
                           int f64, void* out, void* stream)
{
    LineTable T;
    bool v2;
    if (!make_lines(table, nf, T, v2) || m < 1 || n < 1 || block < 1)
        return (int)cudaErrorInvalidValue;
    return f64 ? launch_rows_mask<true>(T, v2, masked, m, n, block, off_keep,
                                        off_red, out, stream)
               : launch_rows_mask<false>(T, v2, masked, m, n, block, off_keep,
                                         off_red, out, stream);
}

// Keep forms of the template: axis 2 is the kept cut axis; `partials` holds
// gz * gy * n2 doubles.
int cutjoin_pair_keep(CUTJOIN_ARGS)
{
    return masked ? launch<TX_FLAT, 1, true>(CUTJOIN_PASS)
                  : launch<TX_FLAT, 0, true>(CUTJOIN_PASS);
}

int cutjoin_pair_keep_f64(CUTJOIN_ARGS)
{
    return masked ? launch<TX_FLAT, 1, true, true>(CUTJOIN_PASS)
                  : launch<TX_FLAT, 0, true, true>(CUTJOIN_PASS);
}

int cutjoin_tri_keep(CUTJOIN_ARGS)
{
    return masked ? launch<TX_TRI, 2, true>(CUTJOIN_PASS)
                  : launch<TX_TRI, 0, true>(CUTJOIN_PASS);
}

// The tri keep form's slab entry: out[w] for w < n_k over the (n_v, n_u)
// slab of the reduced axes.  ptrs: the nf factors' addresses, ordered
// [nc over u and v | nu over u | nv over v | the rest over w or nothing];
// strides: per factor (w, v, u) element strides, 0 on an axis it does not
// span; off_*: the axes' global offsets; partials: splits * n_k doubles,
// split s taking rows [s * span, (s + 1) * span) of every slab.
int cutjoin_tri_keep_slab(const void* const* ptrs, const long long* strides,
                          int nf, int nc, int nu, int nv, int n_k, int n_u,
                          int n_v, int splits, int span, int block,
                          int masked, int off_k, int off_u, int off_v,
                          void* partials, void* stream)
{
    if (nf < 1 || nf > MAXF || nc < 0 || nu < 0 || nv < 0
        || nc + nu + nv > nf || n_k < 1 || n_u < 1 || n_u > SLAB_MAX_U
        || n_v < 1 || splits < 1 || splits > 65535 || span < 1
        || (long long)splits * span < n_v || block < 1)
        return (int)cudaErrorInvalidValue;
    SlabTable T;
    bool v2 = true;
    for (int f = 0; f < MAXF; ++f) {
        T.ptr[f] = f < nf ? (const double*)ptrs[f] : nullptr;
        T.sk[f] = f < nf ? strides[3 * f + 0] : 0;
        T.sv[f] = f < nf ? strides[3 * f + 1] : 0;
        T.su[f] = f < nf ? strides[3 * f + 2] : 0;
        if (f < nc)
            v2 = v2 && T.su[f] == 1 && (T.sk[f] & 1) == 0
                 && (T.sv[f] & 1) == 0
                 && ((unsigned long long)T.ptr[f] & 15) == 0;
    }
    T.nf = nf; T.nc = nc; T.nu = nu; T.nv = nv;
    if (masked)
        return v2 ? launch_slab_nc<true, true>(T, n_k, n_u, n_v, splits, span, block, off_k, off_u, off_v, partials, stream)
                  : launch_slab_nc<true, false>(T, n_k, n_u, n_v, splits, span, block, off_k, off_u, off_v, partials, stream);
    return v2 ? launch_slab_nc<false, true>(T, n_k, n_u, n_v, splits, span, block, off_k, off_u, off_v, partials, stream)
              : launch_slab_nc<false, false>(T, n_k, n_u, n_v, splits, span, block, off_k, off_u, off_v, partials, stream);
}

}  // extern "C"
