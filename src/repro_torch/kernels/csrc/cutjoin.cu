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
//   cutjoin_pair_keep  out[w] = Σ_{v != w} Π_i F_i           (|cut| = 2)
//   cutjoin_tri_keep   out[w] = Σ over the other two axes     (|cut| = 3)
//
// They replace the reference package's TPU kernels _vecjoin_kernel,
// _pairjoin_kernel, _pairjoin_keep_kernel and _trijoin_kernel (also run
// by tri_reduce_keep) in src/repro/kernels/matreduce.py.  All are one
// kernel template over "k factors, three index axes, per-factor strides
// (0 on an axis the factor does not span), per-axis global offsets"; the
// vector and pair tiers leave the leading axes at size 1.  In a keep form
// the kept cut axis is kernel axis 2, the thread axis: the wrapper puts
// it there by permuting the strides it passes (nothing is transposed or
// copied), and every thread writes its own f64 row partial instead of
// joining the block reduction.
//
// Arithmetic contract (what the exact_block guard certifies): factors are
// integer-valued f64.  Each value is converted to f32 in registers, the
// product is taken in f32, and an f32 partial sum accumulates at most
// `block` cells before it is folded into an f64 register.  `block` is a
// loop bound here, not a tile shape.  Every thread block reduces its f64
// registers by a fixed tree and writes ONE f64 into `partials`; the caller
// sums that buffer.  In a keep form each thread writes its f64 register to
// partials[(blockIdx.z * gridDim.y + blockIdx.y) * n2 + i2] and the caller
// sums dim 0 of that (gz * gy, n2) buffer.  The f32 partial folds the same
// <= `block` cells either way, so exact_block certifies both forms alike.
// No atomics: two runs give the same bits.
//
// What bounds it on this card: the vector and pair tiers read every factor
// cell once (8 bytes) and do a handful of operations on it, so they are
// bound by memory bytes; the design gives every thread one column, so a
// warp reads 256 contiguous bytes per row, and splits the rows over
// gridDim.z so that the grid fills the card.  The scalar tri tier here is
// the tri join's dense route only: a factor spans all three cut axes, so
// the n^3 cells are read once from n^3 bytes and the route is bound by
// bytes (kernels/matreduce.py sends the scalar join's mixes of pairs and
// vectors to trijoin.cu: the path route, an O(n^2) function bound by the
// bytes of its factors, and the triangle route, a matrix product bound by
// f64 tensor-core operations).  The tri keep form takes every mix here;
// on a mix without a factor over all three axes it walks n^3 cells of
// O(n^2) bytes and is bound by f32 operations.  The design loads the
// factors that do not span axis 0 once per (y, z) and reuses them for TX
// rows of x, hoists the factors that span axis 0 but not the chunk axis
// (and the x-against-z part of the mask) out of the loop, and walks the
// remaining factors with register pointers that step by a stride.
// A keep form whose kept axis is a row axis of its factors reads them
// uncoalesced (neighbouring threads walk neighbouring rows); that is left
// as it is, with its time written down.
//
// Ragged edges are masked here; nothing is padded and nothing is
// allocated.  Launches go to the stream the caller passes and never
// synchronise.  Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#define MAXF 8        // factor-table capacity; the wrapper folds surplus factors
#define THREADS 256

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
// instead of one per thread block.
template <int TX, int MASK, int NB, bool KEEP>
__global__ void __launch_bounds__(THREADS)
cutjoin_kernel(FactorTable T, int n0, int n1, int n2, int span1, int block,
               int off0, int off1, int off2, double* __restrict__ partials)
{
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
        float hoist[TX];
#pragma unroll
        for (int t = 0; t < TX; ++t) {
            float h = 1.0f;
            if (t < nrow) {
                const int i0 = x0 + t;
                for (int f = nab; f < T.nf; ++f)
                    h *= (float)T.ptr[f][i0 * T.s0[f] + i2 * T.s2[f]];
                if (MASK == 2 && i0 + off0 == g2) h = 0.0f;
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
            float acc[TX];
#pragma unroll
            for (int t = 0; t < TX; ++t) acc[t] = 0.0f;
            const int c_end = min(c + block, y_end);
            for (int i1 = c; i1 < c_end; ++i1) {
                float pin = 1.0f;
                for (int f = 0; f < T.na; ++f)
                    pin *= (float)T.ptr[f][i1 * T.s1[f] + i2 * T.s2[f]];
                const int g1 = i1 + off1;
                if (MASK != 0 && g1 == g2) pin = 0.0f;
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
                        float p = pin * hoist[t];
                        if (NB > 0) {
#pragma unroll
                            for (int f = 0; f < NBR; ++f) {
                                p *= (float)(*q[f]);
                                q[f] += sb0[f];
                            }
                        } else if (NB < 0) {
                            const int i0 = x0 + t;
                            for (int f = T.na; f < nab; ++f)
                                p *= (float)T.ptr[f][i0 * T.s0[f]
                                                     + i1 * T.s1[f]
                                                     + i2 * T.s2[f]];
                        }
                        if (MASK == 2 && t == d01) p = 0.0f;
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

    // fixed-tree block reduction: shuffles within a warp, then warp 0 lane 0
    // adds the warp sums in order
    __shared__ double warp_sum[THREADS / 32];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        acc64 += __shfl_down_sync(0xffffffffu, acc64, d);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc64;
    __syncthreads();
    if (threadIdx.x == 0) {
        double total = 0.0;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
        partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                 + blockIdx.x] = total;
    }
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

template <int TX, int MASK, int NB, bool KEEP>
static int launch_nb(const FactorTable& T, int n0, int n1, int n2, int span1,
                     int block, int off0, int off1, int off2, void* partials,
                     dim3 grid, void* stream)
{
    cutjoin_kernel<TX, MASK, NB, KEEP>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        T, n0, n1, n2, span1, block, off0, off1, off2, (double*)partials);
    return (int)cudaGetLastError();
}

#define LAUNCH_NB(NB)                                                         \
    launch_nb<TX, MASK, NB, KEEP>(T, n0, n1, n2, span1, block, off0, off1,    \
                                  off2, partials, grid, stream)

template <int TX, int MASK, bool KEEP>
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

extern "C" {

int cutjoin_tx_tri() { return TX_TRI; }
int cutjoin_max_factors() { return MAXF; }
int cutjoin_threads() { return THREADS; }

// |cut| = 1: n0 = n1 = 1, axis 2 is the cut axis; a single vertex is always
// injective, so there is no mask.
int cutjoin_vec(CUTJOIN_ARGS)
{
    (void)masked;
    return launch<TX_FLAT, 0, false>(CUTJOIN_PASS);
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

// Keep forms: axis 2 is the kept cut axis; `partials` holds gz * gy * n2
// doubles.
int cutjoin_pair_keep(CUTJOIN_ARGS)
{
    return masked ? launch<TX_FLAT, 1, true>(CUTJOIN_PASS)
                  : launch<TX_FLAT, 0, true>(CUTJOIN_PASS);
}

int cutjoin_tri_keep(CUTJOIN_ARGS)
{
    return masked ? launch<TX_TRI, 2, true>(CUTJOIN_PASS)
                  : launch<TX_TRI, 0, true>(CUTJOIN_PASS);
}

}  // extern "C"
