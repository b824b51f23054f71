// The tile walk and the cell maps of the triangle route's kernel
// (`tri::tri_mma` in trijoin.cu).
//
// Tiles.  The join's (x, z) plane is cut into TILE_X x tile_z tiles, one
// f64 partial each at the tile's index in the grouped raster: GROUP x tiles
// share their B panels (the z rows) in L2, and a group's tiles go z tile by
// z tile, x fastest.  A launch runs `grid` persistent CTAs; CTA b takes the
// tiles b, b + grid, b + 2 grid, ... in that order, so the CTAs resident at
// one time hold neighbouring tiles of the raster.
//
// Cells.  A stage holds BK values of y for the tile's rows of each
// operand (TILE_X of A′, tile_z of B′), in
// the layout a TMA load with 128-byte swizzle writes: k-inner (`kin`:
// the operand's lead factor has unit stride along y) as rows of 16 k, or
// row-inner (unit stride along the rows) as boxes of 16 rows x 16 k.
// Either way the 16-byte chunk c of a 128-byte line l lies at chunk
// c ^ (l % 8).  The copies with cp.async, where TMA cannot read the
// factor, write the same cells.
//
// Fragments.  Lane (g, t) = (lane / 4, lane % 4) of a warp holds, for
// each of its mma's rows, the values of y at k = kappa(t, q), q = 0..3: a
// permutation of the stage's 16 k that A and B share, so that every
// product still sums over all of y.  It puts q = 0, 1 in one 16-byte chunk
// and q = 2, 3 in another, one load each in the k-inner layout.  A
// fragment row g is the tile row rho(kin, g) of its group of 8 (the
// accumulators follow it): in the k-inner layout rows 0..3 and 4..7
// alternate, so that the eight lanes of a quarter warp read eight distinct
// chunks; in the row-inner layout, with the k of the four lanes t eight
// apart in their swizzle (2t), rows stay in order.  No fragment load has a
// bank conflict in either layout (tests/test_torch_kernels_tri_order.py
// counts them).
//
// Plain C++ apart from the qualifiers, so that a host compiler can build
// it alone (tests/test_torch_kernels_tri_order.py does).
#pragma once

#ifdef __CUDACC__
#define TRI_ORDER_FN __host__ __device__ __forceinline__
#else
#define TRI_ORDER_FN inline
#endif

namespace tri_order {

constexpr int BK = 16;        // y per stage
constexpr int GROUP = 8;      // x tiles per raster group
constexpr int WM = 64;        // a consumer warp's rows of x ...
constexpr int WN = 32;        // ... and of z
constexpr int TILE_X = 2 * WM;   // a CTA tile's x: two warps; its z is
                                 // the kernel's choice, WN a warp pair

struct Tile {
  int tx, tz;
};

// The tile at index `idx` of the grouped raster over tiles_x x tiles_z
// (fewer than 2^31 tiles: 32-bit arithmetic).
TRI_ORDER_FN Tile tile_at(int idx, int tiles_x, int tiles_z) {
  const int per_group = GROUP * tiles_z;
  const int first = idx / per_group * GROUP;
  const int gsize = tiles_x - first < GROUP ? tiles_x - first : GROUP;
  const int rem = idx % per_group;
  return {first + rem % gsize, rem / gsize};
}

// The TILE_X x tile_z tiles of an (nx, nz) join: the count of its
// partials.
TRI_ORDER_FN long long tiles(int nx, int nz, int tile_z) {
  return (long long)((nx + TILE_X - 1) / TILE_X) * ((nz + tile_z - 1) / tile_z);
}

// The persistent CTAs of a launch: one a tile up to as many as the card
// holds at once (`slots`: the CTAs an SM holds times the SMs).
TRI_ORDER_FN int grid(long long n_tiles, int slots) {
  return (int)(n_tiles < slots ? n_tiles : slots);
}

// The k of lane column t's q-th value of y in a stage.
TRI_ORDER_FN int kappa(int t, int q) { return 2 * t + (q & 1) + 8 * (q >> 1); }

// The row, within its group of 8, of fragment row g.
TRI_ORDER_FN int rho(bool kin, int g) { return kin ? (g >> 1) + 4 * (g & 1) : g; }

// The tile row of a warp's A fragment: m16 block i, half h (rows g or
// g + 8); and of its B fragment: n8 block j.
TRI_ORDER_FN int a_row(bool kin, int i, int h, int g) { return 16 * i + 8 * h + rho(kin, g); }
TRI_ORDER_FN int b_row(bool kin, int j, int g) { return 8 * j + rho(kin, g); }

// The (x, z) cell, within the warp's WM x WN, of accumulator c of the
// (i, j) product at lane (g, t): c = 0, 1 row g, columns 2t, 2t + 1; c = 2,
// 3 row g + 8.
TRI_ORDER_FN int acc_x(bool kin_a, int i, int c, int g) { return a_row(kin_a, i, c >> 1, g); }
TRI_ORDER_FN int acc_z(bool kin_b, int j, int c, int t) { return b_row(kin_b, j, 2 * t + (c & 1)); }

// The double at which cell (r, k) of an operand's stage lies.
TRI_ORDER_FN int offset(bool kin, int r, int k) {
  if (kin) return r * BK + ((((k >> 1) ^ (r & 7)) << 1) | (k & 1));
  return (r >> 4) * 256 + k * 16 + (((((r & 15) >> 1) ^ (k & 7)) << 1) | (r & 1));
}

// The byte at which cell (r0 + d, kappa(t, q)) of a stage lies, for a
// warp's first fragment row r0 (a multiple of 16 plus rho(g)) and a row
// step d (a multiple of 8), as the lane's base XOR a constant plus a
// constant: (frag_base(kin, r0, t) ^ frag_xor(kin, d, q)) + frag_add(kin,
// d, q).  The XOR moves the 16-byte chunk inside its 128-byte line (the
// swizzle), which a stage's 1024-byte alignment leaves to the lane's
// part; so a lane keeps two bases k-inner (q < 2, q >= 2) and four
// row-inner (q odd or not, d / 8 odd or not), and every load adds an
// immediate.
TRI_ORDER_FN int frag_base(bool kin, int r0, int t) { return 8 * offset(kin, r0, kappa(t, 0)); }
TRI_ORDER_FN int frag_xor(bool kin, int d, int q) {
  return kin ? 64 * (q >> 1) : 16 * (q & 1) + 64 * ((d >> 3) & 1);
}
TRI_ORDER_FN int frag_add(bool kin, int d, int q) {
  return kin ? d * BK * 8 + 8 * (q & 1) : (d >> 4) * 2048 + 128 * (q & 1) + 1024 * (q >> 1);
}

}  // namespace tri_order
