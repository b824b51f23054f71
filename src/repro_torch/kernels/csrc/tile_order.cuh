// The tile order of K9's bf16 kernel (`flash_fwd` in flashattn.cu).
//
// The grid is linear, one CTA per ((batch, head) pair, query tile), and
// CTAs start in the order of their index.  The pairs go in groups of
// `group` (the last group may be smaller); a group's CTAs come tile rank
// by tile rank, the heaviest rank (the last query tile) first, and within
// a rank pair by pair.  So the CTAs resident at one time hold the query
// tiles of a few heads, which stream the same K and V tiles while L2 still
// holds them.  With group = B·H this is the order of a grid (B·H, tiles)
// with the pairs on x.
//
// Plain C++ apart from the qualifiers, so that a host compiler can build
// it alone (tests/test_torch_kernels_attn_order.py does).
#pragma once

#ifdef __CUDACC__
#define TILE_ORDER_FN __host__ __device__ __forceinline__
#else
#define TILE_ORDER_FN inline
#endif

namespace tile_order {

// A group's streamed operands, K and V of each of its heads, are kept to
// this many bytes, well inside the H100's 50 MB L2.
constexpr long long L2_GROUP_BYTES = 16LL << 20;

struct TileAt {
  int bh, rank;                 // the pair; 0 is its heaviest tile
};

TILE_ORDER_FN TileAt tile_at(int idx, int BH, int tiles, int group) {
  const int per = group * tiles;                 // CTAs of a whole group
  const int g = idx / per, first = g * group;
  const int n = group < BH - first ? group : BH - first;  // pairs in it
  const int rem = idx - g * per;
  return {first + rem % n, rem / n};
}

// The pairs a group: the largest divisor of BH whose streamed operands,
// S·(Dq + Dv) bf16 values a pair, fit L2_GROUP_BYTES (at least 1).  A
// divisor, so that every group is whole: a last group of fewer pairs would
// start its heaviest tiles when the card is nearly done.
inline int heads_per_group(int BH, int S, int Dq, int Dv) {
  long long most = L2_GROUP_BYTES / (2LL * S * (Dq + Dv));
  if (most > BH) most = BH;
  int g = most < 1 ? 1 : static_cast<int>(most);
  while (BH % g != 0) --g;
  return g;
}

}  // namespace tile_order
