// The radix sort's block-level steps, shared by K5 (csrc/join_probe.cu,
// join_sort_pairs) and K8 (csrc/sharded_agg.cu, agg_sort_reduce). Both sort
// by 8-bit digits, least significant first, one stable pass per digit
// ("onesweep", Adinets & Merrill 2022); the kernels around these steps load
// and store their own records.
//
// The stable rank: a block of 32 * WARPS threads holds ITEMS items per
// thread, warp w the rows [32 w ITEMS, 32 (w + 1) ITEMS) of its tile, item
// j of lane l being row 32 w ITEMS + 32 j + l, so walking j, then lanes,
// visits the warp's rows in order. An item's rank among its warp's items of
// its digit is the warp's count so far plus its peers in lower lanes (found
// with __match_any_sync, which ranked faster than one ballot per digit bit
// on the H100 in K5's and K8's sorts), and the warps' counts are summed in
// warp order. The digit RADIX marks a slot that holds no item.
//
// The look-back between the tiles of one pass: one 64-bit status word per
// (tile, digit) holds the count (low 32 bits), whether it covers this tile
// alone or every tile up to it (2 bits), and the pass it belongs to (the
// rest), so one memset serves every pass of a sort. The words carry their
// own data, so relaxed loads and stores suffice.

#pragma once

#include <cuda_runtime.h>

namespace radix {

constexpr int RADIX = 256;
constexpr int LOOKBACK = 4;  // status words read at a time
constexpr unsigned long long FLAG_AGGREGATE = 1ULL;  // the count covers this tile alone
constexpr unsigned long long FLAG_PREFIX = 2ULL;     // the count covers every tile up to this one

template <int WARPS>
struct RankShared {
  unsigned whist[WARPS][RADIX];  // per-warp digit counts, then each warp's offset in its digit
  unsigned tile_start[RADIX];    // the tile's first row of each digit
  unsigned warp_sums[WARPS];
};

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Exclusive sum over the block's 32 * WARPS threads (all must call it).
template <int WARPS>
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();
  return before + x - v;
}

// Rank the warp's items by digit, stably (see the header; a block whose
// tile holds fewer rows may lay out `used` < ITEMS items per thread, warp
// w then holding rows [32 w used, 32 (w + 1) used), and the items from
// `used` on are not ranked). On return whist[w][d] is warp w's count of
// digit d and rank[j] item j's rank among its warp's items of its digit.
template <int WARPS, int ITEMS>
__device__ __forceinline__ void rank_digits(RankShared<WARPS>& sm, const unsigned (&dig)[ITEMS],
                                            unsigned (&rank)[ITEMS], int used = ITEMS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* wh = sm.whist[warp];
  for (int d = lane; d < RADIX; d += 32) wh[d] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j >= used) break;
    const unsigned d = dig[j];
    const bool ok = d < RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);  // the lanes of d
    const unsigned seen = ok ? wh[d] : 0u;
    __syncwarp();
    if (ok && lane == 31 - __clz(peers)) wh[d] = seen + __popc(peers);
    __syncwarp();
    rank[j] = seen + __popc(peers & below);
  }
}

// Thread d < RADIX: whist[.][d] becomes each warp's offset within digit d
// and tile_start[d] digit d's first row in the tile; returns the tile's
// count of digit d (0 on the other threads). Every thread calls it, after
// a __syncthreads that follows rank_digits.
template <int WARPS>
__device__ __forceinline__ unsigned digit_offsets(RankShared<WARPS>& sm) {
  const int d = threadIdx.x;
  unsigned total = 0;
  if (d < RADIX)
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = sm.whist[w][d];
      sm.whist[w][d] = total;
      total += c;
    }
  const unsigned start = block_exclusive_sum<WARPS>(total, sm.warp_sums);
  if (d < RADIX) sm.tile_start[d] = start;
  return total;
}

// An item's row in the tile in digit order (after digit_offsets and a
// __syncthreads).
template <int WARPS>
__device__ __forceinline__ unsigned tile_slot(const RankShared<WARPS>& sm, unsigned d,
                                              unsigned rank) {
  return sm.tile_start[d] + sm.whist[threadIdx.x >> 5][d] + rank;
}

// Look back from tile t_from down for digit d's rows before this tile:
// the sum of the counts read until one covers every tile up to its own.
// Reads LOOKBACK statuses at a time (one latency for up to LOOKBACK tiles
// that published only their own count), spinning on a status that is not
// yet this pass's. Tile 0 always publishes a covering count.
__device__ __forceinline__ unsigned look_back(const unsigned long long* status, long long t_from,
                                              int d, unsigned long long pass_tag) {
  unsigned before = 0;
  long long t = t_from;
  for (;;) {
    unsigned long long w[LOOKBACK];
#pragma unroll
    for (int k = 0; k < LOOKBACK; ++k)
      w[k] = t - k >= 0 ? load_status(status + (t - k) * RADIX + d) : 0ULL;
    int k = 0;
    for (; k < LOOKBACK && t - k >= 0; ++k) {
      if ((w[k] >> 34) != pass_tag) break;  // not published yet: read it again
      before += (unsigned)w[k];
      if (((w[k] >> 32) & 3ULL) == FLAG_PREFIX) return before;
    }
    t -= k;
  }
}

// Thread d of a onesweep tile: publish the tile's count of digit d, look
// back over the earlier tiles, publish the covering count; returns digit
// d's rows in the tiles before this one. pass_tag is the pass + 1.
__device__ __forceinline__ unsigned publish_and_look_back(unsigned long long* status,
                                                          long long tile, int d, unsigned count,
                                                          unsigned long long pass_tag) {
  unsigned long long* mine = status + tile * RADIX + d;
  if (tile == 0) {
    store_status(mine, pass_tag << 34 | (FLAG_PREFIX << 32) | count);
    return 0;
  }
  store_status(mine, pass_tag << 34 | (FLAG_AGGREGATE << 32) | count);
  const unsigned before = look_back(status, tile - 1, d, pass_tag);
  store_status(mine, pass_tag << 34 | (FLAG_PREFIX << 32) | (before + count));
  return before;
}

}  // namespace radix
