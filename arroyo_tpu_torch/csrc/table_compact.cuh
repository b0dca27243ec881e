// The stable compaction shared by K11 (csrc/sharded_agg.cu,
// shard_extract), K12's walk (csrc/hash_agg.cu, hash_scan_walk) and K10's
// spill (csrc/sharded_agg.cu, shard_spill). The table reads compute one
// thing: per shard of an open-addressing table (keys int64, bins int32,
// occ bool, lanes; [S * cap]), the slots for which occ && lo <= bin < hi
// ("emitting"), compacted stably in slot order into E output rows per
// shard, with their count.
//
// SPILL is the same walk over K9's still-active flags (`occ` is the flag
// array [S * M], cap = M, and the predicate is the flag alone: the bins
// are not loaded to decide it). A shard's rows append to its spill buffer
// (E = spill_cap rows) from sp_fill[s] on, in index order; rows at or past
// E are dropped (arroyo_tpu/parallel/sharded_agg.py:243-259, step 7). The
// base comes in through the look-back: the shard's tile 0 reads sp_fill[s]
// and publishes fill + its count as its covering word, so every tile's
// prefix already holds the fill and no other tile reads it. The shard's
// last tile knows P = fill + the shard's flagged rows, and writes
// sp_fill[s] = min(P, E) and adds max(P - E, 0) to oflow[s]: the
// reference's n_spilled / n_lost arithmetic for every fill <= E, which the
// reference keeps. That write cannot race tile 0's read: the last tile's
// look-back ends only on a covering word, every covering word of the shard
// is built on tile 0's (whose value is the fill it read), so the read has
// returned before the last tile can write. One launch, no fill blocks.
//
// What bounds it on the H100: bytes. It must read every slot's occupancy
// (1 byte) and the occupied slots' bins, gather the emitting slots' key
// and lanes, and write the rows; it adds and compares and nothing more.
// The design moves each byte once, in one launch:
//
// - Tiles. A block of TILE_THREADS threads takes a tile of TILE consecutive
//   slots of one shard (a tile never straddles two shards), each thread
//   ITEMS consecutive slots: one 16-byte load of their occupancy and four
//   int4 loads of their bins, issued together. A thread's emitting
//   slots are a 16-bit mask; one block scan of the masks' popcounts gives
//   each thread's rank in the tile.
// - One pass with decoupled look-back. Each tile publishes its emitting
//   count and reads the running prefix from the tiles before it in its
//   shard (one warp reads 32 status words at a time), with
//   csrc/radix_sort.cuh's 64-bit status words and flag bits (the pass tag
//   numbers the launch). Tiles take their index from an atomic ticket, so
//   a tile's look-back only ever waits on tiles that are running.
// - Coalesced rows. The tile stages its emitting slots' offsets in shared
//   memory, then its threads write consecutive output rows (key, bin,
//   valid, every lane as bits) in slot order.
// - The frees are decided by the thread that read the slot (an emitting
//   slot's position is known once the prefix is), which writes back only
//   its own 16 occupancy bytes.
//
// What needs the shard's total, which only the shard's last tile knows:
// the rows past the emitting ones. Under ZERO_TAIL they are zeros; in
// CLOSE they are the first E - total non-emitting slots of the shard (the
// reference's argsort(~emit_mask)[:E]), i.e. non-emitting rank r goes to
// row total + r. Those slots lie in the shard's first E slots, so each
// tile writes, for its non-emitting slots whose rank could still be
// needed (r < E minus the emitting slots up to its end), the slot into a
// rank-indexed list (`fill`), each entry tagged with the launch as a status
// word is. The rows themselves are written by fill blocks: the grid's last
// tickets, one per FILL_ROWS output rows of a shard. A fill block waits for
// the covering word of its shard's last tile, whose count is the total,
// and in CLOSE for its rows' entries; rows at or past the total belong to
// no tile, so nothing else orders them. Every tile has a
// smaller ticket than every fill block, so the wait never holds back a
// tile that has not started. WALK has no rows past the emitting ones and
// no fill blocks.
//
// Rows are copied RB to a thread with every load before any store, so a
// thread waits out one memory latency per RB rows, not one per array.
//
// The state words (the ticket counter, per-tile statuses) and the fill list
// are zero before a buffer's first launch and never cleared:
// the tickets number the launches (see compact_table), so a caller keeps
// one buffer per layout and stream.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include "radix_sort.cuh"

namespace compact {

constexpr int TILE_THREADS = 256;
constexpr int WARPS = TILE_THREADS / 32;
constexpr int ITEMS = 16;                 // consecutive slots a thread reads
constexpr int TILE = TILE_THREADS * ITEMS;     // slots a tile compacts
constexpr int RB = 4;                     // rows a thread copies at once
constexpr int FILL_ROWS = TILE_THREADS * RB;  // output rows a fill block writes
constexpr int LANE_REGS = 4;              // lanes of RB rows staged in registers
constexpr int MAX_COPY_LANES = 32;
constexpr unsigned long long TAG_MASK = (1ULL << 30) - 1;  // radix_sort.cuh's pass-tag bits
constexpr unsigned long long AGGREGATE = radix::FLAG_AGGREGATE << 32;
constexpr unsigned long long PREFIX = radix::FLAG_PREFIX << 32;

// CLOSE: K11's default mode; ZERO_TAIL: K11 with zeros past the emitting
// rows (E may exceed cap); WALK: K12's walk (the emitting rows and their
// count, nothing freed); SPILL: K10's spill append (see the top).
enum Mode { CLOSE = 0, ZERO_TAIL = 1, WALK = 2, SPILL = 3 };

// The modes that free slots, write `valid` and run fill blocks (K11's).
__host__ __device__ constexpr bool is_close(int mode) { return mode == CLOSE || mode == ZERO_TAIL; }

struct Lanes {
  const void* in[MAX_COPY_LANES];  // the table's lanes [S * cap]
  void* out[MAX_COPY_LANES];       // the rows' lanes [S * E]
  int wide[MAX_COPY_LANES];        // 8-byte lane, else 4
  int n;
};

struct Args {
  const long long* keys;
  const int* bins;
  unsigned char* occ;     // SPILL: the still flags (read only)
  long long cap;          // slots per shard
  int tiles;              // tiles per shard
  int S;
  int lo, hi, free_below;  // free_below INT_MIN: nothing freed
  int vec;                 // occ and bins 16-byte aligned at every run of ITEMS slots
  long long E;             // output rows per shard
  long long* out_key;      // [S * E]
  int* out_bin;
  unsigned char* out_valid;  // NULL in WALK
  int* total;                // [S] emitting slots (CLOSE, ZERO_TAIL)
  long long* count;          // [S] emitting slots (WALK)
  const int* oflow_in;       // [S] copied to oflow_out when given
  int* oflow_out;            // SPILL: [S] the shard's lost rows added
  int* sp_fill;              // SPILL: [S] read by tile 0, written by the last tile
  unsigned long long* state;  // state_words(S, tiles), zero before a buffer's first launch
  unsigned long long* fill;   // CLOSE: [S * E] non-emitting slots by rank, tagged
  double ticket_scale;        // 1 / the grid's blocks (ticket -> launch without a division)
};

__host__ __device__ inline long long tiles_for(long long cap) { return (cap + TILE - 1) / TILE; }

// the ticket counter, per tile status
__host__ __device__ inline long long state_words(int S, long long tiles) {
  return 1 + S * tiles;
}

__host__ inline long long fill_blocks(int S, long long E, int mode) {
  return is_close(mode) ? S * ((E + FILL_ROWS - 1) / FILL_ROWS) : 0;
}

__device__ __forceinline__ unsigned occ_byte(const unsigned (&ow)[4], int k) {
  return (ow[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

__device__ __forceinline__ unsigned long long ld_lane(const Lanes& lanes, int l, long long i) {
  return lanes.wide[l] ? static_cast<const unsigned long long*>(lanes.in[l])[i]
                       : (unsigned long long)static_cast<const unsigned*>(lanes.in[l])[i];
}

__device__ __forceinline__ void st_lane(const Lanes& lanes, int l, long long i,
                                        unsigned long long v) {
  if (lanes.wide[l]) static_cast<unsigned long long*>(lanes.out[l])[i] = v;
  else static_cast<unsigned*>(lanes.out[l])[i] = (unsigned)v;
}

// Copy up to RB rows, table slot src[j] to output row dst[j] where ok[j]:
// key, bin, valid and every lane's bits. Every load of the first
// LANE_REGS lanes is issued before any store (a store may alias a later
// load as far as the compiler knows, so interleaving them would wait out
// one memory latency per array and row).
template <int MODE>
__device__ __forceinline__ void copy_rows(const Lanes& lanes, const Args& a,
                                          const long long (&src)[RB], const long long (&dst)[RB],
                                          const bool (&ok)[RB], unsigned char valid) {
  long long k[RB];
  int b[RB];
  unsigned long long v[LANE_REGS][RB];
#pragma unroll
  for (int j = 0; j < RB; ++j)
    if (ok[j]) k[j] = a.keys[src[j]], b[j] = a.bins[src[j]];
#pragma unroll
  for (int l = 0; l < LANE_REGS; ++l)
    if (l < lanes.n) {
#pragma unroll
      for (int j = 0; j < RB; ++j)
        if (ok[j]) v[l][j] = ld_lane(lanes, l, src[j]);
    }
#pragma unroll
  for (int j = 0; j < RB; ++j)
    if (ok[j]) {
      a.out_key[dst[j]] = k[j];
      a.out_bin[dst[j]] = b[j];
      if constexpr (is_close(MODE)) a.out_valid[dst[j]] = valid;
    }
#pragma unroll
  for (int l = 0; l < LANE_REGS; ++l)
    if (l < lanes.n) {
#pragma unroll
      for (int j = 0; j < RB; ++j)
        if (ok[j]) st_lane(lanes, l, dst[j], v[l][j]);
    }
  for (int l = LANE_REGS; l < lanes.n; ++l)
#pragma unroll
    for (int j = 0; j < RB; ++j)
      if (ok[j]) st_lane(lanes, l, dst[j], ld_lane(lanes, l, src[j]));
}

// Exclusive sum over the block, and the block's total (every thread calls it).
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* warp_sums, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < WARPS ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  *total = warp_sums[WARPS - 1];
  return (warp ? warp_sums[warp - 1] : 0u) + x - v;
}

// Warp 0 of tile t > 0: the emitting slots in the tiles before it in its
// shard (status: the shard's words). Each lane reads one predecessor's
// word, the window 32 tiles back at a time; the sum stops at the nearest
// word that covers every tile up to its own. A word not yet published is
// read again. Tile 0 of a shard always publishes a covering count, and a
// covering word is published only after every tile before it published,
// so the loop ends.
__device__ __forceinline__ unsigned long long look_back(const unsigned long long* status,
                                                        long long t, unsigned long long tag) {
  const int lane = threadIdx.x & 31;
  unsigned long long before = 0;
  for (long long end = t - 1;; end -= 32) {
    const long long i = end - lane;
    unsigned long long w = i >= 0 ? radix::load_status(status + i) : (tag | PREFIX);
    while (__any_sync(0xffffffffu, (w >> 34) != (tag >> 34)))
      if ((w >> 34) != (tag >> 34)) w = radix::load_status(status + i);
    const unsigned covering = __ballot_sync(0xffffffffu, (w & PREFIX) != 0);
    const int first = covering ? __ffs(covering) - 1 : 32;
    unsigned long long v = lane <= first ? (w & 0xffffffffULL) : 0ULL;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    before += v;
    if (covering) return before;
  }
}

template <int MODE>
__device__ __forceinline__ void compact_tile(const Lanes& lanes, const Args& a, int id,
                                             unsigned long long tag, unsigned short* slot_of,
                                             unsigned short* fill_of, unsigned* warp_sums,
                                             unsigned long long* sh_prefix) {
  const int s = id / a.tiles;
  const int t = id % a.tiles;
  const long long tile0 = (long long)t * TILE;
  const int off0 = threadIdx.x * ITEMS;  // the thread's first slot in the tile
  const long long run0 = tile0 + off0;   // and in the shard
  const long long g0 = s * a.cap + run0;
  unsigned ow[4] = {0u, 0u, 0u, 0u};
  int bn[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) bn[k] = 0;
  // occupancy and bins are loaded together: one memory latency, not two
  // (SPILL loads the flags alone: its predicate reads no bin)
  if (a.vec) {
    if (run0 < a.cap) {
      const uint4 o = *reinterpret_cast<const uint4*>(a.occ + g0);
      ow[0] = o.x, ow[1] = o.y, ow[2] = o.z, ow[3] = o.w;
      if constexpr (MODE != SPILL) {
        const int4* bp = reinterpret_cast<const int4*>(a.bins + g0);
        int4 b[ITEMS / 4];
#pragma unroll
        for (int q = 0; q < ITEMS / 4; ++q) b[q] = bp[q];
#pragma unroll
        for (int q = 0; q < ITEMS / 4; ++q)
          bn[4 * q] = b[q].x, bn[4 * q + 1] = b[q].y, bn[4 * q + 2] = b[q].z, bn[4 * q + 3] = b[q].w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (run0 + k < a.cap) {
        if (a.occ[g0 + k]) ow[k >> 2] |= 1u << (8 * (k & 3));
        if constexpr (MODE != SPILL) bn[k] = a.bins[g0 + k];
      }
  }
  unsigned mask = 0;  // the run's emitting slots
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (occ_byte(ow, k) && (MODE == SPILL || (bn[k] >= a.lo && bn[k] < a.hi))) mask |= 1u << k;
  unsigned tile_count;
  const unsigned excl = block_scan(__popc(mask), warp_sums, &tile_count);
  for (unsigned m = mask, i = excl; m; m &= m - 1, ++i) slot_of[i] = off0 + __ffs(m) - 1;
  unsigned long long* status = a.state + 1 + (long long)s * a.tiles;
  if (threadIdx.x < 32) {
    unsigned long long before = 0;
    if (t == 0) {
      if (threadIdx.x == 0) {
        // SPILL: the shard's rows start at its fill (see the top)
        if constexpr (MODE == SPILL) before = (unsigned)a.sp_fill[s];
        radix::store_status(status, tag | PREFIX | (before + tile_count));
      }
    } else {
      if (threadIdx.x == 0) radix::store_status(status + t, tag | AGGREGATE | tile_count);
      before = look_back(status, t, tag);
      if (threadIdx.x == 0) radix::store_status(status + t, tag | PREFIX | (before + tile_count));
    }
    if (threadIdx.x == 0) *sh_prefix = before;
  }
  __syncthreads();
  const long long P = (long long)*sh_prefix;  // emitting slots before the tile (SPILL: and the fill)
  const long long done = P + tile_count;      // and up to its end
  const long long ex0 = P + excl;  // emitting slots before the thread's run
  if constexpr (MODE == CLOSE) {
    // the tile's non-emitting slots by rank, while a rank below E - total
    // is possible (only the shard's first E slots hold such ranks), staged
    // in shared memory and written as consecutive words, each tagged with
    // the launch (a fill block reads an entry once its tag is this one's)
    if (tile0 < a.E) {
      const int ne0 = off0 - (int)excl;  // non-emitting slots before the run in the tile
      for (int k = 0, i = ne0; k < ITEMS && run0 + k < a.cap; ++k)
        if (!((mask >> k) & 1u)) fill_of[i++] = (unsigned short)(off0 + k);
      __syncthreads();
      const long long r0 = tile0 - P;  // non-emitting slots before the tile
      const long long in_tile = (a.cap - tile0 < TILE ? a.cap - tile0 : TILE) - tile_count;
      const long long room = a.E - done - r0;
      const long long n = in_tile < room ? in_tile : (room > 0 ? room : 0);
      for (long long i = threadIdx.x; i < n; i += TILE_THREADS)
        radix::store_status(a.fill + s * a.E + r0 + i,
                            tag | (unsigned long long)(tile0 + fill_of[i]));
    }
  }
  if constexpr (is_close(MODE)) {
    if (a.free_below != INT_MIN) {
      // expired slots outside the range free now, emitting ones once emitted
      unsigned nw[4] = {ow[0], ow[1], ow[2], ow[3]};
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (!occ_byte(ow, k) || bn[k] >= a.free_below) continue;
        const bool e = (mask >> k) & 1u;
        if (!e || ex0 + __popc(mask & ((1u << k) - 1u)) < a.E)
          nw[k >> 2] &= ~(0xffu << (8 * (k & 3)));
      }
      if ((nw[0] ^ ow[0]) | (nw[1] ^ ow[1]) | (nw[2] ^ ow[2]) | (nw[3] ^ ow[3])) {
        if (a.vec) {
          *reinterpret_cast<uint4*>(a.occ + g0) = make_uint4(nw[0], nw[1], nw[2], nw[3]);
        } else {
#pragma unroll
          for (int k = 0; k < ITEMS; ++k)
            if (occ_byte(nw, k) != occ_byte(ow, k)) a.occ[g0 + k] = 0;
        }
      }
    }
  }
  // the tile's rows, consecutive, in slot order
  const long long n_rows = done <= a.E ? (long long)tile_count : (a.E > P ? a.E - P : 0);
  for (long long i0 = 0; i0 < n_rows; i0 += TILE_THREADS * RB) {
    long long src[RB], dst[RB];
    bool ok[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const long long i = i0 + j * TILE_THREADS + threadIdx.x;
      ok[j] = i < n_rows;
      src[j] = ok[j] ? s * a.cap + tile0 + slot_of[i] : 0;
      dst[j] = s * a.E + P + i;
    }
    copy_rows<MODE>(lanes, a, src, dst, ok, 1);
  }
  if (t == a.tiles - 1 && threadIdx.x == 0) {
    if constexpr (MODE == WALK) {
      a.count[s] = done;
    } else if constexpr (MODE == SPILL) {
      __threadfence();  // after the look-back that saw tile 0's fill (see the top)
      a.sp_fill[s] = (int)(done < a.E ? done : a.E);
      if (done > a.E) a.oflow_out[s] += (int)(done - a.E);
    } else {
      a.total[s] = (int)done;
      if (a.oflow_out != nullptr) a.oflow_out[s] = a.oflow_in[s];
    }
  }
}

// Fill block h: output rows [c FILL_ROWS, (c + 1) FILL_ROWS) of shard s,
// once the shard's last tile has published its covering count (the
// shard's total) and, in CLOSE, each row's fill-list entry carries this
// launch's tag. Rows at or past the total are no tile's, and the table's
// keys, bins and lanes do not change in the launch, so nothing else
// orders them.
template <int MODE>
__device__ __forceinline__ void fill_rows(const Lanes& lanes, const Args& a, int h,
                                          unsigned long long launch, long long* sh_total) {
  const int per = (int)((a.E + FILL_ROWS - 1) / FILL_ROWS);
  const int s = h / per;
  const long long row0 = (long long)(h % per) * FILL_ROWS;
  if (threadIdx.x == 0) {
    const unsigned long long* last = a.state + 1 + (long long)s * a.tiles + a.tiles - 1;
    const unsigned long long want = ((launch + 1) & TAG_MASK) << 34 | PREFIX;
    unsigned long long w;
    while (((w = radix::load_status(last)) & ~0xffffffffULL) != want) __nanosleep(32);
    *sh_total = (long long)(w & 0xffffffffULL);
  }
  __syncthreads();
  const long long total = *sh_total;
  const long long first = total < a.E ? total : a.E;  // rows below are emitting rows
  const long long lo = row0 > first ? row0 : first;
  const long long hi = row0 + FILL_ROWS < a.E ? row0 + FILL_ROWS : a.E;
  if constexpr (MODE == ZERO_TAIL) {
    for (long long i = lo + threadIdx.x; i < hi; i += TILE_THREADS) {
      const long long d = s * a.E + i;
      a.out_valid[d] = 0;
      a.out_key[d] = 0;
      a.out_bin[d] = 0;
      for (int l = 0; l < lanes.n; ++l) st_lane(lanes, l, d, 0ULL);
    }
  } else {
    // row i is non-emitting rank i - total: its slot from the fill list,
    // read again until the entry carries this launch's tag
    const unsigned long long tag = ((launch + 1) & TAG_MASK) << 34;
    long long src[RB], dst[RB];
    unsigned long long e[RB];
    bool ok[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {  // every entry's first read in flight at once
      const long long i = lo + j * TILE_THREADS + threadIdx.x;
      ok[j] = i < hi;
      dst[j] = s * a.E + i;
      e[j] = ok[j] ? radix::load_status(a.fill + s * a.E + (i - total)) : tag;
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      while ((e[j] & ~0xffffffffULL) != tag)
        e[j] = radix::load_status(a.fill + dst[j] - total);
      src[j] = s * a.cap + (long long)(e[j] & 0xffffffffULL);
    }
    copy_rows<MODE>(lanes, a, src, dst, ok, 0);
  }
}

// Grid: S * tiles tile blocks, then fill_blocks(S, E, MODE) fill blocks,
// TILE_THREADS threads each; which block does what follows its ticket.
// Every launch on one state buffer has the same grid and runs after the
// one before it (one layout, one stream), so the ticket counter, never
// cleared, also numbers the launches: launch = ticket / grid. Status
// words carry launch + 1 as their pass tag, so an earlier launch's words
// read as not yet published, and nothing needs clearing between launches.
template <int MODE>
__global__ void __launch_bounds__(TILE_THREADS) compact_table(Lanes lanes, Args a) {
  __shared__ unsigned short slot_of[TILE];
  __shared__ unsigned short fill_of[MODE == CLOSE ? TILE : 1];
  __shared__ unsigned warp_sums[WARPS];
  __shared__ unsigned long long sh_prefix;
  __shared__ unsigned long long sh_ticket;
  if (threadIdx.x == 0) sh_ticket = atomicAdd(a.state, 1ULL);
  __syncthreads();
  // launch = ticket / grid, id = ticket % grid, without a 64-bit division
  // (a called routine, whose register convention made the walk spill)
  const long long grid = gridDim.x;
  unsigned long long launch = (unsigned long long)((double)sh_ticket * a.ticket_scale);
  long long rem = (long long)(sh_ticket - launch * grid);
  while (rem < 0) --launch, rem += grid;
  while (rem >= grid) ++launch, rem -= grid;
  const int id = (int)rem;
  const int n_tiles = a.S * a.tiles;
  if (id < n_tiles) {
    compact_tile<MODE>(lanes, a, id, ((launch + 1) & TAG_MASK) << 34, slot_of, fill_of,
                       warp_sums, &sh_prefix);
  } else if constexpr (is_close(MODE)) {
    fill_rows<MODE>(lanes, a, id - n_tiles, launch, reinterpret_cast<long long*>(&sh_prefix));
  }
}

}  // namespace compact
