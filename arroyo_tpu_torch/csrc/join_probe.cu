// Windowed-join probe kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (arroyo_tpu_torch/ops/join_kernels.py builds this
// file with nvcc at first use and holds each kernel against its plain
// PyTorch version).
//
// They replace arroyo_tpu/ops/join_probe.py _probe_jit.probe, the jitted
// program that sorts one window's build side and binary-searches every
// probe key:
//
//   K5 join_sort_pairs     order = argsort(build keys), stable, plus the
//      sorted keys: equal keys keep their input order, as jnp.argsort's
//      do, and int32 keys sort as their int64 values. The slot
//      aggregator's K1 (csrc/slot_agg.cu) sorts its slots with it too, in
//      range mode, to add float sums in row order.
//   K6 join_search_bounds  lo = first index whose key >= probe key, hi =
//      first index whose key > probe key, over the sorted keys (what
//      jnp.searchsorted side="left" / side="right" return). A probe key of
//      INT64_MAX finds hi = the length of the sorted array.
//
// K5 is a least-significant-digit radix sort with 8-bit digits, one pass
// per digit ("onesweep", Adinets & Merrill 2022). A key's digits are read
// from key ^ INT64_MIN, so unsigned digit order is signed key order; the
// join sorts all 64 bits (8 passes). In range mode (K1's slots) a key in
// [0, cap) sorts on bit_length(cap) bits and every other key sorts as cap,
// after all in-range keys and in row order; the sorted keys then hold cap
// for those rows, so they stay ascending, and the keys travel between
// passes as 32-bit words. Every pass is stable, so the result is the
// stable argsort and does not depend on the order in which blocks run.
//
// Launches: one kernel counts every pass's digits in one read of the
// keys; then one launch per pass. Each block of a pass takes the next tile
// number from an atomic counter (so it waits only on tiles handed out
// before it, which are running or done), ranks its tile's keys by digit
// stably in shared memory, publishes its per-digit counts, looks back over
// earlier tiles' published counts for its output offsets (decoupled
// look-back: one 64-bit status word per (tile, digit) holds the count,
// whether it covers this tile alone or every tile up to it, and the pass
// it belongs to; the thread of digit d reads four earlier tiles' words at
// a time), and writes the tile out in digit order, so neighbouring threads
// write neighbouring addresses within each digit. A memset clears the
// counts, the tile counters and the status words first; the pass tag lets
// one status array serve every pass. Tiles are 1024 keys below 2^21 keys
// (more blocks on the card for a small input) and 4096 above. An input of
// at most 4096 keys sorts in one launch, every pass in shared memory. The
// stable rank: warp w holds rows [32 w I, 32 (w + 1) I) of its tile (I
// items per thread), item j of lane l being row 32 w I + 32 j + l, so
// walking j, then lanes, visits the warp's rows in order; an item's rank
// among its warp's items of its digit is the warp's count so far plus its
// peers in lower lanes (found with one ballot per digit bit), and the
// warps' counts are summed in warp order.
//
// Bound on the H100 (3.35 TB/s): K5 must read 8 bytes and write 12 bytes
// per row, and does a few integer operations per row and pass, far below
// the card's integer rate, so bytes bound it. What it moves: the count
// read (8 B per row) and, per pass, 12 B read and 12 B written per row
// (8 B per row of keys in range mode), plus 2 KB of status per tile. At
// q8's build side (131,072 rows, 1.5 MB, in the 50 MB L2) it is 9
// launches of 128 blocks, bound by their latency; at 16,777,216 rows
// about 3.2 GB over 8 passes, where each tile's 256 digit runs average 16
// keys, so its writes fill cache lines only in part.
// K6 reads each probe key once and writes two int32 per key; the sorted
// keys it searches are read log2(m) times per probe key but sit in L2 at
// q8's size. One thread per probe key, two binary searches, the second
// starting from the first's result.
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller hands K5 its scratch) and returns cudaGetLastError() after
// every launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define RADIX 256
#define SORT_THREADS 256  // one thread per digit in the per-digit steps
#define SORT_WARPS (SORT_THREADS / 32)
#define SORT_ITEMS 16  // the one-launch sort's items per thread: SORT_TILE keys
#define SORT_TILE (SORT_THREADS * SORT_ITEMS)
#define MAX_PASSES 8
#define MAX_RANGE_PASSES 4  // range mode sorts at most 31 bits
#define COUNT_BLOCKS 528    // 4 per SM of the H100
#define THREADS 256
#define SIGN_BIT 0x8000000000000000ULL
#define INT32_LIMIT 0x7fffffffLL

// scratch layout: counts [MAX_PASSES][RADIX] u32, tile counters
// [MAX_PASSES] u32, status [tiles][RADIX] u64 (cleared by the memset), the
// alternate keys [n] and order [n] of the ping-pong
#define COUNTS_BYTES (MAX_PASSES * RADIX * 4)
#define HEADER_BYTES (COUNTS_BYTES + 256)
#define FLAG_AGGREGATE 1ULL  // the count covers this tile alone
#define FLAG_PREFIX 2ULL     // the count covers every tile up to this one

__host__ __device__ __forceinline__ long long align256(long long b) { return (b + 255) & ~255LL; }

template <typename K>
__device__ __forceinline__ K to_digits(long long k, long long cap) {
  if constexpr (sizeof(K) == 4) return (K)((k >= 0 && k < cap) ? k : cap);
  else return (K)((unsigned long long)k ^ SIGN_BIT);
}

template <typename K>
__device__ __forceinline__ long long from_digits(K u) {
  if constexpr (sizeof(K) == 4) return (long long)u;
  else return (long long)((unsigned long long)u ^ SIGN_BIT);
}

template <typename K>
__device__ __forceinline__ K load_key(const void* raw, int raw_i32, long long row, long long cap) {
  const long long k = raw_i32 ? (long long)static_cast<const int*>(raw)[row]
                              : static_cast<const long long*>(raw)[row];
  return to_digits<K>(k, cap);
}

template <typename K>
__device__ __forceinline__ unsigned digit_of(K k, int shift) {
  return (unsigned)(k >> shift) & (RADIX - 1);
}

// The look-back's status words carry their own count, so nothing else is
// published through them: a relaxed 64-bit store and load (single-copy
// atomic at gpu scope) suffice, and release/acquire fences would only make
// each publication wait on the block's other writes.
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <typename K, int ITEMS>
struct SortShared {
  K keys[SORT_THREADS * ITEMS];  // the tile in digit order, after the scatter
  int order[SORT_THREADS * ITEMS];
  unsigned whist[SORT_WARPS][RADIX];  // per-warp digit counts, then each warp's offset in its digit
  unsigned tile_start[RADIX];         // the tile's first row of each digit
  long long out_base[RADIX];          // output position = out_base[digit] + row in the tile
  unsigned warp_sums[SORT_WARPS];
  int tile;
};

// Exclusive sum over the block's 256 threads (all must call it).
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

// The lanes of the warp whose d (9 bits: a digit, or RADIX for no item)
// equals this lane's: one ballot per bit.
__device__ __forceinline__ unsigned same_digit_lanes(unsigned d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const bool set = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

// Rank the tile's items by digit, stably within each warp (see the header;
// a warp holds 32 * ITEMS rows); items at or past tile_n take no digit. On
// return whist[w][d] is warp w's count of digit d and rank[j] item j's
// rank among its warp's items of its digit.
template <typename K, int ITEMS>
__device__ __forceinline__ void rank_items(SortShared<K, ITEMS>& sm, const K (&key)[ITEMS],
                                           int tile_n, int shift, unsigned (&rank)[ITEMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* wh = sm.whist[warp];
  for (int d = lane; d < RADIX; d += 32) wh[d] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool ok = warp * 32 * ITEMS + j * 32 + lane < tile_n;
    const unsigned d = ok ? digit_of(key[j], shift) : RADIX;
    const unsigned peers = same_digit_lanes(d);
    const unsigned seen = ok ? wh[d] : 0u;
    __syncwarp();
    if (ok && lane == 31 - __clz(peers)) wh[d] = seen + __popc(peers);
    __syncwarp();
    rank[j] = seen + __popc(peers & below);
  }
}

// Thread d: whist[.][d] becomes each warp's offset within digit d and
// tile_start[d] digit d's first row in the tile; returns the tile's count
// of digit d. Call after a __syncthreads that follows rank_items.
template <typename K, int ITEMS>
__device__ __forceinline__ unsigned digit_offsets(SortShared<K, ITEMS>& sm) {
  const int d = threadIdx.x;
  unsigned total = 0;
  for (int w = 0; w < SORT_WARPS; ++w) {
    const unsigned c = sm.whist[w][d];
    sm.whist[w][d] = total;
    total += c;
  }
  sm.tile_start[d] = block_exclusive_sum(total, sm.warp_sums);
  return total;
}

// Each valid item to its row of the tile in digit order.
template <typename K, int ITEMS>
__device__ __forceinline__ void scatter_to_shared(SortShared<K, ITEMS>& sm, const K (&key)[ITEMS],
                                                  const int (&ord)[ITEMS], int tile_n, int shift,
                                                  const unsigned (&rank)[ITEMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (warp * 32 * ITEMS + j * 32 + lane < tile_n) {
      const unsigned d = digit_of(key[j], shift);
      const unsigned at = sm.tile_start[d] + sm.whist[warp][d] + rank[j];
      sm.keys[at] = key[j];
      sm.order[at] = ord[j];
    }
  }
}

// Every pass's digit counts over the whole input.
template <typename K>
__global__ void __launch_bounds__(SORT_THREADS)
    digit_count_kernel(const void* __restrict__ raw, int raw_i32, long long cap, long long n,
                       int passes, unsigned* __restrict__ counts) {
  __shared__ unsigned h[MAX_PASSES * RADIX];
  for (int i = threadIdx.x; i < passes * RADIX; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    const K k = load_key<K>(raw, raw_i32, row, cap);
    for (int p = 0; p < passes; ++p) atomicAdd(&h[p * RADIX + digit_of(k, 8 * p)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += blockDim.x)
    if (h[i]) atomicAdd(&counts[i], h[i]);
}

template <typename K>
struct SweepArgs {
  const void* raw;  // pass 0 reads the input keys (int64, or int32 if raw_i32)
  int raw_i32;
  long long cap;           // range mode's cap (unused in full mode)
  const K* in_keys;        // later passes read the previous pass's keys and order
  const int* in_order;
  K* out_keys;             // a pass before the last writes digit keys here,
  long long* final_keys;   // the last pass int64 keys here (non-null only then)
  int* out_order;
  long long n;
  const unsigned* counts;      // [passes][RADIX]
  unsigned long long* status;  // [tiles][RADIX]
  unsigned* next_tile;         // [passes]
};

// Look back from tile t_from down for digit d's rows before this tile:
// the sum of the counts read until one covers every tile up to its own.
// Reads LOOKBACK statuses at a time (one latency for up to LOOKBACK tiles
// that published only their own count), spinning on a status that is not
// yet this pass's. Tile 0 always publishes a covering count.
#define LOOKBACK 4
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

// One pass over the digit at bits [8 pass, 8 pass + 8): one tile of
// SORT_THREADS * ITEMS keys per block.
template <typename K, int ITEMS>
__global__ void __launch_bounds__(SORT_THREADS) sweep_kernel(SweepArgs<K> a, int pass) {
  constexpr int TILE = SORT_THREADS * ITEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  SortShared<K, ITEMS>& sm = *reinterpret_cast<SortShared<K, ITEMS>*>(smem);
  const int d = threadIdx.x;
  const unsigned digit_total = a.counts[pass * RADIX + d];  // in flight while the tile is taken
  if (threadIdx.x == 0) sm.tile = (int)atomicAdd(a.next_tile + pass, 1u);
  __syncthreads();
  const long long tile = sm.tile;
  const long long base = tile * TILE;
  const int tile_n = (int)min((long long)TILE, a.n - base);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = 8 * pass;
  K key[ITEMS];
  int ord[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = warp * 32 * ITEMS + j * 32 + lane;
    key[j] = 0;
    ord[j] = 0;
    if (r < tile_n) {
      const long long row = base + r;
      if (pass == 0) {
        key[j] = load_key<K>(a.raw, a.raw_i32, row, a.cap);
        ord[j] = (int)row;
      } else {
        key[j] = a.in_keys[row];
        ord[j] = a.in_order[row];
      }
    }
  }
  // every digit's first output row over the whole input, while the keys load
  sm.out_base[d] = block_exclusive_sum(digit_total, sm.warp_sums);
  unsigned rank[ITEMS];
  rank_items(sm, key, tile_n, shift, rank);
  __syncthreads();
  const unsigned count = digit_offsets(sm);
  // publish this tile's count of digit d, then look back over the earlier
  // tiles for the rows of digit d before it
  const unsigned long long tag = (unsigned long long)(pass + 1);
  unsigned long long* mine = a.status + tile * RADIX + d;
  unsigned before = 0;
  if (tile == 0) {
    store_status(mine, tag << 34 | (FLAG_PREFIX << 32) | count);
  } else {
    store_status(mine, tag << 34 | (FLAG_AGGREGATE << 32) | count);
    before = look_back(a.status, tile - 1, d, tag);
    store_status(mine, tag << 34 | (FLAG_PREFIX << 32) | (before + count));
  }
  sm.out_base[d] += (long long)before - sm.tile_start[d];
  __syncthreads();
  scatter_to_shared(sm, key, ord, tile_n, shift, rank);
  __syncthreads();
  for (int i = threadIdx.x; i < tile_n; i += SORT_THREADS) {
    const K k = sm.keys[i];
    const long long at = sm.out_base[digit_of(k, shift)] + i;
    if (a.final_keys) a.final_keys[at] = from_digits(k);
    else a.out_keys[at] = k;
    a.out_order[at] = sm.order[i];
  }
}

// An input of at most one tile: every pass in shared memory, one block.
template <typename K>
__global__ void __launch_bounds__(SORT_THREADS)
    sort_tile_kernel(const void* __restrict__ raw, int raw_i32, long long cap, int n, int passes,
                     long long* __restrict__ out_keys, int* __restrict__ out_order) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortShared<K, SORT_ITEMS>& sm = *reinterpret_cast<SortShared<K, SORT_ITEMS>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  K key[SORT_ITEMS];
  int ord[SORT_ITEMS];
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const int r = warp * 32 * SORT_ITEMS + j * 32 + lane;
    key[j] = r < n ? load_key<K>(raw, raw_i32, r, cap) : (K)0;
    ord[j] = r;
  }
  unsigned rank[SORT_ITEMS];
  for (int p = 0; p < passes; ++p) {
    rank_items(sm, key, n, 8 * p, rank);
    __syncthreads();
    digit_offsets(sm);
    __syncthreads();
    scatter_to_shared(sm, key, ord, n, 8 * p, rank);
    __syncthreads();
    if (p + 1 < passes) {
#pragma unroll
      for (int j = 0; j < SORT_ITEMS; ++j) {
        const int r = warp * 32 * SORT_ITEMS + j * 32 + lane;
        if (r < n) {
          key[j] = sm.keys[r];
          ord[j] = sm.order[r];
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += SORT_THREADS) {
    out_keys[i] = from_digits(sm.keys[i]);
    out_order[i] = sm.order[i];
  }
}

__global__ void search_bounds_kernel(const long long* __restrict__ sorted, long long m,
                                     const long long* __restrict__ probe, long long p,
                                     int* __restrict__ lo_out, int* __restrict__ hi_out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p) return;
  const long long x = probe[t];
  long long a = 0, b = m;
  while (a < b) {  // first index with sorted[i] >= x
    long long mid = a + ((b - a) >> 1);
    if (sorted[mid] < x) a = mid + 1; else b = mid;
  }
  lo_out[t] = (int)a;
  b = m;
  while (a < b) {  // first index with sorted[i] > x
    long long mid = a + ((b - a) >> 1);
    if (sorted[mid] <= x) a = mid + 1; else b = mid;
  }
  hi_out[t] = (int)a;
}

static unsigned int blocks_for(long long n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

// The onesweep's items per thread: a small input takes small tiles, so
// more blocks share it (measured at 131,072 and 16,777,216 keys).
static int sweep_items(long long n) { return n < (1LL << 21) ? 4 : 16; }

static long long sort_scratch_bytes(long long n, long long range_cap) {
  if (n <= SORT_TILE) return 0;
  const long long tile = (long long)SORT_THREADS * sweep_items(n);
  const long long tiles = (n + tile - 1) / tile;
  const long long key_bytes = range_cap > 0 ? 4 : 8;
  return HEADER_BYTES + align256(tiles * RADIX * 8) + align256(n * key_bytes) + align256(n * 4);
}

// Kernels K5 has launched in this process: a caller reads it before and
// after a call to count that call's launches (chip_smoke.py does).
static long long g_sort_kernel_launches = 0;

template <typename K, int ITEMS>
static int sweep_passes(const void* raw, int raw_i32, long long n, long long cap, int passes,
                        long long* keys_out, int* order_out, unsigned char* scratch,
                        cudaStream_t s) {
  const size_t smem = sizeof(SortShared<K, ITEMS>);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<K, ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tile = (long long)SORT_THREADS * ITEMS;
  const long long tiles = (n + tile - 1) / tile;
  unsigned* counts = reinterpret_cast<unsigned*>(scratch);
  unsigned* next_tile = reinterpret_cast<unsigned*>(scratch + COUNTS_BYTES);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + HEADER_BYTES);
  K* alt_keys = reinterpret_cast<K*>(scratch + HEADER_BYTES + align256(tiles * RADIX * 8));
  int* alt_order = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(alt_keys) +
                                          align256(n * (long long)sizeof(K)));
  if ((err = cudaMemsetAsync(scratch, 0, HEADER_BYTES + tiles * RADIX * 8, s)) != cudaSuccess)
    return (int)err;
  const long long count_tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const unsigned count_blocks = (unsigned)(count_tiles < COUNT_BLOCKS ? count_tiles : COUNT_BLOCKS);
  digit_count_kernel<K><<<count_blocks, SORT_THREADS, 0, s>>>(raw, raw_i32, cap, n, passes, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_sort_kernel_launches;
  // pass p writes to the output when passes - 1 - p is even, else to the
  // alternate buffers, so the last pass writes the output and each pass
  // reads what the one before it wrote (the output holds digit keys until
  // the last pass)
  K* out_as_k = reinterpret_cast<K*>(keys_out);
  for (int p = 0; p < passes; ++p) {
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    SweepArgs<K> a;
    a.raw = raw;
    a.raw_i32 = raw_i32;
    a.cap = cap;
    a.in_keys = to_out ? alt_keys : out_as_k;
    a.in_order = to_out ? alt_order : order_out;
    a.out_keys = to_out ? out_as_k : alt_keys;
    a.final_keys = p == passes - 1 ? keys_out : nullptr;
    a.out_order = to_out ? order_out : alt_order;
    a.n = n;
    a.counts = counts;
    a.status = status;
    a.next_tile = next_tile;
    sweep_kernel<K, ITEMS><<<(unsigned)tiles, SORT_THREADS, smem, s>>>(a, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++g_sort_kernel_launches;
  }
  return (int)cudaSuccess;
}

template <typename K>
static int sort_keys(const void* raw, int raw_i32, long long n, long long cap, int passes,
                     long long* keys_out, int* order_out, unsigned char* scratch,
                     cudaStream_t s) {
  if (n <= SORT_TILE) {
    const size_t smem = sizeof(SortShared<K, SORT_ITEMS>);
    cudaError_t err = cudaFuncSetAttribute(
        sort_tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sort_tile_kernel<K><<<1, SORT_THREADS, smem, s>>>(raw, raw_i32, cap, (int)n, passes,
                                                      keys_out, order_out);
    if ((err = cudaGetLastError()) == cudaSuccess) ++g_sort_kernel_launches;
    return (int)err;
  }
  if (sweep_items(n) == 4)
    return sweep_passes<K, 4>(raw, raw_i32, n, cap, passes, keys_out, order_out, scratch, s);
  return sweep_passes<K, 16>(raw, raw_i32, n, cap, passes, keys_out, order_out, scratch, s);
}

extern "C" {

// Bytes of scratch arroyo_join_sort_pairs needs for n keys (0 when they
// fit one tile); range_cap > 0 for range mode.
long long arroyo_join_sort_scratch_bytes(long long n, long long range_cap) {
  return sort_scratch_bytes(n, range_cap);
}

// keys_in: n int64 keys, or int32 ones (keys_i32) sorted as their int64
// values, 1 <= n < 2^31. range_cap 0: full mode, the digits of key ^
// INT64_MIN, passes of them from the lowest (the caller's passes =
// ceil(key_bits / 8)); range_cap in [1, 2^31): range mode, keys outside
// [0, range_cap) sort and come out as range_cap, passes <= 4. keys_out
// (int64) and order_out (int32) hold n rows; scratch holds at least
// arroyo_join_sort_scratch_bytes(n, range_cap) bytes, 256-byte aligned.
int arroyo_join_sort_pairs(int device, const void* keys_in, int keys_i32, long long n,
                           long long range_cap, int passes, void* keys_out, void* order_out,
                           void* scratch, long long scratch_bytes, void* stream) {
  const int max_passes = range_cap > 0 ? MAX_RANGE_PASSES : MAX_PASSES;
  if (n < 1 || n > INT32_LIMIT || range_cap < 0 || range_cap > INT32_LIMIT || passes < 1 ||
      passes > max_passes || scratch_bytes < sort_scratch_bytes(n, range_cap) ||
      (scratch == nullptr && scratch_bytes > 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* scr = static_cast<unsigned char*>(scratch);
  long long* ko = static_cast<long long*>(keys_out);
  int* oo = static_cast<int*>(order_out);
  if (range_cap > 0)
    return sort_keys<unsigned>(keys_in, keys_i32, n, range_cap, passes, ko, oo, scr, s);
  return sort_keys<unsigned long long>(keys_in, keys_i32, n, 0, passes, ko, oo, scr, s);
}

// The kernels arroyo_join_sort_pairs has launched so far in this process.
long long arroyo_join_sort_kernel_launches(void) { return g_sort_kernel_launches; }

int arroyo_join_search_bounds(int device, const void* sorted, long long m, const void* probe,
                              long long p, void* lo, void* hi, void* stream) {
  if (m < 0 || m > INT32_LIMIT || p < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  search_bounds_kernel<<<blocks_for(p), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted), m, static_cast<const long long*>(probe), p,
      static_cast<int*>(lo), static_cast<int*>(hi));
  return (int)cudaGetLastError();
}

}  // extern "C"
