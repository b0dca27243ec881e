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
// stable rank, the look-back and the status words are csrc/radix_sort.cuh's,
// which K8 (csrc/sharded_agg.cu) sorts with too.
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
// K6 must read each probe key once and write two int32 per key; the
// sorted keys are read where the searches land. A plain binary search
// reads far more: at 16,777,216 sorted keys (134 MB, past the 50 MB L2)
// the last levels of its ~24 dependent loads miss, each a 32-byte sector
// no other probe shares, and a second search for hi from lo misses as
// often. So K6
// answers the top levels from shared memory (every block caches 2048
// evenly spaced keys, 16 KB, read from L2 once the first block has pulled
// them in): the search in device memory then covers a window of m / 2048
// keys. hi is searched from lo, or from the start of the splitter window
// that must hold it where that lies past lo, by reading the last key of
// each 4-key (32-byte) sector, 8 sectors one after another and then
// doubling, then searching inside the last step: a probe key absent from
// the build side costs one load on the sector lo's search read last, a
// run of r equal keys about r / 4 sectors (the bytes it must read; a
// binary search or a gallop from lo reads about twice as many), and a run
// longer than a window no more than a window's search (an INT64_MAX probe,
// the join's padding, takes hi = m at once). Each thread searches 4 probe
// keys in step when
// the call holds enough of them to fill the card twice over, so 4
// independent loads are in flight per level, else 1 (more blocks share a
// small call); at most 8 blocks per SM, looping over the rest.
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller hands K5 its scratch) and returns cudaGetLastError() after
// every launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

#include "radix_sort.cuh"

using radix::RADIX;

#define SORT_THREADS 256  // one thread per digit in the per-digit steps
#define SORT_WARPS (SORT_THREADS / 32)
#define SORT_ITEMS 16  // the one-launch sort's items per thread: SORT_TILE keys
#define SORT_TILE (SORT_THREADS * SORT_ITEMS)
#define MAX_PASSES 8
#define MAX_RANGE_PASSES 4  // range mode sorts at most 31 bits
#define COUNT_BLOCKS 528    // 4 per SM of the H100
#define SIGN_BIT 0x8000000000000000ULL
#define INT32_LIMIT 0x7fffffffLL

// scratch layout: counts [MAX_PASSES][RADIX] u32, tile counters
// [MAX_PASSES] u32, status [tiles][RADIX] u64 (cleared by the memset), the
// alternate keys [n] and order [n] of the ping-pong
#define COUNTS_BYTES (MAX_PASSES * RADIX * 4)
#define HEADER_BYTES (COUNTS_BYTES + 256)

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

template <typename K, int ITEMS>
struct SortShared {
  K keys[SORT_THREADS * ITEMS];  // the tile in digit order, after the scatter
  int order[SORT_THREADS * ITEMS];
  radix::RankShared<SORT_WARPS> r;
  long long out_base[RADIX];  // output position = out_base[digit] + row in the tile
  int tile;
};

// Each item's digit at shift, RADIX for the slots at or past tile_n.
template <typename K, int ITEMS>
__device__ __forceinline__ void digits_of(const K (&key)[ITEMS], int tile_n, int shift,
                                          unsigned (&dig)[ITEMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    dig[j] = warp * 32 * ITEMS + j * 32 + lane < tile_n ? digit_of(key[j], shift) : RADIX;
}

// Each item to its row of the tile in digit order.
template <typename K, int ITEMS>
__device__ __forceinline__ void scatter_to_shared(SortShared<K, ITEMS>& sm, const K (&key)[ITEMS],
                                                  const int (&ord)[ITEMS],
                                                  const unsigned (&dig)[ITEMS],
                                                  const unsigned (&rank)[ITEMS]) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (dig[j] < RADIX) {
      const unsigned at = radix::tile_slot(sm.r, dig[j], rank[j]);
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
  sm.out_base[d] = radix::block_exclusive_sum<SORT_WARPS>(digit_total, sm.r.warp_sums);
  unsigned dig[ITEMS], rank[ITEMS];
  digits_of(key, tile_n, shift, dig);
  radix::rank_digits(sm.r, dig, rank);
  __syncthreads();
  const unsigned count = radix::digit_offsets(sm.r);
  // publish this tile's count of digit d, then look back over the earlier
  // tiles for the rows of digit d before it
  const unsigned before =
      radix::publish_and_look_back(a.status, tile, d, count, (unsigned long long)(pass + 1));
  sm.out_base[d] += (long long)before - sm.r.tile_start[d];
  __syncthreads();
  scatter_to_shared(sm, key, ord, dig, rank);
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
  unsigned dig[SORT_ITEMS], rank[SORT_ITEMS];
  for (int p = 0; p < passes; ++p) {
    digits_of(key, n, 8 * p, dig);
    radix::rank_digits(sm.r, dig, rank);
    __syncthreads();
    radix::digit_offsets(sm.r);
    __syncthreads();
    scatter_to_shared(sm, key, ord, dig, rank);
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

// ------------------------------------------------------------ K6

#define SEARCH_THREADS 256
#define SPLITTERS 2048     // sorted keys every block caches in shared memory (16 KB)
#define SEARCH_BLOCKS_PER_SM 8

// first index of [a, a + n) whose key is >= x (UPPER: > x), or a + n, for
// PPT probes in step, so their loads overlap
template <bool UPPER, int PPT>
__device__ __forceinline__ void search_window(const long long* __restrict__ sorted,
                                              const long long (&x)[PPT], long long (&a)[PPT],
                                              long long (&n)[PPT]) {
  for (bool more = true; more;) {
    more = false;
    long long v[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (n[k] > 0) v[k] = sorted[a[k] + (n[k] >> 1)];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (n[k] <= 0) continue;
      const long long h = n[k] >> 1;
      if (UPPER ? v[k] <= x[k] : v[k] < x[k]) {
        a[k] += h + 1;
        n[k] -= h + 1;
      } else {
        n[k] = h;
      }
      more |= n[k] > 0;
    }
  }
}

// first splitter j with spl[j] >= x (UPPER: > x), in shared memory
template <bool UPPER>
__device__ __forceinline__ int search_splitters(const long long* spl, int ns, long long x) {
  int j = 0, c = ns;
  while (c > 0) {
    const int h = c >> 1;
    if (UPPER ? spl[j + h] <= x : spl[j + h] < x) {
      j += h + 1;
      c -= h + 1;
    } else {
      c = h;
    }
  }
  return j;
}

// Every block caches ns splitters, spl[j] = sorted[j * stride] (ns =
// ceil(m / stride) <= SPLITTERS), then walks its probes in groups of
// SEARCH_THREADS * PPT. For each bound the splitters leave a window of at
// most stride - 1 keys in device memory: lo's is searched directly; hi's
// starts at lo or past it (every key before the window is <= x) and reads
// the last key of each 4-key (32-byte) sector from there, 8 sectors one
// after another and then doubling, up to the window's end, then searches
// inside the last step. Each thread's PPT probes advance in step, so
// their loads overlap.
template <int PPT>
__global__ void __launch_bounds__(SEARCH_THREADS)
    search_bounds_kernel(const long long* __restrict__ sorted, long long m, long long stride,
                         int ns, const long long* __restrict__ probe, long long p,
                         int* __restrict__ lo_out, int* __restrict__ hi_out) {
  __shared__ long long spl[SPLITTERS];
  for (int j = threadIdx.x; j < ns; j += SEARCH_THREADS) spl[j] = sorted[(long long)j * stride];
  __syncthreads();
  constexpr long long GROUP = (long long)SEARCH_THREADS * PPT;
  for (long long g0 = (long long)blockIdx.x * GROUP; g0 < p; g0 += (long long)gridDim.x * GROUP) {
    long long x[PPT], a[PPT], n[PPT], lo[PPT], end[PPT], step[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const long long t = g0 + k * SEARCH_THREADS + threadIdx.x;
      x[k] = t < p ? probe[t] : 0;
    }
    // lo: sorted[(j - 1) stride] < x <= sorted[j stride] (past m when j = ns)
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = search_splitters<false>(spl, ns, x[k]);
      a[k] = j == 0 ? 0 : (long long)(j - 1) * stride + 1;
      n[k] = j == 0 ? 0 : (j < ns ? (long long)j * stride : m) - a[k];
    }
    search_window<false>(sorted, x, a, n);
    // hi: sorted[(j - 1) stride] <= x < sorted[j stride], and hi >= lo
    long long last[PPT], span[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      lo[k] = a[k];
      const int j = search_splitters<true>(spl, ns, x[k]);
      const long long w = j == 0 ? 0 : (long long)(j - 1) * stride + 1;
      a[k] = w > lo[k] ? w : lo[k];
      end[k] = j < ns ? (long long)j * stride : m;
      last[k] = a[k] - 1;  // every index up to it holds a key <= x
      span[k] = 0;
      n[k] = -1;  // scanning
      if (x[k] == INT64_MAX) {  // no key is larger: hi = m (the join's padding)
        step[k] = m;
        n[k] = 0;
      }
    }
    // the last key of each 4-key sector from a's on, 8 sectors one after
    // another (a run's own sectors, the bytes it must read), then doubling
    for (bool more = true; more;) {
      more = false;
      long long v[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const long long q = (a[k] & ~3LL) + 4 * span[k] + 3;
        if (n[k] < 0 && q < end[k]) v[k] = sorted[q];
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (n[k] >= 0) continue;
        const long long q = (a[k] & ~3LL) + 4 * span[k] + 3;
        if (q >= end[k] || v[k] > x[k]) {
          // the first key > x lies in [last + 1, min(q, end)]
          const long long top = q < end[k] ? q : end[k];
          n[k] = top - (last[k] + 1);
          step[k] = last[k] + 1;
        } else {
          last[k] = q;
          span[k] = span[k] < 7 ? span[k] + 1 : 2 * span[k] + 1;
          more = true;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) a[k] = step[k];
    search_window<true>(sorted, x, a, n);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const long long t = g0 + k * SEARCH_THREADS + threadIdx.x;
      if (t < p) {
        lo_out[t] = (int)lo[k];
        hi_out[t] = (int)a[k];
      }
    }
  }
}

// K6's probes per thread: 4 where one per thread would fill the card twice
// over (their loads overlap), else 1 (more blocks share a small call)
static int search_ppt(int sms, long long p) {
  return p >= 2LL * sms * SEARCH_BLOCKS_PER_SM * SEARCH_THREADS ? 4 : 1;
}

// K6's grid: one block per SEARCH_THREADS * ppt probes, at most
// SEARCH_BLOCKS_PER_SM per SM (the rest loop), so the splitters are loaded
// by at most that many blocks
static unsigned int search_blocks(int sms, long long p, int ppt) {
  const long long per_block = (long long)SEARCH_THREADS * ppt;
  const long long want = (p + per_block - 1) / per_block;
  const long long most = (long long)sms * SEARCH_BLOCKS_PER_SM;
  return (unsigned int)(want < most ? want : most);
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
  DeviceGuard guard(device);
  cudaError_t err = guard.err;
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
  DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    sms = 132;
  const long long stride = m > SPLITTERS ? (m + SPLITTERS - 1) / SPLITTERS : 1;
  const int ns = (int)((m + stride - 1) / stride);
  const int ppt = search_ppt(sms, p);
  const auto* sk = static_cast<const long long*>(sorted);
  const auto* pk = static_cast<const long long*>(probe);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ppt == 4)
    search_bounds_kernel<4><<<search_blocks(sms, p, 4), SEARCH_THREADS, 0, s>>>(
        sk, m, stride, ns, pk, p, static_cast<int*>(lo), static_cast<int*>(hi));
  else
    search_bounds_kernel<1><<<search_blocks(sms, p, 1), SEARCH_THREADS, 0, s>>>(
        sk, m, stride, ns, pk, p, static_cast<int*>(lo), static_cast<int*>(hi));
  return (int)cudaGetLastError();
}

}  // extern "C"
