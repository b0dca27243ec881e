// Key-sharded aggregate kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (arroyo_tpu_torch/ops/sharded_kernels.py
// builds this file with nvcc at first use and holds each kernel against its
// plain PyTorch version).
//
// The sharded aggregate keeps n_dev shards of an open-addressing hash
// table on one device, every array laid out [shard][...]; each kernel takes
// the shard as a grid dimension, so one launch serves every shard. They
// replace the jitted programs of the JAX package's mesh path:
//
//   K8  agg_sort_reduce   arroyo_tpu/ops/aggregate.py sort_reduce (B7), and
//       B9's step at one shard: per shard, a stable lexsort of L rows by
//       (key, bin), invalid rows as (INT64_MAX, INT32_MAX), then one
//       reduced partial per run of equal (key, bin): the representative
//       key and bin, every lane's sum / min / max, and active = the run
//       counted a valid row. Slots past the last run hold (INT64_MIN,
//       INT32_MIN), inactive, and each lane's identity.
//   K9  agg_probe_merge   probe_merge (B8): merge unique partials into the
//       (keys, bins, occ, accs) table in place, by max_probes synchronous
//       rounds of linear probing from mix(key ^ bin * C) & (cap - 1).
//       Given an overflow counter, it adds the partials no round placed
//       (the single-device table's step, aggregate.py _build_jax :326-328).
//   K10 shard_exchange    arroyo_tpu/parallel/sharded_agg.py
//       exchange_merge steps 2-3: each partial's owner (contiguous uint64
//       key ranges, U64_MAX / n + 1 wide), a stable order by owner, the
//       rank inside the owner; ranks below dest_cap go to the
//       [n_dev, dest_cap] send buffers, the rest stay local.
//   K10 shard_spill       step 7: partials the table could not place
//       append to the per-shard spill buffer; past its end they count as
//       overflow. One launch of csrc/table_compact.cuh's compaction in its
//       SPILL mode: the still-active flags are the predicate, the fill
//       comes in through tile 0's look-back word, the shard's last tile
//       writes the new fill and the overflow.
//   K11 shard_extract     local_extract: a stable compaction of the slots
//       whose bin lies in [emit_lo, emit_hi), emitting ones first, then the
//       first non-emitting ones (what argsort(~emit_mask)[:emit_cap]
//       selects), the per-shard total, and the frees. With zero_tail, the
//       rows past the emitting ones hold zeros instead, E may exceed cap,
//       and the table's overflow counter is copied beside the totals: the
//       single-device table's extract / scan_packed (aggregate.py
//       _build_jax :350-379, :424-444), whose cumsum scatter gives the
//       same slot order. One launch of csrc/table_compact.cuh's
//       compaction (tiles of 4096 slots, decoupled look-back, the rows
//       past the emitting ones by fill blocks once the shard's total is
//       known).
//
// K8, what bounds it and its design. It must read each valid row once and
// write the [S, L] outputs once, so bytes bound it; its work is the valid
// ("live") rows alone. The merged step of the fused mesh path hands it S *
// (S dest_cap + L) rows of which a few percent are live (q7m: 139,264 a
// shard), so a sort over every slot would move mostly padding. So K8
// first compacts: sr_count counts each chunk's live rows, sr_compact
// scatters each live row's record (key digits, bin digits, flat row) in row
// order, shards one after another, and fills the output slots past live +
// 1 of each shard (no run or padding run can take them) with (INT64_MIN,
// INT32_MIN), inactive, the identities. Then it sorts the records stably by
// (key, bin) within each shard, 8-bit digits least significant first (the
// bin's 4 bytes, the key's 8, the shard), with csrc/radix_sort.cuh's
// stable rank, skipping every digit position whose value is one across the
// rows (a pass that would move nothing: the bins' high bytes, the shard at
// one shard):
//   - with at most SR_BLOCK_ROWS (8192) live rows in every shard, one
//     block per shard sorts its rows in shared memory (sr_block) and then
//     finds and reduces the runs itself: three launches. Up to L = 8192
//     rows a shard that holds by construction; past it sr_compact also
//     counts the digits and the call reads them back (one wait on the
//     stream) to choose;
//   - else one onesweep launch per varying position over all shards'
//     records (sr_sweep: K5's tile counter and decoupled look-back), then
//     a chunk count and scan of the runs' starts and one thread per output
//     slot (sr_reduce).
// Runs: a valid row keyed (INT64_MAX, INT32_MAX) forms the last run of its
// shard, and the shard's invalid rows join it (active, reduced over its
// valid rows, as the reference's lexsort has it); else a shard with an
// invalid row gets one inactive (INT64_MAX, INT32_MAX) run after its live
// runs. A run shorter than SR_LONG_RUN rows is reduced by one thread
// walking its rows in sorted order from the identity; a longer one by a
// warp (one block: every lane's values staged in shared memory in sorted
// order first) or a whole block (onesweep: block_walk stages the run's
// values through shared memory). A float sum is one thread's chain of
// __dadd_rn / __fadd_rn in sorted order, which is how XLA's CPU
// segment_sum adds, so float sums come out bit for bit; integer sums and
// min/max, exact in any grouping, combine across the warp in order. Float
// min/max keep XLA's order: NaN propagates and -0.0 sorts below +0.0.
//
// K9 reproduces the reference's placement slot for slot: each round
// classifies every active partial against the table as it was at the
// round's start, contenders for an empty slot resolve by atomicMax of
// their index (the highest wins, as the reference's scatter-max), and only
// then do matches and winners write. What bounds it is latency: a round is
// a chain of dependent loads and the rounds run one after another. So one
// launch runs every round of a shard on a thread-block cluster of 8 or 16
// CTAs (pm_cluster; the size from cudaOccupancyMaxActiveClusters at first
// use), which the hardware schedules together: the cluster's barrier
// (release / acquire) takes the place of the block's. Round 0 reads the
// active flags 16 at a time, spread over the cluster's CTAs (no list pass,
// no memset), and each CTA lists its active partials; a list entry holds
// the partial's index and its slot in the coming round, so a round's
// classification loads the key, the bin and the slot's words in one wave,
// a thread holds its partials in registers from classifying to writing,
// with the lane values they write loaded before the barrier, and once at
// most 1,024 partials are left CTA 0 runs the remaining rounds alone with
// its block's barrier. The partials left are listed by one shared atomic
// per warp. The claims carry the call's and round's tag in their high
// word, so classifying and claiming are one phase and nothing is reset:
// two barriers a round. The table's words that other CTAs write are read
// at L2. A round that starts with no active
// partial ends the loop (no later round could write). Each call records,
// for its first PM_REPORT_SHARDS shards, the rounds it ran and the active
// list's length at the start of each of the first PM_REPORT_ROUNDS rounds
// and after the last (arroyo_agg_probe_merge_rounds reads them back).
//
// K10's exchange must read each partial and write every send slot (the
// reference's fill values included, 0, 0, invalid and each lane's identity)
// and every local row once: bytes bound it, most of them the fill. It runs
// over the whole card in two launches: ex_count counts each tile's rows per
// owner; ex_scatter's tile blocks rank each tile's rows by owner stably
// (csrc/radix_sort.cuh's rank, the owner one digit) and add the tiles
// before it, and its fill blocks, one per (source, owner, 2048 send
// slots), write the slots past the owner's rows with 16-byte stores. The
// owner comes from __umul64hi and one compare (owner_of), no division.
//
// Bounds (H100, 3.35 TB/s): all five move a few bytes per element and do
// no arithmetic to speak of. K8's compaction counts per chunk in one launch
// and scatters in a second, every block of every shard at once. K11 reads
// each slot's occupancy and bin once, in one launch over tiles of every
// shard (see csrc/table_compact.cuh): its bound is the occupancy, the
// occupied bins, the emitted slots' key and lanes, the E rows written and
// the frees. K10's spill reads the still flags (16 a thread, one 16-byte
// load where M % 16 == 0) and only the flagged rows' key, bin and lanes:
// at q7m nearly every partial is placed, so its bound is the 1.1 MB of
// flags, and the former three launches (count, write, finish) were launch
// latency; the compaction's one launch waits out one look-back instead.
//
// Lanes are int32, int64, uint64 (a numeric group-by key riding as a max
// lane, as the JAX package's sharded store carries it), float32 or float64.
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller passes scratch) and returns cudaGetLastError() after every
// launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <vector>

#include "radix_sort.cuh"
#include "table_compact.cuh"

using radix::RADIX;
namespace cg = cooperative_groups;

#define MAX_LANES 32
#define MAX_SHARDS 32
#define CHUNK 1024  // elements per block of the count / scan passes
#define THREADS 256
#define KEY_MAX 0x7fffffffffffffffLL
#define KEY_MIN (-KEY_MAX - 1LL)
#define BIN_MAX 0x7fffffff
#define BIN_MIN (-BIN_MAX - 1)

enum { KIND_ADD = 0, KIND_MIN = 1, KIND_MAX = 2 };
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3, DT_U64 = 4 };

struct Lanes {
  const void* in[MAX_LANES];  // values read (NULL: a count lane of ones)
  void* out[MAX_LANES];       // values written
  void* aux[MAX_LANES];       // second output (K10: the merged rows)
  unsigned long long ident[MAX_LANES];  // identity bits (low 32 for 32-bit lanes)
  int kind[MAX_LANES];
  int dtype[MAX_LANES];
  int n;
};

// ------------------------------------------------------------ lane values

__device__ __forceinline__ bool wide(int dt) { return dt == DT_I64 || dt == DT_F64 || dt == DT_U64; }

__device__ __forceinline__ unsigned long long ld_bits(int dt, const void* p, long long i) {
  return wide(dt) ? static_cast<const unsigned long long*>(p)[i]
                  : (unsigned long long)static_cast<const unsigned int*>(p)[i];
}

__device__ __forceinline__ void st_bits(int dt, void* p, long long i, unsigned long long b) {
  if (wide(dt)) static_cast<unsigned long long*>(p)[i] = b;
  else static_cast<unsigned int*>(p)[i] = (unsigned int)b;
}

__device__ __forceinline__ unsigned long long one_bits(int dt) {
  switch (dt) {
    case DT_F64: return (unsigned long long)__double_as_longlong(1.0);
    case DT_F32: return (unsigned long long)__float_as_uint(1.0f);
    default: return 1ULL;
  }
}

// v replaces cur under the NaN-propagating order with -0.0 < +0.0
template <bool IS_MIN, typename F>
__device__ __forceinline__ bool replaces(F v, F cur) {
  if (isnan(cur)) return false;
  if (isnan(v)) return true;
  if (IS_MIN) return v < cur || (v == cur && signbit(v) && !signbit(cur));
  return v > cur || (v == cur && !signbit(v) && signbit(cur));
}

// a combined with b (a the running accumulator or the table's value)
__device__ __forceinline__ unsigned long long combine_bits(int kind, int dt, unsigned long long a,
                                                           unsigned long long b) {
  switch (dt) {
    case DT_I64: {
      if (kind == KIND_ADD) return a + b;  // two's complement wrap, as XLA
      long long x = (long long)a, y = (long long)b;
      return (unsigned long long)(kind == KIND_MIN ? (y < x ? y : x) : (y > x ? y : x));
    }
    case DT_U64:
      if (kind == KIND_ADD) return a + b;
      return kind == KIND_MIN ? (b < a ? b : a) : (b > a ? b : a);
    case DT_I32: {
      unsigned int ua = (unsigned int)a, ub = (unsigned int)b;
      if (kind == KIND_ADD) return (unsigned long long)(ua + ub);
      int x = (int)ua, y = (int)ub;
      return (unsigned long long)(unsigned int)(kind == KIND_MIN ? (y < x ? y : x) : (y > x ? y : x));
    }
    case DT_F64: {
      double x = __longlong_as_double((long long)a), y = __longlong_as_double((long long)b);
      if (kind == KIND_ADD) return (unsigned long long)__double_as_longlong(__dadd_rn(x, y));
      bool r = kind == KIND_MIN ? replaces<true>(y, x) : replaces<false>(y, x);
      return r ? b : a;
    }
    default: {
      float x = __uint_as_float((unsigned int)a), y = __uint_as_float((unsigned int)b);
      if (kind == KIND_ADD) return (unsigned long long)__float_as_uint(__fadd_rn(x, y));
      bool r = kind == KIND_MIN ? replaces<true>(y, x) : replaces<false>(y, x);
      return r ? b : a;
    }
  }
}

// ------------------------------------------------------------ block helpers

// exclusive count of set flags before this thread in the block, and the
// block's total; every thread of the block must call it
__device__ __forceinline__ int block_excl_count(bool flag, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_sums[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane < nw) warp_sums[lane] = v;  // inclusive
  }
  __syncthreads();
  const int base = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nw - 1];
  __syncthreads();
  return base + __popc(m & ((1u << lane) - 1u));
}

__device__ __forceinline__ long long block_sum(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < nw ? sh[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) sh[0] = t;
  }
  __syncthreads();
  const long long r = sh[0];
  __syncthreads();
  return r;
}

// chunk prefix and total of a shard's per-chunk counts
__device__ __forceinline__ void chunk_prefix(const int* counts, int n_chunks, int chunk,
                                             long long* prefix, long long* total,
                                             long long* sh) {
  long long before = 0, all = 0;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const int v = counts[c];
    all += v;
    if (c < chunk) before += v;
  }
  *prefix = block_sum(before, sh);
  *total = block_sum(all, sh);
}

// ------------------------------------------------------------ K8

#define SR_BLOCK_THREADS 512
#define SR_BLOCK_WARPS (SR_BLOCK_THREADS / 32)
#define SR_BLOCK_ITEMS 16
#define SR_BLOCK_ROWS (SR_BLOCK_THREADS * SR_BLOCK_ITEMS)  // a shard this small sorts in one block
#define SR_SWEEP_THREADS 256  // one thread per digit in the per-digit steps
#define SR_SWEEP_WARPS (SR_SWEEP_THREADS / 32)
#define SR_MAX_SHARDS 256  // the shard is one digit
#define SR_POSITIONS 13    // digit positions: the bin's 4 bytes, the key's 8, the shard
#define SR_SHARD_POS 12
#define SR_LONG_RUN 64          // a run this long is reduced by a whole block (onesweep)
#define SR_WARP_RUN 16          // one block per shard: a run this long by a warp
#define SR_STAGE_WORDS 8192     // a block walk's staged lane values (64 KB)
#define SR_WALK_BLOCKS 264      // blocks of the onesweep path's long-run walk
#define KEY_DIGITS_MAX 0xffffffffffffffffULL  // the digits of INT64_MAX
#define BIN_DIGITS_MAX 0xffffffffu            // the digits of INT32_MAX

struct SortIn {
  const long long* key;
  const void* bins;  // int32 or int64
  int bins64;
  long long bin_off;  // subtracted before the int32 cast
  const unsigned char* valid;  // NULL: every row valid
  long long n_valid;  // rows at or past this flat index are invalid
};

// A live row's sort record, structure of arrays: the key's digits (key ^
// INT64_MIN, so unsigned order is signed order), the bin's (bin ^
// INT32_MIN) and the row's flat index s * L + r, whose shard is row / L.
struct SrRecs {
  unsigned long long* k;
  unsigned* b;
  int* row;
};

struct SrOut {
  long long* key;
  int* bin;
  unsigned char* active;
};

// K8's counters in the scratch (cleared by a memset when L > SR_BLOCK_ROWS)
struct SrHeader {
  unsigned hist[SR_POSITIONS][RADIX];  // live rows per digit value; the shard row: per shard
  int shard_live[SR_MAX_SHARDS];   // live rows per shard (written by sr_compact)
  int shard_start[SR_MAX_SHARDS];  // a shard's first compacted row (written by sr_compact)
  int run_base[SR_MAX_SHARDS];     // the onesweep path: a shard's first run
  int run_end[SR_MAX_SHARDS];      // and one past its last
  unsigned long long n_long;       // runs listed for sr_walk_long
  unsigned next_tile[16];          // per pass: the next tile to hand out
};

// What the last call did per shard, for a caller to read back after it
// (arroyo_agg_sort_reduce_shards): its live rows (sr_compact), and the
// passes its block ran (sr_block; -1 where the onesweep path sorted it).
__device__ int g_sr_shard_live[SR_MAX_SHARDS];
__device__ int g_sr_shard_passes[SR_MAX_SHARDS];

__device__ __forceinline__ bool row_valid(const SortIn& a, long long row) {
  return row < a.n_valid && (a.valid == nullptr || a.valid[row]);
}

__device__ __forceinline__ int bin_at(const SortIn& a, long long row) {
  const long long b = a.bins64 ? static_cast<const long long*>(a.bins)[row]
                               : (long long)static_cast<const int*>(a.bins)[row];
  return (int)(unsigned int)(unsigned long long)(b - a.bin_off);
}

// digit position pos of a record: 0-3 the bin's bytes, 4-11 the key's, 12 its shard
__device__ __forceinline__ unsigned rec_digit(unsigned long long kd, unsigned bd, int row, int L,
                                              int pos) {
  if (pos < 4) return (bd >> (8 * pos)) & 255u;
  if (pos < SR_SHARD_POS) return (unsigned)(kd >> (8 * (pos - 4))) & 255u;
  return (unsigned)(row / L);
}

// an output slot no run fills: (key, bin), inactive, every lane's identity
__device__ __forceinline__ void write_empty(const SrOut& out, const Lanes& lanes, long long o,
                                            long long key, int bin) {
  out.key[o] = key;
  out.bin[o] = bin;
  out.active[o] = 0;
  for (int l = 0; l < lanes.n; ++l) st_bits(lanes.dtype[l], lanes.out[l], o, lanes.ident[l]);
}

// a run's representative key and bin, active
__device__ __forceinline__ void write_run_key(const SrOut& out, long long o, unsigned long long kd,
                                              unsigned bd) {
  out.key[o] = (long long)(kd ^ 0x8000000000000000ULL);
  out.bin[o] = (int)(bd ^ 0x80000000u);
  out.active[o] = 1;
}

// The lanes of a short run (input rows rows[0, len)) walked by one thread
// from the identity in sorted order, into output slot o; eight rows' loads
// are in flight before their combines.
__device__ __forceinline__ void reduce_short(const Lanes& lanes, const int* rows, int len,
                                             long long o) {
  for (int l = 0; l < lanes.n; ++l) {
    const int dt = lanes.dtype[l], kind = lanes.kind[l];
    const void* vp = lanes.in[l];
    unsigned long long acc = lanes.ident[l];
    for (int i = 0; i < len; i += 8) {
      unsigned long long v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (i + k < len) v[k] = vp ? ld_bits(dt, vp, rows[i + k]) : one_bits(dt);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (i + k < len) acc = combine_bits(kind, dt, acc, v[k]);
    }
    st_bits(dt, lanes.out[l], o, acc);
  }
}

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double from_bits(unsigned long long b, double) {
  return __longlong_as_double((long long)b);
}
__device__ __forceinline__ float from_bits(unsigned long long b, float) {
  return __uint_as_float((unsigned)b);
}

// x plus the staged values v[0, m) in order, one dependent add after
// another (XLA CPU's segment_sum order), the values read eight ahead
template <typename F>
__device__ __forceinline__ F chain(F x, const unsigned long long* v, int m) {
  int i = 0;
  for (; i + 8 <= m; i += 8) {
    F w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = from_bits(v[i + k], x);
#pragma unroll
    for (int k = 0; k < 8; ++k) x = add_rn(x, w[k]);
  }
  for (; i < m; ++i) x = add_rn(x, from_bits(v[i], x));
  return x;
}

// The values v[0, m) of one lane combined in order by the calling warp
// (every lane of it calls; lane 0's result counts): a float sum by lane 0's
// chain, any other lane (exact in any grouping) over 32 consecutive slices
// combined pairwise in order, so a NaN or a signed zero wins where it
// would in a walk.
__device__ __forceinline__ unsigned long long warp_reduce(int kind, int dt, unsigned long long x,
                                                          const unsigned long long* v, int m) {
  const int lane = threadIdx.x & 31;
  if (kind == KIND_ADD && dt == DT_F64)
    return lane ? x : (unsigned long long)__double_as_longlong(
                          chain(__longlong_as_double((long long)x), v, m));
  if (kind == KIND_ADD && dt == DT_F32)
    return lane ? x : (unsigned long long)__float_as_uint(chain(__uint_as_float((unsigned)x), v, m));
  const int per = (m + 31) / 32;
  const int lo = lane * per, hi = min(m, lo + per);
  unsigned long long part = x;  // the identity
  for (int i = lo; i < hi; ++i) part = combine_bits(kind, dt, part, v[i]);
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long next = __shfl_down_sync(0xffffffffu, part, off);
    if ((lane & (2 * off - 1)) == 0) part = combine_bits(kind, dt, part, next);
  }
  return part;
}

// The lanes of a long run (input rows rows[0, len)) reduced by the whole
// block into output slot o: the block stages chunks of every lane's values
// in shared memory (stage: stage_words words), then warp w reduces lanes
// w, w + warps, ... (warp_reduce). acc: MAX_LANES words of shared memory.
// Every thread of the block calls it.
__device__ void block_walk(const Lanes& lanes, const int* rows, int len, long long o,
                           unsigned long long* stage, int stage_words, unsigned long long* acc) {
  const int nl = lanes.n;
  if (nl == 0) return;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int chunk = stage_words / nl;
  if (tid < nl) acc[tid] = lanes.ident[tid];
  for (int c0 = 0; c0 < len; c0 += chunk) {
    const int m = min(chunk, len - c0);
    __syncthreads();  // acc is set and the chunk before is read
    for (int i = tid; i < m; i += nt) {
      const long long row = rows[c0 + i];
      for (int l = 0; l < nl; ++l) {
        const int dt = lanes.dtype[l];
        stage[l * chunk + i] = lanes.in[l] ? ld_bits(dt, lanes.in[l], row) : one_bits(dt);
      }
    }
    __syncthreads();
    for (int l = warp; l < nl; l += nw) {
      const int dt = lanes.dtype[l], kind = lanes.kind[l];
      const unsigned long long* v = stage + l * chunk;
      if (kind == KIND_ADD && (dt == DT_F64 || dt == DT_F32)) {
        const unsigned long long r = warp_reduce(kind, dt, acc[l], v, m);
        if (lane == 0) acc[l] = r;
      } else {
        const unsigned long long part = warp_reduce(kind, dt, lanes.ident[l], v, m);
        if (lane == 0) acc[l] = combine_bits(kind, dt, acc[l], part);
      }
    }
  }
  __syncthreads();
  if (tid < nl) st_bits(lanes.dtype[tid], lanes.out[tid], o, acc[tid]);
  __syncthreads();
}

// Per chunk of CHUNK rows of shard blockIdx.y: its live rows.
__global__ void __launch_bounds__(CHUNK)
    sr_count(SortIn a, int L, int n_chunks, int* __restrict__ counts) {
  __shared__ int ws[32];
  const int s = blockIdx.y;
  const long long r = (long long)blockIdx.x * CHUNK + threadIdx.x;
  int total;
  block_excl_count(r < L && row_valid(a, (long long)s * L + r), ws, &total);
  if (threadIdx.x == 0) counts[s * n_chunks + blockIdx.x] = total;
}

// Each live row's record to its compacted place, shards one after another
// and rows in order within a shard; each shard's live count and first
// place; with_hist: the live rows' digit counts at positions 0-11 and the
// live count per shard (position 12). Output slots past live + 1 (which no
// run or padding run can take) get the empty fill.
__global__ void __launch_bounds__(CHUNK)
    sr_compact(SortIn a, Lanes lanes, int L, int n_chunks, const int* __restrict__ counts,
               SrRecs c, SrHeader* __restrict__ hd, int with_hist, SrOut out) {
  __shared__ int ws[32];
  __shared__ long long sh[32];
  __shared__ unsigned h[SR_SHARD_POS * RADIX];
  const int s = blockIdx.y, chunk = blockIdx.x;
  long long before_s = 0, before_c = 0, total = 0;
  for (int i = threadIdx.x; i < (s + 1) * n_chunks; i += blockDim.x) {
    const int v = counts[i];
    if (i < s * n_chunks) {
      before_s += v;
    } else {
      total += v;
      if (i < s * n_chunks + chunk) before_c += v;
    }
  }
  before_s = block_sum(before_s, sh);
  before_c = block_sum(before_c, sh);
  total = block_sum(total, sh);
  const long long r = (long long)chunk * CHUNK + threadIdx.x;
  const long long row = (long long)s * L + r;
  const bool live = r < L && row_valid(a, row);
  int tot;
  const int ex = block_excl_count(live, ws, &tot);
  unsigned long long kd = 0;
  unsigned bd = 0;
  if (live) {
    kd = (unsigned long long)a.key[row] ^ 0x8000000000000000ULL;
    bd = (unsigned)bin_at(a, row) ^ 0x80000000u;
    const long long at = before_s + before_c + ex;
    c.k[at] = kd;
    c.b[at] = bd;
    c.row[at] = (int)row;
  }
  if (chunk == 0 && threadIdx.x == 0) {
    hd->shard_live[s] = (int)total;
    hd->shard_start[s] = (int)before_s;
    if (with_hist) hd->hist[SR_SHARD_POS][s] = (unsigned)total;
    g_sr_shard_live[s] = (int)total;
    g_sr_shard_passes[s] = -1;
  }
  if (r < L && r > total) write_empty(out, lanes, row, KEY_MIN, BIN_MIN);
  if (!with_hist) return;
  for (int i = threadIdx.x; i < SR_SHARD_POS * RADIX; i += blockDim.x) h[i] = 0;
  __syncthreads();
  // a warp whose live rows share a digit adds them at once (the bins' high
  // bytes), else each live row adds its own
  const unsigned live_mask = __ballot_sync(0xffffffffu, live);
  if (live_mask) {
    const int lane = threadIdx.x & 31, leader = __ffs(live_mask) - 1;
    for (int pos = 0; pos < SR_SHARD_POS; ++pos) {
      const unsigned d = rec_digit(kd, bd, 0, 1, pos);
      const unsigned d0 = __shfl_sync(0xffffffffu, d, leader);
      if (__all_sync(0xffffffffu, !live || d == d0)) {
        if (lane == leader) atomicAdd(&h[pos * RADIX + d0], (unsigned)__popc(live_mask));
      } else if (live) {
        atomicAdd(&h[pos * RADIX + d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SR_SHARD_POS * RADIX; i += blockDim.x)
    if (h[i]) atomicAdd(&hd->hist[0][0] + i, h[i]);
}

struct SrBlockShared {
  unsigned long long k[SR_BLOCK_ROWS];  // after the keys are written: a lane's staged values
  unsigned b[SR_BLOCK_ROWS];
  int row[SR_BLOCK_ROWS];
  int runs[SR_BLOCK_ROWS + 1];  // each run's first row, then the shard's live count
  radix::RankShared<SR_BLOCK_WARPS> r;
  unsigned long long kor, kand;
  unsigned bor, band;
  int n_runs, n_long;
  int long_runs[SR_BLOCK_ROWS / SR_WARP_RUN];
};

extern __shared__ __align__(16) unsigned char sr_smem[];

// The shared-memory path: one block per shard of at most SR_BLOCK_ROWS live
// rows. It sorts them by (key, bin) with one stable pass per digit
// position that varies within the shard, all in shared memory, finds the
// runs and writes output slots [0, min(live + 1, L)); then, lane by lane,
// it stages the lane's values in sorted order in shared memory and reduces
// each run from there, a short one by one thread, a long one by one warp.
__global__ void __launch_bounds__(SR_BLOCK_THREADS, 1)
    sr_block(Lanes lanes, int L, SrRecs c, const SrHeader* __restrict__ hd, SrOut out) {
  SrBlockShared& sm = *reinterpret_cast<SrBlockShared*>(sr_smem);
  const int s = blockIdx.x;
  const int n = hd->shard_live[s];
  const long long base = hd->shard_start[s];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    sm.kor = 0;
    sm.kand = ~0ULL;
    sm.bor = 0;
    sm.band = ~0u;
    sm.n_long = 0;
  }
  __syncthreads();
  unsigned long long kor = 0, kand = ~0ULL;
  unsigned bor = 0, band = ~0u;
  for (int i = tid; i < n; i += SR_BLOCK_THREADS) {
    const unsigned long long kd = c.k[base + i];
    const unsigned bd = c.b[base + i];
    sm.k[i] = kd;
    sm.b[i] = bd;
    sm.row[i] = c.row[base + i];
    kor |= kd;
    kand &= kd;
    bor |= bd;
    band &= bd;
  }
  for (int o = 16; o > 0; o >>= 1) {
    kor |= __shfl_xor_sync(0xffffffffu, kor, o);
    kand &= __shfl_xor_sync(0xffffffffu, kand, o);
    bor |= __shfl_xor_sync(0xffffffffu, bor, o);
    band &= __shfl_xor_sync(0xffffffffu, band, o);
  }
  if (lane == 0) {
    atomicOr(&sm.kor, kor);
    atomicAnd(&sm.kand, kand);
    atomicOr(&sm.bor, bor);
    atomicAnd(&sm.band, band);
  }
  __syncthreads();
  const unsigned long long kvary = sm.kor ^ sm.kand;
  const unsigned bvary = sm.bor ^ sm.band;
  // items per thread: the fewest that hold the shard, so each warp's rank
  // chain is no longer than it must be
  const int used = (n + SR_BLOCK_THREADS - 1) / SR_BLOCK_THREADS;
  int passes = 0;
  for (int pos = 0; n > 1 && pos < SR_SHARD_POS; ++pos) {
    const unsigned vary = pos < 4 ? (bvary >> (8 * pos)) & 255u
                                  : (unsigned)(kvary >> (8 * (pos - 4))) & 255u;
    if (!vary) continue;  // one digit value across the shard: the pass moves nothing
    ++passes;
    unsigned long long kd[SR_BLOCK_ITEMS];
    unsigned bd[SR_BLOCK_ITEMS], dig[SR_BLOCK_ITEMS], rank[SR_BLOCK_ITEMS];
    int rw[SR_BLOCK_ITEMS];
#pragma unroll
    for (int j = 0; j < SR_BLOCK_ITEMS; ++j) {
      const int i = warp * 32 * used + j * 32 + lane;
      dig[j] = RADIX;
      if (j < used && i < n) {
        kd[j] = sm.k[i];
        bd[j] = sm.b[i];
        rw[j] = sm.row[i];
        dig[j] = rec_digit(kd[j], bd[j], 0, 1, pos);
      }
    }
    __syncthreads();  // every item is read before any is overwritten
    radix::rank_digits(sm.r, dig, rank, used);
    __syncthreads();
    radix::digit_offsets(sm.r);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SR_BLOCK_ITEMS; ++j) {
      if (dig[j] < RADIX) {
        const unsigned at = radix::tile_slot(sm.r, dig[j], rank[j]);
        sm.k[at] = kd[j];
        sm.b[at] = bd[j];
        sm.row[at] = rw[j];
      }
    }
    __syncthreads();
  }
  if (tid == 0) g_sr_shard_passes[s] = passes;
  // the runs: thread t flags rows [t ITEMS, (t + 1) ITEMS)
  const int i0 = tid * SR_BLOCK_ITEMS;
  unsigned flags = 0, cnt = 0;
  for (int q = 0; q < SR_BLOCK_ITEMS; ++q) {
    const int i = i0 + q;
    if (i < n && (i == 0 || sm.k[i] != sm.k[i - 1] || sm.b[i] != sm.b[i - 1])) {
      flags |= 1u << q;
      ++cnt;
    }
  }
  unsigned g = radix::block_exclusive_sum<SR_BLOCK_WARPS>(cnt, sm.r.warp_sums);
  if (tid == SR_BLOCK_THREADS - 1) {
    sm.n_runs = (int)(g + cnt);
    sm.runs[g + cnt] = n;
  }
  for (int q = 0; q < SR_BLOCK_ITEMS; ++q)
    if ((flags >> q) & 1u) sm.runs[g++] = i0 + q;
  __syncthreads();
  const int n_runs = sm.n_runs;
  // the padding run: the shard has invalid rows and no valid (INT64_MAX,
  // INT32_MAX) run for them to join
  const bool pad = n < L && !(n > 0 && sm.k[n - 1] == KEY_DIGITS_MAX && sm.b[n - 1] == BIN_DIGITS_MAX);
  const long long o0 = (long long)s * L;
  for (int t = tid; t < n_runs; t += SR_BLOCK_THREADS) {
    const int lo = sm.runs[t];
    write_run_key(out, o0 + t, sm.k[lo], sm.b[lo]);
    if (sm.runs[t + 1] - lo >= SR_WARP_RUN) sm.long_runs[atomicAdd(&sm.n_long, 1)] = t;
  }
  const int fill_end = n + 1 < L ? n + 1 : L;
  for (int t = n_runs + tid; t < fill_end; t += SR_BLOCK_THREADS) {
    if (t == n_runs && pad) write_empty(out, lanes, o0 + t, KEY_MAX, BIN_MAX);
    else write_empty(out, lanes, o0 + t, KEY_MIN, BIN_MIN);
  }
  // each lane in turn: its values in sorted order staged in the keys'
  // array (written out above), then a short run walked by one thread and a
  // long one by one warp, from shared memory
  unsigned long long* stage = sm.k;
  for (int l = 0; l < lanes.n; ++l) {
    const int dt = lanes.dtype[l], kind = lanes.kind[l];
    const void* vp = lanes.in[l];
    const unsigned long long ident = lanes.ident[l];
    __syncthreads();  // the keys, or the lane before, are read
#pragma unroll 4
    for (int i = tid; i < n; i += SR_BLOCK_THREADS)
      stage[i] = vp ? ld_bits(dt, vp, sm.row[i]) : one_bits(dt);
    __syncthreads();
    for (int t = tid; t < n_runs; t += SR_BLOCK_THREADS) {
      const int lo = sm.runs[t], hi = sm.runs[t + 1];
      if (hi - lo >= SR_WARP_RUN) continue;
      unsigned long long acc = ident;
      for (int i = lo; i < hi; ++i) acc = combine_bits(kind, dt, acc, stage[i]);
      st_bits(dt, lanes.out[l], o0 + t, acc);
    }
    for (int q = warp; q < sm.n_long; q += SR_BLOCK_WARPS) {
      const int t = sm.long_runs[q], lo = sm.runs[t];
      const unsigned long long r = warp_reduce(kind, dt, ident, stage + lo, sm.runs[t + 1] - lo);
      if (lane == 0) st_bits(dt, lanes.out[l], o0 + t, r);
    }
  }
}

template <int ITEMS>
struct SrSweepShared {
  unsigned long long k[SR_SWEEP_THREADS * ITEMS];  // the tile in digit order, after the scatter
  unsigned b[SR_SWEEP_THREADS * ITEMS];
  int row[SR_SWEEP_THREADS * ITEMS];
  radix::RankShared<SR_SWEEP_WARPS> r;
  long long out_base[RADIX];  // output position = out_base[digit] + row in the tile
  int tile;
};

// The onesweep path: one stable pass over digit position pos of n
// compacted records, one tile of SR_SWEEP_THREADS * ITEMS per block (K5's
// onesweep, csrc/join_probe.cu, over K8's records).
template <int ITEMS>
__global__ void __launch_bounds__(SR_SWEEP_THREADS)
    sr_sweep(SrRecs in, SrRecs out, long long n, int L, int pos, int pass,
             SrHeader* __restrict__ hd, unsigned long long* __restrict__ status) {
  constexpr int TILE = SR_SWEEP_THREADS * ITEMS;
  SrSweepShared<ITEMS>& sm = *reinterpret_cast<SrSweepShared<ITEMS>*>(sr_smem);
  const int d = threadIdx.x;
  const unsigned digit_total = hd->hist[pos][d];  // in flight while the tile is taken
  if (threadIdx.x == 0) sm.tile = (int)atomicAdd(hd->next_tile + pass, 1u);
  __syncthreads();
  const long long tile = sm.tile;
  const long long base = tile * TILE;
  const int tile_n = (int)min((long long)TILE, n - base);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long kd[ITEMS];
  unsigned bd[ITEMS], dig[ITEMS], rank[ITEMS];
  int rw[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = warp * 32 * ITEMS + j * 32 + lane;
    dig[j] = RADIX;
    if (i < tile_n) {
      kd[j] = in.k[base + i];
      bd[j] = in.b[base + i];
      rw[j] = in.row[base + i];
      dig[j] = rec_digit(kd[j], bd[j], rw[j], L, pos);
    }
  }
  // every digit's first output row over the whole input, while the records load
  sm.out_base[d] = radix::block_exclusive_sum<SR_SWEEP_WARPS>(digit_total, sm.r.warp_sums);
  radix::rank_digits(sm.r, dig, rank);
  __syncthreads();
  const unsigned count = radix::digit_offsets(sm.r);
  const unsigned before =
      radix::publish_and_look_back(status, tile, d, count, (unsigned long long)(pass + 1));
  sm.out_base[d] += (long long)before - sm.r.tile_start[d];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (dig[j] < RADIX) {
      const unsigned at = radix::tile_slot(sm.r, dig[j], rank[j]);
      sm.k[at] = kd[j];
      sm.b[at] = bd[j];
      sm.row[at] = rw[j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile_n; i += SR_SWEEP_THREADS) {
    const unsigned long long k = sm.k[i];
    const unsigned b = sm.b[i];
    const int rw1 = sm.row[i];
    const long long at = sm.out_base[rec_digit(k, b, rw1, L, pos)] + i;
    out.k[at] = k;
    out.b[at] = b;
    out.row[at] = rw1;
  }
}

// sorted record i starts a run: the first row, or a new (shard, key, bin)
__device__ __forceinline__ bool sr_run_start(const SrRecs& c, long long i, int L) {
  return i == 0 || c.k[i] != c.k[i - 1] || c.b[i] != c.b[i - 1] || c.row[i] / L != c.row[i - 1] / L;
}

__global__ void __launch_bounds__(CHUNK)
    sr_run_count(SrRecs c, long long n, int L, int* __restrict__ counts) {
  __shared__ int ws[32];
  const long long i = (long long)blockIdx.x * CHUNK + threadIdx.x;
  int total;
  block_excl_count(i < n && sr_run_start(c, i, L), ws, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Each run's first sorted row (then n after the last run), and each
// shard's first run and one past its last.
__global__ void __launch_bounds__(CHUNK)
    sr_run_scan(SrRecs c, long long n, int L, int n_chunks, const int* __restrict__ counts,
                int* __restrict__ starts, SrHeader* __restrict__ hd) {
  __shared__ int ws[32];
  __shared__ long long sh[32];
  long long prefix, total;
  chunk_prefix(counts, n_chunks, blockIdx.x, &prefix, &total, sh);
  const long long i = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const bool f = i < n && sr_run_start(c, i, L);
  int tot;
  const int ex = block_excl_count(f, ws, &tot);
  if (i >= n) return;
  const long long g = prefix + ex + (f ? 1 : 0) - 1;  // the run holding row i
  if (f) starts[g] = (int)i;
  const int s = c.row[i] / L;
  if (i == 0 || c.row[i - 1] / L != s) hd->run_base[s] = (int)g;
  if (i == n - 1 || c.row[i + 1] / L != s) hd->run_end[s] = (int)g + 1;
  if (i == n - 1) starts[g + 1] = (int)n;
}

// One thread per output slot t < min(live + 1, L) of shard blockIdx.y:
// run t reduced (a long one listed for sr_walk_long), the padding run, or
// the empty fill.
__global__ void sr_reduce(Lanes lanes, SrRecs c, int L, const int* __restrict__ starts,
                          SrHeader* __restrict__ hd, int* __restrict__ longs, SrOut out) {
  const int s = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int live = hd->shard_live[s];
  if (t >= (live + 1 < L ? live + 1 : L)) return;
  const long long o = (long long)s * L + t;
  const int first = hd->run_base[s], n_runs = hd->run_end[s] - first;
  if (t < n_runs) {
    const int lo = starts[first + t], hi = starts[first + t + 1];
    write_run_key(out, o, c.k[lo], c.b[lo]);
    if (hi - lo < SR_LONG_RUN) {
      reduce_short(lanes, c.row + lo, hi - lo, o);
    } else {
      const unsigned long long q = atomicAdd(&hd->n_long, 1ULL);
      longs[3 * q] = lo;
      longs[3 * q + 1] = hi;
      longs[3 * q + 2] = (int)o;
    }
    return;
  }
  const long long last = (long long)hd->shard_start[s] + live - 1;
  const bool pad = live < L && !(live > 0 && c.k[last] == KEY_DIGITS_MAX && c.b[last] == BIN_DIGITS_MAX);
  if (t == n_runs && pad) write_empty(out, lanes, o, KEY_MAX, BIN_MAX);
  else write_empty(out, lanes, o, KEY_MIN, BIN_MIN);
}

// The onesweep path's long runs, one block each (dynamic shared memory:
// SR_STAGE_WORDS words).
__global__ void __launch_bounds__(SR_SWEEP_THREADS)
    sr_walk_long(Lanes lanes, const int* __restrict__ rows, const SrHeader* __restrict__ hd,
                 const int* __restrict__ longs) {
  __shared__ unsigned long long acc[MAX_LANES];
  unsigned long long* stage = reinterpret_cast<unsigned long long*>(sr_smem);
  const long long n_long = (long long)hd->n_long;
  for (long long q = blockIdx.x; q < n_long; q += gridDim.x) {
    const int lo = longs[3 * q], hi = longs[3 * q + 1];
    block_walk(lanes, rows + lo, hi - lo, longs[3 * q + 2], stage, SR_STAGE_WORDS, acc);
  }
}

// ------------------------------------------------------------ K9

__device__ __forceinline__ long long probe_home(long long key, int bin, long long mask) {
  unsigned long long z = (unsigned long long)key ^
                         ((unsigned long long)(long long)bin * 0xFF51AFD7ED558CCDULL);
  z = (z ^ (z >> 33)) * 0xC4CEB9FE1A85EC53ULL;
  z = z ^ (z >> 33);
  return (long long)(z & (unsigned long long)mask);
}

enum { PM_MISS = 0, PM_MATCH = 1, PM_EMPTY = 2 };

#define PM_REPORT_SHARDS 32
#define PM_REPORT_ROUNDS 256
// The last call's rounds per shard, and the active partials at the start
// of round r (r = rounds: those left unplaced).
__device__ int g_pm_rounds[PM_REPORT_SHARDS];
__device__ int g_pm_active[PM_REPORT_SHARDS][PM_REPORT_ROUNDS + 1];

#define PM_THREADS 512
#define PM_ITEMS 2      // listed partials a thread holds at once, their loads in flight together
#define PM_GROUP 16     // active flags a thread reads at once in round 0 (one 16-byte load)
#define PM_SCAN 4       // groups of flags a thread loads before it lists their partials
#define PM_LANE_REGS 4  // lanes whose values a thread holds from classifying to writing
#define PM_NO_SLOT 0xffffffffu  // a listed partial whose slot is not known yet (round 0)
#define PM_SOLO (PM_THREADS * PM_ITEMS)  // partials left that one CTA takes over alone

struct PmArgs {
  long long* keys;  // the table [S * cap]
  int* bins;
  unsigned char* occ;
  long long cap;
  const long long* u_key;  // the partials [S * B]
  const int* u_bin;
  const unsigned char* active;
  long long B;
  long long Bp;  // B rounded up to PM_GROUP: a list buffer's length
  int max_probes;
  int vec;        // active and still 16-byte aligned at every PM_GROUP partials
  unsigned tag0;  // round r's claims carry tag0 + r in their high word
  unsigned char* still;
  unsigned long long* list;     // [S][2][Bp]: (index << 32 | slot) of the partials left
  unsigned long long* claims;   // [S * cap], never cleared (the tags order them)
  unsigned char* code;          // [S * Bp]: a listed partial's class this round
  int* oflow;                   // [S] or NULL
};

// One shard's arrays.
struct PmShard {
  long long* K;
  int* Bn;
  unsigned char* O;
  unsigned long long* CL;
  const long long* uk;
  const int* ub;
  long long mask, row0, slot0;
};

// Up to PM_ITEMS listed partials of one thread: index, slot this round,
// key, bin and class, and the first PM_LANE_REGS lanes' values the write
// needs (the partial's, and the slot's where it matched), loaded as soon as
// the class is known: neither changes before the write, since only a match
// writes a matched slot's lanes.
struct PmItems {
  int i[PM_ITEMS];
  unsigned c[PM_ITEMS];
  long long key[PM_ITEMS];
  int bin[PM_ITEMS];
  unsigned char code[PM_ITEMS];
  bool ok[PM_ITEMS];
  unsigned long long v[PM_LANE_REGS][PM_ITEMS], t[PM_LANE_REGS][PM_ITEMS];
};

__device__ __forceinline__ unsigned long long pm_entry(int i, unsigned c) {
  return (unsigned long long)(unsigned)i << 32 | c;
}

// A word of the table or the claims as another CTA of the cluster may have
// written it: read at L2, the point of coherence.
__device__ __forceinline__ unsigned long long ld_bits_cg(int dt, const void* p, long long i) {
  return wide(dt) ? __ldcg(static_cast<const unsigned long long*>(p) + i)
                  : (unsigned long long)__ldcg(static_cast<const unsigned int*>(p) + i);
}

// The cluster's barrier: every write before it (global and shared memory)
// is visible to every thread of the cluster after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// The sum over the cluster's CTAs of one shared counter (every thread calls it).
__device__ __forceinline__ int cluster_total(cg::cluster_group& cl, int* cnt, int C, int* sh) {
  if (threadIdx.x < 32) {
    int v = (int)threadIdx.x < C ? *cl.map_shared_rank(cnt, (unsigned)threadIdx.x) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) *sh = v;
  }
  __syncthreads();
  return *sh;
}

// Append e to the list segment nxt where f, one shared atomic per warp.
// Every lane of the warp calls it.
__device__ __forceinline__ void warp_append(bool f, unsigned long long e, unsigned long long* nxt,
                                            int* n_nxt) {
  const unsigned m = __ballot_sync(0xffffffffu, f);
  if (!m) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n_nxt, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (f) nxt[base + __popc(m & ((1u << lane) - 1u))] = e;
}

// Listed partials [b0, b0 + PM_ITEMS threads) of a segment of m, thread
// tid taking b0 + q T + tid.
__device__ __forceinline__ void pm_load(PmItems& it, const unsigned long long* cur, int m, int b0) {
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    const int j = b0 + q * (int)blockDim.x + (int)threadIdx.x;
    it.ok[q] = j < m;
    const unsigned long long e = it.ok[q] ? cur[j] : 0ULL;
    it.i[q] = (int)(e >> 32);
    it.c[q] = (unsigned)e;
  }
}

// The lane values a match or a claim writes with (see PmItems).
__device__ __forceinline__ void pm_lane_values(const Lanes& lanes, const PmShard& sh,
                                               PmItems& it) {
#pragma unroll
  for (int l = 0; l < PM_LANE_REGS; ++l) {
    if (l >= lanes.n) break;
    const int dt = lanes.dtype[l];
#pragma unroll
    for (int q = 0; q < PM_ITEMS; ++q) {
      if (!it.ok[q] || it.code[q] == PM_MISS) continue;
      it.v[l][q] = ld_bits(dt, lanes.in[l], sh.row0 + it.i[q]);
      if (it.code[q] == PM_MATCH) it.t[l][q] = ld_bits_cg(dt, lanes.out[l], sh.slot0 + it.c[q]);
    }
  }
}

// Phase A of a round: each partial classified against the table as the
// round found it (its key and bin and its slot's words in one wave once
// the slot is known); one that found its slot empty claims it with
// atomicMax(tag | index): the highest index wins, as the reference's
// scatter-max, and the tag outranks every earlier round's and call's
// claim, so the claims are never reset. Then the lane values the write
// needs are loaded, in flight across the barrier.
__device__ __forceinline__ void pm_classify(const Lanes& lanes, const PmShard& sh,
                                            unsigned long long tag, PmItems& it) {
  unsigned char o[PM_ITEMS];
  long long kk[PM_ITEMS];
  int bb[PM_ITEMS];
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    if (!it.ok[q]) continue;
    it.key[q] = sh.uk[it.i[q]];
    it.bin[q] = sh.ub[it.i[q]];
    if (it.c[q] != PM_NO_SLOT) {
      o[q] = __ldcg(sh.O + it.c[q]);
      kk[q] = __ldcg(sh.K + it.c[q]);
      bb[q] = __ldcg(sh.Bn + it.c[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    if (!it.ok[q] || it.c[q] != PM_NO_SLOT) continue;
    it.c[q] = (unsigned)probe_home(it.key[q], it.bin[q], sh.mask);
    o[q] = __ldcg(sh.O + it.c[q]);
    kk[q] = __ldcg(sh.K + it.c[q]);
    bb[q] = __ldcg(sh.Bn + it.c[q]);
  }
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    if (!it.ok[q]) continue;
    it.code[q] = o[q] ? (kk[q] == it.key[q] && bb[q] == it.bin[q] ? PM_MATCH : PM_MISS)
                      : PM_EMPTY;
    if (it.code[q] == PM_EMPTY) atomicMax(sh.CL + it.c[q], tag | (unsigned)it.i[q]);
  }
  pm_lane_values(lanes, sh, it);
}

// Phase B of a round: a match combines into its slot, the claim's winner
// writes the slot, both leave; the rest are listed in nxt with their next
// slot. Items read back from memory (load_keys) load their keys, bins and
// lane values again with the claims.
__device__ __forceinline__ void pm_write(const Lanes& lanes, const PmArgs& a, const PmShard& sh,
                                         unsigned long long tag, PmItems& it, bool load_keys,
                                         unsigned long long* nxt, int* n_nxt) {
  unsigned long long w[PM_ITEMS];
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    w[q] = 0;
    if (it.ok[q] && it.code[q] == PM_EMPTY) {
      w[q] = __ldcg(sh.CL + it.c[q]);
      if (load_keys) it.key[q] = sh.uk[it.i[q]], it.bin[q] = sh.ub[it.i[q]];
    }
  }
  if (load_keys) pm_lane_values(lanes, sh, it);
  bool won[PM_ITEMS], placed[PM_ITEMS];
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    won[q] = it.ok[q] && it.code[q] == PM_EMPTY && w[q] == (tag | (unsigned)it.i[q]);
    placed[q] = won[q] || (it.ok[q] && it.code[q] == PM_MATCH);
  }
#pragma unroll
  for (int l = 0; l < PM_LANE_REGS; ++l) {
    if (l >= lanes.n) break;
    const int dt = lanes.dtype[l], kind = lanes.kind[l];
#pragma unroll
    for (int q = 0; q < PM_ITEMS; ++q)
      if (placed[q])
        st_bits(dt, lanes.out[l], sh.slot0 + it.c[q],
                won[q] ? it.v[l][q] : combine_bits(kind, dt, it.t[l][q], it.v[l][q]));
  }
  for (int l = PM_LANE_REGS; l < lanes.n; ++l) {
    const int dt = lanes.dtype[l], kind = lanes.kind[l];
    unsigned long long x[PM_ITEMS], y[PM_ITEMS];
#pragma unroll
    for (int q = 0; q < PM_ITEMS; ++q) {
      if (placed[q]) x[q] = ld_bits(dt, lanes.in[l], sh.row0 + it.i[q]);
      if (placed[q] && !won[q]) y[q] = ld_bits_cg(dt, lanes.out[l], sh.slot0 + it.c[q]);
    }
#pragma unroll
    for (int q = 0; q < PM_ITEMS; ++q)
      if (placed[q])
        st_bits(dt, lanes.out[l], sh.slot0 + it.c[q], won[q] ? x[q] : combine_bits(kind, dt, y[q], x[q]));
  }
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q) {
    if (won[q]) {
      sh.K[it.c[q]] = it.key[q];
      sh.Bn[it.c[q]] = it.bin[q];
      sh.O[it.c[q]] = 1;
    }
  }
#pragma unroll
  for (int q = 0; q < PM_ITEMS; ++q)
    warp_append(it.ok[q] && !placed[q],
                pm_entry(it.i[q], (unsigned)((it.c[q] + 1ULL) & (unsigned long long)sh.mask)), nxt,
                n_nxt);
}

// One cluster of C CTAs per shard (blocks s C .. s C + C - 1) runs every
// round. Round 0 reads the active flags PM_GROUP at a time, group g to CTA
// g mod C (so the active partials, which K8 leaves at the front, spread
// over the cluster), writes still = 0 and lists the active partials in the
// CTA's segment of list buffer 0; the partials left after the last round
// get still = 1. Round r: phase A classifies and claims, the cluster's
// barrier, phase B writes and lists the partials left in the CTA's
// segment of the other buffer, the barrier; every CTA
// then sums the cluster's counts (distributed shared memory), and a round
// that would start with none, or past max_probes, ends the loop; once at
// most PM_SOLO partials are left, they move to CTA 0's shared memory and
// CTA 0 runs the remaining rounds alone with its block's barrier. A CTA
// whose segment fits its threads' PM_ITEMS holds its partials in
// registers from phase A to phase B; a longer one writes their classes and
// slots back and reads them again.
__global__ void __launch_bounds__(PM_THREADS, 1) pm_cluster(Lanes lanes, PmArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int k = (int)cl.block_rank();
  const int s = (int)(blockIdx.x / (unsigned)C);
  const int tid = threadIdx.x, T = blockDim.x;
  __shared__ int cnt[2];  // this CTA's listed partials in list buffer b
  __shared__ int sh_n, sh_at;
  __shared__ unsigned long long solo_list[2][PM_SOLO];  // CTA 0's lists once it goes on alone
  __shared__ int solo_cnt[2];
  const PmShard sh{a.keys + s * a.cap, a.bins + s * a.cap, a.occ + s * a.cap,
                   a.claims + s * a.cap, a.u_key + s * a.B, a.u_bin + s * a.B,
                   a.cap - 1, (long long)s * a.B, (long long)s * a.cap};
  // this CTA's groups g = q C + k and its segment of the list buffers
  const unsigned B = (unsigned)a.B;
  const unsigned G = (B + PM_GROUP - 1) / PM_GROUP, per = G / (unsigned)C, extra = G % (unsigned)C;
  const unsigned groups = per + ((unsigned)k < extra ? 1u : 0u);
  const long long seg = (long long)PM_GROUP * ((long long)k * per + min((unsigned)k, extra));
  unsigned long long* lists = a.list + (long long)s * 2 * a.Bp + seg;
  unsigned char* cd = a.code + (long long)s * a.Bp + seg;
  if (tid == 0) cnt[0] = cnt[1] = 0;
  __syncthreads();
  const int lane = tid & 31;
  for (unsigned q0 = 0; q0 < groups; q0 += (unsigned)T * PM_SCAN) {
    unsigned f[PM_SCAN][PM_GROUP / 4];
    long long i0[PM_SCAN];
#pragma unroll
    for (int u = 0; u < PM_SCAN; ++u) {
      const unsigned q = q0 + (unsigned)(u * T + tid);
      i0[u] = ((long long)q * C + k) * PM_GROUP;  // the group's first partial
      f[u][0] = f[u][1] = f[u][2] = f[u][3] = 0u;
      if (q >= groups) continue;
      if (a.vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(a.active + sh.row0 + i0[u]);
        f[u][0] = v.x, f[u][1] = v.y, f[u][2] = v.z, f[u][3] = v.w;
      } else {
        for (int b = 0; b < PM_GROUP && i0[u] + b < a.B; ++b)
          f[u][b >> 2] |= (unsigned)a.active[sh.row0 + i0[u] + b] << (8 * (b & 3));
      }
    }
    // still = 0 here (after every load: the arrays may alias as far as the
    // compiler knows); the partials no round places get 1 at the end
#pragma unroll
    for (int u = 0; u < PM_SCAN; ++u) {
      if (q0 + (unsigned)(u * T + tid) >= groups) continue;
      if (a.vec) {
        *reinterpret_cast<uint4*>(a.still + sh.row0 + i0[u]) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int b = 0; b < PM_GROUP && i0[u] + b < a.B; ++b) a.still[sh.row0 + i0[u] + b] = 0;
      }
    }
    // each group's active partials listed: a warp's counts scanned, one
    // shared atomic per warp
#pragma unroll
    for (int u = 0; u < PM_SCAN; ++u) {
      unsigned bits = 0u;
#pragma unroll
      for (int b = 0; b < PM_GROUP; ++b)
        if ((f[u][b >> 2] >> (8 * (b & 3))) & 0xffu) bits |= 1u << b;
      const int n_mine = __popc(bits);
      int incl = n_mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int base = 0;
      if (lane == 31 && incl) base = atomicAdd(&cnt[0], incl);
      base = __shfl_sync(0xffffffffu, base, 31) + incl - n_mine;
      for (; bits; bits &= bits - 1u)
        lists[base++] = pm_entry((int)(i0[u] + __ffs(bits) - 1), PM_NO_SLOT);
    }
  }
  __syncthreads();
  const bool lead = k == 0 && tid == 0;
  const bool report = lead && s < PM_REPORT_SHARDS;
  const bool probe = a.max_probes > 0;
  int r = 0, n = 0;
  bool solo = false;
  for (;;) {
    const unsigned long long tag = (unsigned long long)(a.tag0 + (unsigned)r) << 32;
    unsigned long long* cur = lists + (r & 1) * a.Bp;
    unsigned long long* nxt = lists + ((r + 1) & 1) * a.Bp;
    const int m = cnt[r & 1];
    const bool held = m <= T * PM_ITEMS;
    PmItems it;
    // phase A
    if (probe) {
      if (held) {
        pm_load(it, cur, m, 0);
        pm_classify(lanes, sh, tag, it);
      } else {
        for (int b0 = 0; b0 < m; b0 += T * PM_ITEMS) {
          pm_load(it, cur, m, b0);
          pm_classify(lanes, sh, tag, it);
#pragma unroll
          for (int q = 0; q < PM_ITEMS; ++q) {
            if (!it.ok[q]) continue;
            const int j = b0 + q * T + tid;
            cur[j] = pm_entry(it.i[q], it.c[q]);
            cd[j] = it.code[q];
          }
        }
      }
    }
    if (tid == 0) cnt[(r + 1) & 1] = 0;  // every CTA summed it before the last barrier
    cluster_barrier();
    if (r == 0) {
      n = cluster_total(cl, &cnt[0], C, &sh_n);
      if (!probe || n == 0) break;
    }
    if (report && r < PM_REPORT_ROUNDS) g_pm_active[s][r] = n;
    // phase B
    if (held) {
      pm_write(lanes, a, sh, tag, it, false, nxt, &cnt[(r + 1) & 1]);
    } else {
      for (int b0 = 0; b0 < m; b0 += T * PM_ITEMS) {
        pm_load(it, cur, m, b0);
#pragma unroll
        for (int q = 0; q < PM_ITEMS; ++q)
          it.code[q] = it.ok[q] ? cd[b0 + q * T + tid] : (unsigned char)PM_MISS;
        pm_write(lanes, a, sh, tag, it, true, nxt, &cnt[(r + 1) & 1]);
      }
    }
    cluster_barrier();
    n = cluster_total(cl, &cnt[(r + 1) & 1], C, &sh_n);
    ++r;
    if (r >= a.max_probes || n == 0) break;
    if (n <= PM_SOLO) {
      solo = true;
      break;
    }
  }
  if (solo) {
    // Few partials left: each CTA's move to CTA 0's shared list, and CTA 0
    // runs the remaining rounds alone, its block's barrier in place of the
    // cluster's (the other CTAs wait at the last barrier).
    const int mine = cnt[r & 1];
    if (tid < 32) {
      const int v = tid < C ? *cl.map_shared_rank(&cnt[r & 1], (unsigned)tid) : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += y;
      }
      const int at = __shfl_sync(0xffffffffu, incl - v, k);
      if (tid == 0) sh_at = at;
    }
    __syncthreads();
    unsigned long long* dst = cl.map_shared_rank(&solo_list[0][0], 0u) + sh_at;
    const unsigned long long* src = lists + (r & 1) * a.Bp;
    for (int j = tid; j < mine; j += T) dst[j] = src[j];
    cluster_barrier();
    if (k == 0) {
      int b = 0;
      for (;;) {
        const unsigned long long tag = (unsigned long long)(a.tag0 + (unsigned)r) << 32;
        PmItems it;
        pm_load(it, solo_list[b], n, 0);
        pm_classify(lanes, sh, tag, it);
        if (tid == 0) solo_cnt[b ^ 1] = 0;
        __syncthreads();
        if (report && r < PM_REPORT_ROUNDS) g_pm_active[s][r] = n;
        pm_write(lanes, a, sh, tag, it, false, solo_list[b ^ 1], &solo_cnt[b ^ 1]);
        __syncthreads();
        n = solo_cnt[b ^ 1];
        b ^= 1;
        ++r;
        if (r >= a.max_probes || n == 0) break;
      }
      for (int j = tid; j < n; j += T) a.still[sh.row0 + (int)(solo_list[b][j] >> 32)] = 1;
    }
  } else {
    // the partials left: still (this CTA's segment of the last list)
    const unsigned long long* left = lists + (r & 1) * a.Bp;
    for (int j = tid; j < cnt[r & 1]; j += T) a.still[sh.row0 + (int)(left[j] >> 32)] = 1;
  }
  if (report) {
    g_pm_rounds[s] = r;
    if (r <= PM_REPORT_ROUNDS) g_pm_active[s][r] = n;
  }
  // partials no round placed: the table's overflow
  if (lead && a.oflow != nullptr) a.oflow[s] += n;
  // no CTA leaves while another may still read its counters
  cluster_barrier();
}

// ------------------------------------------------------------ K10

#define EX_THREADS 256  // one thread per digit in radix_sort.cuh's per-digit steps
#define EX_WARPS (EX_THREADS / 32)
#define EX_ITEMS 4
#define EX_TILE (EX_THREADS * EX_ITEMS)  // rows a tile block buckets
#define EX_FILL_SLOTS 2048               // send slots a fill block writes
#define EX_BUCKETS (MAX_SHARDS + 1)

// The owner of a key's uint64 bits u: the reference's min(u // R, S - 1),
// R = U64_MAX / S + 1 (contiguous ranges), without a division. R S - 2^64
// lies in [0, S - 1], so e = floor(u S / 2^64) (__umul64hi) is the owner
// or one past it, and one compare with e R decides (u // R <= S - 1 always,
// and (S - 1) R < 2^64). An inactive row's owner is S (sorts last).
__device__ __forceinline__ int owner_of(long long key, bool act, int S, unsigned long long range) {
  if (!act) return S;
  const unsigned long long u = (unsigned long long)key;
  unsigned long long e = __umul64hi(u, (unsigned long long)S);
  if (e > (unsigned long long)(S - 1)) e = (unsigned long long)(S - 1);
  if (e > 0 && u < e * range) --e;
  return (int)e;
}

struct ExArgs {
  const long long* u_key;  // [S * L]
  const int* u_bin;
  const unsigned char* active;
  int S, tiles, fill_chunks;
  long long L, dc, M;
  unsigned long long range;  // U64_MAX / S + 1 (S > 1)
  int* counts;               // [S][tiles][S + 1]: rows per (source, tile, owner)
  long long* s_key;          // [S * S * dc]
  int* s_bin;
  unsigned char* s_valid;
  long long* m_key;  // [S * M]
  int* m_bin;
  unsigned char* m_valid;
};

// a thread's item j: row 32 w EX_ITEMS + 32 j + lane of its tile (warp w;
// csrc/radix_sort.cuh's layout, so the rank is stable)
__device__ __forceinline__ int ex_item(int j) {
  return (threadIdx.x >> 5) * 32 * EX_ITEMS + 32 * j + (threadIdx.x & 31);
}

// Rows per owner in each tile of EX_TILE rows of source shard blockIdx.y.
__global__ void __launch_bounds__(EX_THREADS) ex_count(ExArgs a) {
  __shared__ int cnt[EX_BUCKETS];
  const int s = blockIdx.y, t = blockIdx.x;
  for (int o = threadIdx.x; o <= a.S; o += EX_THREADS) cnt[o] = 0;
  const long long r0 = (long long)s * a.L + (long long)t * EX_TILE;
  const long long n = min((long long)EX_TILE, a.L - (long long)t * EX_TILE);
  long long key[EX_ITEMS];
  unsigned char act[EX_ITEMS];
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int i = ex_item(j);
    if (i < n) key[j] = a.u_key[r0 + i], act[j] = a.active[r0 + i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int o = ex_item(j) < n ? owner_of(key[j], act[j] != 0, a.S, a.range) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    if (o >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&cnt[o], __popc(peers));
  }
  __syncthreads();
  for (int o = threadIdx.x; o <= a.S; o += EX_THREADS)
    a.counts[((long long)s * a.tiles + t) * (a.S + 1) + o] = cnt[o];
}

__device__ __forceinline__ void store_bytes(unsigned long long x, int es, unsigned long long bits) {
  if (es == 8) *reinterpret_cast<unsigned long long*>(x) = bits;
  else if (es == 4) *reinterpret_cast<unsigned*>(x) = (unsigned)bits;
  else *reinterpret_cast<unsigned char*>(x) = (unsigned char)bits;
}

// Elements [e0, e1) of an array of es-byte elements (es = 1, 4 or 8; the
// array es-aligned) set to bits by the block: 16-byte stores from the first
// 16-byte boundary to the last, single elements around them.
__device__ __forceinline__ void fill_range(void* p, int es, long long e0, long long e1,
                                           unsigned long long bits) {
  const unsigned long long addr = reinterpret_cast<unsigned long long>(p);
  const unsigned long long b0 = addr + (unsigned long long)e0 * es;
  const unsigned long long b1 = addr + (unsigned long long)e1 * es;
  unsigned long long v0 = (b0 + 15) & ~15ULL, v1 = b1 & ~15ULL;
  if (v0 > b1) v0 = b1;
  if (v1 < v0) v1 = v0;
  for (unsigned long long x = b0 + threadIdx.x * es; x < v0; x += blockDim.x * es)
    store_bytes(x, es, bits);
  for (unsigned long long x = v1 + threadIdx.x * es; x < b1; x += blockDim.x * es)
    store_bytes(x, es, bits);
  uint4 pat;
  if (es == 8) {
    pat.x = pat.z = (unsigned)bits;
    pat.y = pat.w = (unsigned)(bits >> 32);
  } else {
    pat.x = es == 4 ? (unsigned)bits : (unsigned)(bits & 0xffu) * 0x01010101u;
    pat.y = pat.z = pat.w = pat.x;
  }
  for (unsigned long long x = v0 + threadIdx.x * 16ULL; x < v1; x += blockDim.x * 16ULL)
    *reinterpret_cast<uint4*>(x) = pat;
}

struct ExShared {
  radix::RankShared<EX_WARPS> r;
  int before[EX_BUCKETS];       // an owner's rows in the source's tiles before this one
  int total[EX_BUCKETS];        // and in the whole source shard
  long long first[EX_BUCKETS];  // its first row in the owner order
};

// Blocks [0, S tiles): one tile of a source shard each. Its rows' owners
// ranked stably in the tile (radix_sort.cuh's rank, the owner one digit),
// plus the owner's rows in the tiles before it (ex_count's counts): the
// rank in the owner. Every row goes to the owner-ordered rows m_*[src, recv
// + p], and a rank below dc to s_*[src, owner dc + rank].
// Blocks past them: one per (source, owner, EX_FILL_SLOTS send slots),
// writing the slots at or past the owner's row count with the fill (0, 0,
// invalid, each lane's identity).
__global__ void __launch_bounds__(EX_THREADS) ex_scatter(Lanes lanes, ExArgs a) {
  __shared__ ExShared sm;
  const int tid = threadIdx.x, nb = a.S + 1;
  const int n_tile_blocks = a.S * a.tiles;
  const long long recv = (long long)a.S * a.dc;
  if ((int)blockIdx.x >= n_tile_blocks) {
    const int h = blockIdx.x - n_tile_blocks;
    const int per_src = a.S * a.fill_chunks;
    const int src = h / per_src, o = (h - src * per_src) / a.fill_chunks;
    const int chunk = h - src * per_src - o * a.fill_chunks;
    if (tid == 0) sm.total[0] = 0;
    __syncthreads();
    int v = 0;
    for (int t = tid; t < a.tiles; t += EX_THREADS)
      v += a.counts[((long long)src * a.tiles + t) * nb + o];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0 && v) atomicAdd(&sm.total[0], v);
    __syncthreads();
    const long long lo = max((long long)sm.total[0], (long long)chunk * EX_FILL_SLOTS);
    const long long hi = min(a.dc, (long long)(chunk + 1) * EX_FILL_SLOTS);
    if (lo >= hi) return;
    const long long d = (long long)src * recv + (long long)o * a.dc;
    fill_range(a.s_key, 8, d + lo, d + hi, 0ULL);
    fill_range(a.s_bin, 4, d + lo, d + hi, 0ULL);
    fill_range(a.s_valid, 1, d + lo, d + hi, 0ULL);
    for (int l = 0; l < lanes.n; ++l)
      fill_range(lanes.out[l], wide(lanes.dtype[l]) ? 8 : 4, d + lo, d + hi, lanes.ident[l]);
    return;
  }
  const int s = blockIdx.x / a.tiles, t = blockIdx.x - s * a.tiles;
  for (int o = tid; o <= a.S; o += EX_THREADS) sm.before[o] = sm.total[o] = 0;
  const long long r0 = (long long)s * a.L + (long long)t * EX_TILE;
  const long long n = min((long long)EX_TILE, a.L - (long long)t * EX_TILE);
  long long key[EX_ITEMS];
  int bin[EX_ITEMS];
  unsigned char act[EX_ITEMS];
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int i = ex_item(j);
    if (i < n) key[j] = a.u_key[r0 + i], bin[j] = a.u_bin[r0 + i], act[j] = a.active[r0 + i];
  }
  __syncthreads();
  const int* cs = a.counts + (long long)s * a.tiles * nb;
  for (int e = tid; e < a.tiles * nb; e += EX_THREADS) {
    const int v = cs[e];
    if (!v) continue;
    const int tt = e / nb, o = e - tt * nb;
    atomicAdd(&sm.total[o], v);
    if (tt < t) atomicAdd(&sm.before[o], v);
  }
  unsigned dig[EX_ITEMS], rank[EX_ITEMS];
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j)
    dig[j] = ex_item(j) < n ? (unsigned)owner_of(key[j], act[j] != 0, a.S, a.range) : radix::RADIX;
  radix::rank_digits(sm.r, dig, rank);
  __syncthreads();
  radix::digit_offsets(sm.r);
  if (tid == 0) {
    long long acc = 0;
    for (int o = 0; o <= a.S; ++o) {
      sm.first[o] = acc;
      acc += sm.total[o];
    }
  }
  __syncthreads();
  const int warp = tid >> 5;
  long long m[EX_ITEMS], d[EX_ITEMS];
  bool ok[EX_ITEMS], send[EX_ITEMS];
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j) {
    ok[j] = dig[j] < (unsigned)radix::RADIX;
    send[j] = false;
    if (!ok[j]) continue;
    const int o = (int)dig[j];
    const long long rk = (long long)sm.before[o] + sm.r.whist[warp][o] + rank[j];
    m[j] = (long long)s * a.M + recv + sm.first[o] + rk;
    send[j] = o < a.S && rk < a.dc;
    d[j] = (long long)s * recv + (long long)o * a.dc + rk;
    a.m_key[m[j]] = key[j];
    a.m_bin[m[j]] = bin[j];
    a.m_valid[m[j]] = (o < a.S && rk >= a.dc) ? 1 : 0;
    if (send[j]) {
      a.s_key[d[j]] = key[j];
      a.s_bin[d[j]] = bin[j];
      a.s_valid[d[j]] = 1;
    }
  }
  for (int l = 0; l < lanes.n; ++l) {
    const int dt = lanes.dtype[l];
    unsigned long long v[EX_ITEMS];
#pragma unroll
    for (int j = 0; j < EX_ITEMS; ++j)
      if (ok[j]) v[j] = ld_bits(dt, lanes.in[l], r0 + ex_item(j));
#pragma unroll
    for (int j = 0; j < EX_ITEMS; ++j) {
      if (!ok[j]) continue;
      st_bits(dt, lanes.aux[l], m[j], v[j]);
      if (send[j]) st_bits(dt, lanes.out[l], d[j], v[j]);
    }
  }
}

// ------------------------------------------------------------ K11

// K11 is csrc/table_compact.cuh's one-pass compaction (CLOSE, or
// ZERO_TAIL), K10's spill its SPILL mode; the library counts their kernel
// launches.
static std::atomic<long long> g_ext_launches{0};
static std::atomic<long long> g_sp_launches{0};

// csrc/table_compact.cuh's lanes from this file's (the bits move, so an
// 8-byte lane is wide whatever its type).
static compact::Lanes compact_lanes(const Lanes* lanes) {
  compact::Lanes cl;
  for (int l = 0; l < lanes->n; ++l) {
    cl.in[l] = lanes->in[l];
    cl.out[l] = lanes->out[l];
    const int dt = lanes->dtype[l];
    cl.wide[l] = dt == DT_I64 || dt == DT_F64 || dt == DT_U64;
  }
  cl.n = lanes->n;
  return cl;
}

// ------------------------------------------------------------ entry points

static unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

static int chunks_for(long long n) { return (int)((n + CHUNK - 1) / CHUNK); }

static bool lanes_ok(const Lanes* l) { return l->n >= 0 && l->n <= MAX_LANES; }

// ------------------------------------------------------------ K8's host side

// K8's scratch, 256-byte aligned pieces: the header, the per-chunk live
// counts, the compacted records; past SR_BLOCK_ROWS rows per shard also the
// onesweep's second records, tile statuses, run counts and starts, and the
// long-run list.
struct SrLayout {
  long long counts, k, b, row, k2, b2, row2, status, run_counts, starts, longs, total;
};

static long long align_up(long long b) { return (b + 255) & ~255LL; }

// tiles of the onesweep pass: 1024 records below 2^21 (more blocks for a
// small input), 4096 above
static int sr_items(long long n) { return n < (1LL << 21) ? 4 : 16; }

static SrLayout sr_layout(int S, long long L) {
  SrLayout y{};
  const long long SL = (long long)S * L;
  long long at = align_up(sizeof(SrHeader));
  auto take = [&at](long long bytes) {
    const long long here = at;
    at += align_up(bytes);
    return here;
  };
  y.counts = take(4LL * S * ((L + CHUNK - 1) / CHUNK));
  y.k = take(8 * SL);
  y.b = take(4 * SL);
  y.row = take(4 * SL);
  if (L > SR_BLOCK_ROWS) {
    const long long tiles = SL < (1LL << 21) ? (SL + 1023) / 1024
                                              : (SL + 4095) / 4096 > 2048 ? (SL + 4095) / 4096
                                                                           : 2048;
    y.k2 = take(8 * SL);
    y.b2 = take(4 * SL);
    y.row2 = take(4 * SL);
    y.status = take(8LL * RADIX * tiles);
    y.run_counts = take(4 * ((SL + CHUNK - 1) / CHUNK));
    y.starts = take(4 * (SL + 1));
    y.longs = take(12 * (SL / SR_LONG_RUN + 1));
  }
  y.total = at;
  return y;
}

// Kernels K8 has launched in this process, and what the calling thread's
// last call did: a caller reads them around a call (chip_smoke.py does).
static std::atomic<long long> g_sr_launches{0};
struct SrLast {
  long long launches, onesweep, passes, skipped, live, max_live, synced, memsets, wait_ns;
};
static thread_local SrLast g_sr_last;

// the launch just made: counted if it was taken
static int sr_launched(SrLast& last) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    ++g_sr_launches;
    ++last.launches;
  }
  return (int)err;
}

template <int ITEMS>
static int sr_sweeps(SrRecs a, SrRecs b, long long n, int L, const int* positions, int passes,
                     SrHeader* hd, unsigned long long* status, cudaStream_t s, SrLast& last,
                     SrRecs* sorted) {
  const size_t smem = sizeof(SrSweepShared<ITEMS>);
  cudaError_t err = cudaFuncSetAttribute(sr_sweep<ITEMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + SR_SWEEP_THREADS * ITEMS - 1) / (SR_SWEEP_THREADS * ITEMS);
  if ((err = cudaMemsetAsync(status, 0, 8ULL * RADIX * tiles, s)) != cudaSuccess) return (int)err;
  ++last.memsets;
  for (int p = 0; p < passes; ++p) {
    sr_sweep<ITEMS><<<(unsigned)tiles, SR_SWEEP_THREADS, smem, s>>>(a, b, n, L, positions[p], p,
                                                                    hd, status);
    const int e = sr_launched(last);
    if (e != cudaSuccess) return e;
    const SrRecs t = a;
    a = b;
    b = t;
  }
  *sorted = a;
  return (int)cudaSuccess;
}

// K9's launches in this process, and its cluster shape: the CTAs of a
// shard's cluster chosen per call, and what cudaOccupancyMaxActiveClusters
// gave at first use for clusters of 16 and of 8 (-1: not asked yet; 0 for
// 16: the CUDA runtime refused that size).
static std::atomic<long long> g_pm_launches{0};
static int g_pm_max16 = -1, g_pm_max8 = -1, g_pm_cluster = 0;

static cudaError_t pm_clusters(int C, cudaStream_t s, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(PM_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, pm_cluster, &cfg);
}

// The cluster size for S shards: 16 CTAs where that many clusters of 16
// are resident at once, else 8 (then clusters beyond the resident ones
// wait for a wave, which is correct and slower).
static cudaError_t pm_cluster_size(int S, cudaStream_t s, int* C) {
  if (g_pm_max8 < 0) {
    cudaError_t err = cudaFuncSetAttribute(pm_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = pm_clusters(16, s, &g_pm_max16);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      g_pm_max16 = 0;
    }
    if ((err = pm_clusters(8, s, &g_pm_max8)) != cudaSuccess) return err;
  }
  if (g_pm_max8 < 1) return cudaErrorInvalidConfiguration;
  *C = g_pm_max16 >= S ? 16 : 8;
  return cudaSuccess;
}

static long long pm_list_len(long long B) { return (B + PM_GROUP - 1) / PM_GROUP * PM_GROUP; }

static long long ex_tiles(long long L) { return (L + EX_TILE - 1) / EX_TILE; }

// K10's exchange kernel launches in this process
static std::atomic<long long> g_ex_launches{0};

extern "C" {

// Bytes of scratch arroyo_agg_sort_reduce needs for [S, L] rows.
long long arroyo_agg_sort_reduce_scratch_bytes(int S, long long L) {
  return sr_layout(S, L).total;
}

// Kernels arroyo_agg_sort_reduce has launched so far in this process.
long long arroyo_agg_sort_reduce_kernel_launches(void) { return g_sr_launches.load(); }

// Bytes of pinned host memory arroyo_agg_sort_reduce needs for [S, L]
// rows to read the digit counts back into (0: it reads nothing back).
long long arroyo_agg_sort_reduce_hist_bytes(int S, long long L) {
  (void)S;
  return L > SR_BLOCK_ROWS ? (long long)sizeof(SrHeader::hist) : 0;
}

// The calling thread's last call: kernel launches, onesweep (0: one block
// per shard), onesweep passes run and skipped, live rows, the most live
// rows in a shard (-1 where not read back), read back (0 / 1), memsets
// issued, and the host's wait for the read-back in ns.
void arroyo_agg_sort_reduce_last(long long* out) {
  const SrLast& l = g_sr_last;
  const long long v[9] = {l.launches, l.onesweep, l.passes, l.skipped, l.live, l.max_live,
                          l.synced, l.memsets, l.wait_ns};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// The last call on the device, per shard of its first S: live rows and the
// passes its block ran (-1: sorted by the onesweep path). Waits for the
// device first.
int arroyo_agg_sort_reduce_shards(int device, int S, int* live, int* passes) {
  if (S < 1 || S > SR_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaSetDevice(device)) != cudaSuccess ||
      (err = cudaDeviceSynchronize()) != cudaSuccess ||
      (err = cudaMemcpyFromSymbol(live, g_sr_shard_live, sizeof(int) * S)) != cudaSuccess ||
      (err = cudaMemcpyFromSymbol(passes, g_sr_shard_passes, sizeof(int) * S)) != cudaSuccess)
    return (int)err;
  return (int)cudaSuccess;
}

// K8. [S, L] rows in, [S, L] partials out; scratch holds
// arroyo_agg_sort_reduce_scratch_bytes(S, L) bytes, 256-byte aligned. With
// L > SR_BLOCK_ROWS, host_hist (pinned, SR_POSITIONS * RADIX uint32) takes
// the digit counts back: the call waits for them on the stream, then picks
// one block per shard (every shard at most SR_BLOCK_ROWS live rows) or the
// onesweep passes of the digit positions that vary.
int arroyo_agg_sort_reduce(int device, int S, long long L, const void* key, const void* bins,
                           int bins64, long long bin_off, const void* valid, long long n_valid,
                           const Lanes* lanes, void* scratch, long long scratch_bytes,
                           void* host_hist, void* u_key, void* u_bin, void* active,
                           void* stream) {
  if (S < 1 || S > SR_MAX_SHARDS || L < 1 || (long long)S * L > 0x7fffffffLL ||
      !lanes_ok(lanes) || scratch == nullptr || scratch_bytes < sr_layout(S, L).total ||
      (L > SR_BLOCK_ROWS && host_hist == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SrLast& last = g_sr_last;
  last = SrLast{0, 0, 0, 0, -1, -1, 0, 0, 0};
  const SrLayout y = sr_layout(S, L);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  SrHeader* hd = reinterpret_cast<SrHeader*>(base);
  int* counts = reinterpret_cast<int*>(base + y.counts);
  SrRecs c{reinterpret_cast<unsigned long long*>(base + y.k), reinterpret_cast<unsigned*>(base + y.b),
           reinterpret_cast<int*>(base + y.row)};
  SortIn a{static_cast<const long long*>(key), bins, bins64, bin_off,
           static_cast<const unsigned char*>(valid), n_valid};
  SrOut out{static_cast<long long*>(u_key), static_cast<int*>(u_bin),
            static_cast<unsigned char*>(active)};
  const int Li = (int)L;
  const int nc = chunks_for(L);
  const bool big = L > SR_BLOCK_ROWS;
  if (big) {
    if ((err = cudaMemsetAsync(hd, 0, sizeof(SrHeader), s)) != cudaSuccess) return (int)err;
    ++last.memsets;
  }
  sr_count<<<dim3(nc, S), CHUNK, 0, s>>>(a, Li, nc, counts);
  int e = sr_launched(last);
  if (e != cudaSuccess) return e;
  sr_compact<<<dim3(nc, S), CHUNK, 0, s>>>(a, *lanes, Li, nc, counts, c, hd, big ? 1 : 0, out);
  if ((e = sr_launched(last)) != cudaSuccess) return e;
  bool onesweep = false;
  long long live = 0;
  int positions[SR_POSITIONS];
  int passes = 0;
  if (big) {
    // the digit counts back on the host: the path and the passes follow
    unsigned* h = static_cast<unsigned*>(host_hist);
    const auto t0 = std::chrono::steady_clock::now();
    if ((err = cudaMemcpyAsync(h, hd->hist, sizeof(hd->hist), cudaMemcpyDeviceToHost, s)) !=
            cudaSuccess ||
        (err = cudaStreamSynchronize(s)) != cudaSuccess)
      return (int)err;
    last.wait_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::steady_clock::now() - t0).count();
    last.synced = 1;
    long long most = 0;
    for (int d = 0; d < S; ++d) {
      const long long v = h[SR_SHARD_POS * RADIX + d];
      live += v;
      most = v > most ? v : most;
    }
    last.live = live;
    last.max_live = most;
    onesweep = most > SR_BLOCK_ROWS;
    if (onesweep) {
      const int n_pos = S > 1 ? SR_POSITIONS : SR_SHARD_POS;
      for (int pos = 0; pos < n_pos; ++pos) {
        bool one_bucket = false;
        for (int d = 0; d < RADIX && !one_bucket; ++d) one_bucket = h[pos * RADIX + d] == live;
        if (!one_bucket) positions[passes++] = pos;
      }
      last.passes = passes;
      last.skipped = n_pos - passes;
    }
  }
  last.onesweep = onesweep ? 1 : 0;
  if (!onesweep) {
    const size_t smem = sizeof(SrBlockShared);
    if ((err = cudaFuncSetAttribute(sr_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    sr_block<<<S, SR_BLOCK_THREADS, smem, s>>>(*lanes, Li, c, hd, out);
    return sr_launched(last);
  }
  SrRecs c2{reinterpret_cast<unsigned long long*>(base + y.k2),
            reinterpret_cast<unsigned*>(base + y.b2), reinterpret_cast<int*>(base + y.row2)};
  unsigned long long* status = reinterpret_cast<unsigned long long*>(base + y.status);
  SrRecs sorted;
  e = sr_items(live) == 4
          ? sr_sweeps<4>(c, c2, live, Li, positions, passes, hd, status, s, last, &sorted)
          : sr_sweeps<16>(c, c2, live, Li, positions, passes, hd, status, s, last, &sorted);
  if (e != cudaSuccess) return e;
  int* run_counts = reinterpret_cast<int*>(base + y.run_counts);
  int* starts = reinterpret_cast<int*>(base + y.starts);
  int* longs = reinterpret_cast<int*>(base + y.longs);
  const int nr = chunks_for(live);
  sr_run_count<<<nr, CHUNK, 0, s>>>(sorted, live, Li, run_counts);
  if ((e = sr_launched(last)) != cudaSuccess) return e;
  sr_run_scan<<<nr, CHUNK, 0, s>>>(sorted, live, Li, nr, run_counts, starts, hd);
  if ((e = sr_launched(last)) != cudaSuccess) return e;
  const long long slots = last.max_live + 1 < L ? last.max_live + 1 : L;
  sr_reduce<<<dim3(blocks_for(slots, THREADS), S), THREADS, 0, s>>>(*lanes, sorted, Li, starts,
                                                                    hd, longs, out);
  if ((e = sr_launched(last)) != cudaSuccess) return e;
  const size_t smem = 8 * SR_STAGE_WORDS;
  if ((err = cudaFuncSetAttribute(sr_walk_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  const long long walk_blocks = live / SR_LONG_RUN < SR_WALK_BLOCKS ? live / SR_LONG_RUN + 1
                                                                    : SR_WALK_BLOCKS;
  sr_walk_long<<<(unsigned)walk_blocks, SR_SWEEP_THREADS, smem, s>>>(*lanes, sorted.row, hd,
                                                                      longs);
  return sr_launched(last);
}

// K9. lanes->out: the table's lanes, lanes->in: the partials'. scratch:
// list uint64 [S * 2 * Bp], code uint8 [S * Bp] (Bp: arroyo_agg_probe_merge_list_len(B)),
// claims uint64 [S * cap] (zero before its first call, then never
// cleared: each call's tag0 must exceed every earlier call's tag0 +
// max(max_probes, 1) - 1 on it, and tag0 + max_probes < 2^32). oflow int32 [S] or NULL: each shard's unplaced partials
// add to it. One launch: a cluster of CTAs per shard.
int arroyo_agg_probe_merge(int device, int S, long long cap, void* keys, void* bins, void* occ,
                           const Lanes* lanes, long long B, const void* u_key, const void* u_bin,
                           const void* active, int max_probes, void* still, void* list,
                           void* claims, void* code, void* oflow, unsigned tag0, void* stream) {
  if (S < 1 || B < 1 || B > 0x7fffffffLL - PM_GROUP || cap < 1 || cap > 0x80000000LL ||
      (cap & (cap - 1)) != 0 || max_probes < 0 || !lanes_ok(lanes) || tag0 < 1 ||
      (unsigned long long)tag0 + (unsigned long long)max_probes > 0xffffffffULL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int C = 0;
  if ((err = pm_cluster_size(S, s, &C)) != cudaSuccess) return (int)err;
  if ((long long)S * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = B % PM_GROUP == 0 && reinterpret_cast<uintptr_t>(active) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(still) % 16 == 0;
  PmArgs a{static_cast<long long*>(keys), static_cast<int*>(bins), static_cast<unsigned char*>(occ),
           cap, static_cast<const long long*>(u_key), static_cast<const int*>(u_bin),
           static_cast<const unsigned char*>(active), B, pm_list_len(B), max_probes, vec, tag0,
           static_cast<unsigned char*>(still), static_cast<unsigned long long*>(list),
           static_cast<unsigned long long*>(claims), static_cast<unsigned char*>(code),
           static_cast<int*>(oflow)};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(S * C));
  cfg.blockDim = dim3(PM_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, pm_cluster, *lanes, a)) != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_pm_launches;
  g_pm_cluster = C;
  return (int)cudaSuccess;
}

// K9's kernel launches in this process.
long long arroyo_agg_probe_merge_kernel_launches(void) { return g_pm_launches.load(); }

// K9's list length per buffer for B partials a shard: B rounded up to PM_GROUP.
long long arroyo_agg_probe_merge_list_len(long long B) { return pm_list_len(B); }

// K9's cluster shape: the last call's CTAs per shard (0: none yet), and
// the resident clusters of 16 and of 8 at first use (-1: not asked yet).
void arroyo_agg_probe_merge_cluster(int* out) {
  out[0] = g_pm_cluster;
  out[1] = g_pm_max16;
  out[2] = g_pm_max8;
}

// The last K9 call on the device, per shard of its first S (at most
// PM_REPORT_SHARDS): the rounds it ran, and per shard max_rounds + 1
// counts, active[s * (max_rounds + 1) + r] the active partials at the start
// of round r for r up to min(rounds, PM_REPORT_ROUNDS, max_rounds) (at
// r = rounds: the unplaced ones); the rest are not written. Waits for the
// device first.
int arroyo_agg_probe_merge_rounds(int device, int S, int max_rounds, int* rounds, int* active) {
  if (S < 1 || S > PM_REPORT_SHARDS || max_rounds < 0 || max_rounds > PM_REPORT_ROUNDS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaSetDevice(device)) != cudaSuccess ||
      (err = cudaDeviceSynchronize()) != cudaSuccess ||
      (err = cudaMemcpyFromSymbol(rounds, g_pm_rounds, sizeof(int) * S)) != cudaSuccess)
    return (int)err;
  std::vector<int> all((size_t)S * (PM_REPORT_ROUNDS + 1));
  if ((err = cudaMemcpyFromSymbol(all.data(), g_pm_active,
                                  sizeof(int) * all.size())) != cudaSuccess)
    return (int)err;
  for (int s = 0; s < S; ++s)
    for (int r = 0; r <= max_rounds; ++r)
      active[s * (max_rounds + 1) + r] = all[(size_t)s * (PM_REPORT_ROUNDS + 1) + r];
  return (int)cudaSuccess;
}

// K10's exchange: int32 words of its counts scratch for [S, L] partials.
long long arroyo_shard_exchange_counts_words(int S, long long L) {
  return (long long)S * ex_tiles(L) * (S + 1);
}

// K10's exchange: its kernel launches in this process (two a call).
long long arroyo_shard_exchange_kernel_launches(void) { return g_ex_launches.load(); }

// K10, steps 2-3. lanes->in: the partials' lanes, ->out: the send buffers
// [S * S * dc], ->aux: the merged rows [S * M], M = S * dc + L. counts:
// arroyo_shard_exchange_counts_words(S, L) int32 words, written by the
// first launch and read by the second (nothing to clear).
int arroyo_shard_exchange(int device, int S, long long L, long long dc, const void* u_key,
                          const void* u_bin, const void* active, const Lanes* lanes, void* s_key,
                          void* s_bin, void* s_valid, void* m_key, void* m_bin, void* m_valid,
                          void* counts, void* stream) {
  if (S < 1 || S > MAX_SHARDS || L < 1 || dc < 1 || !lanes_ok(lanes) || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long tiles = ex_tiles(L);
  const long long fill_chunks = (dc + EX_FILL_SLOTS - 1) / EX_FILL_SLOTS;
  const long long blocks = S * tiles + (long long)S * S * fill_chunks;
  if (tiles > 65535 || blocks > 0x7fffffffLL || S * tiles * (S + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ExArgs a{static_cast<const long long*>(u_key), static_cast<const int*>(u_bin),
           static_cast<const unsigned char*>(active), S, (int)tiles, (int)fill_chunks, L, dc,
           (long long)S * dc + L, S > 1 ? 0xffffffffffffffffULL / (unsigned long long)S + 1ULL : 0ULL,
           static_cast<int*>(counts), static_cast<long long*>(s_key), static_cast<int*>(s_bin),
           static_cast<unsigned char*>(s_valid), static_cast<long long*>(m_key),
           static_cast<int*>(m_bin), static_cast<unsigned char*>(m_valid)};
  ex_count<<<dim3((unsigned)tiles, S), EX_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_ex_launches;
  ex_scatter<<<(unsigned)blocks, EX_THREADS, 0, s>>>(*lanes, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_ex_launches;
  return (int)cudaSuccess;
}

// K10, step 7. lanes->in: the merged partials' lanes [S * M], ->out: the
// spill lanes [S * sc]. scratch: arroyo_shard_spill_scratch_bytes(S, M)
// bytes, 16-byte aligned, zero before its first call and then passed to
// every call of this (S, M) on one stream, never cleared (see
// csrc/table_compact.cuh). sp_fill <= sc on entry, as the reference keeps it.
int arroyo_shard_spill(int device, int S, long long M, const void* c_key, const void* c_bin,
                       const void* still, const Lanes* lanes, long long sc, void* sp_key,
                       void* sp_bin, void* sp_fill, void* oflow, void* scratch, void* stream) {
  if (S < 1 || M < 1 || M > 0x7fffffffLL || sc < 0 || sc > 0x7fffffffLL || !lanes_ok(lanes) ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long tiles = compact::tiles_for(M);
  const long long blocks = (long long)S * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const compact::Lanes cl = compact_lanes(lanes);
  compact::Args a{};
  a.keys = static_cast<const long long*>(c_key);
  a.bins = static_cast<const int*>(c_bin);
  a.occ = static_cast<unsigned char*>(const_cast<void*>(still));  // read only in SPILL
  a.cap = M;
  a.tiles = (int)tiles;
  a.S = S;
  a.free_below = INT_MIN;
  a.vec = M % compact::ITEMS == 0 && reinterpret_cast<uintptr_t>(still) % 16 == 0;
  a.E = sc;
  a.out_key = static_cast<long long*>(sp_key);
  a.out_bin = static_cast<int*>(sp_bin);
  a.sp_fill = static_cast<int*>(sp_fill);
  a.oflow_out = static_cast<int*>(oflow);
  a.state = static_cast<unsigned long long*>(scratch);
  a.ticket_scale = 1.0 / (double)blocks;
  compact::compact_table<compact::SPILL>
      <<<(unsigned)blocks, compact::TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(cl, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_sp_launches;
  return (int)cudaSuccess;
}

// K10's spill scratch: the compaction's state words (no fill list).
long long arroyo_shard_spill_scratch_bytes(int S, long long M) {
  return 8 * compact::state_words(S, compact::tiles_for(M));
}

// Kernels K10's spill has launched in this process (one a call).
long long arroyo_shard_spill_kernel_launches(void) { return g_sp_launches.load(); }

// K11. lanes->in: the table's lanes, ->out: the extracted lanes [S * E].
// scratch: arroyo_shard_extract_scratch_bytes(S, cap, E, zero_tail) bytes,
// 16-byte aligned, zero before its first call and then passed to every
// call of this (S, cap, E, zero_tail) on one stream, never cleared (see
// csrc/table_compact.cuh).
// E <= cap unless zero_tail; oflow_in / oflow_out int32 [S] or NULL.
int arroyo_shard_extract(int device, int S, long long cap, const void* keys, const void* bins,
                         void* occ, const Lanes* lanes, int emit_lo, int emit_hi, int free_below,
                         long long E, void* out_key, void* out_bin, void* out_valid,
                         void* total, void* scratch, int zero_tail, const void* oflow_in,
                         void* oflow_out, void* stream) {
  if (S < 1 || cap < 1 || cap > 0x7fffffffLL || E < 1 || (E > cap && !zero_tail) ||
      !lanes_ok(lanes) || (oflow_in == nullptr) != (oflow_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const compact::Lanes cl = compact_lanes(lanes);
  compact::Args a{};
  a.keys = static_cast<const long long*>(keys);
  a.bins = static_cast<const int*>(bins);
  a.occ = static_cast<unsigned char*>(occ);
  a.cap = cap;
  a.tiles = (int)compact::tiles_for(cap);
  a.S = S;
  a.lo = emit_lo;
  a.hi = emit_hi;
  a.free_below = free_below;
  a.vec = cap % compact::ITEMS == 0 && reinterpret_cast<uintptr_t>(occ) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(bins) % 16 == 0;
  a.E = E;
  a.out_key = static_cast<long long*>(out_key);
  a.out_bin = static_cast<int*>(out_bin);
  a.out_valid = static_cast<unsigned char*>(out_valid);
  a.total = static_cast<int*>(total);
  a.oflow_in = static_cast<const int*>(oflow_in);
  a.oflow_out = static_cast<int*>(oflow_out);
  a.state = static_cast<unsigned long long*>(scratch);
  a.fill = a.state + compact::state_words(S, a.tiles);
  const int mode = zero_tail ? compact::ZERO_TAIL : compact::CLOSE;
  const long long blocks = (long long)S * a.tiles + compact::fill_blocks(S, E, mode);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.ticket_scale = 1.0 / (double)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (zero_tail)
    compact::compact_table<compact::ZERO_TAIL><<<grid, compact::TILE_THREADS, 0, s>>>(cl, a);
  else
    compact::compact_table<compact::CLOSE><<<grid, compact::TILE_THREADS, 0, s>>>(cl, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_ext_launches;
  return (int)cudaSuccess;
}

// K11's scratch: the state words, then (default mode) the fill list.
long long arroyo_shard_extract_scratch_bytes(int S, long long cap, long long E, int zero_tail) {
  const long long words = compact::state_words(S, compact::tiles_for(cap));
  return 8 * (words + (zero_tail ? 0 : (long long)S * E));
}

// Kernels K11 has launched in this process: the difference across one
// call is that call's launches.
long long arroyo_shard_extract_kernel_launches(void) { return g_ext_launches.load(); }

}  // extern "C"
