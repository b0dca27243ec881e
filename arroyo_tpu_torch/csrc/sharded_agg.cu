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
//       overflow.
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
// then do matches and winners write. One block per shard runs all rounds
// with __syncthreads between the phases, so there is one launch per merge;
// a round that starts with no active partial ends the loop (no later round
// could write). Each call records, for its first PM_REPORT_SHARDS shards,
// the rounds it ran and the active list's length at the start of each of
// the first PM_REPORT_ROUNDS rounds and after the last
// (arroyo_agg_probe_merge_rounds reads them back).
//
// Bounds (H100, 3.35 TB/s): all five move a few bytes per element and do
// no arithmetic to speak of. K10's per-shard scan and K9's rounds run one
// block per shard, so they are latency-bound at small sizes; K8's
// compaction counts per chunk in one launch and scatters in a second,
// every block of every shard at once. K11 reads each slot's occupancy and
// bin once, in one launch over tiles of every shard (see
// csrc/table_compact.cuh): its bound is the occupancy, the occupied bins,
// the emitted slots' key and lanes, the E rows written and the frees.
//
// Lanes are int32, int64, uint64 (a numeric group-by key riding as a max
// lane, as the JAX package's sharded store carries it), float32 or float64.
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller passes scratch) and returns cudaGetLastError() after every
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <vector>

#include "radix_sort.cuh"
#include "table_compact.cuh"

using radix::RADIX;

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

// still = active; the active partials' indices appended to each shard's list
__global__ void pm_list(const unsigned char* __restrict__ active, long long B,
                        unsigned char* __restrict__ still, int* __restrict__ list,
                        int* __restrict__ n_list) {
  const long long s = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const unsigned char a = active[s * B + i];
  still[s * B + i] = a;
  if (a) list[s * 2 * B + atomicAdd(&n_list[s], 1)] = (int)i;
}

enum { PM_MISS = 0, PM_MATCH = 1, PM_EMPTY = 2 };

#define PM_REPORT_SHARDS 32
#define PM_REPORT_ROUNDS 256
// The last call's rounds per shard, and the active partials at the start
// of round r (r = rounds: those left unplaced).
__device__ int g_pm_rounds[PM_REPORT_SHARDS];
__device__ int g_pm_active[PM_REPORT_SHARDS][PM_REPORT_ROUNDS + 1];

// one block per shard runs every round
__global__ void pm_rounds(long long* __restrict__ keys, int* __restrict__ bins,
                          unsigned char* __restrict__ occ, Lanes lanes, long long cap,
                          const long long* __restrict__ u_key, const int* __restrict__ u_bin,
                          long long B, int max_probes, unsigned char* __restrict__ still,
                          int* __restrict__ list, const int* __restrict__ n_list0,
                          int* __restrict__ claims, unsigned char* __restrict__ code,
                          int* __restrict__ oflow) {
  __shared__ int n_next;
  const long long s = blockIdx.x;
  const long long mask = cap - 1;
  long long* K = keys + s * cap;
  int* Bn = bins + s * cap;
  unsigned char* O = occ + s * cap;
  int* C = claims + s * cap;
  const long long* uk = u_key + s * B;
  const int* ub = u_bin + s * B;
  int* cur = list + s * 2 * B;
  int* nxt = cur + B;
  unsigned char* cd = code + s * B;
  int n = n_list0[s];
  const bool report = s < PM_REPORT_SHARDS && threadIdx.x == 0;
  int r = 0;
  for (; r < max_probes && n > 0; ++r) {
    if (report && r < PM_REPORT_ROUNDS) g_pm_active[s][r] = n;
    // phase 1: classify against the table as it is at the round's start
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = cur[j];
      const long long c = (probe_home(uk[i], ub[i], mask) + r) & mask;
      unsigned char k = PM_MISS;
      if (O[c]) {
        if (K[c] == uk[i] && Bn[c] == ub[i]) k = PM_MATCH;
      } else {
        k = PM_EMPTY;
        C[c] = -1;
      }
      cd[j] = k;
    }
    if (threadIdx.x == 0) n_next = 0;
    __syncthreads();
    // phase 2: the highest contending index claims each empty slot
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (cd[j] != PM_EMPTY) continue;
      const int i = cur[j];
      const long long c = (probe_home(uk[i], ub[i], mask) + r) & mask;
      atomicMax(&C[c], i);
    }
    __syncthreads();
    // phase 3: matches combine, winners write, the rest go on
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = cur[j];
      const long long c = (probe_home(uk[i], ub[i], mask) + r) & mask;
      const unsigned char k = cd[j];
      const long long row = s * B + i;
      const long long slot = s * cap + c;
      if (k == PM_MATCH) {
        for (int l = 0; l < lanes.n; ++l) {
          const int dt = lanes.dtype[l];
          st_bits(dt, lanes.out[l], slot,
                  combine_bits(lanes.kind[l], dt, ld_bits(dt, lanes.out[l], slot),
                               ld_bits(dt, lanes.in[l], row)));
        }
        still[row] = 0;
      } else if (k == PM_EMPTY && C[c] == i) {
        K[c] = uk[i];
        Bn[c] = ub[i];
        O[c] = 1;
        for (int l = 0; l < lanes.n; ++l) {
          const int dt = lanes.dtype[l];
          st_bits(dt, lanes.out[l], slot, ld_bits(dt, lanes.in[l], row));
        }
        still[row] = 0;
      } else {
        nxt[atomicAdd(&n_next, 1)] = i;
      }
    }
    __syncthreads();
    n = n_next;
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncthreads();
  }
  if (report) {
    g_pm_rounds[s] = r;
    if (r <= PM_REPORT_ROUNDS) g_pm_active[s][r] = n;
  }
  // partials no round placed: the table's overflow (one block per shard)
  if (oflow != nullptr && threadIdx.x == 0) oflow[s] += n;
}

// ------------------------------------------------------------ K10

__device__ __forceinline__ int owner_of(long long key, bool act, int S) {
  if (!act) return S;
  if (S == 1) return 0;
  const unsigned long long range = 0xffffffffffffffffULL / (unsigned long long)S + 1ULL;
  const unsigned long long o = (unsigned long long)key / range;
  return o > (unsigned long long)(S - 1) ? S - 1 : (int)o;
}

// one block per source shard: send buffers [S * dc] and the owner-ordered
// local rows at m[recv_cap ..]
__global__ void ex_bucket(const long long* __restrict__ u_key, const int* __restrict__ u_bin,
                          const unsigned char* __restrict__ active, Lanes lanes, int S,
                          long long L, long long dc, long long M,
                          long long* __restrict__ s_key, int* __restrict__ s_bin,
                          unsigned char* __restrict__ s_valid, long long* __restrict__ m_key,
                          int* __restrict__ m_bin, unsigned char* __restrict__ m_valid) {
  __shared__ int counts[MAX_SHARDS + 1];
  __shared__ int starts[MAX_SHARDS + 1];
  __shared__ int running[MAX_SHARDS + 1];
  __shared__ int wc[32][MAX_SHARDS + 1];
  const long long src = blockIdx.x;
  const long long recv = (long long)S * dc;
  const long long* uk = u_key + src * L;
  const unsigned char* ua = active + src * L;
  for (int o = threadIdx.x; o <= S; o += blockDim.x) {
    counts[o] = 0;
    running[o] = 0;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < L; i += blockDim.x)
    atomicAdd(&counts[owner_of(uk[i], ua[i] != 0, S)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int o = 0; o <= S; ++o) {
      starts[o] = acc;
      acc += counts[o];
    }
  }
  // send slots no row fills take the fill values: 0, 0, invalid, identity
  for (long long slot = threadIdx.x; slot < recv; slot += blockDim.x) {
    const int o = (int)(slot / dc);
    if (slot % dc < (long long)counts[o]) continue;
    const long long d = src * recv + slot;
    s_key[d] = 0;
    s_bin[d] = 0;
    s_valid[d] = 0;
    for (int l = 0; l < lanes.n; ++l) st_bits(lanes.dtype[l], lanes.out[l], d, lanes.ident[l]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (long long c0 = 0; c0 < L; c0 += blockDim.x) {
    const long long i = c0 + threadIdx.x;
    const int o = i < L ? owner_of(uk[i], ua[i] != 0, S) : -1;
    unsigned int mine = 0;
    for (int q = 0; q <= S; ++q) {
      const unsigned int b = __ballot_sync(0xffffffffu, o == q);
      if (lane == 0) wc[warp][q] = __popc(b);
      if (o == q) mine = b;
    }
    __syncthreads();
    if (o >= 0) {
      int off = __popc(mine & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) off += wc[w][o];
      const long long rank = running[o] + off;
      const long long p = starts[o] + rank;
      const long long row = src * L + i;
      const long long m = src * M + recv + p;
      m_key[m] = uk[i];
      m_bin[m] = u_bin[row];
      m_valid[m] = (o < S && rank >= dc) ? 1 : 0;
      for (int l = 0; l < lanes.n; ++l) {
        const int dt = lanes.dtype[l];
        st_bits(dt, lanes.aux[l], m, ld_bits(dt, lanes.in[l], row));
      }
      if (o < S && rank < dc) {
        const long long d = src * recv + (long long)o * dc + rank;
        s_key[d] = uk[i];
        s_bin[d] = u_bin[row];
        s_valid[d] = 1;
        for (int l = 0; l < lanes.n; ++l) {
          const int dt = lanes.dtype[l];
          st_bits(dt, lanes.out[l], d, ld_bits(dt, lanes.in[l], row));
        }
      }
    }
    __syncthreads();
    if (threadIdx.x <= S) {
      int add = 0;
      for (int w = 0; w < nw; ++w) add += wc[w][threadIdx.x];
      running[threadIdx.x] += add;
    }
    __syncthreads();
  }
}

// spill: still-active rows append in index order from sp_fill
__global__ void sp_count(const unsigned char* __restrict__ still, long long M, int n_chunks,
                         int* __restrict__ counts) {
  __shared__ int ws[32];
  const long long s = blockIdx.y;
  const long long i = (long long)blockIdx.x * CHUNK + threadIdx.x;
  int total;
  block_excl_count(i < M && still[s * M + i], ws, &total);
  if (threadIdx.x == 0) counts[s * n_chunks + blockIdx.x] = total;
}

__global__ void sp_write(const long long* __restrict__ c_key, const int* __restrict__ c_bin,
                         const unsigned char* __restrict__ still, Lanes lanes, long long M,
                         int n_chunks, const int* __restrict__ counts, long long sc,
                         long long* __restrict__ sp_key, int* __restrict__ sp_bin,
                         const int* __restrict__ sp_fill) {
  __shared__ int ws[32];
  __shared__ long long sh[32];
  const long long s = blockIdx.y;
  long long prefix, total;
  chunk_prefix(counts + s * n_chunks, n_chunks, blockIdx.x, &prefix, &total, sh);
  if (total == 0) return;
  const long long i = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const bool f = i < M && still[s * M + i];
  int tot;
  const long long sidx = sp_fill[s] + prefix + block_excl_count(f, ws, &tot);
  if (!f || sidx >= sc) return;
  const long long row = s * M + i, d = s * sc + sidx;
  sp_key[d] = c_key[row];
  sp_bin[d] = c_bin[row];
  for (int l = 0; l < lanes.n; ++l) {
    const int dt = lanes.dtype[l];
    st_bits(dt, lanes.out[l], d, ld_bits(dt, lanes.in[l], row));
  }
}

__global__ void sp_finish(int S, int n_chunks, const int* __restrict__ counts, long long sc,
                          int* __restrict__ sp_fill, int* __restrict__ oflow) {
  const int s = threadIdx.x;
  if (s >= S) return;
  long long total = 0;
  for (int c = 0; c < n_chunks; ++c) total += counts[s * n_chunks + c];
  const long long fill = sp_fill[s];
  long long room = sc - fill;
  if (room < 0) room = 0;
  const long long spilled = total < room ? total : room;
  sp_fill[s] = (int)(fill + spilled < sc ? fill + spilled : sc);
  oflow[s] += (int)(total - spilled);
}

// ------------------------------------------------------------ K11

// K11 is csrc/table_compact.cuh's one-pass compaction (CLOSE, or
// ZERO_TAIL); the library counts its kernel launches.
static std::atomic<long long> g_ext_launches{0};

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
// list int32 [S * 2 * B], n_list int32 [S], claims int32 [S * cap], code
// uint8 [S * B].
// oflow int32 [S] or NULL: each shard's unplaced partials add to it.
int arroyo_agg_probe_merge(int device, int S, long long cap, void* keys, void* bins, void* occ,
                           const Lanes* lanes, long long B, const void* u_key, const void* u_bin,
                           const void* active, int max_probes, void* still, void* list,
                           void* n_list, void* claims, void* code, void* oflow, void* stream) {
  if (S < 1 || B < 1 || B > 0x7fffffffLL || cap < 1 || (cap & (cap - 1)) != 0 ||
      max_probes < 0 || !lanes_ok(lanes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(n_list, 0, sizeof(int) * S, s)) != cudaSuccess) return (int)err;
  pm_list<<<dim3(blocks_for(B, THREADS), S), THREADS, 0, s>>>(
      static_cast<const unsigned char*>(active), B, static_cast<unsigned char*>(still),
      static_cast<int*>(list), static_cast<int*>(n_list));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pm_rounds<<<S, 1024, 0, s>>>(
      static_cast<long long*>(keys), static_cast<int*>(bins), static_cast<unsigned char*>(occ),
      *lanes, cap, static_cast<const long long*>(u_key), static_cast<const int*>(u_bin), B,
      max_probes, static_cast<unsigned char*>(still), static_cast<int*>(list),
      static_cast<const int*>(n_list), static_cast<int*>(claims),
      static_cast<unsigned char*>(code), static_cast<int*>(oflow));
  return (int)cudaGetLastError();
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

// K10, steps 2-3. lanes->in: the partials' lanes, ->out: the send buffers
// [S * S * dc], ->aux: the merged rows [S * M], M = S * dc + L.
int arroyo_shard_exchange(int device, int S, long long L, long long dc, const void* u_key,
                          const void* u_bin, const void* active, const Lanes* lanes, void* s_key,
                          void* s_bin, void* s_valid, void* m_key, void* m_bin, void* m_valid,
                          void* stream) {
  if (S < 1 || S > MAX_SHARDS || L < 1 || dc < 1 || !lanes_ok(lanes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ex_bucket<<<S, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(u_key), static_cast<const int*>(u_bin),
      static_cast<const unsigned char*>(active), *lanes, S, L, dc, (long long)S * dc + L,
      static_cast<long long*>(s_key), static_cast<int*>(s_bin),
      static_cast<unsigned char*>(s_valid), static_cast<long long*>(m_key),
      static_cast<int*>(m_bin), static_cast<unsigned char*>(m_valid));
  return (int)cudaGetLastError();
}

// K10, step 7. lanes->in: the merged partials' lanes [S * M], ->out: the
// spill lanes [S * sc]. scratch: counts int32 [S * chunks(M)].
int arroyo_shard_spill(int device, int S, long long M, const void* c_key, const void* c_bin,
                       const void* still, const Lanes* lanes, long long sc, void* sp_key,
                       void* sp_bin, void* sp_fill, void* oflow, void* counts, void* stream) {
  if (S < 1 || S > 1024 || M < 1 || sc < 0 || !lanes_ok(lanes)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = chunks_for(M);
  sp_count<<<dim3(nc, S), CHUNK, 0, s>>>(static_cast<const unsigned char*>(still), M, nc,
                                         static_cast<int*>(counts));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sp_write<<<dim3(nc, S), CHUNK, 0, s>>>(
      static_cast<const long long*>(c_key), static_cast<const int*>(c_bin),
      static_cast<const unsigned char*>(still), *lanes, M, nc, static_cast<const int*>(counts),
      sc, static_cast<long long*>(sp_key), static_cast<int*>(sp_bin),
      static_cast<const int*>(sp_fill));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sp_finish<<<1, 1024, 0, s>>>(S, nc, static_cast<const int*>(counts), sc,
                               static_cast<int*>(sp_fill), static_cast<int*>(oflow));
  return (int)cudaGetLastError();
}

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
  compact::Lanes cl;
  for (int l = 0; l < lanes->n; ++l) {
    cl.in[l] = lanes->in[l];
    cl.out[l] = lanes->out[l];
    const int dt = lanes->dtype[l];
    cl.wide[l] = dt == DT_I64 || dt == DT_F64 || dt == DT_U64;
  }
  cl.n = lanes->n;
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
