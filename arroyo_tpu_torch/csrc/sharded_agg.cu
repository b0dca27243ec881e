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
//   K8  agg_sort_reduce   arroyo_tpu/ops/aggregate.py sort_reduce (B7):
//       per shard, a stable lexsort of L rows by (key, bin), invalid rows
//       as (INT64_MAX, INT32_MAX), then one reduced partial per run of
//       equal (key, bin): the representative key and bin, every lane's
//       sum / min / max, and active = the run counted a valid row. Slots
//       past the last run hold (INT64_MIN, INT32_MIN), inactive, and each
//       lane's identity.
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
//       same slot order.
//
// Exactness. K8 sorts (key, tag) pairs, tag = (bin with its sign bit
// flipped) << 32 | invalid << 31 | row: every tag is distinct, so the order
// is total, and among valid rows it is the stable lexsort. Invalid rows sort
// as (INT64_MAX, INT32_MAX) after the valid rows of that run (the only run
// that mixes them), which changes no reduction: an invalid row adds each
// lane's identity. Each run is reduced by one thread walking its valid rows
// in sorted order from the identity, which is how XLA's CPU segment_sum
// adds (float sums come out bit for bit). Float min/max keep XLA's order:
// NaN propagates and -0.0 sorts below +0.0. K9 reproduces the reference's
// placement slot for slot: each round classifies every active partial
// against the table as it was at the round's start, contenders for an
// empty slot resolve by atomicMax of their index (the highest wins, as the
// reference's scatter-max), and only then do matches and winners write.
// One block per shard runs all rounds with __syncthreads between the
// phases, so there is one launch per merge; a round that starts with no
// active partial ends the loop (no later round could write).
//
// Bounds (H100, 3.35 TB/s): all four move a few bytes per element and do
// no arithmetic to speak of. K8's bitonic network makes log^2 passes over
// the padded power of two (the short strides in shared memory, one tile of
// SORT_TILE pairs per block); K10's per-shard scan and K9's rounds run one
// block per shard, so they are latency-bound at small sizes; K11 and the
// run scan of K8 count per chunk in one launch and scatter in a second,
// every block of every shard at once.
//
// Lanes are int32, int64, uint64 (a numeric group-by key riding as a max
// lane, as the JAX package's sharded store carries it), float32 or float64.
//
// Each entry point launches on the stream it is given, allocates nothing
// (the caller passes scratch) and returns cudaGetLastError() after every
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LANES 32
#define MAX_SHARDS 32
#define SORT_TILE 2048
#define CHUNK 1024  // elements per block of the count / scan passes
#define THREADS 256
#define KEY_MAX 0x7fffffffffffffffLL
#define KEY_MIN (-KEY_MAX - 1LL)
#define BIN_MAX 0x7fffffff
#define BIN_MIN (-BIN_MAX - 1)
#define PAD_TAG 0xffffffff00000000ULL
#define INVALID_BIT 0x80000000u  // in a tag's row field: the row is invalid
#define ROW_MASK 0x7fffffffu

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

struct SortIn {
  const long long* key;
  const void* bins;  // int32 or int64
  int bins64;
  long long bin_off;  // subtracted before the int32 cast
  const unsigned char* valid;  // NULL: every row valid
  long long n_valid;  // rows at or past this flat index are invalid
};

__device__ __forceinline__ bool row_valid(const SortIn& a, long long row) {
  return row < a.n_valid && (a.valid == nullptr || a.valid[row]);
}

__device__ __forceinline__ bool pair_greater(long long ka, unsigned long long ta, long long kb,
                                             unsigned long long tb) {
  return ka > kb || (ka == kb && ta > tb);
}

__device__ __forceinline__ void exchange(long long* k, unsigned long long* t, long long lo,
                                         long long j, bool asc) {
  const long long hi = lo + j;
  const long long ka = k[lo], kb = k[hi];
  const unsigned long long ta = t[lo], tb = t[hi];
  if (pair_greater(ka, ta, kb, tb) == asc) {
    k[lo] = kb;
    k[hi] = ka;
    t[lo] = tb;
    t[hi] = ta;
  }
}

// load one tile of pairs (padding past L sorts last), sort it; blockDim = tile / 2
__global__ void sr_sort_tiles(SortIn a, long long L, long long P, long long* __restrict__ sk,
                              unsigned long long* __restrict__ st, int tile) {
  __shared__ long long k[SORT_TILE];
  __shared__ unsigned long long t[SORT_TILE];
  const long long s = blockIdx.y;
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    if (g < L) {
      const long long row = s * L + g;
      const bool v = row_valid(a, row);
      long long b = a.bins64 ? static_cast<const long long*>(a.bins)[row]
                             : (long long)static_cast<const int*>(a.bins)[row];
      const int b32 = v ? (int)(unsigned int)(unsigned long long)(b - a.bin_off) : BIN_MAX;
      k[i] = v ? a.key[row] : KEY_MAX;
      t[i] = ((unsigned long long)((unsigned int)b32 ^ 0x80000000u) << 32) |
             (unsigned int)g | (v ? 0u : INVALID_BIT);
    } else {
      k[i] = KEY_MAX;
      t[i] = PAD_TAG | (unsigned int)g | INVALID_BIT;
    }
  }
  __syncthreads();
  const int th = threadIdx.x;
  for (int kk = 2; kk <= tile; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const int lo = (th / j) * 2 * j + (th % j);
      exchange(k, t, lo, j, ((base + lo) & kk) == 0);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[s * P + base + i] = k[i];
    st[s * P + base + i] = t[i];
  }
}

__global__ void sr_merge_global(long long* __restrict__ sk, unsigned long long* __restrict__ st,
                                long long P, long long kk, long long j) {
  const long long pairs = P / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long lo = (t / j) * 2 * j + (t % j);
  const long long off = (long long)blockIdx.y * P;
  exchange(sk + off, st + off, lo, j, (lo & kk) == 0);
}

// strides SORT_TILE / 2 .. 1 of stage kk; blockDim = SORT_TILE / 2
__global__ void sr_merge_tile(long long* __restrict__ sk, unsigned long long* __restrict__ st,
                              long long P, long long kk) {
  __shared__ long long k[SORT_TILE];
  __shared__ unsigned long long t[SORT_TILE];
  const long long off = (long long)blockIdx.y * P;
  const long long base = (long long)blockIdx.x * SORT_TILE;
  for (int i = threadIdx.x; i < SORT_TILE; i += blockDim.x) {
    k[i] = sk[off + base + i];
    t[i] = st[off + base + i];
  }
  __syncthreads();
  const bool asc = (base & kk) == 0;
  const int th = threadIdx.x;
  for (int j = SORT_TILE >> 1; j > 0; j >>= 1) {
    const int lo = (th / j) * 2 * j + (th % j);
    exchange(k, t, lo, j, asc);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < SORT_TILE; i += blockDim.x) {
    sk[off + base + i] = k[i];
    st[off + base + i] = t[i];
  }
}

__device__ __forceinline__ bool run_start(const long long* sk, const unsigned long long* st,
                                          long long i) {
  return i == 0 || sk[i] != sk[i - 1] || (st[i] >> 32) != (st[i - 1] >> 32);
}

__global__ void sr_run_count(const long long* __restrict__ sk, const unsigned long long* __restrict__ st,
                             long long L, long long P, int n_chunks, int* __restrict__ counts) {
  __shared__ int ws[32];
  const long long s = blockIdx.y;
  const long long i = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const bool f = i < L && run_start(sk + s * P, st + s * P, i);
  int total;
  block_excl_count(f, ws, &total);
  if (threadIdx.x == 0) counts[s * n_chunks + blockIdx.x] = total;
}

__global__ void sr_run_scan(const long long* __restrict__ sk, const unsigned long long* __restrict__ st,
                            long long L, long long P, int n_chunks, const int* __restrict__ counts,
                            int* __restrict__ starts, int* __restrict__ nseg) {
  __shared__ int ws[32];
  __shared__ long long sh[32];
  const long long s = blockIdx.y;
  long long prefix, total;
  chunk_prefix(counts + s * n_chunks, n_chunks, blockIdx.x, &prefix, &total, sh);
  const long long i = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const bool f = i < L && run_start(sk + s * P, st + s * P, i);
  int tot;
  const int ex = block_excl_count(f, ws, &tot);
  if (f) starts[s * L + prefix + ex] = (int)i;
  if (blockIdx.x == 0 && threadIdx.x == 0) nseg[s] = (int)total;
}

// one thread per output slot t of shard s: run t reduced, or the identities
__global__ void sr_reduce(Lanes lanes, const long long* __restrict__ sk,
                          const unsigned long long* __restrict__ st, long long L, long long P,
                          const int* __restrict__ starts, const int* __restrict__ nseg,
                          long long* __restrict__ u_key, int* __restrict__ u_bin,
                          unsigned char* __restrict__ active) {
  const long long s = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L) return;
  const long long o = s * L + t;
  const long long n = nseg[s];
  if (t >= n) {
    u_key[o] = KEY_MIN;
    u_bin[o] = BIN_MIN;
    active[o] = 0;
    for (int l = 0; l < lanes.n; ++l) st_bits(lanes.dtype[l], lanes.out[l], o, lanes.ident[l]);
    return;
  }
  const long long lo = starts[s * L + t];
  const long long hi = t + 1 < n ? starts[s * L + t + 1] : L;
  const long long* k = sk + s * P;
  const unsigned long long* tg = st + s * P;
  u_key[o] = k[lo];
  u_bin[o] = (int)((unsigned int)(tg[lo] >> 32) ^ 0x80000000u);
  // a run's valid rows come first (only the padding run holds invalid
  // ones); invalid rows would add each lane's identity, which changes no
  // accumulator, so the walk stops at the first
  long long end = lo;
  while (end < hi && !((unsigned int)tg[end] & INVALID_BIT)) ++end;
  active[o] = end > lo ? 1 : 0;
  for (int l = 0; l < lanes.n; ++l) {
    const int dt = lanes.dtype[l], kind = lanes.kind[l];
    const void* vp = lanes.in[l];
    unsigned long long acc = lanes.ident[l];
    for (long long i = lo; i < end; ++i) {
      const long long row = s * L + (long long)((unsigned int)tg[i] & ROW_MASK);
      acc = combine_bits(kind, dt, acc, vp ? ld_bits(dt, vp, row) : one_bits(dt));
    }
    st_bits(dt, lanes.out[l], o, acc);
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
  for (int r = 0; r < max_probes && n > 0; ++r) {
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

struct ExtractOut {
  long long* key;
  int* bin;
  unsigned char* valid;
  int* total;
  int zero_tail;  // rows past the emitting ones hold zeros
  const int* oflow_in;  // copied to oflow_out per shard, when given
  int* oflow_out;
};

__device__ __forceinline__ bool emits(const unsigned char* occ, const int* bins, long long j,
                                      int lo, int hi) {
  return occ[j] && bins[j] >= lo && bins[j] < hi;
}

__global__ void ext_count(const int* __restrict__ bins, const unsigned char* __restrict__ occ,
                          long long cap, int lo, int hi, int n_chunks, int* __restrict__ counts) {
  __shared__ int ws[32];
  const long long s = blockIdx.y;
  const long long j = (long long)blockIdx.x * CHUNK + threadIdx.x;
  int total;
  block_excl_count(j < cap && emits(occ, bins, s * cap + j, lo, hi), ws, &total);
  if (threadIdx.x == 0) counts[s * n_chunks + blockIdx.x] = total;
}

__global__ void ext_write(const long long* __restrict__ keys, const int* __restrict__ bins,
                          unsigned char* __restrict__ occ, Lanes lanes, long long cap, int lo,
                          int hi, int free_below, long long E, int n_chunks,
                          const int* __restrict__ counts, ExtractOut out) {
  __shared__ int ws[32];
  __shared__ long long sh[32];
  const long long s = blockIdx.y;
  long long prefix, total;
  chunk_prefix(counts + s * n_chunks, n_chunks, blockIdx.x, &prefix, &total, sh);
  const long long j = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const long long g = s * cap + j;
  const bool e = j < cap && emits(occ, bins, g, lo, hi);
  int tot;
  const long long ex = prefix + block_excl_count(e, ws, &tot);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out.total[s] = (int)total;
    if (out.oflow_out != nullptr) out.oflow_out[s] = out.oflow_in[s];
  }
  if (out.zero_tail && j < E && j >= (total < E ? total : E)) {
    const long long d = s * E + j;  // output row j, past the emitted rows
    out.key[d] = 0;
    out.bin[d] = 0;
    out.valid[d] = 0;
    for (int l = 0; l < lanes.n; ++l) st_bits(lanes.dtype[l], lanes.out[l], d, 0ULL);
  }
  if (j >= cap) return;
  // emitting slots first in slot order, then the others in slot order
  // (with zero_tail only the emitting ones)
  const long long pos = e ? ex : (out.zero_tail ? E : total + j - ex);
  if (pos < E) {
    const long long d = s * E + pos;
    out.key[d] = keys[g];
    out.bin[d] = bins[g];
    out.valid[d] = e ? 1 : 0;
    for (int l = 0; l < lanes.n; ++l) {
      const int dt = lanes.dtype[l];
      st_bits(dt, lanes.out[l], d, ld_bits(dt, lanes.in[l], g));
    }
  }
  // expired slots outside the emit range free now, emitted ones once emitted
  if (bins[g] < free_below && (e ? pos < E : occ[g] != 0)) occ[g] = 0;
}

// ------------------------------------------------------------ entry points

static unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

static int chunks_for(long long n) { return (int)((n + CHUNK - 1) / CHUNK); }

static bool lanes_ok(const Lanes* l) { return l->n >= 0 && l->n <= MAX_LANES; }

extern "C" {

// K8. scratch: sk int64 [S * P], st uint64 [S * P], starts int32 [S * L],
// nseg int32 [S], counts int32 [S * chunks(L)]; P a power of two >= max(L, 64).
int arroyo_agg_sort_reduce(int device, int S, long long L, long long P, const void* key,
                           const void* bins, int bins64, long long bin_off, const void* valid,
                           long long n_valid, const Lanes* lanes, void* sk, void* st,
                           void* starts, void* nseg, void* counts, void* u_key, void* u_bin,
                           void* active, void* stream) {
  if (S < 1 || L < 1 || L > 0x7fffffffLL || P < 64 || (P & (P - 1)) != 0 || P < L ||
      !lanes_ok(lanes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SortIn a{static_cast<const long long*>(key), bins, bins64, bin_off,
           static_cast<const unsigned char*>(valid), n_valid};
  long long* k = static_cast<long long*>(sk);
  unsigned long long* t = static_cast<unsigned long long*>(st);
  const int tile = P < SORT_TILE ? (int)P : SORT_TILE;
  sr_sort_tiles<<<dim3((unsigned int)(P / tile), S), tile / 2, 0, s>>>(a, L, P, k, t, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (long long kk = 2LL * SORT_TILE; kk <= P; kk <<= 1) {
    for (long long j = kk >> 1; j >= SORT_TILE; j >>= 1) {
      sr_merge_global<<<dim3(blocks_for(P / 2, THREADS), S), THREADS, 0, s>>>(k, t, P, kk, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    sr_merge_tile<<<dim3((unsigned int)(P / SORT_TILE), S), SORT_TILE / 2, 0, s>>>(k, t, P, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int nc = chunks_for(L);
  sr_run_count<<<dim3(nc, S), CHUNK, 0, s>>>(k, t, L, P, nc, static_cast<int*>(counts));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sr_run_scan<<<dim3(nc, S), CHUNK, 0, s>>>(k, t, L, P, nc, static_cast<const int*>(counts),
                                            static_cast<int*>(starts), static_cast<int*>(nseg));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sr_reduce<<<dim3(blocks_for(L, THREADS), S), THREADS, 0, s>>>(
      *lanes, k, t, L, P, static_cast<const int*>(starts), static_cast<const int*>(nseg),
      static_cast<long long*>(u_key), static_cast<int*>(u_bin),
      static_cast<unsigned char*>(active));
  return (int)cudaGetLastError();
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
// scratch: counts int32 [S * chunks(cap)]. E <= cap unless zero_tail;
// oflow_in / oflow_out int32 [S] or NULL.
int arroyo_shard_extract(int device, int S, long long cap, const void* keys, const void* bins,
                         void* occ, const Lanes* lanes, int emit_lo, int emit_hi, int free_below,
                         long long E, void* out_key, void* out_bin, void* out_valid,
                         void* total, void* counts, int zero_tail, const void* oflow_in,
                         void* oflow_out, void* stream) {
  if (S < 1 || cap < 1 || E < 1 || (E > cap && !zero_tail) || !lanes_ok(lanes) ||
      (oflow_in == nullptr) != (oflow_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = chunks_for(cap);
  ext_count<<<dim3(nc, S), CHUNK, 0, s>>>(static_cast<const int*>(bins),
                                          static_cast<const unsigned char*>(occ), cap, emit_lo,
                                          emit_hi, nc, static_cast<int*>(counts));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ExtractOut out{static_cast<long long*>(out_key), static_cast<int*>(out_bin),
                 static_cast<unsigned char*>(out_valid), static_cast<int*>(total), zero_tail,
                 static_cast<const int*>(oflow_in), static_cast<int*>(oflow_out)};
  // with a zeroed tail past cap, the blocks cover the output rows too
  const int nw = chunks_for(E > cap ? E : cap);
  ext_write<<<dim3(nw, S), CHUNK, 0, s>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(bins),
      static_cast<unsigned char*>(occ), *lanes, cap, emit_lo, emit_hi, free_below, E, nc,
      static_cast<const int*>(counts), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
