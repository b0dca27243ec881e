// Slot-aggregator kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (arroyo_tpu_torch/ops/kernels.py builds this file
// with nvcc at first use and holds each kernel against its plain PyTorch
// version).
//
// Window state is one [cap] array per accumulator lane (int32, int64,
// uint64, float32 or float64; uint64 carries a numeric group-by key as a
// max lane). The host resolves a slot for every batch row; these kernels
// update and read that state in place:
//
//   K1 slot_scatter_combine  replaces arroyo_tpu/ops/slot_agg.py
//      _build_slot_jax step / step_merge: per lane, rows combine into
//      state[slot] with add (sum, count), min or max. Rows whose slot lies
//      outside [0, cap) are dropped. A lane with no value pointer adds 1
//      (a count lane in the hot path ships no values).
//   K2 slot_region_read_pack replaces _build_slot_jax make_read_multi's
//      go (_pack, then _clear when it clears): for k region bases, R slots
//      of every lane, int lanes widened into one int64 buffer (uint64 as
//      its bits, as _pack's astype(int64)) and float lanes into one float64
//      buffer, laid out [base][lane of its class][R] (a float32 subnormal
//      widens to the zero of its sign, as XLA's astype(float64) does on the
//      CPU and the TPU); in its clear mode the same launch then resets
//      every read slot to the lane's identity.
//   K3 slot_region_clear     replaces _clear / clear: R slots from each
//      base reset to the lane's identity, without a read (the same kernel
//      body as K2, in its CLEAR mode).
//      K2 and K3 are one kernel, region_kernel<READ, CLEAR>. The host pads
//      k to a power of two by duplicating the first base, so bases repeat;
//      the wrapper hands the kernel each DISTINCT base once, with a mask of
//      the output positions that name it. One thread reads a slot once,
//      writes it to every masked position, and then (CLEAR) stores the
//      identity into the same word, which no other thread touches: that is
//      the reference's read-every-base-then-clear-every-base, exactly, as
//      long as distinct regions do not overlap (the wrapper refuses
//      overlapping bases in the read-and-clear mode).
//   K7 slot_gather           replaces _build_slot_jax make_read_slots.go:
//      for k slots (int32 or int64 indices), every lane's value at each
//      slot, widened as K2 widens, into one packed buffer: the int lanes'
//      [lane of its class][k] int64 words, then, from the next 16-byte
//      boundary, the float lanes' [lane of its class][k] float64 words. A
//      slot outside [0, cap) reads 0. The updating aggregate's flush reads
//      its touched keys with it; it launches on the stream of the K1
//      launches it must see, so it reads their sums.
//
// Bound on the H100 (3.35 TB/s HBM, 50 MB L2): all four move a few bytes
// per element and do no arithmetic to speak of, so each is bound by bytes.
// K1 reads 4 or 8 bytes of slot and 8 of value per row and updates the
// touched state words; q7's state (65536 slots x 3 lanes x 8 B = 1.5 MB)
// sits in L2, so the atomics resolve there and skewed keys (hot auctions)
// serialise on their slots. The design reads each row's slot once and
// walks the lanes in a loop inside the thread, so the slot load is shared
// and neighbouring threads touch neighbouring rows (coalesced loads of
// slots and values). K2 and K3 stream R contiguous slots per lane, but at
// the main path's shapes (one 2048-slot region of three lanes, 48 KB) a
// call is launch latency and one round trip to memory, not bytes; so the
// kernel does as little per element as it can. Its grid is 3-D (blockIdx.z
// the lane, blockIdx.y the distinct region, blockIdx.x a chunk of it), so
// a thread makes one round trip and its lane's dtype is uniform across the
// block; indices are 32-bit (the wrapper refuses R >= 2^31), with no
// division; each thread owns a quad of four slots aligned to the state
// (one 16-byte load and store of a 4-byte lane, two of an 8-byte lane;
// the widened outputs in 16-byte stores where aligned). A quad cut by the
// region's ends, or a lane or output off a 16-byte boundary, takes scalar
// accesses in the same code. K7 reads k random words of every lane: its
// bound is the bytes of the slots, the gathered words and the widened
// output, but each random read costs a 32-byte sector unless the state
// sits in L2 (qu's 262144 slots x 4 lanes x 8 B = 8 MB does), and at qu's
// k (~10,000) a call is latency. So the lane is blockIdx.y (the block's
// dtype is uniform, dispatched once per thread by a template over the
// widths), and a thread takes a quad of four consecutive gathered
// positions: one 16-byte load of four int32 slots (two of int64 slots),
// its four state reads (__ldg, the state __restrict__) issued before any
// store, and its four widened words written as two 16-byte stores. A
// thread makes two dependent round trips to memory, whatever the lanes.
// The tail quad (k % 4) and a slot array or output row off a 16-byte
// boundary take scalar accesses in the same code. Blocks of 128 threads
// put a qu-shaped call (9,867 slots, 4 lanes) on 80 blocks; the deployment
// state's (1,048,576 slots) on 2,048 a lane, a quad a thread. There the
// random state reads set the time: 4,194,304 of them, each a 32-byte
// sector of a 512 MB state, take 0.13-0.15 ms (~1 TB/s of sectors), in
// the design K7 replaced too (PERF.md).
// The lane table and the bases are passed by value in the kernel
// parameters: no device allocation and no host-to-device copy for them.
// empty_kernel, launched on K2's grid, is the card's launch floor for such
// a kernel (chip_smoke.py times it beside K2).
//
// Exactness. Integer adds wrap (two's complement, as XLA's); integer
// min/max are atomics, exact in any order (uint64 with the unsigned
// atomics). Float min/max: XLA's scatter-min/max propagates NaN and orders
// -0.0 below +0.0, whatever the order of the rows; the CAS loops below keep
// the same order, so the result does not depend on the order the atomics
// land in. Float sums do depend on the order: the reference adds each
// slot's rows one after another in batch order, starting from the state
// value. So a float add lane takes no atomic: the caller first sorts the
// slots stably with K5 in range mode (csrc/join_probe.cu,
// arroyo_join_sort_pairs: equal slots keep their row order, and every
// slot outside [0, cap) sorts last, as cap), and each run of equal slots
// is then added in row order from state[slot] (__dadd_rn, and for
// float32 add.rn.ftz.f32, no contraction).
//
// Float32 subnormals: XLA computes float32 with subnormal operands read as
// zero and subnormal results flushed to zero, keeping the sign (on the CPU
// and the TPU alike). So a float32 lane's every touched slot does the
// same: the sums add with add.rn.ftz.f32 (which flushes inputs and
// result), and min/max compare the flushed value against the flushed
// state and store the flushed winner, even where the state wins. XLA on
// the CPU does the same with float64 subnormals (below DBL_MIN), and PTX
// has no .ftz for f64: a float64 lane flushes by hand (ftz), each
// operand before the add or compare and each result (float_flush.cuh).
//
// That serial chain per slot is the result, so a hot slot's run costs its
// length in dependent adds (the chain floor: at the deployment shape the
// hottest of 65536 Zipf(1.2) rows' slots holds about 11,000 rows). What
// the walk removes are the load waits inside the chain. walk_runs gives
// one thread to each sorted row: a run's head (the first row of its slot)
// finds the run's end by a galloping binary search over the sorted slots;
// a run shorter than long_run is added by that thread, its order and
// values loaded eight rows at a time ahead of their adds; a longer run
// goes to a device list (an atomic counter, zeroed by a memset on the
// stream). walk_long then gives one block to each listed run: eight warps
// stage the next chunk (1024 rows, 256 with more than eight ordered lanes)
// of the run's order and values into shared memory while one thread per
// ordered lane, each lane on its own warp, adds the chunk staged before
// (double buffered), reading 32 staged values ahead of its adds. So the
// float64 and float32 lanes walk concurrently, and a step costs one add.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError(); K7 counts its launches
// (arroyo_slot_gather_kernel_launches).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "float_flush.cuh"

#define MAX_LANES 32
#define MAX_BASES 16
#define THREADS 256
#define REGION_THREADS 128  // K2 / K3: a 2048-slot region spreads over four blocks
#ifndef GATHER_THREADS  // tools/block_sweep.py builds this file with other blocks
#define GATHER_THREADS 128  // K7's block, from that sweep on the card (PERF.md)
#endif

enum { KIND_ADD = 0, KIND_MIN = 1, KIND_MAX = 2 };
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3, DT_U64 = 4 };

struct ScatterArgs {
  void* state[MAX_LANES];
  const void* vals[MAX_LANES];  // NULL: the lane adds 1 per row
  int kind[MAX_LANES];
  int dtype[MAX_LANES];
  int ordered[MAX_LANES];  // a float add lane: summed in row order, not by atomics
  int ord_lane[MAX_LANES];  // the ordered lanes' indices
  int n_lanes;
  int n_ord;
};

__host__ __device__ __forceinline__ bool is_float(int dt) { return dt == DT_F32 || dt == DT_F64; }

// K2 / K3: the lanes and the distinct regions of one launch
struct RegionArgs {
  void* state[MAX_LANES];
  int dtype[MAX_LANES];
  int pos[MAX_LANES];                   // the lane's index among the lanes of its class
  unsigned long long ident[MAX_LANES];  // identity bit pattern, low bytes used for 32-bit lanes
  long long base[MAX_BASES];            // the distinct bases, one per blockIdx.y
  unsigned mask[MAX_BASES];             // bit j: output position j reads this base
  int n_int;
  int n_flt;
  int n_lanes;
};

// K7: one lane per blockIdx.y
struct GatherArgs {
  const void* state[MAX_LANES];
  unsigned long long* out[MAX_LANES];  // the lane's k widened words in the packed output
  int dtype[MAX_LANES];
};

// v replaces old under the NaN-propagating order with -0.0 < +0.0
template <bool IS_MIN, typename F>
__device__ __forceinline__ bool replaces(F v, F old) {
  if (isnan(old)) return false;
  if (isnan(v)) return true;
  if (IS_MIN) return v < old || (v == old && signbit(v) && !signbit(old));
  return v > old || (v == old && !signbit(v) && signbit(old));
}

// float64 and float32: both sides flushed, and the flushed winner stored
// (a subnormal state that keeps its slot still becomes its zero)
template <bool IS_MIN>
__device__ __forceinline__ void minmax_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  const unsigned long long fv = ftz_bits64((unsigned long long)__double_as_longlong(v));
  unsigned long long old = *a;
  while (true) {
    const unsigned long long fo = ftz_bits64(old);
    const unsigned long long want =
        replaces<IS_MIN>(__longlong_as_double((long long)fv), __longlong_as_double((long long)fo))
            ? fv : fo;
    if (want == old) return;
    unsigned long long prev = atomicCAS(a, old, want);
    if (prev == old) return;
    old = prev;
  }
}

template <bool IS_MIN>
__device__ __forceinline__ void minmax_f32(float* addr, float v) {
  unsigned int* a = reinterpret_cast<unsigned int*>(addr);
  const unsigned fv = ftz_bits32(__float_as_uint(v));
  unsigned int old = *a;
  while (true) {
    const unsigned fo = ftz_bits32(old);
    const unsigned want = replaces<IS_MIN>(__uint_as_float(fv), __uint_as_float(fo)) ? fv : fo;
    if (want == old) return;
    unsigned int prev = atomicCAS(a, old, want);
    if (prev == old) return;
    old = prev;
  }
}

__device__ __forceinline__ void combine_lane(const ScatterArgs& args, int l, long long s, long long i) {
  const void* vp = args.vals[l];
  const int kind = args.kind[l];
  switch (args.dtype[l]) {
    case DT_I64: {
      long long* st = static_cast<long long*>(args.state[l]) + s;
      long long v = vp ? static_cast<const long long*>(vp)[i] : 1LL;
      if (kind == KIND_ADD) atomicAdd(reinterpret_cast<unsigned long long*>(st), (unsigned long long)v);
      else if (kind == KIND_MIN) atomicMin(st, v);
      else atomicMax(st, v);
      break;
    }
    case DT_U64: {
      unsigned long long* st = static_cast<unsigned long long*>(args.state[l]) + s;
      unsigned long long v = vp ? static_cast<const unsigned long long*>(vp)[i] : 1ULL;
      if (kind == KIND_ADD) atomicAdd(st, v);
      else if (kind == KIND_MIN) atomicMin(st, v);
      else atomicMax(st, v);
      break;
    }
    case DT_I32: {
      int* st = static_cast<int*>(args.state[l]) + s;
      int v = vp ? static_cast<const int*>(vp)[i] : 1;
      if (kind == KIND_ADD) atomicAdd(st, v);
      else if (kind == KIND_MIN) atomicMin(st, v);
      else atomicMax(st, v);
      break;
    }
    case DT_F64: {
      double* st = static_cast<double*>(args.state[l]) + s;
      double v = vp ? static_cast<const double*>(vp)[i] : 1.0;
      if (kind == KIND_ADD) atomicAdd(st, v);
      else if (kind == KIND_MIN) minmax_f64<true>(st, v);
      else minmax_f64<false>(st, v);
      break;
    }
    default: {  // DT_F32
      float* st = static_cast<float*>(args.state[l]) + s;
      float v = vp ? static_cast<const float*>(vp)[i] : 1.0f;
      if (kind == KIND_ADD) atomicAdd(st, v);
      else if (kind == KIND_MIN) minmax_f32<true>(st, v);
      else minmax_f32<false>(st, v);
      break;
    }
  }
}

template <typename SlotT>
__global__ void scatter_combine_kernel(ScatterArgs args, const SlotT* __restrict__ slots,
                                       long long n, long long cap) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long s = (long long)slots[i];
    if (s < 0 || s >= cap) continue;  // padding rows are dropped
    for (int l = 0; l < args.n_lanes; ++l)
      if (!args.ordered[l]) combine_lane(args, l, s, i);
  }
}

// ------------------------------------------------------------ K1, float sums

#define STAGE_THREADS 256  // the threads of a walk_long block that stage rows
#define STAGE_ROWS 4        // rows each of them stages per chunk, at most
#define MAX_WALKERS 8

// A float sum adds as csrc/float_flush.cuh sets out: each operand flushed
// where it is loaded or staged (operand()), and a float64 run added by the
// fast pass, then by the exact pass where a partial sum may have been
// subnormal (two_pass).

// The end of the run of slot s that starts at sorted row i: the first row
// after it whose slot is above s (galloping, then a binary search).
__device__ __forceinline__ long long run_end(const long long* __restrict__ sorted, long long i,
                                             long long n, long long s) {
  long long in = i, step = 1;  // sorted[in] == s
  while (i + step < n && sorted[i + step] == s) {
    in = i + step;
    step <<= 1;
  }
  long long out = i + step < n ? i + step : n;  // past the run
  while (out - in > 1) {
    const long long mid = in + ((out - in) >> 1);
    if (sorted[mid] == s) in = mid; else out = mid;
  }
  return out;
}

// acc (flushed) plus the values of rows order[a..e) in row order, loads
// eight rows ahead of the adds; vp NULL adds 1 per row
template <bool FAST, typename F>
__device__ __forceinline__ F walk_short_pass(F acc, const F* __restrict__ vp,
                                             const int* __restrict__ order, long long a,
                                             long long e, unsigned& lo) {
  long long r = a;
  for (; r + 8 <= e; r += 8) {
    int o[8];
    F v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = order[r + k];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = vp ? operand(vp[o[k]]) : F(1);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = add_rn<FAST>(acc, v[k], lo);
  }
  for (; r < e; ++r) acc = add_rn<FAST>(acc, vp ? operand(vp[order[r]]) : F(1), lo);
  return acc;
}

// the fast pass, and the exact one where a partial sum may have been subnormal
template <typename F>
__device__ __forceinline__ F walk_short(F acc, const F* __restrict__ vp,
                                        const int* __restrict__ order, long long a, long long e) {
  return two_pass(operand(acc), [&](auto kind, F x, unsigned& lo) {
    return walk_short_pass<decltype(kind)::fast>(x, vp, order, a, e, lo);
  });
}

// One thread per sorted row: a run's head walks a short run itself and
// lists a run of at least long_run rows for walk_long. runs[0] counts the
// listed runs; runs[1 + 2k], runs[2 + 2k] are run k's first and past-last rows.
__global__ void walk_runs(ScatterArgs args, const long long* __restrict__ sorted,
                          const int* __restrict__ order, long long n, long long cap,
                          long long long_run, long long* __restrict__ runs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long s = sorted[i];
    if (s < 0 || s >= cap || (i > 0 && sorted[i - 1] == s)) continue;
    const long long e = run_end(sorted, i, n, s);
    if (e - i >= long_run) {
      const unsigned long long k = atomicAdd(reinterpret_cast<unsigned long long*>(runs), 1ULL);
      runs[1 + 2 * k] = i;
      runs[2 + 2 * k] = e;
      continue;
    }
    for (int li = 0; li < args.n_ord; ++li) {
      const int l = args.ord_lane[li];
      if (args.dtype[l] == DT_F64) {
        double* st = static_cast<double*>(args.state[l]) + s;
        *st = walk_short(*st, static_cast<const double*>(args.vals[l]), order, i, e);
      } else {
        float* st = static_cast<float*>(args.state[l]) + s;
        *st = walk_short(*st, static_cast<const float*>(args.vals[l]), order, i, e);
      }
    }
  }
}

// chunk c (of `chunk` rows) of the run [a, e): staging thread t loads the
// order of rows a + c chunk + t + k STAGE_THREADS, then each ordered lane's
// value of those rows (its bits; 1 for a lane without values) into buf
__device__ __forceinline__ void stage_chunk(const ScatterArgs& args, const int* __restrict__ order,
                                            long long a, long long e, long long c, int chunk,
                                            unsigned long long* buf, int t) {
  int o[STAGE_ROWS];
#pragma unroll
  for (int k = 0; k < STAGE_ROWS; ++k) {
    const int j = t + k * STAGE_THREADS;
    const long long r = a + c * chunk + j;
    o[k] = j < chunk && r < e ? order[r] : -1;
  }
  for (int li = 0; li < args.n_ord; ++li) {
    const int l = args.ord_lane[li];
    const void* vp = args.vals[l];
    const bool f64 = args.dtype[l] == DT_F64;
    unsigned long long v[STAGE_ROWS];
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k) {
      if (o[k] < 0) continue;
      v[k] = f64 ? (vp ? ftz_bits64(static_cast<const unsigned long long*>(vp)[o[k]])
                       : (unsigned long long)__double_as_longlong(1.0))
                 : (vp ? static_cast<const unsigned*>(vp)[o[k]] : __float_as_uint(1.0f));
    }
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k)
      if (o[k] >= 0) buf[li * chunk + t + k * STAGE_THREADS] = v[k];
  }
}

extern __shared__ unsigned long long stage[];  // walk_long's staged chunks

// x (flushed) plus the len staged values stage[at..at + len) in order
// (staged flushed): the next WALK_AHEAD values are read from shared memory
// while the adds of the ones before run, so the chain waits on the adds alone
#define WALK_AHEAD 32
template <bool FAST, typename F>
__device__ __forceinline__ F walk_staged_pass(F x, int at, int len, unsigned& lo) {
  F cur[WALK_AHEAD], nxt[WALK_AHEAD];
  int r = 0;
  if (len >= WALK_AHEAD) {
#pragma unroll
    for (int k = 0; k < WALK_AHEAD; ++k) cur[k] = from_bits(stage[at + k], x);
    for (; r + 2 * WALK_AHEAD <= len; r += WALK_AHEAD) {
#pragma unroll
      for (int k = 0; k < WALK_AHEAD; ++k) {
        nxt[k] = from_bits(stage[at + r + WALK_AHEAD + k], x);
        x = add_rn<FAST>(x, cur[k], lo);
      }
#pragma unroll
      for (int k = 0; k < WALK_AHEAD; ++k) cur[k] = nxt[k];
    }
#pragma unroll
    for (int k = 0; k < WALK_AHEAD; ++k) x = add_rn<FAST>(x, cur[k], lo);
    r += WALK_AHEAD;
  }
  for (; r < len; ++r) x = add_rn<FAST>(x, from_bits(stage[at + r], x), lo);
  return x;
}

// one staged chunk: the fast pass, and the exact one where a partial sum
// may have been subnormal (the chunk stays staged until the block's next
// barrier)
template <typename F>
__device__ __forceinline__ F walk_staged(F x, int at, int len) {
  return two_pass(operand(x), [&](auto kind, F y, unsigned& lo) {
    return walk_staged_pass<decltype(kind)::fast>(y, at, len, lo);
  });
}

// One block per listed run: STAGE_THREADS threads stage chunk c + 1 while
// lane 0 of each of the first `walkers` warps adds chunk c of its lanes
// (lanes w, w + walkers, ...). blockDim.x = 32 * walkers + STAGE_THREADS;
// dynamic shared memory 2 * n_ord * chunk words.
__global__ void walk_long(ScatterArgs args, const long long* __restrict__ sorted,
                          const int* __restrict__ order, const long long* __restrict__ runs,
                          int walkers, int chunk) {
  __shared__ unsigned long long acc[MAX_LANES];  // each ordered lane's sum, as bits
  const long long n_runs = runs[0];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stager = (int)threadIdx.x - 32 * walkers;  // < 0 on a walker warp
  const bool walker = warp < walkers && lane == 0;
  const int chunk_words = args.n_ord * chunk;
  for (long long k = blockIdx.x; k < n_runs; k += gridDim.x) {
    const long long a = runs[1 + 2 * k], e = runs[2 + 2 * k];
    const long long s = sorted[a];
    const long long chunks = (e - a + chunk - 1) / chunk;
    if (stager >= 0) stage_chunk(args, order, a, e, 0, chunk, stage, stager);
    if (walker)
      for (int li = warp; li < args.n_ord; li += walkers) {
        const int l = args.ord_lane[li];
        acc[li] = args.dtype[l] == DT_F64
                      ? static_cast<const unsigned long long*>(args.state[l])[s]
                      : static_cast<const unsigned*>(args.state[l])[s];
      }
    __syncthreads();
    for (long long c = 0; c < chunks; ++c) {
      if (stager >= 0 && c + 1 < chunks)
        stage_chunk(args, order, a, e, c + 1, chunk, stage + ((c + 1) & 1) * chunk_words, stager);
      if (walker) {
        const int len = (int)min((long long)chunk, e - a - c * chunk);
        for (int li = warp; li < args.n_ord; li += walkers) {
          const int at = (int)(c & 1) * chunk_words + li * chunk;
          if (args.dtype[args.ord_lane[li]] == DT_F64)
            acc[li] = (unsigned long long)__double_as_longlong(
                walk_staged(__longlong_as_double((long long)acc[li]), at, len));
          else
            acc[li] = __float_as_uint(walk_staged(__uint_as_float((unsigned)acc[li]), at, len));
        }
      }
      __syncthreads();
    }
    if (walker)
      for (int li = warp; li < args.n_ord; li += walkers) {
        const int l = args.ord_lane[li];
        if (args.dtype[l] == DT_F64)
          static_cast<unsigned long long*>(args.state[l])[s] = acc[li];
        else
          static_cast<unsigned*>(args.state[l])[s] = (unsigned)acc[li];
      }
  }
}

// The chain floor: one thread adds x[1] to x[0] n times, each add waiting
// on the one before (float32 add.rn.ftz.f32 if f32, else bare __dadd_rn);
// out[0] keeps the sum.
__global__ void add_chain_kernel(const double* __restrict__ x, long long n, int f32,
                                 double* __restrict__ out) {
  if (f32) {
    float acc = (float)x[0];
    const float d = (float)x[1];
    unsigned lo = ~0u;
    for (long long i = 0; i < n; ++i) acc = add_rn<true>(acc, d, lo);
    out[0] = acc;
  } else {
    double acc = x[0];
    const double d = x[1];
    for (long long i = 0; i < n; ++i) acc = __dadd_rn(acc, d);
    out[0] = acc;
  }
}

// A float32's bits widened to a float64's as XLA widens on the CPU and
// the TPU (the reference's astype(float64)): a subnormal flushes to the
// zero of its sign.
__device__ __forceinline__ unsigned long long widen_f32(unsigned x) {
  if ((x & 0x7f800000u) == 0u) x &= 0x80000000u;
  return (unsigned long long)__double_as_longlong((double)__uint_as_float(x));
}

// A 4-byte lane's word widened to 64 bits: an int32 sign-extended, a
// float32 as the double's bits (widen_f32).
__device__ __forceinline__ unsigned long long widen(int dt, unsigned x) {
  return dt == DT_I32 ? (unsigned long long)(long long)(int)x : widen_f32(x);
}

// K2 / K3 on one lane of one quad: w holds the quad's four slots widened,
// `in` marks the slots inside the region (all four on the vector path).
template <bool READ, bool CLEAR>
__device__ __forceinline__ void region_lane(const RegionArgs& a, int l, unsigned mask,
                                            long long qbase, unsigned q, int head, unsigned R,
                                            bool full, long long* ibuf, double* fbuf) {
  const int dt = a.dtype[l];
  const bool w8 = dt == DT_I64 || dt == DT_U64 || dt == DT_F64;
  // the quad's first slot: qbase (the region's base rounded down to a
  // multiple of four) + 4q, so a lane aligned to 16 bytes is aligned here
  char* lane = static_cast<char*>(a.state[l]);
  const bool vec = full && ((reinterpret_cast<uintptr_t>(lane) & 15) == 0);
  const unsigned r0 = 4u * q - (unsigned)head;  // region offset of the quad's first slot (wraps below 0)
  unsigned long long w[4];
  bool in[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) in[e] = vec || (r0 + (unsigned)e < R);
  if (w8) {
    unsigned long long* p = reinterpret_cast<unsigned long long*>(lane) + qbase + 4u * q;
    if (READ) {
      if (vec) {
        const ulonglong2 x0 = reinterpret_cast<const ulonglong2*>(p)[0];
        const ulonglong2 x1 = reinterpret_cast<const ulonglong2*>(p)[1];
        w[0] = x0.x; w[1] = x0.y; w[2] = x1.x; w[3] = x1.y;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = in[e] ? p[e] : 0ULL;
      }
    }
    if (CLEAR) {
      const unsigned long long id = a.ident[l];
      if (vec) {
        reinterpret_cast<ulonglong2*>(p)[0] = make_ulonglong2(id, id);
        reinterpret_cast<ulonglong2*>(p)[1] = make_ulonglong2(id, id);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (in[e]) p[e] = id;
      }
    }
  } else {
    unsigned* p = reinterpret_cast<unsigned*>(lane) + qbase + 4u * q;
    if (READ) {
      if (vec) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        w[0] = widen(dt, x.x); w[1] = widen(dt, x.y); w[2] = widen(dt, x.z); w[3] = widen(dt, x.w);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = in[e] ? widen(dt, p[e]) : 0ULL;
      }
    }
    if (CLEAR) {
      const unsigned id = (unsigned)a.ident[l];
      if (vec) {
        *reinterpret_cast<uint4*>(p) = make_uint4(id, id, id, id);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (in[e]) p[e] = id;
      }
    }
  }
  if (!READ) return;
  const bool flt = is_float(dt);
  const long long n_cls = flt ? a.n_flt : a.n_int;
  unsigned long long* out0 = flt ? reinterpret_cast<unsigned long long*>(fbuf)
                                 : reinterpret_cast<unsigned long long*>(ibuf);
  // every output position j that reads this region: block (j, pos) of R words
  for (unsigned m = mask; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    unsigned long long* o = out0 + (j * n_cls + a.pos[l]) * (long long)R;
    if (full && ((reinterpret_cast<uintptr_t>(o + r0) & 15) == 0)) {
      reinterpret_cast<ulonglong2*>(o + r0)[0] = make_ulonglong2(w[0], w[1]);
      reinterpret_cast<ulonglong2*>(o + r0)[1] = make_ulonglong2(w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (in[e]) o[r0 + (unsigned)e] = w[e];
    }
  }
}

// K2 (READ, READ | CLEAR) and K3 (CLEAR). blockIdx.y: the distinct
// region, blockIdx.z: the lane, so a thread's accesses are one round trip
// to memory, and the lane's dtype is uniform across the block. The
// region's slots [base, base + R) lie in the quads of four slots q = 0 ..
// nq - 1 from the base rounded down to a multiple of four; a thread takes
// quads blockIdx.x * blockDim.x + threadIdx.x apart by the grid's width.
// All index arithmetic past the region's base is 32-bit (R < 2^31).
template <bool READ, bool CLEAR>
__global__ void __launch_bounds__(REGION_THREADS)
    region_kernel(RegionArgs a, unsigned R, long long* __restrict__ ibuf,
                  double* __restrict__ fbuf) {
  const long long base = a.base[blockIdx.y];
  const int head = (int)(base & 3);  // slots of the first quad before the region
  const long long qbase = base - head;
  const unsigned nq = (unsigned)(head + R + 3) >> 2;
  const unsigned mask = READ ? a.mask[blockIdx.y] : 0u;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < nq; q += gridDim.x * blockDim.x) {
    const unsigned r0 = 4u * q - (unsigned)head;
    const bool full = (q > 0 || head == 0) && R >= 4u && r0 <= R - 4u;
    region_lane<READ, CLEAR>(a, blockIdx.z, mask, qbase, q, head, R, full, ibuf, fbuf);
  }
}

// The launch floor: a kernel that does nothing, launched on K2's grid.
__global__ void empty_kernel() {}

// K2 / K3's grid for R slots from each of n_distinct bases of n_lanes
// lanes: blocks of REGION_THREADS threads, a thread a quad of one lane, as
// many blocks along x as the region with the most quads needs (at most ~16
// blocks of 128 threads per SM over the whole grid; the threads then take
// several quads each), the regions along y, the lanes along z.
static dim3 region_grid(const long long* bases, int n_distinct, long long R, int n_lanes) {
  long long nq = 0;
  for (int d = 0; d < n_distinct; ++d) {
    const long long n = ((bases[d] & 3) + R + 3) / 4;
    if (n > nq) nq = n;
  }
  long long bx = (nq + REGION_THREADS - 1) / REGION_THREADS;
  const long long cap = (132LL * 16) / ((long long)n_distinct * n_lanes);
  if (bx > cap) bx = cap;
  return dim3((unsigned)(bx < 1 ? 1 : bx), (unsigned)n_distinct, (unsigned)n_lanes);
}

// K7's read of one state word at slot s, widened: an 8-byte lane's bits
// as they are (int64, uint64, float64), an int32 sign-extended, a float32
// as widen_f32 widens it.
template <int DT>
__device__ __forceinline__ unsigned long long gather_word(const void* __restrict__ st,
                                                          long long s) {
  if constexpr (DT == DT_I32)
    return (unsigned long long)(long long)__ldg(static_cast<const int*>(st) + s);
  else if constexpr (DT == DT_F32)
    return widen_f32(__ldg(static_cast<const unsigned*>(st) + s));
  else
    return __ldg(static_cast<const unsigned long long*>(st) + s);
}

// K7 on one lane: a thread takes the quads of four gathered positions
// blockIdx.x * blockDim.x + threadIdx.x apart by the grid's width. Its
// slots in one 16-byte load (two of int64 slots), then its four state
// reads, then its stores: no store lies between two of its loads.
template <typename SlotT, int DT>
__device__ __forceinline__ void gather_lane(const void* __restrict__ st,
                                            unsigned long long* __restrict__ o,
                                            const SlotT* __restrict__ slots, long long k,
                                            long long cap) {
  const bool slots_vec = (reinterpret_cast<uintptr_t>(slots) & 15) == 0;
  const bool out_vec = (reinterpret_cast<uintptr_t>(o) & 15) == 0;
  const long long nq = (k + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < nq; q += stride) {
    const long long i0 = q << 2;
    const bool full = i0 + 4 <= k;
    long long s[4];
    if (full && slots_vec) {
      if constexpr (sizeof(SlotT) == 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(slots + i0));
        s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
      } else {
        const longlong2 x0 = __ldg(reinterpret_cast<const longlong2*>(slots + i0));
        const longlong2 x1 = __ldg(reinterpret_cast<const longlong2*>(slots + i0) + 1);
        s[0] = x0.x; s[1] = x0.y; s[2] = x1.x; s[3] = x1.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = i0 + e < k ? (long long)__ldg(slots + i0 + e) : -1LL;
    }
    unsigned long long w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (s[e] >= 0 && s[e] < cap) ? gather_word<DT>(st, s[e]) : 0ULL;
    if (full && out_vec) {
      reinterpret_cast<ulonglong2*>(o + i0)[0] = make_ulonglong2(w[0], w[1]);
      reinterpret_cast<ulonglong2*>(o + i0)[1] = make_ulonglong2(w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e < k) o[i0 + e] = w[e];
    }
  }
}

// K7. blockIdx.y: the lane, so the dtype is chosen once per thread.
template <typename SlotT>
__global__ void gather_kernel(GatherArgs a, const SlotT* __restrict__ slots, long long k,
                              long long cap) {
  const int l = blockIdx.y;
  switch (a.dtype[l]) {
    case DT_I32:
      gather_lane<SlotT, DT_I32>(a.state[l], a.out[l], slots, k, cap);
      break;
    case DT_F32:
      gather_lane<SlotT, DT_F32>(a.state[l], a.out[l], slots, k, cap);
      break;
    default:  // int64, uint64, float64: the bits as they are
      gather_lane<SlotT, DT_I64>(a.state[l], a.out[l], slots, k, cap);
      break;
  }
}

// K7's grid for k slots of n_lanes lanes: a quad a thread along x, not
// capped (a grid capped at the card's resident threads, each thread
// walking four quads, read slower at the deployment state, PERF.md), the
// lanes along y.
static dim3 gather_grid(long long k, int n_lanes) {
  const long long bx = ((k + 3) / 4 + GATHER_THREADS - 1) / GATHER_THREADS;
  return dim3((unsigned)(bx < 1 ? 1 : bx), (unsigned)n_lanes, 1);
}

static std::atomic<long long> g_gather_launches{0};

static int grid_for(long long n) {
  long long blocks = (n + THREADS - 1) / THREADS;
  const long long cap = 132LL * 16;  // 16 blocks of 256 threads per SM fill the H100
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

extern "C" {

// K1. sorted, order: for a float add lane, the slots sorted stably and
// each sorted row's index (K5 arroyo_join_sort_pairs of the slots in range
// mode, on the same stream); runs: 1 + 2 * runs_cap int64 words, room for
// every run of at least long_run rows (runs_cap >= n / long_run); all three
// NULL when no lane is a float add lane.
int arroyo_slot_scatter_combine(int device, void** state, const void** vals, const int* kinds,
                                const int* dtypes, int n_lanes, const void* slots, int slots_i64,
                                long long n, long long cap, const void* sorted, const void* order,
                                void* runs, long long runs_cap, long long long_run,
                                void* stream) {
  if (n_lanes < 1 || n_lanes > MAX_LANES || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ScatterArgs args;
  int n_ordered = 0;
  for (int l = 0; l < n_lanes; ++l) {
    args.state[l] = state[l];
    args.vals[l] = vals[l];
    args.kind[l] = kinds[l];
    args.dtype[l] = dtypes[l];
    args.ordered[l] = kinds[l] == KIND_ADD && is_float(dtypes[l]);
    if (args.ordered[l]) args.ord_lane[n_ordered++] = l;
  }
  args.n_lanes = n_lanes;
  args.n_ord = n_ordered;
  if (n_ordered && (sorted == nullptr || order == nullptr || runs == nullptr || long_run < 1 ||
                    runs_cap < n / long_run))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ordered < n_lanes) {
    if (slots_i64)
      scatter_combine_kernel<long long><<<grid_for(n), THREADS, 0, s>>>(
          args, static_cast<const long long*>(slots), n, cap);
    else
      scatter_combine_kernel<int><<<grid_for(n), THREADS, 0, s>>>(
          args, static_cast<const int*>(slots), n, cap);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (!n_ordered) return (int)cudaSuccess;
  const long long* sk = static_cast<const long long*>(sorted);
  const int* ord = static_cast<const int*>(order);
  long long* rl = static_cast<long long*>(runs);
  if ((err = cudaMemsetAsync(rl, 0, sizeof(long long), s)) != cudaSuccess) return (int)err;
  walk_runs<<<grid_for(n), THREADS, 0, s>>>(args, sk, ord, n, cap, long_run, rl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n < long_run) return (int)cudaSuccess;  // no run can be long
  const int walkers = n_ordered < MAX_WALKERS ? n_ordered : MAX_WALKERS;
  // two chunks of every ordered lane in shared memory: at most 128 KB
  const int chunk = n_ordered <= 8 ? STAGE_THREADS * STAGE_ROWS : STAGE_THREADS;
  const size_t smem = 2 * (size_t)n_ordered * chunk * sizeof(unsigned long long);
  if ((err = cudaFuncSetAttribute(walk_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  long long blocks = n / long_run;
  if (blocks > 132LL * 2) blocks = 132LL * 2;
  walk_long<<<(unsigned)blocks, 32 * walkers + STAGE_THREADS, smem, s>>>(args, sk, ord, rl,
                                                                        walkers, chunk);
  return (int)cudaGetLastError();
}

// The chain floor's probe (chip_smoke.py only): add_chain_kernel on one
// thread; x holds two doubles (start, step), out one.
int arroyo_slot_add_chain(int device, const void* x, long long n, int f32, void* out,
                          void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), n, f32, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

#define REGION_READ 1
#define REGION_CLEAR 2

// K2 and K3. mode: REGION_READ, REGION_READ | REGION_CLEAR or REGION_CLEAR.
// bases: the n_distinct distinct bases; masks[d]: the output positions
// (bits 0 .. k-1) that read base d, each position in exactly one mask
// (ignored, and k 0, in REGION_CLEAR alone). idents: every lane's identity
// bits (REGION_CLEAR), else NULL. ibuf / fbuf: k x n_int x R int64 and
// k x n_flt x R float64 words (REGION_READ). The caller keeps distinct
// regions apart in the read-and-clear mode.
int arroyo_slot_region(int device, void** state, const int* dtypes,
                       const unsigned long long* idents, int n_lanes, const long long* bases,
                       const unsigned* masks, int n_distinct, int k, long long R, int mode,
                       void* ibuf, void* fbuf, void* stream) {
  const bool read = mode & REGION_READ, clear = mode & REGION_CLEAR;
  if (n_lanes < 1 || n_lanes > MAX_LANES || n_distinct < 1 || n_distinct > MAX_BASES || R < 1 ||
      R >= (1LL << 31) || (mode & ~(REGION_READ | REGION_CLEAR)) || !(read || clear) ||
      (clear && idents == nullptr))
    return (int)cudaErrorInvalidValue;
  RegionArgs a;
  if (read) {
    if (k < 1 || k > MAX_BASES) return (int)cudaErrorInvalidValue;
    unsigned seen = 0;
    for (int d = 0; d < n_distinct; ++d) {
      if (masks[d] == 0 || (masks[d] & seen) || (masks[d] >> k)) return (int)cudaErrorInvalidValue;
      seen |= masks[d];
    }
    if (seen != (1u << k) - 1) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int n_int = 0, n_flt = 0;
  for (int l = 0; l < n_lanes; ++l) {
    a.state[l] = state[l];
    a.dtype[l] = dtypes[l];
    a.pos[l] = is_float(dtypes[l]) ? n_flt++ : n_int++;
    a.ident[l] = clear ? idents[l] : 0ULL;
  }
  for (int d = 0; d < n_distinct; ++d) {
    a.base[d] = bases[d];
    a.mask[d] = read ? masks[d] : 0u;
  }
  a.n_lanes = n_lanes;
  a.n_int = n_int;
  a.n_flt = n_flt;
  const dim3 grid = region_grid(bases, n_distinct, R, n_lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* ib = static_cast<long long*>(ibuf);
  double* fb = static_cast<double*>(fbuf);
  if (read && clear)
    region_kernel<true, true><<<grid, REGION_THREADS, 0, s>>>(a, (unsigned)R, ib, fb);
  else if (read)
    region_kernel<true, false><<<grid, REGION_THREADS, 0, s>>>(a, (unsigned)R, ib, fb);
  else
    region_kernel<false, true><<<grid, REGION_THREADS, 0, s>>>(a, (unsigned)R, ib, fb);
  return (int)cudaGetLastError();
}

// K2 / K3's grid for these distinct bases and lanes (chip_smoke.py times
// empty_kernel on it): out[0..3] = blocks along x, y and z, threads a block.
void arroyo_slot_region_grid(const long long* bases, int n_distinct, long long R, int n_lanes,
                             int* out) {
  const dim3 g = region_grid(bases, n_distinct, R, n_lanes);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = (int)g.z;
  out[3] = REGION_THREADS;
}

// The launch floor's probe (chip_smoke.py only): empty_kernel on a grid of
// grid_x x grid_y x grid_z blocks of `threads`.
int arroyo_slot_empty(int device, int grid_x, int grid_y, int grid_z, int threads,
                      void* stream) {
  if (grid_x < 1 || grid_y < 1 || grid_z < 1 || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<dim3(grid_x, grid_y, grid_z), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// K7. out: the packed output, 16-byte aligned: the int lanes' k words
// each from byte 0, the float lanes' from byte flt_offset (a multiple of
// 16), each class in lane order.
int arroyo_slot_gather(int device, void** state, const int* dtypes, int n_lanes,
                       const void* slots, int slots_i64, long long k, long long cap, void* out,
                       long long flt_offset, void* stream) {
  if (n_lanes < 1 || n_lanes > MAX_LANES || k < 1 || k >= (1LL << 37) || flt_offset < 0 ||
      flt_offset % 16 || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GatherArgs a;
  int n_int = 0, n_flt = 0;
  char* base = static_cast<char*>(out);
  for (int l = 0; l < n_lanes; ++l) {
    a.state[l] = state[l];
    a.dtype[l] = dtypes[l];
    const int pos = is_float(dtypes[l]) ? n_flt++ : n_int++;
    a.out[l] = reinterpret_cast<unsigned long long*>(base + (is_float(dtypes[l]) ? flt_offset : 0)) +
               (long long)pos * k;
  }
  const dim3 grid = gather_grid(k, n_lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots_i64)
    gather_kernel<long long><<<grid, GATHER_THREADS, 0, s>>>(
        a, static_cast<const long long*>(slots), k, cap);
  else
    gather_kernel<int><<<grid, GATHER_THREADS, 0, s>>>(a, static_cast<const int*>(slots), k, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_gather_launches;
  return (int)cudaSuccess;
}

// Kernels K7 has launched in this process: the difference across one call
// is that call's launches.
long long arroyo_slot_gather_kernel_launches(void) { return g_gather_launches.load(); }

}  // extern "C"
