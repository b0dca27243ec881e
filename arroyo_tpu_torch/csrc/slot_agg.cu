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
//      _pack: for k region bases, R slots of every lane, int lanes widened
//      into one int64 buffer (uint64 as its bits, as _pack's
//      astype(int64)) and float lanes into one float64 buffer, laid out
//      [base][lane of its class][R].
//   K3 slot_region_clear     replaces _clear / clear: R slots from each
//      base reset to the lane's identity. After a read with clear it runs
//      as a second launch on the same stream: bases may repeat (the host
//      pads k to a power of two by duplicating the first base), so one
//      pass that read and cleared could clear a region before its
//      duplicate was read.
//   K7 slot_gather           replaces _build_slot_jax make_read_slots.go:
//      for k slots (int32 or int64 indices), every lane's value at each
//      slot, widened as K2 widens, laid out [lane of its class][k]. A slot
//      outside [0, cap) reads 0. The updating aggregate's flush reads its
//      touched keys with it; it launches on the stream of the K1 launches
//      it must see, so it reads their sums.
//
// Bound on the H100 (3.35 TB/s HBM, 50 MB L2): all four move a few bytes
// per element and do no arithmetic to speak of, so each is bound by bytes.
// K1 reads 4 or 8 bytes of slot and 8 of value per row and updates the
// touched state words; q7's state (65536 slots x 3 lanes x 8 B = 1.5 MB)
// sits in L2, so the atomics resolve there and skewed keys (hot auctions)
// serialise on their slots. The design reads each row's slot once and
// walks the lanes in a loop inside the thread, so the slot load is shared
// and neighbouring threads touch neighbouring rows (coalesced loads of
// slots and values). K2 and K3 stream R contiguous slots per lane; one
// thread per output element, neighbouring threads on neighbouring slots,
// so every load and store is coalesced. K7 gives one thread to each
// gathered slot: the slot is loaded once (coalesced) and the thread walks
// the lanes, so each lane's random read of the state is independent of the
// others and the stores to [lane][k] are coalesced. Its bound is the bytes
// of the slots, the gathered words and the widened output; the state reads
// are random, so each costs a 32-byte sector unless the state sits in L2
// (qu's 262144 slots x 4 lanes x 8 B = 8 MB does). The lane table and the
// bases are passed by value in the kernel parameters: no device
// allocation and no host-to-device copy for them.
//
// Exactness. Integer adds wrap (two's complement, as XLA's); integer
// min/max are atomics, exact in any order (uint64 with the unsigned
// atomics). Float min/max: XLA's scatter-min/max propagates NaN and orders
// -0.0 below +0.0, whatever the order of the rows; the CAS loops below keep
// the same order, so the result does not depend on the order the atomics
// land in. Float sums do depend on the order: the reference adds each
// slot's rows one after another in batch order, starting from the state
// value. So a float add lane takes no atomic: the caller first sorts the
// slots stably with K5 (csrc/join_probe.cu, arroyo_join_sort_pairs: equal
// slots keep their row order), and one thread per run of equal slots walks
// its rows in order from state[slot] (__dadd_rn / __fadd_rn, no
// contraction). A hot slot's run costs its length serially.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LANES 32
#define MAX_BASES 16
#define THREADS 256

enum { KIND_ADD = 0, KIND_MIN = 1, KIND_MAX = 2 };
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3, DT_U64 = 4 };

struct ScatterArgs {
  void* state[MAX_LANES];
  const void* vals[MAX_LANES];  // NULL: the lane adds 1 per row
  int kind[MAX_LANES];
  int dtype[MAX_LANES];
  int ordered[MAX_LANES];  // a float add lane: summed in row order, not by atomics
  int n_lanes;
};

__host__ __device__ __forceinline__ bool is_float(int dt) { return dt == DT_F32 || dt == DT_F64; }

struct PackArgs {
  const void* state[MAX_LANES];
  int dtype[MAX_LANES];
  int pos[MAX_LANES];  // the lane's index among the lanes of its class
  long long bases[MAX_BASES];
  int n_lanes;
  int n_int;
  int n_flt;
  int k;
};

struct GatherArgs {
  const void* state[MAX_LANES];
  int dtype[MAX_LANES];
  int pos[MAX_LANES];  // the lane's index among the lanes of its class
  int n_lanes;
};

struct ClearArgs {
  void* state[MAX_LANES];
  int dtype[MAX_LANES];
  unsigned long long ident[MAX_LANES];  // identity bit pattern, low bytes used for 32-bit lanes
  long long bases[MAX_BASES];
  int n_lanes;
  int k;
};

// v replaces old under the NaN-propagating order with -0.0 < +0.0
template <bool IS_MIN, typename F>
__device__ __forceinline__ bool replaces(F v, F old) {
  if (isnan(old)) return false;
  if (isnan(v)) return true;
  if (IS_MIN) return v < old || (v == old && signbit(v) && !signbit(old));
  return v > old || (v == old && !signbit(v) && signbit(old));
}

template <bool IS_MIN>
__device__ __forceinline__ void minmax_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (replaces<IS_MIN>(v, __longlong_as_double((long long)old))) {
    unsigned long long prev = atomicCAS(a, old, (unsigned long long)__double_as_longlong(v));
    if (prev == old) return;
    old = prev;
  }
}

template <bool IS_MIN>
__device__ __forceinline__ void minmax_f32(float* addr, float v) {
  unsigned int* a = reinterpret_cast<unsigned int*>(addr);
  unsigned int old = *a;
  while (replaces<IS_MIN>(v, __uint_as_float(old))) {
    unsigned int prev = atomicCAS(a, old, __float_as_uint(v));
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

// one thread per run of equal slots in K5's output (the slots sorted
// stably, with each row's index): each float add lane's rows added one
// after another in row order from the state value
__global__ void ord_walk(ScatterArgs args, const long long* __restrict__ sorted,
                         const int* __restrict__ order, long long n, long long cap) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long s = sorted[i];
    if (s < 0 || s >= cap || (i > 0 && sorted[i - 1] == s)) continue;
    long long end = i + 1;
    while (end < n && sorted[end] == s) ++end;
    for (int l = 0; l < args.n_lanes; ++l) {
      if (!args.ordered[l]) continue;
      const void* vp = args.vals[l];
      if (args.dtype[l] == DT_F64) {
        double* st = static_cast<double*>(args.state[l]) + s;
        double acc = *st;
        for (long long r = i; r < end; ++r)
          acc = __dadd_rn(acc, vp ? static_cast<const double*>(vp)[order[r]] : 1.0);
        *st = acc;
      } else {
        float* st = static_cast<float*>(args.state[l]) + s;
        float acc = *st;
        for (long long r = i; r < end; ++r)
          acc = __fadd_rn(acc, vp ? static_cast<const float*>(vp)[order[r]] : 1.0f);
        *st = acc;
      }
    }
  }
}

__global__ void read_pack_kernel(PackArgs a, long long R, long long* __restrict__ ibuf,
                                 double* __restrict__ fbuf) {
  const long long total = (long long)a.k * a.n_lanes * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += stride) {
    const long long r = idx % R;
    const long long t = idx / R;
    const int lane = (int)(t % a.n_lanes);
    const int j = (int)(t / a.n_lanes);
    const long long src = a.bases[j] + r;
    const void* st = a.state[lane];
    switch (a.dtype[lane]) {
      case DT_I64:
      case DT_U64:  // the bits as they are
        ibuf[((long long)j * a.n_int + a.pos[lane]) * R + r] = static_cast<const long long*>(st)[src];
        break;
      case DT_I32:
        ibuf[((long long)j * a.n_int + a.pos[lane]) * R + r] = (long long)static_cast<const int*>(st)[src];
        break;
      case DT_F64:
        fbuf[((long long)j * a.n_flt + a.pos[lane]) * R + r] = static_cast<const double*>(st)[src];
        break;
      default:
        fbuf[((long long)j * a.n_flt + a.pos[lane]) * R + r] = (double)static_cast<const float*>(st)[src];
        break;
    }
  }
}

__global__ void clear_kernel(ClearArgs a, long long R) {
  const long long total = (long long)a.k * a.n_lanes * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += stride) {
    const long long r = idx % R;
    const long long t = idx / R;
    const int lane = (int)(t % a.n_lanes);
    const int j = (int)(t / a.n_lanes);
    const long long dst = a.bases[j] + r;
    const unsigned long long id = a.ident[lane];
    if (a.dtype[lane] == DT_I64 || a.dtype[lane] == DT_U64 || a.dtype[lane] == DT_F64)
      static_cast<unsigned long long*>(a.state[lane])[dst] = id;
    else
      static_cast<unsigned int*>(a.state[lane])[dst] = (unsigned int)id;
  }
}

template <typename SlotT>
__global__ void gather_kernel(GatherArgs a, const SlotT* __restrict__ slots, long long k,
                              long long cap, long long* __restrict__ ibuf,
                              double* __restrict__ fbuf) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += stride) {
    const long long s = (long long)slots[i];
    const bool ok = s >= 0 && s < cap;
    for (int l = 0; l < a.n_lanes; ++l) {
      const void* st = a.state[l];
      const long long o = (long long)a.pos[l] * k + i;
      switch (a.dtype[l]) {
        case DT_I64:
        case DT_U64:  // the bits as they are
          ibuf[o] = ok ? static_cast<const long long*>(st)[s] : 0LL;
          break;
        case DT_I32:
          ibuf[o] = ok ? (long long)static_cast<const int*>(st)[s] : 0LL;
          break;
        case DT_F64:
          fbuf[o] = ok ? static_cast<const double*>(st)[s] : 0.0;
          break;
        default:
          fbuf[o] = ok ? (double)static_cast<const float*>(st)[s] : 0.0;
          break;
      }
    }
  }
}

static int grid_for(long long n) {
  long long blocks = (n + THREADS - 1) / THREADS;
  const long long cap = 132LL * 16;  // 16 blocks of 256 threads per SM fill the H100
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

extern "C" {

// K1. sorted, order: for a float add lane, the slots sorted stably and
// each sorted row's index (K5 arroyo_join_sort_pairs of the slots, on the
// same stream); NULL when no lane is a float add lane.
int arroyo_slot_scatter_combine(int device, void** state, const void** vals, const int* kinds,
                                const int* dtypes, int n_lanes, const void* slots, int slots_i64,
                                long long n, long long cap, const void* sorted, const void* order,
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
    n_ordered += args.ordered[l];
  }
  args.n_lanes = n_lanes;
  if (n_ordered && (sorted == nullptr || order == nullptr)) return (int)cudaErrorInvalidValue;
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
  if (n_ordered)
    ord_walk<<<grid_for(n), THREADS, 0, s>>>(args, static_cast<const long long*>(sorted),
                                             static_cast<const int*>(order), n, cap);
  return (int)cudaGetLastError();
}

int arroyo_slot_region_read_pack(int device, void** state, const int* dtypes, int n_lanes,
                                 const long long* bases, int k, long long R, void* ibuf,
                                 void* fbuf, void* stream) {
  if (n_lanes < 1 || n_lanes > MAX_LANES || k < 1 || k > MAX_BASES || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PackArgs a;
  int n_int = 0, n_flt = 0;
  for (int l = 0; l < n_lanes; ++l) {
    a.state[l] = state[l];
    a.dtype[l] = dtypes[l];
    a.pos[l] = is_float(dtypes[l]) ? n_flt++ : n_int++;
  }
  for (int j = 0; j < k; ++j) a.bases[j] = bases[j];
  a.n_lanes = n_lanes;
  a.n_int = n_int;
  a.n_flt = n_flt;
  a.k = k;
  read_pack_kernel<<<grid_for((long long)k * n_lanes * R), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, R, static_cast<long long*>(ibuf), static_cast<double*>(fbuf));
  return (int)cudaGetLastError();
}

int arroyo_slot_region_clear(int device, void** state, const int* dtypes,
                             const unsigned long long* idents, int n_lanes,
                             const long long* bases, int k, long long R, void* stream) {
  if (n_lanes < 1 || n_lanes > MAX_LANES || k < 1 || k > MAX_BASES || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ClearArgs a;
  for (int l = 0; l < n_lanes; ++l) {
    a.state[l] = state[l];
    a.dtype[l] = dtypes[l];
    a.ident[l] = idents[l];
  }
  for (int j = 0; j < k; ++j) a.bases[j] = bases[j];
  a.n_lanes = n_lanes;
  a.k = k;
  clear_kernel<<<grid_for((long long)k * n_lanes * R), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, R);
  return (int)cudaGetLastError();
}

int arroyo_slot_gather(int device, void** state, const int* dtypes, int n_lanes,
                       const void* slots, int slots_i64, long long k, long long cap, void* ibuf,
                       void* fbuf, void* stream) {
  if (n_lanes < 1 || n_lanes > MAX_LANES || k < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GatherArgs a;
  int n_int = 0, n_flt = 0;
  for (int l = 0; l < n_lanes; ++l) {
    a.state[l] = state[l];
    a.dtype[l] = dtypes[l];
    a.pos[l] = is_float(dtypes[l]) ? n_flt++ : n_int++;
  }
  a.n_lanes = n_lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots_i64)
    gather_kernel<long long><<<grid_for(k), THREADS, 0, s>>>(
        a, static_cast<const long long*>(slots), k, cap, static_cast<long long*>(ibuf),
        static_cast<double*>(fbuf));
  else
    gather_kernel<int><<<grid_for(k), THREADS, 0, s>>>(
        a, static_cast<const int*>(slots), k, cap, static_cast<long long*>(ibuf),
        static_cast<double*>(fbuf));
  return (int)cudaGetLastError();
}

}  // extern "C"
