// Single-device hash-table kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (arroyo_tpu_torch/ops/hash_kernels.py
// builds this file with nvcc at first use and holds each kernel against its
// plain PyTorch version).
//
// The single-device aggregate keeps one open-addressing table (keys int64,
// bins int32, occ bool, one [cap] array per lane) on the device. Its step
// is K8 + K9 and its close K11 (csrc/sharded_agg.cu, at one shard); the
// two reads that neither covers are here. They replace programs of
// arroyo_tpu/ops/aggregate.py _build_jax (B9):
//
//   K12 hash_scan_walk   the reference's chunked read of a range
//       (aggregate.py scan_range :752-762, one scan (:331-342) per
//       emit_cap chunk of the table): every slot that is occupied with
//       emit_lo <= bin < emit_hi, in slot order, compacted into rows, with
//       their count, in one launch of csrc/table_compact.cuh's compaction
//       (its WALK mode). That is the concatenation of the chunks' valid
//       rows, whatever emit_cap is: the walk stops at cap, and the
//       reference's clamped positions past it are never valid.
//   K12 hash_scan_chunk  scan itself, one chunk: the emit_cap slots from
//       chunk_start and their flags, read without freeing; a position past
//       cap reads slot cap - 1 (what the reference's gather does: XLA
//       clamps an out-of-bounds index) and is never valid.
//   K13 hash_free        free (:344-348): occ &= !(bin < below), in place.
//       Any cap, any alignment: the table's own arrays and, in
//       chip_smoke.py's edge cases, odd lengths and offset views.
//
// Bounds (H100, 3.35 TB/s): all three move a few bytes per slot and
// compute nothing, so they are bound by bytes. The walk reads every
// slot's occupancy, the occupied slots' bins and the valid slots' key and
// lanes, and writes those rows once (see csrc/table_compact.cuh for the
// tiles and the look-back). The chunk reads and writes emit_cap rows (key,
// bin, flag, lanes), one thread per row, neighbouring threads on
// neighbouring slots: every load and store is coalesced. K13 must read
// every slot's occupancy, the occupied slots' bins, and write the freed
// slots' bytes; at q7's table (65,536 slots) that is ~0.1 us of bytes, so
// a call is launch latency and what its stores cost to drain. A thread
// takes a 16-byte word of occupancy (16 slots): one 16-byte load of it;
// only if a byte of it is set, its 16 bins in four 16-byte loads; and one
// 16-byte store of the new word, only if it changed. An empty or untouched
// word costs one load and no store. The word past the last multiple of 16
// slots, and occupancy or bins off a 16-byte boundary, take byte and int
// accesses in the same code (occupied slots' bins only, changed bytes
// only). Blocks of 64 threads (tools/block_sweep.py against 128 and 256:
// fastest at q7's table, the hop drive's and a 4,194,304-slot one): q7's
// table is 4,096 words, 64 blocks. The bins' load waits on the occupancy
// word's (~0.25 us at q7's table, PERF.md); it saves the empty words'
// bins, 4 bytes a slot, where a table is large.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError(); K13 counts its launches
// (arroyo_hash_free_kernel_launches).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "table_compact.cuh"

#define MAX_LANES 32
#define THREADS 256
#ifndef FREE_THREADS  // tools/block_sweep.py builds this file with other blocks
#define FREE_THREADS 64  // K13's block, a thread a 16-slot word (that sweep, PERF.md)
#endif

struct ScanLanes {
  const void* in[MAX_LANES];  // the table's lanes [cap]
  void* out[MAX_LANES];       // the rows read [emit_cap]
  int wide[MAX_LANES];        // 8-byte lane (int64, uint64, float64), else 4
  int n;
};

__global__ void scan_chunk(const long long* __restrict__ keys, const int* __restrict__ bins,
                           const unsigned char* __restrict__ occ, ScanLanes lanes, long long cap,
                           int lo, int hi, long long start, long long E,
                           long long* __restrict__ out_key, int* __restrict__ out_bin,
                           unsigned char* __restrict__ out_valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const long long sel = start + i;
  const bool in_bounds = sel < cap;
  const long long j = in_bounds ? sel : cap - 1;
  const int b = bins[j];
  out_key[i] = keys[j];
  out_bin[i] = b;
  out_valid[i] = (in_bounds && occ[j] && b >= lo && b < hi) ? 1 : 0;
  for (int l = 0; l < lanes.n; ++l) {
    if (lanes.wide[l])
      static_cast<unsigned long long*>(lanes.out[l])[i] =
          static_cast<const unsigned long long*>(lanes.in[l])[j];
    else
      static_cast<unsigned int*>(lanes.out[l])[i] = static_cast<const unsigned int*>(lanes.in[l])[j];
  }
}

// K13: word w holds slots [16w, 16w + 16); vec: occ and bins 16-byte aligned.
__global__ void free_words(const int* __restrict__ bins, unsigned char* __restrict__ occ,
                           long long cap, int below, bool vec) {
  const long long n_words = (cap + 15) >> 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < n_words; w += stride) {
    const long long j0 = w << 4;
    if (vec && j0 + 16 <= cap) {
      uint4* op = reinterpret_cast<uint4*>(occ + j0);
      const uint4 o = *op;
      const unsigned ow[4] = {o.x, o.y, o.z, o.w};
      if ((o.x | o.y | o.z | o.w) == 0u) continue;
      const int4* bp = reinterpret_cast<const int4*>(bins + j0);
      int4 b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = __ldg(bp + q);
      unsigned nw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned keep = (b[q].x >= below ? 0x000000ffu : 0u) |
                              (b[q].y >= below ? 0x0000ff00u : 0u) |
                              (b[q].z >= below ? 0x00ff0000u : 0u) |
                              (b[q].w >= below ? 0xff000000u : 0u);
        nw[q] = ow[q] & keep;
      }
      if ((nw[0] ^ ow[0]) | (nw[1] ^ ow[1]) | (nw[2] ^ ow[2]) | (nw[3] ^ ow[3]))
        *op = make_uint4(nw[0], nw[1], nw[2], nw[3]);
    } else {
      const int n = cap - j0 < 16 ? (int)(cap - j0) : 16;
      for (int e = 0; e < n; ++e)
        if (occ[j0 + e] && __ldg(bins + j0 + e) < below) occ[j0 + e] = 0;
    }
  }
}

static std::atomic<long long> g_free_launches{0};

extern "C" {

// K12. in / out: n_lanes lane pointers each, wide: 1 for an 8-byte lane.
int arroyo_hash_scan_chunk(int device, long long cap, const void* keys, const void* bins,
                           const void* occ, int n_lanes, const void** in, void** out,
                           const int* wide, int emit_lo, int emit_hi, long long chunk_start,
                           long long E, void* out_key, void* out_bin, void* out_valid,
                           void* stream) {
  if (cap < 1 || E < 1 || chunk_start < 0 || n_lanes < 0 || n_lanes > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ScanLanes lanes;
  for (int l = 0; l < n_lanes; ++l) {
    lanes.in[l] = in[l];
    lanes.out[l] = out[l];
    lanes.wide[l] = wide[l];
  }
  lanes.n = n_lanes;
  scan_chunk<<<(unsigned int)((E + THREADS - 1) / THREADS), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(bins),
      static_cast<const unsigned char*>(occ), lanes, cap, emit_lo, emit_hi, chunk_start, E,
      static_cast<long long*>(out_key), static_cast<int*>(out_bin),
      static_cast<unsigned char*>(out_valid));
  return (int)cudaGetLastError();
}

// K12's walk. in / out: n_lanes lane pointers each, wide: 1 for an 8-byte
// lane; E rows out (the caller's count of valid slots: rows past E are
// not written, the count is); count: int64 [1]; scratch:
// arroyo_hash_scan_walk_scratch_bytes(cap) bytes, 16-byte aligned, zero
// before its first call and then passed to every walk of a table of this
// cap on one stream, never cleared (see csrc/table_compact.cuh).
int arroyo_hash_scan_walk(int device, long long cap, const void* keys, const void* bins,
                          const void* occ, int n_lanes, const void** in, void** out,
                          const int* wide, int emit_lo, int emit_hi, long long E, void* out_key,
                          void* out_bin, void* count, void* scratch, void* stream) {
  if (cap < 1 || cap > 0x7fffffffLL || E < 0 || n_lanes < 0 || n_lanes > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  compact::Lanes lanes;
  for (int l = 0; l < n_lanes; ++l) {
    lanes.in[l] = in[l];
    lanes.out[l] = out[l];
    lanes.wide[l] = wide[l];
  }
  lanes.n = n_lanes;
  compact::Args a{};
  a.keys = static_cast<const long long*>(keys);
  a.bins = static_cast<const int*>(bins);
  a.occ = static_cast<unsigned char*>(const_cast<void*>(occ));  // WALK writes no occupancy
  a.cap = cap;
  a.tiles = (int)compact::tiles_for(cap);
  a.S = 1;
  a.lo = emit_lo;
  a.hi = emit_hi;
  a.free_below = INT_MIN;
  a.vec = cap % compact::ITEMS == 0 && reinterpret_cast<uintptr_t>(occ) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(bins) % 16 == 0;
  a.E = E;
  a.out_key = static_cast<long long*>(out_key);
  a.out_bin = static_cast<int*>(out_bin);
  a.count = static_cast<long long*>(count);
  a.state = static_cast<unsigned long long*>(scratch);
  a.ticket_scale = 1.0 / (double)a.tiles;
  compact::compact_table<compact::WALK>
      <<<(unsigned int)a.tiles, compact::TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          lanes, a);
  return (int)cudaGetLastError();
}

long long arroyo_hash_scan_walk_scratch_bytes(long long cap) {
  return 8 * compact::state_words(1, compact::tiles_for(cap));
}

// K13. bins: int32 [cap], occ: bool [cap], any alignment.
int arroyo_hash_free(int device, long long cap, const void* bins, void* occ, int below,
                     void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (reinterpret_cast<uintptr_t>(occ) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(bins) & 15) == 0;
  long long blocks = ((cap + 15) / 16 + FREE_THREADS - 1) / FREE_THREADS;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // then a thread takes several words
  free_words<<<(unsigned)blocks, FREE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<unsigned char*>(occ), cap, below, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_free_launches;
  return (int)cudaSuccess;
}

// Kernels K13 has launched in this process: the difference across one
// call is that call's launches.
long long arroyo_hash_free_kernel_launches(void) { return g_free_launches.load(); }

}  // extern "C"
