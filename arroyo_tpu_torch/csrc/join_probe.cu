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
//      sorted keys. The kernels sort (key: int64 signed, index: int32)
//      pairs by (key, index). Every index is distinct, so that order is a
//      total order, and sorting by it gives exactly a stable argsort: rows
//      with equal keys keep their input order, as jnp.argsort's do. The
//      result does not depend on the order in which threads run. The slot
//      aggregator's K1 (csrc/slot_agg.cu) sorts its slots with it too, to
//      add float sums in row order.
//   K6 join_search_bounds  lo = first index whose key >= probe key, hi =
//      first index whose key > probe key, over the sorted keys (what
//      jnp.searchsorted side="left" / side="right" return). A probe key of
//      INT64_MAX finds hi = the length of the sorted array.
//
// K5 is a bitonic network over the length rounded up to a power of two
// (at least 64); the rows past n are (INT64_MAX, i) with i >= n, so they
// sort after every real row, a real INT64_MAX key included. Tiles of
// SORT_TILE pairs (24 KB of keys and indices) are sorted and merged in
// shared memory by one block each; every merge stride of SORT_TILE or
// more takes one pass over device memory. At q8's build side (131,072
// rows, 1.5 MB, which stays in the 50 MB L2) that is 21 global passes and
// 7 tile passes; at 16,777,216 rows, 91 global passes of 200 MB each.
//
// Bound on the H100 (3.35 TB/s): K5 must read 8 bytes and write 12 bytes
// per row, and does O(n log^2 n) compare-exchanges of one 64-bit and one
// 32-bit compare each, far below the card's integer rate; so the bytes
// bound it in principle, and the network's log^2 passes over device
// memory are what it pays in practice. The design keeps the short strides
// (11 of every level's up to 24) in shared memory, one block per tile,
// and its global passes read and write neighbouring pairs from
// neighbouring threads (coalesced). A radix sort would move fewer bytes
// at the deployment size; that is later work.
// K6 reads each probe key once and writes two int32 per key; the sorted
// keys it searches are read log2(m) times per probe key but sit in L2 at
// q8's size. One thread per probe key, two binary searches, the second
// starting from the first's result.
//
// Each entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() after every launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define SORT_TILE 2048  // pairs sorted in shared memory by one block
#define THREADS 256
#define KEY_MAX 0x7fffffffffffffffLL

__device__ __forceinline__ bool pair_greater(long long ka, int va, long long kb, int vb) {
  return ka > kb || (ka == kb && va > vb);
}

// One compare-exchange of the network on stage (k, j), pair t: the lower
// element lo and its partner lo + j; the pair sorts ascending where bit k
// of the lower element's global index is 0.
__device__ __forceinline__ void exchange(long long* keys, int* idx, long long lo, long long j,
                                         bool asc) {
  long long hi = lo + j;
  long long ka = keys[lo], kb = keys[hi];
  int va = idx[lo], vb = idx[hi];
  if (pair_greater(ka, va, kb, vb) == asc) {
    keys[lo] = kb;
    keys[hi] = ka;
    idx[lo] = vb;
    idx[hi] = va;
  }
}

// Sort each tile of `tile` pairs: load the input keys (int64, or int32
// widened; INT64_MAX past n) with their indices, run every stage k = 2 ..
// tile, write the tile back. blockDim.x == tile / 2.
__global__ void sort_tiles_kernel(const void* __restrict__ in, int in_i32, long long n,
                                  long long* __restrict__ keys, int* __restrict__ idx, int tile) {
  __shared__ long long sk[SORT_TILE];
  __shared__ int sv[SORT_TILE];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    long long g = base + i;
    sk[i] = g >= n ? KEY_MAX
            : in_i32 ? (long long)static_cast<const int*>(in)[g] : static_cast<const long long*>(in)[g];
    sv[i] = (int)g;
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int lo = (t / j) * 2 * j + (t % j);
      exchange(sk, sv, lo, j, ((base + lo) & k) == 0);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    keys[base + i] = sk[i];
    idx[base + i] = sv[i];
  }
}

// One stride j >= SORT_TILE of stage k, over device memory: one thread per pair.
__global__ void merge_global_kernel(long long* __restrict__ keys, int* __restrict__ idx,
                                    long long pairs, long long k, long long j) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  long long lo = (t / j) * 2 * j + (t % j);
  exchange(keys, idx, lo, j, (lo & k) == 0);
}

// The strides j = SORT_TILE / 2 .. 1 of stage k, one tile per block in
// shared memory. blockDim.x == SORT_TILE / 2.
__global__ void merge_tile_kernel(long long* __restrict__ keys, int* __restrict__ idx,
                                  long long k) {
  __shared__ long long sk[SORT_TILE];
  __shared__ int sv[SORT_TILE];
  const long long base = (long long)blockIdx.x * SORT_TILE;
  for (int i = threadIdx.x; i < SORT_TILE; i += blockDim.x) {
    sk[i] = keys[base + i];
    sv[i] = idx[base + i];
  }
  __syncthreads();
  const int t = threadIdx.x;
  const bool asc = (base & k) == 0;  // k > SORT_TILE: one direction per tile
  for (int j = SORT_TILE >> 1; j > 0; j >>= 1) {
    int lo = (t / j) * 2 * j + (t % j);
    exchange(sk, sv, lo, j, asc);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < SORT_TILE; i += blockDim.x) {
    keys[base + i] = sk[i];
    idx[base + i] = sv[i];
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

extern "C" {

// keys_in: n int64 keys, or int32 ones (keys_i32) sorted as their int64
// values. keys_out and order_out hold cap pairs; cap is a power of two,
// 64 <= cap < 2^31, n <= cap. On return the first n pairs are the sorted
// input rows.
int arroyo_join_sort_pairs(int device, const void* keys_in, int keys_i32, long long n,
                           void* keys_out, void* order_out, long long cap, void* stream) {
  if (cap < 64 || (cap & (cap - 1)) != 0 || cap > 0x7fffffffLL || n < 0 || n > cap)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* keys = static_cast<long long*>(keys_out);
  int* idx = static_cast<int*>(order_out);
  const int tile = cap < SORT_TILE ? (int)cap : SORT_TILE;
  sort_tiles_kernel<<<(unsigned int)(cap / tile), tile / 2, 0, s>>>(
      keys_in, keys_i32, n, keys, idx, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long pairs = cap / 2;
  for (long long k = 2LL * SORT_TILE; k <= cap; k <<= 1) {
    for (long long j = k >> 1; j >= SORT_TILE; j >>= 1) {
      merge_global_kernel<<<blocks_for(pairs), THREADS, 0, s>>>(keys, idx, pairs, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    merge_tile_kernel<<<(unsigned int)(cap / SORT_TILE), SORT_TILE / 2, 0, s>>>(keys, idx, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

int arroyo_join_search_bounds(int device, const void* sorted, long long m, const void* probe,
                              long long p, void* lo, void* hi, void* stream) {
  if (m < 0 || m > 0x7fffffffLL || p < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  search_bounds_kernel<<<blocks_for(p), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted), m, static_cast<const long long*>(probe), p,
      static_cast<int*>(lo), static_cast<int*>(hi));
  return (int)cudaGetLastError();
}

}  // extern "C"
