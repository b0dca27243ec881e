// Float subnormals flushed to the zero of their sign, as XLA computes on the
// CPU (float32 and float64 operands and results), and the ordered float sum
// that K1's walk (csrc/slot_agg.cu) and K8's chain (csrc/sharded_agg.cu)
// share.
//
// One add of a chain is a + b with subnormal operands and result flushed: a
// is the running sum, flushed already, and b is flushed where it is read
// (operand(), off the chain). Float32: add.rn.ftz.f32 flushes in hardware.
// Float64 has no .ftz, and a flush of each result on the dependent chain
// tripled its latency on the H100 (K1's chain at 11,076 rows 0.046 -> 0.143
// ms). So a float64 chain is added twice at most (two_pass): the FAST pass
// adds alone and keeps the least tiny_key of its operands b, work that waits
// on no add; where none is below TINY_KEY, no partial sum was subnormal,
// every flush would have kept its value, and the pass is exact. Else the
// chain is added again with every result flushed (the exact pass).
//
// Why the operands are enough. Let r = a + b be a chain's first subnormal
// partial sum. a (the start or the partial sum before) and b are normal or
// zero, and neither is zero (else r is the other, or a zero). A subnormal
// result is exact, so a + b = r with 0 < |r| < 2^-1022. If the larger of
// |a|, |b| is at least 2^e with e >= -1021, the smaller is above 2^(e-1),
// both are multiples of 2^(e-53), and so is r: |r| >= 2^(e-53), so e <= -970.
// Both are below 2^-969, an exponent field of at most 53, and b's key is
// below TINY_KEY. A zero's key is the largest (0xFFFFFFFE): a run of zeros,
// or a sum that cancels to exactly zero, keeps the fast pass.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned ftz_bits32(unsigned u) {
  return (u & 0x7F800000u) == 0 ? (u & 0x80000000u) : u;
}
__device__ __forceinline__ unsigned long long ftz_bits64(unsigned long long u) {
  return (u & 0x7FF0000000000000ULL) == 0 ? (u & 0x8000000000000000ULL) : u;
}
__device__ __forceinline__ double ftz(double x) {
  return __longlong_as_double((long long)ftz_bits64((unsigned long long)__double_as_longlong(x)));
}
__device__ __forceinline__ float ftz(float x) { return __uint_as_float(ftz_bits32(__float_as_uint(x))); }

// b as an operand of add_rn: a float64 flushed, a float32 as it is
// (add.rn.ftz.f32 flushes it)
__device__ __forceinline__ double operand(double b) { return ftz(b); }
__device__ __forceinline__ float operand(float b) { return b; }

__device__ __forceinline__ double from_bits(unsigned long long b, double) {
  return __longlong_as_double((long long)b);
}
__device__ __forceinline__ float from_bits(unsigned long long b, float) {
  return __uint_as_float((unsigned)b);
}

// A float64's high word without its sign, less one, wrapping (one IMAD): a
// zero's key is the largest, a normal's grows with its exponent field.
// TINY_KEY: the key of the least normal with an exponent field of 64.
#define TINY_KEY ((64u << 21) - 2u)
__device__ __forceinline__ unsigned tiny_key(double x) {
  return (unsigned)__double2hiint(x) * 2u - 2u;
}
__device__ __forceinline__ unsigned tiny_key(float) { return ~0u; }  // never an exact pass

template <bool FAST>
__device__ __forceinline__ double add_rn(double a, double b, unsigned& lo) {
  if (FAST) {
    lo = min(lo, tiny_key(b));
    return __dadd_rn(a, b);
  }
  return ftz(__dadd_rn(a, b));
}
template <bool FAST>
__device__ __forceinline__ float add_rn(float a, float b, unsigned&) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool B>
struct PassKind {
  static constexpr bool fast = B;
};

// x (flushed) through pass(PassKind<true>(), x, lo), the fast pass, and
// through pass(PassKind<false>(), x, lo), the exact one, where the fast
// pass's least operand key fell below TINY_KEY
template <typename F, typename Pass>
__device__ __forceinline__ F two_pass(F x, Pass pass) {
  unsigned lo = ~0u;
  const F y = pass(PassKind<true>(), x, lo);
  return lo < TINY_KEY ? pass(PassKind<false>(), x, lo) : y;
}
