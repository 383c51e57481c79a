// Field arithmetic for the STARK base field FP and scalar field FR on Hopper.
//
// Elements are four little-endian 64-bit words, always canonical (< m).
// Montgomery form uses R = 2^256 for both fields, the same R as the plain
// PyTorch versions in ops/limb.py, so kernel and plain outputs are equal bit
// for bit.
//
// The product is word-serial CIOS Montgomery multiplication with 64x64->128
// products from mul.lo / mul.hi (__umul64hi) and explicit carries.  For FP,
// p = 2^251 + 17*2^192 + 1 has words {1, 0, 0, 2^59 + 17} and
// m' = -p^-1 mod 2^64 = 2^64 - 1, so every constant below is a compile-time
// constant: the reduction's u = -t0 needs no multiply, and the u*p products
// by the zero words and by 1 fold away (the Hopper analogue of the
// multiply-free REDC of the JAX package's limb._redc).  FR has no such form
// and pays the full reduction.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

struct FpConst {
  static constexpr u64 M0 = 0x0000000000000001ull, M1 = 0x0000000000000000ull,
                       M2 = 0x0000000000000000ull, M3 = 0x0800000000000011ull;
  static constexpr u64 MINV = 0xffffffffffffffffull;  // -m^-1 mod 2^64
  // R mod m (1 in Montgomery form) and R^2 mod m
  static constexpr u64 ONE0 = 0xffffffffffffffe1ull, ONE1 = 0xffffffffffffffffull,
                       ONE2 = 0xffffffffffffffffull, ONE3 = 0x07fffffffffffdf0ull;
  static constexpr u64 R20 = 0xfffffd737e000401ull, R21 = 0x00000001330fffffull,
                       R22 = 0xffffffffff6f8000ull, R23 = 0x07ffd4ab5e008810ull;
};

struct FrConst {
  static constexpr u64 M0 = 0x1e66a241adc64d2full, M1 = 0xb781126dcae7b232ull,
                       M2 = 0xffffffffffffffffull, M3 = 0x0800000000000010ull;
  static constexpr u64 MINV = 0xbb6b3c4ce8bde631ull;
  static constexpr u64 ONE0 = 0x51925a0bf4fca74full, ONE1 = 0xc75ec4b46df16beeull,
                       ONE2 = 0x0000000000000008ull, ONE3 = 0x07fffffffffffdf1ull;
  static constexpr u64 R20 = 0x6021b3f1ea1c688dull, R21 = 0x509cf64d14ce60b9ull,
                       R22 = 0xbaf0ab4cf78bbabbull, R23 = 0x07d9e57c2333766eull;
};

struct Fe {
  u64 v[4];
};

// (hi, lo) = a * b + t + c; never overflows 128 bits.
__device__ __forceinline__ void mac(u64 a, u64 b, u64 t, u64 c, u64 &lo, u64 &hi) {
  lo = a * b;
  hi = __umul64hi(a, b);
  lo += t;
  hi += (lo < t);
  lo += c;
  hi += (lo < c);
}

// r = t - m if (t4, t) >= m else t
template <class F>
__device__ __forceinline__ Fe reduce_once(const u64 t[4], u64 t4) {
  const u64 M[4] = {F::M0, F::M1, F::M2, F::M3};
  u64 d[4];
  u64 br = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    u64 x = t[j] - M[j];
    u64 b1 = t[j] < M[j];
    u64 y = x - br;
    u64 b2 = x < br;
    d[j] = y;
    br = b1 | b2;
  }
  bool ge = (t4 != 0) || (br == 0);
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.v[j] = ge ? d[j] : t[j];
  return r;
}

template <class F>
__device__ __forceinline__ Fe fe_add(const Fe &a, const Fe &b) {
  u64 s[4];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    u64 x = a.v[j] + b.v[j];
    u64 c1 = x < a.v[j];
    u64 y = x + c;
    u64 c2 = y < x;
    s[j] = y;
    c = c1 | c2;
  }
  return reduce_once<F>(s, c);
}

template <class F>
__device__ __forceinline__ Fe fe_sub(const Fe &a, const Fe &b) {
  const u64 M[4] = {F::M0, F::M1, F::M2, F::M3};
  u64 d[4];
  u64 br = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    u64 x = a.v[j] - b.v[j];
    u64 b1 = a.v[j] < b.v[j];
    u64 y = x - br;
    u64 b2 = x < br;
    d[j] = y;
    br = b1 | b2;
  }
  // on borrow, add m back (mod 2^256)
  u64 mask = 0ull - br;
  u64 c = 0;
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    u64 mj = M[j] & mask;
    u64 x = d[j] + mj;
    u64 c1 = x < d[j];
    u64 y = x + c;
    u64 c2 = y < x;
    r.v[j] = y;
    c = c1 | c2;
  }
  return r;
}

// a * b * 2^-256 mod m (CIOS), canonical inputs and output.
template <class F>
__device__ __forceinline__ Fe fe_mont_mul(const Fe &a, const Fe &b) {
  const u64 M[4] = {F::M0, F::M1, F::M2, F::M3};
  u64 t[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    u64 C = 0, lo, hi;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      mac(a.v[j], b.v[i], t[j], C, lo, hi);
      t[j] = lo;
      C = hi;
    }
    u64 s = t[4] + C;
    t[5] = (s < C);
    t[4] = s;
    u64 u = t[0] * F::MINV;
    mac(u, M[0], t[0], 0ull, lo, hi);
    C = hi;
#pragma unroll
    for (int j = 1; j < 4; j++) {
      mac(u, M[j], t[j], C, lo, hi);
      t[j - 1] = lo;
      C = hi;
    }
    s = t[4] + C;
    u64 c2 = (s < C);
    t[3] = s;
    t[4] = t[5] + c2;
  }
  return reduce_once<F>(t, t[4]);
}

template <class F>
__device__ __forceinline__ Fe fe_one_mont() {
  Fe r;
  r.v[0] = F::ONE0; r.v[1] = F::ONE1; r.v[2] = F::ONE2; r.v[3] = F::ONE3;
  return r;
}

template <class F>
__device__ __forceinline__ Fe fe_r2() {
  Fe r;
  r.v[0] = F::R20; r.v[1] = F::R21; r.v[2] = F::R22; r.v[3] = F::R23;
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
  r.v[0] = 0; r.v[1] = 0; r.v[2] = 0; r.v[3] = 0;
  return r;
}

// Element k of a limb-major (4, stride) word array.
__device__ __forceinline__ Fe fe_load(const u64 *base, long long stride, long long k) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.v[j] = base[j * stride + k];
  return r;
}

__device__ __forceinline__ void fe_store(u64 *base, long long stride, long long k, const Fe &x) {
#pragma unroll
  for (int j = 0; j < 4; j++) base[j * stride + k] = x.v[j];
}
