// Field arithmetic for the STARK base field FP and scalar field FR on Hopper.
//
// In memory an element is four little-endian 64-bit words, always canonical
// (< m), in Montgomery form with R = 2^256 for both fields: the layout and
// the R of the plain PyTorch versions in ops/limb.py.  In registers it is
// eight 32-bit limbs (Fe), split on load and joined on store.  Canonical
// values make a kernel and its plain version equal bit for bit, whatever
// order of operations either takes.
//
// Replaces the limb field of mpc_bulletproof_tpu/ops/limb.py inside every
// Pallas kernel of mpc_bulletproof_tpu/ops/kernels.py (13-bit limbs in
// int32 lanes, Barrett or lazy Montgomery reduction).
//
// Bound on this card: the latency of one product where a kernel waits on
// one product at a time (Horner's lanes, the ladder, the reduction: one
// dependent chain on a few warps), and the issue rate of its ~400 SASS
// instructions where many run side by side (the scan, point_add; the
// scan issues as fast as at one warp a scheduler as at three).
//
// Design: the product is CIOS Montgomery multiplication on 8 x 32-bit
// limbs: one hardware 32 x 32 + 32 -> 64 multiply-add (mad.wide.u32) per
// limb product and PTX carry chains (add.cc / addc.cc / addc) for the
// carries: no emulated 64 x 64 -> 128 products and no compare-based
// carries.  On the H100 (700 W) a chain of FP products on one lane takes
// ~0.37 us a product (the ladder's 314 for p - 2 in 0.114 to 0.118 ms),
// the 4 x 64-bit CIOS it replaced ~0.59 us (0.185 ms; PERF.md).
// Measured and dropped: the same rounds as mad.lo.cc / madc.hi.cc rows
// (the same SASS count, 5% slower on Horner) and a carry-save
// accumulator (34 to 56% slower).  m < 2^252, so a 9-limb accumulator
// never overflows and one conditional subtraction leaves the result
// canonical.  For FP, p = 2^251 + 17 * 2^192 + 1 has 32-bit limbs
// [1, 0, 0, 0, 0, 0, 17, 2^27] and m' = -p^-1 mod 2^32 = 2^32 - 1: the
// reduction's u = -t0 needs no multiply and u * p is u, u * 17 at limb 6
// and u * 2^27 at limb 7.  FR pays the full 8-limb reduction.  Sums and
// differences use the same chains (add.cc / addc, sub.cc / subc).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

#define BP_DEV __device__ __forceinline__

struct FpConst {
  static constexpr u64 M0 = 0x0000000000000001ull, M1 = 0x0000000000000000ull,
                       M2 = 0x0000000000000000ull, M3 = 0x0800000000000011ull;
  static constexpr u32 MINV = 0xffffffffu;  // -m^-1 mod 2^32
  static constexpr bool SPARSE = true;      // the limb-sparse reduction below
  // R mod m (1 in Montgomery form) and R^2 mod m
  static constexpr u64 ONE0 = 0xffffffffffffffe1ull, ONE1 = 0xffffffffffffffffull,
                       ONE2 = 0xffffffffffffffffull, ONE3 = 0x07fffffffffffdf0ull;
  static constexpr u64 R20 = 0xfffffd737e000401ull, R21 = 0x00000001330fffffull,
                       R22 = 0xffffffffff6f8000ull, R23 = 0x07ffd4ab5e008810ull;
};

struct FrConst {
  static constexpr u64 M0 = 0x1e66a241adc64d2full, M1 = 0xb781126dcae7b232ull,
                       M2 = 0xffffffffffffffffull, M3 = 0x0800000000000010ull;
  static constexpr u32 MINV = 0xe8bde631u;
  static constexpr bool SPARSE = false;
  static constexpr u64 ONE0 = 0x51925a0bf4fca74full, ONE1 = 0xc75ec4b46df16beeull,
                       ONE2 = 0x0000000000000008ull, ONE3 = 0x07fffffffffffdf1ull;
  static constexpr u64 R20 = 0x6021b3f1ea1c688dull, R21 = 0x509cf64d14ce60b9ull,
                       R22 = 0xbaf0ab4cf78bbabbull, R23 = 0x07d9e57c2333766eull;
};

struct Fe {
  u32 v[8];
};

// --- carry-chain primitives: one PTX instruction each; the carry flag
// --- travels between consecutive calls of one chain
BP_DEV u32 add_cc(u32 a, u32 b) {
  u32 r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
BP_DEV u32 addc_cc(u32 a, u32 b) {
  u32 r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
BP_DEV u32 addc(u32 a, u32 b) {
  u32 r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
BP_DEV u32 sub_cc(u32 a, u32 b) {
  u32 r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
BP_DEV u32 subc_cc(u32 a, u32 b) {
  u32 r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
BP_DEV u32 subc(u32 a, u32 b) {
  u32 r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// a * b + c, the full 64 bits (one IMAD.WIDE.U32; never overflows for c < 2^32)
BP_DEV u64 mad_wide(u32 a, u32 b, u64 c) {
  u64 r;
  asm volatile("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}
// --- end of the carry-chain primitives

// limb j of the modulus (a compile-time constant once the loops unroll)
template <class F>
BP_DEV u32 mlimb(int j) {
  const u64 w = j < 2 ? F::M0 : j < 4 ? F::M1 : j < 6 ? F::M2 : F::M3;
  return (u32)(w >> (32 * (j & 1)));
}

BP_DEV Fe fe_from_words(u64 w0, u64 w1, u64 w2, u64 w3) {
  const u64 w[4] = {w0, w1, w2, w3};
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    r.v[2 * j] = (u32)w[j];
    r.v[2 * j + 1] = (u32)(w[j] >> 32);
  }
  return r;
}

// t - m if t >= m else t, for t < 2m (< 2^253: no carry limb)
template <class F>
BP_DEV Fe reduce_once(const u32 t[8]) {
  u32 d[8];
  d[0] = sub_cc(t[0], mlimb<F>(0));
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(t[j], mlimb<F>(j));
  const u32 keep = subc(0u, 0u);  // all ones on a borrow (t < m)
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = (t[j] & keep) | (d[j] & ~keep);
  return r;
}

template <class F>
BP_DEV Fe fe_add(const Fe &a, const Fe &b) {
  u32 s[8];
  s[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) s[j] = addc_cc(a.v[j], b.v[j]);
  s[7] = addc(a.v[7], b.v[7]);
  return reduce_once<F>(s);
}

template <class F>
BP_DEV Fe fe_sub(const Fe &a, const Fe &b) {
  u32 d[8];
  d[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(a.v[j], b.v[j]);
  const u32 mask = subc(0u, 0u);  // all ones on a borrow: add m back (mod 2^256)
  Fe r;
  r.v[0] = add_cc(d[0], mlimb<F>(0) & mask);
#pragma unroll
  for (int j = 1; j < 7; j++) r.v[j] = addc_cc(d[j], mlimb<F>(j) & mask);
  r.v[7] = addc(d[7], mlimb<F>(7) & mask);
  return r;
}

BP_DEV u32 lo32(u64 x) { return (u32)x; }
BP_DEV u32 hi32(u64 x) { return (u32)(x >> 32); }

// a * b * 2^-256 mod m (CIOS), canonical inputs and output.  Each round
// adds a * b_i as 8 independent 32 x 32 + 32 -> 64 products (a_j b_i + t_j,
// which cannot overflow 64 bits) and one carry chain that adds each
// product's high half to the next one's low half; the reduction adds u * m
// the same way and drops limb 0.  After each of the 8 rounds t < 2m;
// inside a round t < 2^286, which 9 limbs hold.
//
// UNROLL: how many of the 8 rounds the compiler unrolls.  8 (the default)
// lets one product's rounds overlap, for the kernels that wait on one
// product at a time (Horner's lanes, the ladder, the reduction).  Kernels
// whose loop body holds many products side by side (point_add, the scan)
// take 1: their code shrinks ~3x (the scan's from 18,056 SASS
// instructions to 5,904) and they run 10 to 15% faster (PERF.md).
template <class F, int UNROLL = 8>
BP_DEV Fe fe_mont_mul(const Fe &a, const Fe &b) {
  u32 t[9], bb[8];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) bb[j] = b.v[j];
#pragma unroll UNROLL
  for (int i = 0; i < 8; i++) {
    const u32 bi = bb[0];
#pragma unroll
    for (int j = 0; j < 7; j++) bb[j] = bb[j + 1];
    // t += a * b_i (t[8] is 0 here)
    u64 p[8];
#pragma unroll
    for (int j = 0; j < 8; j++) p[j] = mad_wide(a.v[j], bi, t[j]);
    t[0] = lo32(p[0]);
    t[1] = add_cc(lo32(p[1]), hi32(p[0]));
#pragma unroll
    for (int j = 2; j < 8; j++) t[j] = addc_cc(lo32(p[j]), hi32(p[j - 1]));
    t[8] = addc(hi32(p[7]), 0u);
    // (t + u * m) / 2^32 with u = t0 m' mod 2^32, so that limb 0 is 0
    if constexpr (F::SPARSE) {
      // m = 1 + 17 * 2^192 + 2^27 * 2^224 (limbs 0, 6, 7); m' = -1
      const u32 u = 0u - t[0];
      const u64 q6 = mad_wide(u, mlimb<F>(6), t[6]);
      const u64 q7 = mad_wide(u, mlimb<F>(7), t[7]);
      add_cc(t[0], u);  // 0, with a carry unless t0 = 0
#pragma unroll
      for (int j = 1; j < 6; j++) t[j - 1] = addc_cc(t[j], 0u);
      t[5] = addc_cc(lo32(q6), 0u);
      t[6] = addc_cc(lo32(q7), hi32(q6));
      t[7] = addc(t[8], hi32(q7));
    } else {
      const u32 u = t[0] * F::MINV;
      u64 q[8];
#pragma unroll
      for (int j = 0; j < 8; j++) q[j] = mad_wide(u, mlimb<F>(j), t[j]);
      t[0] = add_cc(lo32(q[1]), hi32(q[0]));  // lo32(q[0]) is 0
#pragma unroll
      for (int j = 2; j < 8; j++) t[j - 1] = addc_cc(lo32(q[j]), hi32(q[j - 1]));
      t[7] = addc(t[8], hi32(q[7]));
    }
    t[8] = 0;
  }
  return reduce_once<F>(t);
}

template <class F>
BP_DEV Fe fe_one_mont() {
  return fe_from_words(F::ONE0, F::ONE1, F::ONE2, F::ONE3);
}

template <class F>
BP_DEV Fe fe_r2() {
  return fe_from_words(F::R20, F::R21, F::R22, F::R23);
}

BP_DEV Fe fe_zero() {
  return fe_from_words(0, 0, 0, 0);
}

// Element k of a limb-major (4, stride) array of 64-bit words.
BP_DEV Fe fe_load(const u64 *base, long long stride, long long k) {
  return fe_from_words(base[k], base[stride + k], base[2 * stride + k], base[3 * stride + k]);
}

BP_DEV void fe_store(u64 *base, long long stride, long long k, const Fe &x) {
#pragma unroll
  for (int j = 0; j < 4; j++) base[j * stride + k] = (u64)x.v[2 * j] | ((u64)x.v[2 * j + 1] << 32);
}
