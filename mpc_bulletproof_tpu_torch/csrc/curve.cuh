// Complete projective point addition on the STARK curve (Renes-Costello-
// Batina 2016, Algorithm 1, a = 1): 12 Montgomery products plus 2 by the
// constant 3b, straight-line, correct for every input pair (identity,
// doubling, P + (-P)).  Coordinates are canonical Montgomery-form FP
// elements; the operation order matches curve_t._point_add exactly.
//
// A point of a (3, 4, ...) word tensor: coordinate c, word j of lane k sits
// at base[(c * 4 + j) * stride + k].
#pragma once

#include "field.cuh"

struct Pt {
  Fe x, y, z;
};

// 3b in Montgomery form
BP_DEV Fe b3_mont() {
  return fe_from_words(0xa0d9983720ce655eull, 0x3571d66a7002b012ull, 0x029e5a007ec5ebd6ull,
                       0x03ab942f465c6d7full);
}

__device__ __forceinline__ Pt pt_identity() {
  Pt p;
  p.x = fe_zero();
  p.y = fe_one_mont<FpConst>();
  p.z = fe_zero();
  return p;
}

__device__ __forceinline__ Pt pt_load(const u64 *base, long long stride, long long k) {
  Pt p;
  p.x = fe_load(base, stride, k);
  p.y = fe_load(base + 4 * stride, stride, k);
  p.z = fe_load(base + 8 * stride, stride, k);
  return p;
}

__device__ __forceinline__ void pt_store(u64 *base, long long stride, long long k, const Pt &p) {
  fe_store(base, stride, k, p.x);
  fe_store(base + 4 * stride, stride, k, p.y);
  fe_store(base + 8 * stride, stride, k, p.z);
}

// UNROLL: the product's unrolled rounds (fe_mont_mul).
template <int UNROLL = 8>
__device__ __forceinline__ Pt pt_add(const Pt &p, const Pt &q) {
#define MUL(a, b) fe_mont_mul<FpConst, UNROLL>(a, b)
#define ADD(a, b) fe_add<FpConst>(a, b)
#define SUB(a, b) fe_sub<FpConst>(a, b)
  const Fe b3 = b3_mont();
  Fe t0 = MUL(p.x, q.x);
  Fe t1 = MUL(p.y, q.y);
  Fe t2 = MUL(p.z, q.z);
  Fe t3 = MUL(ADD(p.x, p.y), ADD(q.x, q.y));
  t3 = SUB(t3, ADD(t0, t1));
  Fe t4 = MUL(ADD(p.x, p.z), ADD(q.x, q.z));
  t4 = SUB(t4, ADD(t0, t2));
  Fe t5 = MUL(ADD(p.y, p.z), ADD(q.y, q.z));
  t5 = SUB(t5, ADD(t1, t2));
  Fe X3 = MUL(b3, t2);
  Fe Z3 = ADD(X3, t4);
  X3 = SUB(t1, Z3);
  Z3 = ADD(t1, Z3);
  Fe Y3 = MUL(X3, Z3);
  Fe t1b = ADD(ADD(ADD(t0, t0), t0), t2);  // 3 t0 + a t2
  Fe t4b = ADD(MUL(b3, t4), SUB(t0, t2));  // b3 t4 + (t0 - a t2)
  Y3 = ADD(Y3, MUL(t1b, t4b));
  Fe r;
  Pt out;
  r = MUL(t5, t4b);
  out.x = SUB(MUL(t3, X3), r);
  out.y = Y3;
  out.z = ADD(MUL(t5, Z3), MUL(t3, t1b));
  return out;
#undef MUL
#undef ADD
#undef SUB
}
