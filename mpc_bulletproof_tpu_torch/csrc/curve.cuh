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

// --- The complete add split over the lanes of a group of 8 (Horner's
// warp, a group of point_add's narrow kernel).  The 14 products form 3
// dependent levels: t0..t5 (6 products), b3 t2 and b3 t4' (2), then 6
// products of sums of those; each level runs on lanes 0..5 at once, one
// product per lane, with the sums and differences between levels fused
// into each lane's operand fetch.  Operands and results pass through the
// group's table of field elements in shared memory (slots below), with
// __syncwarp() between the 4 steps.  Every lane runs the same instruction
// stream on the slots its row of kSteps names, so no lane waits for
// another's branch.  The result lands in P (X1, Y1, Z1) and in Q.

// Slots of one group's table of field elements.
enum : unsigned char {
  X1, Y1, Z1, X2, Y2, Z2, ZERO, B3,   // the accumulator P, the addend Q, constants
  T0, T1, T2, T3, T4, T5,             // level 1: X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), ...
  T1B, T3P, T4P, T5P, D02,            // 3 t0 + t2, t3 - (t0 + t1), t4 - (t0 + t2),
                                      // t5 - (t1 + t2), t0 - t2
  P2A, P2B,                           // level 2: b3 t2, b3 t4'
  Q0, Q1, Q2, Q3, Q4, Q5,             // level 3: X3 Z3, t1b t4b, t5' t4b, t3' X3, t5' Z3, t3' t1b
  JUNK, NSLOT
};

// One lane's share of a step.  The operands, by the step's form:
//   0  A = a0 + a1,            B = b0 + b1,            r = A * B
//   1  A = a0 -/+ (a1 + a2),   B = b0,                 r = A * B or A + B
//   2  A = a0 -/+ (a1 + a2),   B = b0 -/+ (b1 + b2),   r = A * B
//   3  r = a0 -/+ a1
// (minus where sub_a / sub_b), written to slots dst and dst2.
struct __align__(4) LaneOp {
  unsigned char a0, a1, a2, b0, b1, b2, dst, dst2, sub_a, sub_b, mul, live;
};

#define WARP_ADD_STEPS 4
#define WARP_ADD_LANES 8

__device__ const LaneOp kSteps[WARP_ADD_STEPS][WARP_ADD_LANES] = {
    {// level 1: the six products of the coordinates and their sums
     {X1, ZERO, 0, X2, ZERO, 0, T0, JUNK, 0, 0, 1, 1},
     {Y1, ZERO, 0, Y2, ZERO, 0, T1, JUNK, 0, 0, 1, 1},
     {Z1, ZERO, 0, Z2, ZERO, 0, T2, JUNK, 0, 0, 1, 1},
     {X1, Y1, 0, X2, Y2, 0, T3, JUNK, 0, 0, 1, 1},
     {X1, Z1, 0, X2, Z2, 0, T4, JUNK, 0, 0, 1, 1},
     {Y1, Z1, 0, Y2, Z2, 0, T5, JUNK, 0, 0, 1, 1},
     {},
     {}},
    {// level 2 (b3 t2, b3 t4') and the differences level 3 reads
     {T2, ZERO, ZERO, B3, 0, 0, P2A, JUNK, 0, 0, 1, 1},
     {T4, T0, T2, B3, 0, 0, P2B, JUNK, 1, 0, 1, 1},
     {T2, T0, T0, T0, 0, 0, T1B, JUNK, 0, 0, 0, 1},
     {T3, T0, T1, ZERO, 0, 0, T3P, JUNK, 1, 0, 0, 1},
     {T0, T2, ZERO, ZERO, 0, 0, D02, JUNK, 1, 0, 0, 1},
     {T5, T1, T2, ZERO, 0, 0, T5P, JUNK, 1, 0, 0, 1},
     {T4, T0, T2, ZERO, 0, 0, T4P, JUNK, 1, 0, 0, 1},
     {}},
    {// level 3, with X3 = t1 - (b3 t2 + t4'), Z3 = t1 + (b3 t2 + t4'),
     // t4b = b3 t4' + (t0 - t2) formed in the operand fetch
     {T1, P2A, T4P, T1, P2A, T4P, Q0, JUNK, 1, 0, 1, 1},
     {T1B, ZERO, ZERO, P2B, D02, ZERO, Q1, JUNK, 0, 0, 1, 1},
     {T5P, ZERO, ZERO, P2B, D02, ZERO, Q2, JUNK, 0, 0, 1, 1},
     {T3P, ZERO, ZERO, T1, P2A, T4P, Q3, JUNK, 0, 1, 1, 1},
     {T5P, ZERO, ZERO, T1, P2A, T4P, Q4, JUNK, 0, 0, 1, 1},
     {T3P, ZERO, ZERO, T1B, ZERO, ZERO, Q5, JUNK, 0, 0, 1, 1},
     {},
     {}},
    {// X = t3' X3 - t5' t4b, Y = X3 Z3 + t1b t4b, Z = t5' Z3 + t3' t1b,
     // into P and Q (the next add may be a doubling)
     {Q3, Q2, 0, 0, 0, 0, X1, X2, 1, 0, 0, 1},
     {Q0, Q1, 0, 0, 0, 0, Y1, Y2, 0, 0, 0, 1},
     {Q4, Q5, 0, 0, 0, 0, Z1, Z2, 0, 0, 0, 1},
     {},
     {},
     {},
     {},
     {}},
};

// Lane `lane`'s row of step i (lane < WARP_ADD_LANES): three aligned words
// through the read-only cache, neighbouring lanes on neighbouring words.
BP_DEV LaneOp lane_op(int i, int lane) {
  const u32 *w = reinterpret_cast<const u32 *>(&kSteps[i][lane]);
  const u32 v[3] = {__ldg(w), __ldg(w + 1), __ldg(w + 2)};
  LaneOp o;
  memcpy(&o, v, sizeof o);
  return o;
}

// x + y, or x - y when sub: both formed, one kept, so lanes never diverge.
BP_DEV Fe add_or_sub(const Fe &x, const Fe &y, u32 sub) {
  const Fe a = fe_add<FpConst>(x, y), d = fe_sub<FpConst>(x, y);
  const u32 m = 0u - sub;
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = (d.v[j] & m) | (a.v[j] & ~m);
  return r;
}

template <int FORM>
BP_DEV void lane_step(const LaneOp &o, Fe *s) {
  if (!o.live) return;
  Fe r;
  if constexpr (FORM == 0) {
    r = fe_mont_mul<FpConst>(fe_add<FpConst>(s[o.a0], s[o.a1]), fe_add<FpConst>(s[o.b0], s[o.b1]));
  } else if constexpr (FORM == 3) {
    r = add_or_sub(s[o.a0], s[o.a1], o.sub_a);
  } else {
    const Fe A = add_or_sub(s[o.a0], fe_add<FpConst>(s[o.a1], s[o.a2]), o.sub_a);
    const Fe B =
        FORM == 1 ? s[o.b0] : add_or_sub(s[o.b0], fe_add<FpConst>(s[o.b1], s[o.b2]), o.sub_b);
    r = fe_add<FpConst>(A, B);
    if (o.mul) r = fe_mont_mul<FpConst>(A, B);
  }
  s[o.dst] = r;
  s[o.dst2] = r;
}

// P = P + Q over the warp's table (Q = P for a doubling).
BP_DEV void warp_add(const LaneOp ops[WARP_ADD_STEPS], Fe *s) {
  lane_step<0>(ops[0], s);
  __syncwarp();
  lane_step<1>(ops[1], s);
  __syncwarp();
  lane_step<2>(ops[2], s);
  __syncwarp();
  lane_step<3>(ops[3], s);
  __syncwarp();
}
