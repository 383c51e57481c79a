// point_horner_multi: acc = sum_w 2^(c w) S_w for k independent outputs,
// from a (nw, 3, 4, k) batch of window sums (window 0 least significant).
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_horner_multi
// (_phorner_kernel), a Pallas grid of nw * (c + 1) sequential steps with the
// accumulator in VMEM scratch and the k outputs on the lanes of one granule.
//
// Bound on this card: latency.  The work is a serial chain of (nw - 1) *
// (c + 1) complete adds (70 at nw = 8, c = 9; 279 at nw = 32, c = 8) on
// k <= 2 outputs, and no add can start before the one before it ends.  The
// chain's length is fixed, so the time is the latency of one add times
// the chain: the one-thread kernel before this one ran each add's 14
// Montgomery products one after another, ~16 us an add; this one takes
// ~1.8 us (0.50 ms at nw = 32, c = 8, k = 2, against 4.88; H100, 700 W,
// PERF.md).
//
// Design: one warp per output cuts the latency of one add.  The 14
// products of the RCB add (curve.cuh) form 3 dependent levels: t0..t5
// (6 products), b3 t2 and b3 t4' (2), then 6 products of sums of those.
// Each level runs on lanes 0..5 at once, one product per lane; the sums
// and differences between levels are spread over the lanes the same way,
// fused into each lane's operand fetch.  Operands and results pass
// through a table of field elements in shared memory with __syncwarp()
// between the 4 steps of an add.  Every lane runs the same instruction
// stream on lane-selected slots (the per-lane step table kSteps), so no
// lane waits for another's branch; each step's operand form is fixed at
// compile time (lane_step<FORM>), which cut the add by 22% against one
// generic form.  Each product stays on one thread: the level split alone
// takes the add from 14 products' latency to 3, which leaves the
// products ~70% of it; splitting them over lanes is not done.  The
// chain starts from the top window's sum instead of doubling the identity
// c times (point_horner_plain starts the same way); the next window's sum
// is loaded before the c doublings it waits behind.  Values are canonical,
// so X, Y, Z equal point_horner_plain's bit for bit.
#include "curve.cuh"

// Slots of one warp's table of field elements.
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
struct LaneOp {
  unsigned char a0, a1, a2, b0, b1, b2, dst, dst2, sub_a, sub_b, mul, live;
};

#define HORNER_STEPS 4
#define HORNER_LANES 8

__constant__ LaneOp kSteps[HORNER_STEPS][HORNER_LANES] = {
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
BP_DEV void warp_add(const LaneOp ops[HORNER_STEPS], Fe *s) {
  lane_step<0>(ops[0], s);
  __syncwarp();
  lane_step<1>(ops[1], s);
  __syncwarp();
  lane_step<2>(ops[2], s);
  __syncwarp();
  lane_step<3>(ops[3], s);
  __syncwarp();
}

// Lane l < 12 holds word l of a point (coordinate l / 4, 64-bit word l % 4).
BP_DEV void put_point(Fe *s, int base, int lane, u64 w) {
  if (lane < 12) {
    s[base + lane / 4].v[2 * (lane % 4)] = (u32)w;
    s[base + lane / 4].v[2 * (lane % 4) + 1] = (u32)(w >> 32);
  }
}

__global__ void __launch_bounds__(32)
point_horner_kernel(const u64 *__restrict__ ws, u64 *__restrict__ out, int nw, int c,
                    long long k) {
  __shared__ __align__(16) Fe s[NSLOT];
  const int lane = threadIdx.x;
  const long long j = blockIdx.x;
  LaneOp ops[HORNER_STEPS];
#pragma unroll
  for (int i = 0; i < HORNER_STEPS; i++)
    ops[i] = lane < HORNER_LANES ? kSteps[i][lane] : LaneOp{};
  auto window = [&](int w) { return lane < 12 ? ws[((long long)w * 12 + lane) * k + j] : 0ull; };

  if (lane == 0) {
    s[ZERO] = fe_zero();
    s[B3] = b3_mont();
  }
  const u64 top = window(nw - 1);
  put_point(s, X1, lane, top);
  put_point(s, X2, lane, top);
  __syncwarp();
  for (int w = nw - 2; w >= 0; w--) {
    const u64 next = window(w);  // in flight during the doublings
    for (int i = 0; i < c; i++) warp_add(ops, s);
    put_point(s, X2, lane, next);
    __syncwarp();
    warp_add(ops, s);
  }
  if (lane < 12) {
    const Fe &e = s[X1 + lane / 4];
    out[lane * k + j] = (u64)e.v[2 * (lane % 4)] | ((u64)e.v[2 * (lane % 4) + 1] << 32);
  }
}

extern "C" int bp_point_horner(const void *ws, void *out, int nw, int c, long long k,
                               void *stream) {
  if (nw < 1 || c < 1 || k < 0 || k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (k > 0)
    point_horner_kernel<<<(unsigned)k, 32, 0, (cudaStream_t)stream>>>((const u64 *)ws,
                                                                      (u64 *)out, nw, c, k);
  return (int)cudaGetLastError();
}
