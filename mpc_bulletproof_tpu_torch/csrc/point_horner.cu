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
// Design: one warp per output cuts the latency of one add: lanes 0..7
// run the warp-split add of curve.cuh (warp_add: the add's 3 product
// levels on 6 lanes at once, through a table of field elements in shared
// memory; each step's operand form fixed at compile time, lane_step<FORM>,
// which cut the add by 22% against one generic form).  point_add's narrow
// kernel runs the same add.  Each product stays on one thread: the level
// split alone takes the add from 14 products' latency to 3, which leaves
// the products ~70% of it; splitting them over lanes is not done.  The
// chain starts from the top window's sum instead of doubling the identity
// c times (point_horner_plain starts the same way); the next window's sum
// is loaded before the c doublings it waits behind.  Values are canonical,
// so X, Y, Z equal point_horner_plain's bit for bit.
#include "curve.cuh"

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
  LaneOp ops[WARP_ADD_STEPS];
#pragma unroll
  for (int i = 0; i < WARP_ADD_STEPS; i++)
    ops[i] = lane < WARP_ADD_LANES ? lane_op(i, lane) : LaneOp{};
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
