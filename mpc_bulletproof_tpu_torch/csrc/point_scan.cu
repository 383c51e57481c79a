// point_scan_steps_inner and point_scan_steps: inclusive prefix point-sum
// along a step axis T; the L lanes are independent scans.  The two differ
// only in where T sits:
//
//   point_scan_steps_inner  (3, 4, T, L)   step axis inside the words
//   point_scan_steps        (3, T, 4, L)   step axis outside the words
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_scan_steps_inner and
// point_scan_steps (both _pscan_kernel), which walked T as a sequential
// Pallas grid and carried the running prefix from one grid step to the next
// in VMEM scratch.
//
// Bound on this card: the issue rate of the Montgomery products over the
// lanes, then bytes (96 in and 96 out per point).  The kernel before this
// one ran one thread per lane with the 64-bit product: at the MSM's 16,384
// lanes, one warp on each of the card's 528 schedulers, ~25 us an add
// (13.0 ms at T = 512).
//
// Design: the sequential scan, one thread per lane, blocks of one warp (32
// lanes), so that the 16,384 lanes spread one warp on each scheduler.  Each
// thread keeps the running sum in registers and loads the next step's
// point before the current add, so the load hides behind the add's 14
// products.  The add takes the 32-bit product with its rounds rolled
// (pt_add<1>, a third of the code): one warp a scheduler then issues near
// the card's rate, 3.6 ms at T = 512 over 16,384 lanes (~7 us an add;
// H100, 700 W, PERF.md).  A segmented scan (S segments of the step axis a
// lane, carries through shared memory) was measured and dropped: more
// warps in flight, but a segment's thread runs as many adds as the whole
// chain, and S = 2 or 3 read 1.5x slower at every path shape.  One body
// serves both layouts: the entry points pass the strides between
// coordinates, words and steps.
#include "curve.cuh"

#define SCAN_LANES 32  // lanes of one block

struct Strides {
  long long coord, word, step;
};

BP_DEV Pt load_at(const u64 *base, const Strides &s, long long off) {
  Pt p;
  p.x = fe_load(base, s.word, off);
  p.y = fe_load(base + s.coord, s.word, off);
  p.z = fe_load(base + 2 * s.coord, s.word, off);
  return p;
}

BP_DEV void store_at(u64 *base, const Strides &s, long long off, const Pt &p) {
  fe_store(base, s.word, off, p.x);
  fe_store(base + s.coord, s.word, off, p.y);
  fe_store(base + 2 * s.coord, s.word, off, p.z);
}

__global__ void __launch_bounds__(SCAN_LANES)
point_scan_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, int T, long long L,
                  Strides s) {
  const long long l = (long long)blockIdx.x * SCAN_LANES + threadIdx.x;
  if (l >= L) return;
  Pt acc = load_at(x, s, l);
  store_at(out, s, l, acc);
  Pt next = acc;
  if (T > 1) next = load_at(x, s, s.step + l);
  for (int t = 1; t < T; t++) {
    const Pt cur = next;
    if (t + 1 < T) next = load_at(x, s, (t + 1) * s.step + l);
    acc = pt_add<1>(acc, cur);
    store_at(out, s, t * s.step + l, acc);
  }
}

static int launch_scan(const void *x, void *out, int T, long long L, Strides s, void *stream) {
  const long long blocks = (L + SCAN_LANES - 1) / SCAN_LANES;
  if (L > 0 && T > 0)
    point_scan_kernel<<<(unsigned)blocks, SCAN_LANES, 0, (cudaStream_t)stream>>>(
        (const u64 *)x, (u64 *)out, T, L, s);
  return (int)cudaGetLastError();
}

// (3, 4, T, L)
extern "C" int bp_point_scan(const void *x, void *out, int T, long long L, void *stream) {
  const long long tl = (long long)T * L;
  return launch_scan(x, out, T, L, Strides{4 * tl, tl, L}, stream);
}

// (3, T, 4, L)
extern "C" int bp_point_scan_steps(const void *x, void *out, int T, long long L, void *stream) {
  return launch_scan(x, out, T, L, Strides{(long long)T * 4 * L, L, 4 * L}, stream);
}
