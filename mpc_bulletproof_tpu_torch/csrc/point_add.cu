// point_add: complete projective addition over a (3, 4, n) batch, in two
// designs that the wrapper (ops/kernels.py point_add) picks by the width n.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_add (_padd_kernel), the
// Pallas kernel that ran RCB16 over (8, 128) granules of 13-bit limbs with
// lanes zero-padded to 1024.
//
// Bound on this card: by the roofline, memory: an add reads 192 bytes and
// writes 96 against ~2,240 multiply operations (14 Montgomery products of
// 80 32 x 32 multiply-adds each), under the ~20 operations per byte at
// which H100 turns compute-bound.  In practice two limits, by width: at a
// few thousand lanes the latency of one thread's add (14 dependent
// products, ~8 us a launch at every proof width); from ~8,000
// lanes the issue of the products' mad.wide instructions (~710 cycles a
// product a warp at 262,144 lanes, so 16,384 lanes already need ~5.6 us
// of issue: one warp a scheduler fills the multiplier).
//
// Design:
// - wide (point_add_kernel): one thread per add, grid over n, limb-major
//   words so that neighbouring threads read neighbouring addresses.  It
//   takes the field product with its rounds rolled (pt_add<1>): a third
//   of the code, 12% faster.  It issues the fewest instructions an add.
// - narrow (point_add_narrow_kernel): a group of 8 lanes per add, 4 adds a
//   warp, running the warp-split add of curve.cuh (warp_add, Horner's):
//   the add's 3 product levels on 6 lanes at once, so an add waits on 3
//   product latencies instead of 14.  It issues ~2.4x the cycles an add of
//   the wide design (a level's step costs the warp one product whatever
//   the number of its live lanes, plus the sums and the slot traffic).  A
//   block of NARROW_ADDS adds loads both points of each add into its
//   group's slot table with adds on neighbouring threads (coalesced), all
//   of a thread's loads in flight at once, and writes the sums back the
//   same way; the step table comes through the read-only cache (curve.cuh
//   lane_op: read from constant memory, where the lanes' different
//   addresses likely serialize, the kernel took 5.2 us at 16 lanes; as
//   words from global memory 3.9, measured in two calls).  Lanes past n
//   compute on zeros and store nothing, so every lane reaches each
//   __syncwarp().
// Crossover (POINT_ADD_NARROW_MAX in the wrapper): narrow up to 4,096
// lanes.  Both designs in turns on one H100 80GB HBM3 at 700 W
// (chip_smoke.py's point_add_sweep; device us, wide / narrow): 16 lanes
// 8.02 / 3.79, 256 8.15 / 3.87, 2,048 8.20 / 3.96, 4,096 8.26 / 5.51,
// 8,192 8.33 / 8.99, 13,312 8.46 / 13.57, 16,384 8.57 / 15.18, 65,536
// 23.68 / 51.51, 262,144 88.53 / 195.43 (PERF.md).
// Both give curve_t._point_add's words bit for bit (canonical values),
// doublings, P + (-P) and identity lanes included.  No padding and no
// broadcasting: the caller passes two operands of the same shape (the JAX
// wrapper zero-padded a ragged operand; here the wrapper rejects it).
#include "curve.cuh"

__global__ void point_add_kernel(const u64 *__restrict__ a, const u64 *__restrict__ b,
                                 u64 *__restrict__ out, long long n) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Pt p = pt_load(a, n, k);
  Pt q = pt_load(b, n, k);
  pt_store(out, n, k, pt_add<1>(p, q));
}

#define NARROW_ADDS 16  // adds a block: 128 threads, 14,336 bytes of slot tables
#define NARROW_THREADS (NARROW_ADDS * WARP_ADD_LANES)

__global__ void __launch_bounds__(NARROW_THREADS)
point_add_narrow_kernel(const u64 *__restrict__ a, const u64 *__restrict__ b,
                        u64 *__restrict__ out, long long n) {
  __shared__ __align__(16) Fe s[NARROW_ADDS][NSLOT];
  const int tid = threadIdx.x, group = tid / WARP_ADD_LANES;
  const long long k0 = (long long)blockIdx.x * NARROW_ADDS;
  LaneOp ops[WARP_ADD_STEPS];
#pragma unroll
  for (int i = 0; i < WARP_ADD_STEPS; i++) ops[i] = lane_op(i, tid % WARP_ADD_LANES);
  // word w < 24 of add j (0..11: P's, 12..23: Q's), adds on neighbouring threads
  constexpr int LOADS = NARROW_ADDS * 24 / NARROW_THREADS;
  u64 x[LOADS];
#pragma unroll
  for (int r = 0; r < LOADS; r++) {
    const int i = tid + r * NARROW_THREADS, j = i % NARROW_ADDS, w = i / NARROW_ADDS, c = w % 12;
    const long long k = k0 + j;
    x[r] = k >= n ? 0ull : w < 12 ? a[c * n + k] : b[c * n + k];
  }
#pragma unroll
  for (int r = 0; r < LOADS; r++) {
    const int i = tid + r * NARROW_THREADS, j = i % NARROW_ADDS, w = i / NARROW_ADDS, c = w % 12;
    Fe &e = s[j][(w < 12 ? X1 : X2) + c / 4];
    e.v[2 * (c % 4)] = (u32)x[r];
    e.v[2 * (c % 4) + 1] = (u32)(x[r] >> 32);
  }
  if (tid % WARP_ADD_LANES == 0) {
    s[group][ZERO] = fe_zero();
    s[group][B3] = b3_mont();
  }
  __syncthreads();
  warp_add(ops, s[group]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NARROW_ADDS * 12 / NARROW_THREADS + 1; r++) {
    const int i = tid + r * NARROW_THREADS, j = i % NARROW_ADDS, c = i / NARROW_ADDS;
    const long long k = k0 + j;
    if (i < NARROW_ADDS * 12 && k < n) {
      const Fe &e = s[j][X1 + c / 4];
      out[c * n + k] = (u64)e.v[2 * (c % 4)] | ((u64)e.v[2 * (c % 4) + 1] << 32);
    }
  }
}

extern "C" int bp_point_add(const void *a, const void *b, void *out, long long n, int narrow,
                            void *stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (narrow) {
    const long long blocks = (n + NARROW_ADDS - 1) / NARROW_ADDS;
    point_add_narrow_kernel<<<(unsigned)blocks, NARROW_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64 *)a, (const u64 *)b, (u64 *)out, n);
  } else {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    point_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64 *)a, (const u64 *)b, (u64 *)out, n);
  }
  return (int)cudaGetLastError();
}
