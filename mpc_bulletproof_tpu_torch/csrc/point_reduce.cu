// point_reduce: segmented point sums.  A contiguous (3, 4, S, n) batch is
// read as S independent segments of n points; the result (3, 4, S, 1)
// holds each segment's sum.  S = 1 is the sum of one batch.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_reduce
// (_preduce_kernel), which accumulated (8, 128) granules along a sequential
// Pallas grid in VMEM and finished with an in-register halving tree.  Here
// one kernel serves every point sum of the port: the range prover's
// A-commitment bit sum (1 x 8,192 points at m = 64), every bucket tail of
// the MSMs (16 x 256 on the prover's split-table MSMs, 26 x 512 on the
// verifier's, 8 x 32,768 in the 2^20 MSM) and the fixed-base commitments
// (k x 64).
//
// Bound on this card: a sum of n points is n - 1 complete adds on a
// dependency tree at least ceil(log2 n) adds deep.  Up to tens of
// thousands of points the depth bounds it (13 dependent adds at 8,192
// points; the one-block design this replaces, whose threads each folded 32
// points with the one-thread add, took 0.375 ms there, ~48 one-thread add
// latencies).
// From ~10^5 points the issue of the adds' multiplies bounds it, as in
// point_add's wide design.
//
// Design: a sum runs as a few passes, each one launch that shrinks every
// segment from m points to fewer.  The wrapper (ops/kernels.py,
// point_reduce_plan) picks the passes from (S, n) by a fixed rule, so the
// association never depends on the SM count, on scheduling or on which
// block ends first (no atomics), and kernels.point_reduce_plain adds in
// the same order: the two agree on the projective words.
// - fold (point_fold_kernel): thread t of a segment adds points t, t + w,
//   t + 2w, ... (w = ceil(m / run)) in series with the one-thread add
//   (pt_add<1>, the fewest instructions an add), the next point loaded
//   before each add.  Neighbouring threads read neighbouring points.  Only
//   where the sum is issue-bound: the plan folds while it keeps >= 32,768
//   threads (two warps a scheduler) and >= 4 threads a segment (a warp's
//   loads then fill whole 32-byte sectors).
// - tree (point_tree_kernel<LEVELS>): a block reduces sub-trees of
//   C = 2^LEVELS consecutive points of a segment on the warp-split add of
//   curve.cuh (warp_add, 8 lanes an add, a dependent add waits on 3
//   product latencies instead of 14).  Group g of the block loads leaves
//   2g and 2g + 1 (points on neighbouring threads, all loads in flight at
//   once; leaves past the segment are the identity) and adds them; at each
//   further level group g adds the partials of groups 2g and 2g + 1, staged
//   through registers between two __syncthreads, so the live groups stay
//   at the front and whole warps drop out.  A warp runs warp_add if any of
//   its groups is live (idle groups add their own stale slots), so no lane
//   diverges around a __syncwarp.  Blocks of C / 2 groups (at least one
//   warp, which then holds several short sub-trees), so a pass over many
//   short segments or chunks spreads over every SM.
// A pass has at most 6 levels (32 groups, 256 threads, 29,696 bytes of
// slot tables); the plan splits ceil(log2 m) levels over as few passes as
// that allows.  Passes of 7 and 8 levels (512 and 1,024 threads) were
// measured and dropped: they tied or lost at every path shape, by up to
// 1.7x at 16 x 256 (one SM then issues all of a segment's first level).
#include "curve.cuh"

#define FOLD_THREADS 128
#define TREE_MAX_LEVELS 6

__global__ void __launch_bounds__(FOLD_THREADS)
point_fold_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, long long S, long long m,
                  int run, long long w) {
  const long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (j >= S * w) return;
  const long long s = j / w, t = j - s * w, plane = S * m;
  const u64 *seg = x + s * m;
  // points t + k w < m for k <= adds (t < w <= m)
  const int adds = (int)min((long long)run - 1, (m - 1 - t) / w);
  Pt acc = pt_load(seg, plane, t);
  Pt next = acc;
  if (adds > 0) next = pt_load(seg, plane, t + w);
  for (int k = 1; k <= adds; k++) {
    const Pt cur = next;
    if (k < adds) next = pt_load(seg, plane, t + (k + 1) * w);
    acc = pt_add<1>(acc, cur);
  }
  pt_store(out, S * w, j, acc);
}

template <int LEVELS>
struct TreeShape {
  static constexpr int C = 1 << LEVELS;                           // leaves of a sub-tree
  static constexpr int GROUPS = LEVELS >= 3 ? C / 2 : 4;          // at least one warp
  static constexpr int THREADS = GROUPS * WARP_ADD_LANES;
  static constexpr int LEAVES = 2 * GROUPS;
  static constexpr int SUBTREES = LEAVES / C;                     // sub-trees a block
};

// word w < 12 (coordinate w / 4, 64-bit word w % 4) of the identity (0 : 1_M : 0)
BP_DEV u64 identity_word(int w) {
  return w == 4 ? FpConst::ONE0 : w == 5 ? FpConst::ONE1 : w == 6 ? FpConst::ONE2
                                                          : w == 7 ? FpConst::ONE3 : 0ull;
}

BP_DEV u64 slot_word(const Fe *t, int w) {
  const Fe &e = t[X1 + w / 4];
  return (u64)e.v[2 * (w % 4)] | ((u64)e.v[2 * (w % 4) + 1] << 32);
}

// word w < 24 of a group's P (0..11) and Q (12..23)
BP_DEV void set_slot_word(Fe *t, int w, u64 v) {
  Fe &e = t[X1 + w / 4];
  e.v[2 * (w % 4)] = (u32)v;
  e.v[2 * (w % 4) + 1] = (u32)(v >> 32);
}

template <int LEVELS>
__global__ void __launch_bounds__(TreeShape<LEVELS>::THREADS)
point_tree_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, long long S, long long m,
                  long long w) {
  using Sh = TreeShape<LEVELS>;
  __shared__ __align__(16) Fe s[Sh::GROUPS][NSLOT];
  const int tid = threadIdx.x, group = tid / WARP_ADD_LANES, lane = tid % WARP_ADD_LANES;
  const long long subtrees = S * w, j0 = (long long)blockIdx.x * Sh::SUBTREES, plane = S * m;
  LaneOp ops[WARP_ADD_STEPS];
#pragma unroll
  for (int i = 0; i < WARP_ADD_STEPS; i++) ops[i] = lane_op(i, lane);

  // word wd of leaf q, leaves on neighbouring threads; sub-tree j covers
  // points (j mod w) C .. + C - 1 of segment j / w
  constexpr int LOADS = Sh::LEAVES * 12 / Sh::THREADS;
  u64 v[LOADS];
#pragma unroll
  for (int r = 0; r < LOADS; r++) {
    const int i = tid + r * Sh::THREADS, q = i % Sh::LEAVES, wd = i / Sh::LEAVES;
    const long long j = j0 + q / Sh::C, seg = j / w, pt = (j - seg * w) * Sh::C + q % Sh::C;
    v[r] = j < subtrees && pt < m ? x[wd * plane + seg * m + pt] : identity_word(wd);
  }
#pragma unroll
  for (int r = 0; r < LOADS; r++) {
    const int i = tid + r * Sh::THREADS, q = i % Sh::LEAVES, wd = i / Sh::LEAVES;
    set_slot_word(s[q / 2], wd + 12 * (q % 2), v[r]);
  }
  if (lane == 0) {
    s[group][ZERO] = fe_zero();
    s[group][B3] = b3_mont();
  }
  __syncthreads();
  warp_add(ops, s[group]);  // level 1: leaves 2g + (2g + 1) into group g's P
#pragma unroll 1
  for (int l = 1; l < LEVELS; l++) {
    const int live = Sh::GROUPS >> l;  // level l + 1: group g adds partials 2g, 2g + 1
    u64 st[3];
    __syncthreads();
    if (group < live) {
#pragma unroll
      for (int r = 0; r < 3; r++) {
        const int u = lane + WARP_ADD_LANES * r;
        st[r] = slot_word(s[2 * group + u / 12], u % 12);
      }
    }
    __syncthreads();
    if (group < live) {
#pragma unroll
      for (int r = 0; r < 3; r++) set_slot_word(s[group], lane + WARP_ADD_LANES * r, st[r]);
    }
    __syncwarp();
    if ((group & ~3) < live) warp_add(ops, s[group]);  // uniform across the warp
  }
  __syncthreads();
  // partial k < SUBTREES sits in group k's P
  constexpr int STORES = (Sh::SUBTREES * 12 + Sh::THREADS - 1) / Sh::THREADS;
#pragma unroll
  for (int r = 0; r < STORES; r++) {
    const int i = tid + r * Sh::THREADS, k = i % Sh::SUBTREES, wd = i / Sh::SUBTREES;
    const long long j = j0 + k;
    if (i < Sh::SUBTREES * 12 && j < subtrees) out[wd * subtrees + j] = slot_word(s[k], wd);
  }
}

template <int LEVELS>
static int launch_tree(const void *x, void *out, long long S, long long m, cudaStream_t stream) {
  using Sh = TreeShape<LEVELS>;
  const long long w = (m + Sh::C - 1) / Sh::C;
  const long long blocks = (S * w + Sh::SUBTREES - 1) / Sh::SUBTREES;
  point_tree_kernel<LEVELS><<<(unsigned)blocks, Sh::THREADS, 0, stream>>>(
      (const u64 *)x, (u64 *)out, S, m, w);
  return (int)cudaGetLastError();
}

// One pass over (3, 4, S, m) -> (3, 4, S, w): fold != 0 folds runs of
// `param` points (w = ceil(m / param)), else a tree of `param` levels
// (w = ceil(m / 2^param)).
extern "C" int bp_point_reduce(const void *x, void *out, long long S, long long m, int fold,
                               int param, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || m <= 0 || param < 1 || (!fold && param > TREE_MAX_LEVELS))
    return (int)cudaErrorInvalidValue;
  if (fold) {
    const long long w = (m + param - 1) / param;
    const long long blocks = (S * w + FOLD_THREADS - 1) / FOLD_THREADS;
    point_fold_kernel<<<(unsigned)blocks, FOLD_THREADS, 0, st>>>((const u64 *)x, (u64 *)out, S, m,
                                                                 param, w);
    return (int)cudaGetLastError();
  }
  switch (param) {
    case 1: return launch_tree<1>(x, out, S, m, st);
    case 2: return launch_tree<2>(x, out, S, m, st);
    case 3: return launch_tree<3>(x, out, S, m, st);
    case 4: return launch_tree<4>(x, out, S, m, st);
    case 5: return launch_tree<5>(x, out, S, m, st);
    default: return launch_tree<6>(x, out, S, m, st);
  }
}
