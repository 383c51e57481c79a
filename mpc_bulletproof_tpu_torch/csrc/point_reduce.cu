// point_reduce: the sum of a (3, 4, n) point batch as one point.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_reduce
// (_preduce_kernel), which accumulated (8, 128) granules along a sequential
// Pallas grid in VMEM and finished with an in-register halving tree; on
// the fused range prover it is the A-commitment bit-sum over 2nm points.
//
// Bound on this card: latency.  n - 1 adds are little work (8,191 at
// m = 64), but the sum crosses blocks, and blocks cannot exchange partial
// sums without a second pass or atomics (none exist for points).
//
// Design: ONE block of 256 threads.  Thread i folds points i, i + 256, ...
// in registers (32 serial adds at n = 8,192), then a shared-memory halving
// tree of 8 levels folds the 256 partials.  Lanes past n are skipped, not
// padded.  The plain version (kernels.point_reduce_plain) adds in the same
// order, so the two agree on the projective words, not only on the point.
#include "curve.cuh"

#define REDUCE_THREADS 256

__global__ void __launch_bounds__(REDUCE_THREADS)
point_reduce_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, long long n) {
  __shared__ u64 sh[REDUCE_THREADS * 12];
  const int tid = threadIdx.x;
  Pt acc = pt_identity();
  for (long long i = tid; i < n; i += REDUCE_THREADS) acc = pt_add(acc, pt_load(x, n, i));
  pt_store(sh, REDUCE_THREADS, tid, acc);
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      Pt a = pt_load(sh, REDUCE_THREADS, tid);
      Pt b = pt_load(sh, REDUCE_THREADS, tid + s);
      pt_store(sh, REDUCE_THREADS, tid, pt_add(a, b));
    }
    __syncthreads();
  }
  if (tid == 0) pt_store(out, 1, 0, pt_load(sh, REDUCE_THREADS, 0));
}

extern "C" int bp_point_reduce(const void *x, void *out, long long n, void *stream) {
  point_reduce_kernel<<<1, REDUCE_THREADS, 0, (cudaStream_t)stream>>>((const u64 *)x,
                                                                       (u64 *)out, n);
  return (int)cudaGetLastError();
}
