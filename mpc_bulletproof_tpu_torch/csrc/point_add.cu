// point_add: complete projective addition over a (3, 4, n) batch.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_add (_padd_kernel), the
// Pallas kernel that ran RCB16 over (8, 128) granules of 13-bit limbs with
// lanes zero-padded to 1024.
//
// Bound on this card: by the roofline, memory: an add reads 192 bytes and
// writes 96 against ~2,240 multiply operations (14 Montgomery products of
// 80 32 x 32 multiply-adds each), under the ~20 operations per byte at
// which H100 turns compute-bound.  In practice the carry chains'
// instruction issue and, at the widths of one proof (at most 16,384
// lanes), the launch itself set the time.  It takes the field product
// with its rounds rolled (pt_add<1>): a third of the code, 12% faster.
//
// Design: one thread per output lane, grid over n; limb-major words make
// neighbouring threads read neighbouring addresses.  No padding and no
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

extern "C" int bp_point_add(const void *a, const void *b, void *out, long long n,
                            void *stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (n > 0)
    point_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64 *)a, (const u64 *)b, (u64 *)out, n);
  return (int)cudaGetLastError();
}
