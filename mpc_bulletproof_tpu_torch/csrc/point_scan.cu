// point_scan_steps_inner: inclusive prefix point-sum along the step axis T
// of a (3, 4, T, L) batch; the L lanes are independent scans.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_scan_steps_inner
// (_pscan_kernel), which walked T as a sequential Pallas grid and carried
// the running prefix from one grid step to the next in VMEM scratch.
//
// Bound on this card: by the roofline, memory (96 bytes in and out per
// point against ~2,240 operations per add); each lane's T - 1 dependent
// adds are its latency chain.
//
// Design: blocks on Hopper run in no order, so nothing can carry across the
// grid.  One thread owns one lane and loops over T inside the kernel with
// the running sum in registers; the grid covers the L lanes (16,384 at the
// m = 64 shapes, T = 16 or 17).
#include "curve.cuh"

__global__ void point_scan_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, int T,
                                  long long L) {
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const long long stride = (long long)T * L;  // between (coord, word) rows
  Pt acc = pt_load(x, stride, l);
  pt_store(out, stride, l, acc);
  for (int t = 1; t < T; t++) {
    Pt p = pt_load(x, stride, (long long)t * L + l);
    acc = pt_add(acc, p);
    pt_store(out, stride, (long long)t * L + l, acc);
  }
}

extern "C" int bp_point_scan(const void *x, void *out, int T, long long L, void *stream) {
  const int threads = 128;
  long long blocks = (L + threads - 1) / threads;
  if (L > 0 && T > 0)
    point_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64 *)x, (u64 *)out, T, L);
  return (int)cudaGetLastError();
}
