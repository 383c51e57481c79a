// point_horner_multi: acc = sum_w 2^(c w) S_w for k independent outputs,
// from a (nw, 3, 4, k) batch of window sums (window 0 least significant).
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py point_horner_multi
// (_phorner_kernel), a Pallas grid of nw * (c + 1) sequential steps with the
// accumulator in VMEM scratch and the k outputs on the lanes of one granule.
//
// Bound on this card: latency.  The work is a serial chain of nw * (c + 1)
// complete adds (80 at c = 9, nw = 8) on only k <= 2 live lanes, so one
// thread per output does it all; each add's 14 dependent Montgomery
// products set the time.  It is the serial tail of every MSM.
//
// Design: one thread per output walks the whole chain in registers: for
// each window from the most significant, c doublings, then one add of the
// window sum, starting from the identity as the TPU kernel did.
#include "curve.cuh"

__global__ void point_horner_kernel(const u64 *__restrict__ ws, u64 *__restrict__ out, int nw,
                                    int c, long long k) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  Pt acc = pt_identity();
  for (int w = nw - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) acc = pt_add(acc, acc);
    Pt s = pt_load(ws + (long long)w * 12 * k, k, j);
    acc = pt_add(acc, s);
  }
  pt_store(out, k, j, acc);
}

extern "C" int bp_point_horner(const void *ws, void *out, int nw, int c, long long k,
                               void *stream) {
  const int threads = 32;
  long long blocks = (k + threads - 1) / threads;
  if (k > 0)
    point_horner_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64 *)ws, (u64 *)out, nw, c, k);
  return (int)cudaGetLastError();
}
