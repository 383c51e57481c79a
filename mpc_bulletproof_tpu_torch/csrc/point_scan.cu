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
// Bound on this card: by the roofline, memory (96 bytes in and out per
// point against ~2,240 operations per add); each lane's T - 1 dependent
// adds are its latency chain.
//
// Design: blocks on Hopper run in no order, so nothing can carry across the
// grid.  One thread owns one lane and loops over T inside the kernel with
// the running sum in registers; the grid covers the L lanes (16,384 at the
// m = 64 shapes, T = 16 or 17).  One body serves both layouts: the entry
// points pass the strides between coordinates, words and steps.
#include "curve.cuh"

struct Strides {
  long long coord, word, step;
};

__device__ __forceinline__ Pt load_at(const u64 *base, const Strides &s, long long off) {
  Pt p;
  p.x = fe_load(base, s.word, off);
  p.y = fe_load(base + s.coord, s.word, off);
  p.z = fe_load(base + 2 * s.coord, s.word, off);
  return p;
}

__device__ __forceinline__ void store_at(u64 *base, const Strides &s, long long off, const Pt &p) {
  fe_store(base, s.word, off, p.x);
  fe_store(base + s.coord, s.word, off, p.y);
  fe_store(base + 2 * s.coord, s.word, off, p.z);
}

__global__ void point_scan_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, int T,
                                  long long L, Strides s) {
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  Pt acc = load_at(x, s, l);
  store_at(out, s, l, acc);
  for (int t = 1; t < T; t++) {
    long long off = (long long)t * s.step + l;
    acc = pt_add(acc, load_at(x, s, off));
    store_at(out, s, off, acc);
  }
}

static int launch_scan(const void *x, void *out, int T, long long L, Strides s, void *stream) {
  const int threads = 128;
  long long blocks = (L + threads - 1) / threads;
  if (L > 0 && T > 0)
    point_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
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
