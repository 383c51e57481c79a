// mod_pow_static: batched x^e mod m for a fixed exponent e < 2^256, on
// canonical standard-form (4, n) words, for m = p (FP) or m = r (FR).  On
// the prover it is the Fermat inverse (e = m - 2): y^-1 and each IPP
// round's u^-1 in FR, and the z^-1 of every projective-to-affine
// conversion before a transcript absorb in FP.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py mod_pow_static (_pow_kernel),
// a 4-bit fixed-window ladder over exponent digits held in SMEM, with
// Barrett products on 13-bit limbs.
//
// Bound on this card: latency.  One ladder is ~270 dependent Montgomery
// products (14 for the table, then 4 squarings and at most 1 product per
// digit); on the proof path the batch is 1 to 64 lanes (32,772 once, when
// the split table is built), so a single warp does the work.
//
// Design: one thread per element runs the ladder in Montgomery form (one
// product by R^2 in, one by 1 out).  The exponent travels by value as four
// words; digits are read most significant first, leading zeros skipped.
// x = 0 gives 0 for e > 0, as the callers expect (they substitute 1 for
// identity lanes themselves).
#include "field.cuh"

template <class F>
__global__ void mod_pow_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, long long n,
                               u64 e0, u64 e1, u64 e2, u64 e3) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const u64 e[4] = {e0, e1, e2, e3};
  Fe xm = fe_mont_mul<F>(fe_load(x, n, k), fe_r2<F>());
  Fe table[16];
  table[0] = fe_one_mont<F>();
  table[1] = xm;
#pragma unroll 1
  for (int i = 2; i < 16; i++) table[i] = fe_mont_mul<F>(table[i - 1], xm);
  Fe acc = fe_one_mont<F>();
  bool started = false;
#pragma unroll 1
  for (int d = 63; d >= 0; d--) {
    int digit = (int)((e[d >> 4] >> (4 * (d & 15))) & 15ull);
    if (started) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) acc = fe_mont_mul<F>(acc, acc);
    }
    if (digit) {
      acc = fe_mont_mul<F>(acc, table[digit]);
      started = true;
    }
  }
  Fe one = fe_zero();
  one.v[0] = 1;
  fe_store(out, n, k, fe_mont_mul<F>(acc, one));
}

extern "C" int bp_mod_pow(const void *x, void *out, long long n, u64 e0, u64 e1, u64 e2,
                          u64 e3, int field, void *stream) {
  const int threads = 64;
  long long blocks = (n + threads - 1) / threads;
  if (n > 0) {
    if (field == 0)
      mod_pow_kernel<FpConst><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          (const u64 *)x, (u64 *)out, n, e0, e1, e2, e3);
    else
      mod_pow_kernel<FrConst><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          (const u64 *)x, (u64 *)out, n, e0, e1, e2, e3);
  }
  return (int)cudaGetLastError();
}
