// mod_pow_static: batched x^e mod m for a fixed exponent e < 2^256, on
// canonical standard-form (4, n) words, for m = p (FP) or m = r (FR).  On
// the prover it is always the Fermat inverse (e = m - 2): y^-1 and each
// IPP round's u^-1 in FR, and the z^-1 of every projective-to-affine
// conversion before a transcript absorb in FP.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py mod_pow_static (_pow_kernel),
// a 4-bit fixed-window ladder over exponent digits held in SMEM, with
// Barrett products on 13-bit limbs.
//
// Bound on this card: latency.  On the proof path the batch is 1 to 64
// lanes (32,772 once, when the split table is built), so one warp does the
// work and the time is one lane's dependent chain.  The ladder's chain for
// p - 2 is 314 Montgomery products (16 for the table and the conversion,
// 248 squarings, 50 digit products), ~0.37 us each: 0.118 ms (PERF.md).
//
// Design, two kernels picked by the wrapper (it knows e on the host):
// - e = m - 2 (mod_inv_kernel): x^-1 by T. Pornin's optimized binary GCD
//   ("Optimized Binary GCD for Modular Inversion", IACR ePrint 2020/972,
//   Algorithm 2), in place of any Fermat chain, which needs ~250
//   squarings at least.  State a = x, b = m, u = 1, v = 0, with a = u x
//   and b = v x (mod m) throughout.  A round takes 64-bit approximations
//   of a and b (the top 33 bits of the wider at its length, over the low
//   31 bits), runs 31 binary-GCD steps on them with selects, not branches,
//   and records signed update factors (|f| + |g| <= 2^31).  It then
//   applies them to the full values: a, b <- (a f + b g) / 2^31, negated
//   where negative (and their factors with them), and u, v <- (u f + v g)
//   / 2^31 mod m, the division by 2^31 a Montgomery step (m odd), so the
//   invariant keeps no power of 2 and no final correction is needed.  b
//   stays odd, a reaches 0 and b = gcd = 1 within 2 * 252 - 1 = 503 steps
//   (Pornin's bound), so a fixed 17 rounds (527 steps) end with v = x^-1;
//   rounds after a = 0 leave v alone, and x = 0 gives v = 0.  The round
//   count is fixed, so lanes never diverge.  Limbs are 8 x 32 bits as in
//   field.cuh; a factor is a 32-bit magnitude (2^31 occurs) and a sign
//   mask.  For FP, m = 1 mod 2^192, so the Montgomery quotient is -t mod
//   2^31 and q m is three nonzero limbs; FR takes the full q m.
// - any other exponent (mod_pow_kernel): the 4-bit ladder that served
//   every exponent before the GCD.  One thread per element runs it in
//   Montgomery form (one product by R^2 in, one by 1 out); the exponent
//   travels by value as four words; digits are read most significant
//   first, leading zeros skipped.  No path calls it.
// x = 0 gives 0 for e > 0 in both, as the callers expect (they substitute
// 1 for identity lanes themselves).
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

// --- the binary GCD inverse

#define GCD_ROUNDS 17
#define GCD_STEPS 31

// t = a * f, 9 limbs (a < 2^256, f < 2^32)
BP_DEV void mul_small(const Fe &a, u32 f, u32 t[9]) {
  u64 p[8];
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] = mad_wide(a.v[j], f, 0ull);
  t[0] = lo32(p[0]);
  t[1] = add_cc(lo32(p[1]), hi32(p[0]));
#pragma unroll
  for (int j = 2; j < 8; j++) t[j] = addc_cc(lo32(p[j]), hi32(p[j - 1]));
  t[8] = addc(hi32(p[7]), 0u);
}

// t = -t mod 2^288 where mask is all ones, else t
BP_DEV void cond_neg9(u32 t[9], u32 mask) {
  t[0] = add_cc(t[0] ^ mask, mask & 1u);
#pragma unroll
  for (int j = 1; j < 8; j++) t[j] = addc_cc(t[j] ^ mask, 0u);
  t[8] = addc(t[8] ^ mask, 0u);
}

// t += s over 9 limbs, mod 2^288
BP_DEV void add9(u32 t[9], const u32 s[9]) {
  t[0] = add_cc(t[0], s[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) t[j] = addc_cc(t[j], s[j]);
  t[8] = addc(t[8], s[8]);
}

// t / 2^31 for t < 2^287 divisible by 2^31 -> 8 limbs
BP_DEV Fe shr31(const u32 t[9]) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = __funnelshift_r(t[j], t[j + 1], 31);
  return r;
}

// A signed update factor: its magnitude (<= 2^31) and a sign mask.
struct Factor {
  u32 mag, neg;
};

BP_DEV Factor factor(long long f) {
  const u32 neg = f < 0 ? ~0u : 0u;
  return {(u32)(f < 0 ? -f : f), neg};
}

// |a f + b g| / 2^31 for a, b < 2^252; neg gets the sign mask of a f + b g.
BP_DEV Fe lin_comb(const Fe &a, const Fe &b, Factor f, Factor g, u32 &neg) {
  u32 t[9], s[9];
  mul_small(a, f.mag, t);
  mul_small(b, g.mag, s);
  cond_neg9(t, f.neg);
  cond_neg9(s, g.neg);
  add9(t, s);  // |a f + b g| <= 2^252 (|f| + |g|) <= 2^283
  neg = 0u - (t[8] >> 31);
  cond_neg9(t, neg);
  return shr31(t);
}

// (u f + v g) / 2^31 mod m for canonical u, v, canonical out.  A negative
// factor takes m - u (or m - v): t = u' |f| + v' |g| <= m 2^31, then
// t + q m with q = -t m^-1 mod 2^31 is divisible by 2^31 and below m 2^32,
// so the quotient lies below 2m: one conditional subtraction.
template <class F>
BP_DEV Fe mont_comb(const Fe &u, const Fe &v, Factor f, Factor g) {
  u32 nu[8], nv[8];
  nu[0] = sub_cc(mlimb<F>(0), u.v[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) nu[j] = subc_cc(mlimb<F>(j), u.v[j]);
  nu[7] = subc(mlimb<F>(7), u.v[7]);
  nv[0] = sub_cc(mlimb<F>(0), v.v[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) nv[j] = subc_cc(mlimb<F>(j), v.v[j]);
  nv[7] = subc(mlimb<F>(7), v.v[7]);
  Fe uu, vv;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uu.v[j] = (nu[j] & f.neg) | (u.v[j] & ~f.neg);
    vv.v[j] = (nv[j] & g.neg) | (v.v[j] & ~g.neg);
  }
  u32 t[9], s[9];
  mul_small(uu, f.mag, t);
  mul_small(vv, g.mag, s);
  add9(t, s);
  const u32 q = (t[0] * F::MINV) & 0x7fffffffu;  // -t m^-1 mod 2^31
  if constexpr (F::SPARSE) {
    // q m = q + 17 q 2^192 + q 2^251 (limbs 0, 6 and 7)
    const u64 q6 = (u64)q * 17u, q7 = (u64)q << 27;
    t[0] = add_cc(t[0], q);
#pragma unroll
    for (int j = 1; j < 6; j++) t[j] = addc_cc(t[j], 0u);
    t[6] = addc_cc(t[6], lo32(q6));
    t[7] = addc_cc(t[7], hi32(q6));
    t[8] = addc(t[8], 0u);
    t[7] = add_cc(t[7], lo32(q7));
    t[8] = addc(t[8], hi32(q7));
  } else {
    const Fe m = fe_from_words(F::M0, F::M1, F::M2, F::M3);
    mul_small(m, q, s);
    add9(t, s);
  }
  const Fe r = shr31(t);
  return reduce_once<F>(r.v);
}

template <class F>
__global__ void mod_inv_kernel(const u64 *__restrict__ x, u64 *__restrict__ out, long long n) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Fe a = fe_load(x, n, k);
  Fe b = fe_from_words(F::M0, F::M1, F::M2, F::M3);
  Fe u = fe_zero(), v = fe_zero();
  u.v[0] = 1;
#pragma unroll 1
  for (int round = 0; round < GCD_ROUNDS; round++) {
    // the approximations: top 33 bits at len = max(len(a), len(b), 64), low 31
    u32 len = 64;
#pragma unroll
    for (int j = 2; j < 8; j++) {
      const u32 w = a.v[j] | b.v[j];
      if (w) len = 32 * j + 32 - __clz(w);
    }
    const u32 sh = len - 33, wi = sh >> 5;  // 31 <= sh <= 219, so wi + 1 <= 7
    u64 a2 = 0, b2 = 0;  // limbs wi, wi + 1 of a and of b
#pragma unroll
    for (int j = 0; j < 7; j++) {
      if (j == wi) {
        a2 = (u64)a.v[j] | ((u64)a.v[j + 1] << 32);
        b2 = (u64)b.v[j] | ((u64)b.v[j + 1] << 32);
      }
    }
    const u64 top = (1ull << 33) - 1;
    u64 at = (((a2 >> (sh & 31)) & top) << 31) | (a.v[0] & 0x7fffffffu);
    u64 bt = (((b2 >> (sh & 31)) & top) << 31) | (b.v[0] & 0x7fffffffu);
    long long f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
    for (int s = 0; s < GCD_STEPS; s++) {
      // odd: a' = |a - b| / 2, b' = min(a, b), the factors swapped with them;
      // even: a' = a / 2.  (f1, g1) double either way.
      const bool odd = at & 1, swap = odd && at < bt;
      const u64 d = at - bt;
      const u64 na = swap ? 0ull - d : odd ? d : at;
      bt = swap ? at : bt;
      const long long sf = swap ? f1 : f0, sg = swap ? g1 : g0;
      f1 = swap ? f0 : f1;
      g1 = swap ? g0 : g1;
      f0 = odd ? sf - f1 : sf;
      g0 = odd ? sg - g1 : sg;
      at = na >> 1;
      f1 <<= 1;
      g1 <<= 1;
    }
    Factor F0 = factor(f0), G0 = factor(g0), F1 = factor(f1), G1 = factor(g1);
    u32 nega, negb;
    const Fe na = lin_comb(a, b, F0, G0, nega);
    const Fe nb = lin_comb(a, b, F1, G1, negb);
    F0.neg ^= nega;
    G0.neg ^= nega;
    F1.neg ^= negb;
    G1.neg ^= negb;
    const Fe nu = mont_comb<F>(u, v, F0, G0);
    v = mont_comb<F>(u, v, F1, G1);
    u = nu;
    a = na;
    b = nb;
  }
  fe_store(out, n, k, v);
}

extern "C" int bp_mod_pow(const void *x, void *out, long long n, u64 e0, u64 e1, u64 e2,
                          u64 e3, int field, int inverse, void *stream) {
  const int threads = 64;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    if (inverse) {
      if (field == 0)
        mod_inv_kernel<FpConst><<<(unsigned)blocks, threads, 0, st>>>((const u64 *)x,
                                                                      (u64 *)out, n);
      else
        mod_inv_kernel<FrConst><<<(unsigned)blocks, threads, 0, st>>>((const u64 *)x,
                                                                      (u64 *)out, n);
    } else if (field == 0) {
      mod_pow_kernel<FpConst><<<(unsigned)blocks, threads, 0, st>>>(
          (const u64 *)x, (u64 *)out, n, e0, e1, e2, e3);
    } else {
      mod_pow_kernel<FrConst><<<(unsigned)blocks, threads, 0, st>>>(
          (const u64 *)x, (u64 *)out, n, e0, e1, e2, e3);
    }
  }
  return (int)cudaGetLastError();
}
