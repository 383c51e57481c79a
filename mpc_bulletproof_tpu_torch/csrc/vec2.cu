// The field's elementwise kernels: vec_mul / vec_add / vec_sub, and the
// three fixed expressions of the MPC device share plane (the Beaver
// difference, the Beaver combination and the degree-3 evaluation at a
// public point), each one launch.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py _vec2 (vec_mul, vec_add,
// vec_sub), one Pallas kernel per op over (8, 128) granules of 13-bit
// limbs, with Barrett products (limb._mod_mul / _mod_add / _mod_sub): its
// inputs and outputs are standard-form residues, and so are these.  The
// JAX package's share plane (parallel/device_shares.py DeviceShareVector,
// models/r1cs_mpc/authenticated_poly.py) composes those ops one call an
// operation; the three share-plane entries compute the same expressions
// in one pass.
//
// Bound on this card: memory, and launches.  A vec_add lane reads 64 bytes
// and writes 32; a product is ~256 operations, so the elementwise ops sit
// below the ~20 operations per byte at which the card turns compute-bound.
// On the share plane's path a launch moves 1.3 to 11.8 MB (4,096 to
// 73,728 lanes), 0.4 to 3.5 us of bytes, against ~1.2 us of launch and
// fill a launch: so each Beaver round's local algebra and each evaluation
// is one launch.
//
// Design: one thread per lane (per lane and row where rows are
// independent), limb-major words so neighbouring threads read
// neighbouring addresses.  A product a b of standard-form values is two
// Montgomery products (a b R^-1, then by R^2); where one operand is public
// or used several times it is put in Montgomery form once (b R), and each
// use is one product: mont(a, b R) = a b.  vec_mul with a width-1 b does
// that once per block (one thread, then shared memory); the Beaver
// combination converts its opened d and e once a lane and uses each three
// times; the MAC key share and the evaluation point come in Montgomery
// form by value from the host.  Stacks of (4, k) operands are contiguous
// (..., 4, k) tensors: matrix j at j * 4k words.  The share plane's
// entries and the width-1 product take fe_mont_mul's full unroll, which
// lets a thread's independent products overlap; measured on the H100 it
// beat the rolled product on all three, and neither 32- or 64-thread
// blocks nor a thread a row for the combination (73,728 threads, 11
// products a lane in place of 8) beat 128 threads a lane (PERF.md).
#include "field.cuh"

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

template <class F, int OP>
__global__ void vec2_kernel(const u64 *__restrict__ a, const u64 *__restrict__ b,
                            u64 *__restrict__ out, long long n) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Fe x = fe_load(a, n, k);
  Fe y = fe_load(b, n, k);
  Fe r;
  if (OP == OP_MUL)
    r = fe_mont_mul<F, 1>(fe_mont_mul<F, 1>(x, y), fe_r2<F>());
  else if (OP == OP_ADD)
    r = fe_add<F>(x, y);
  else
    r = fe_sub<F>(x, y);
  fe_store(out, n, k, r);
}

// b is one element for every lane: + and - read it from the cache, the
// product takes b R from shared memory, made by one thread a block
template <class F, int OP>
__global__ void vec2_public_kernel(const u64 *__restrict__ a, const u64 *__restrict__ b,
                                   u64 *__restrict__ out, long long n) {
  __shared__ Fe br;
  if (OP == OP_MUL) {
    if (threadIdx.x == 0) br = fe_mont_mul<F>(fe_load(b, 1, 0), fe_r2<F>());
    __syncthreads();
  }
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Fe x = fe_load(a, n, k);
  Fe r;
  if (OP == OP_MUL)
    r = fe_mont_mul<F>(x, br);
  else if (OP == OP_ADD)
    r = fe_add<F>(x, fe_load(b, 1, 0));
  else
    r = fe_sub<F>(x, fe_load(b, 1, 0));
  fe_store(out, n, k, r);
}

static const int THREADS = 128;

static unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <class F, int OP>
static void launch_op(const u64 *a, const u64 *b, u64 *out, long long n, long long nb,
                      cudaStream_t s) {
  if (nb == 1)
    vec2_public_kernel<F, OP><<<blocks_for(n), THREADS, 0, s>>>(a, b, out, n);
  else
    vec2_kernel<F, OP><<<blocks_for(n), THREADS, 0, s>>>(a, b, out, n);
}

template <class F>
static void launch(int op, const u64 *a, const u64 *b, u64 *out, long long n, long long nb,
                   cudaStream_t s) {
  if (op == OP_MUL)
    launch_op<F, OP_MUL>(a, b, out, n, nb, s);
  else if (op == OP_ADD)
    launch_op<F, OP_ADD>(a, b, out, n, nb, s);
  else
    launch_op<F, OP_SUB>(a, b, out, n, nb, s);
}

// op: 0 mul, 1 add, 2 sub; field: 0 FP, 1 FR; nb: b's lane count (n or 1)
extern "C" int bp_vec2(const void *a, const void *b, void *out, long long n, long long nb,
                       int op, int field, void *stream) {
  if (op < 0 || op > 2 || (nb != n && nb != 1)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (field == 0)
      launch<FpConst>(op, (const u64 *)a, (const u64 *)b, (u64 *)out, n, nb,
                      (cudaStream_t)stream);
    else
      launch<FrConst>(op, (const u64 *)a, (const u64 *)b, (u64 *)out, n, nb,
                      (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// ---- the share plane's expressions (FR) -------------------------------------

typedef FrConst FR;

// [x - a | y - b] as one (4, 2k) tensor, lane t < k from x and a, lane
// k + t from y and b; a and b are the shares (matrices 0 and 2) of the
// triple's (3, 2, 4, k) stack
__global__ void beaver_diff_kernel(const u64 *__restrict__ x, const u64 *__restrict__ y,
                                   const u64 *__restrict__ triple, u64 *__restrict__ out,
                                   long long k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * k) return;
  const bool second = t >= k;
  const long long i = second ? t - k : t;
  const u64 *share = second ? y : x;
  const u64 *mask = triple + (second ? 2 : 0) * 4 * k;
  fe_store(out, 2 * k, t, fe_sub<FR>(fe_load(share, k, i), fe_load(mask, k, i)));
}

// z = c + d b + e a (+ d e on party 0) and its MAC c_m + d b_m + e a_m +
// alpha_i d e, for the opened d = de[:, :k] and e = de[:, k:] (row stride
// ld = 2k, read in place) and the triple's (3, 2, 4, k) stack [(a, a_m),
// (b, b_m), (c, c_m)]; out is (2, 4, k): shares, then MACs.  alpha R comes
// by value.  Eight products: d R and e R, then one each for d b, e a,
// d b_m, e a_m, d e and alpha d e.
__global__ void beaver_combine_kernel(const u64 *__restrict__ de, long long ld,
                                      const u64 *__restrict__ triple, u64 *__restrict__ out,
                                      long long k, int party, u64 al0, u64 al1, u64 al2, u64 al3) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const long long m = 4 * k;  // words of one (4, k) matrix
  const Fe d = fe_load(de, ld, i);
  const Fe e = fe_load(de + k, ld, i);
  const Fe dr = fe_mont_mul<FR>(d, fe_r2<FR>());
  const Fe er = fe_mont_mul<FR>(e, fe_r2<FR>());
  const Fe d_e = fe_mont_mul<FR>(d, er);
  Fe s = fe_add<FR>(fe_load(triple + 4 * m, k, i),
                    fe_mont_mul<FR>(fe_load(triple + 2 * m, k, i), dr));
  s = fe_add<FR>(s, fe_mont_mul<FR>(fe_load(triple, k, i), er));
  if (party == 0) s = fe_add<FR>(s, d_e);
  Fe mac = fe_add<FR>(fe_load(triple + 5 * m, k, i),
                      fe_mont_mul<FR>(fe_load(triple + 3 * m, k, i), dr));
  mac = fe_add<FR>(mac, fe_mont_mul<FR>(fe_load(triple + m, k, i), er));
  mac = fe_add<FR>(mac, fe_mont_mul<FR>(d_e, fe_from_words(al0, al1, al2, al3)));
  fe_store(out, k, i, s);
  fe_store(out + m, k, i, mac);
}

// c0 + c1 x + c2 x^2 + c3 x^3 by Horner, x R by value, over the (4, 2, 4,
// k) stack [(c_j, c_j MACs)]: thread t < k the shares of lane t, thread
// k + t their MACs; out is (2, 4, k).  Three products a thread.
__global__ void poly3_eval_kernel(const u64 *__restrict__ coeffs, u64 *__restrict__ out,
                                  long long k, u64 x0, u64 x1, u64 x2, u64 x3) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * k) return;
  const long long row = t >= k, i = t - row * k, m = 4 * k;
  const u64 *c = coeffs + row * m;  // c_j of this row at c + 2 j m
  const Fe xr = fe_from_words(x0, x1, x2, x3);
  Fe acc = fe_load(c + 6 * m, k, i);
#pragma unroll
  for (int j = 2; j >= 0; j--)
    acc = fe_add<FR>(fe_mont_mul<FR>(acc, xr), fe_load(c + 2 * j * m, k, i));
  fe_store(out + row * m, k, i, acc);
}

extern "C" int bp_beaver_diff(const void *x, const void *y, const void *triple, void *out,
                              long long k, void *stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  if (k > 0)
    beaver_diff_kernel<<<blocks_for(2 * k), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64 *)x, (const u64 *)y, (const u64 *)triple, (u64 *)out, k);
  return (int)cudaGetLastError();
}

extern "C" int bp_beaver_combine(const void *de, long long ld, const void *triple, void *out,
                                 long long k, int party, u64 al0, u64 al1, u64 al2, u64 al3,
                                 void *stream) {
  if (k < 0 || ld < 2 * k || (party != 0 && party != 1)) return (int)cudaErrorInvalidValue;
  if (k > 0)
    beaver_combine_kernel<<<blocks_for(k), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64 *)de, ld, (const u64 *)triple, (u64 *)out, k, party, al0, al1, al2, al3);
  return (int)cudaGetLastError();
}

extern "C" int bp_poly3_eval(const void *coeffs, void *out, long long k, u64 x0, u64 x1, u64 x2,
                             u64 x3, void *stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  if (k > 0)
    poly3_eval_kernel<<<blocks_for(2 * k), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64 *)coeffs, (u64 *)out, k, x0, x1, x2, x3);
  return (int)cudaGetLastError();
}
