// vec_mul / vec_add / vec_sub: elementwise (a * b), (a + b) and (a - b)
// mod m over canonical standard-form (4, n) words, for m = p (FP) or
// m = r (FR).  b is either (4, n) or a single (4, 1) element broadcast
// over the n lanes.
//
// Replaces mpc_bulletproof_tpu/ops/kernels.py _vec2 (vec_mul, vec_add,
// vec_sub), one Pallas kernel per op over (8, 128) granules of 13-bit
// limbs, with Barrett products (limb._mod_mul / _mod_add / _mod_sub): its
// inputs and outputs are standard-form residues, and so are these.
//
// Bound on this card: memory.  A lane reads 64 bytes and writes 32; the
// product is two Montgomery products (a b R^-1, then by R^2 R^-1 to leave
// Montgomery form), ~600 operations, below the ~20 operations per byte at
// which the card turns compute-bound.
//
// Design: one thread per lane, limb-major words so neighbouring threads
// read neighbouring addresses; the op and the modulus are template
// arguments, chosen by the entry point as mod_pow.cu chooses the modulus.
#include "field.cuh"

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

template <class F, int OP>
__global__ void vec2_kernel(const u64 *__restrict__ a, const u64 *__restrict__ b,
                            u64 *__restrict__ out, long long n, long long nb) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  Fe x = fe_load(a, n, k);
  Fe y = fe_load(b, nb, nb == 1 ? 0 : k);
  Fe r;
  if (OP == OP_MUL)
    r = fe_mont_mul<F, 1>(fe_mont_mul<F, 1>(x, y), fe_r2<F>());
  else if (OP == OP_ADD)
    r = fe_add<F>(x, y);
  else
    r = fe_sub<F>(x, y);
  fe_store(out, n, k, r);
}

template <class F>
static void launch(int op, const u64 *a, const u64 *b, u64 *out, long long n, long long nb,
                   cudaStream_t stream) {
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (op == OP_MUL)
    vec2_kernel<F, OP_MUL><<<blocks, threads, 0, stream>>>(a, b, out, n, nb);
  else if (op == OP_ADD)
    vec2_kernel<F, OP_ADD><<<blocks, threads, 0, stream>>>(a, b, out, n, nb);
  else
    vec2_kernel<F, OP_SUB><<<blocks, threads, 0, stream>>>(a, b, out, n, nb);
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
