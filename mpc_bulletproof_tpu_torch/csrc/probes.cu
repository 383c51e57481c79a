// Op-rate probes: chains of int32 and float32 operations, one thread per
// lane, that measure what one elementwise operation costs on this card.
//
// Replaces the three Pallas probe kernels of the JAX package's benches,
// which measured the TPU's vector unit (VPU) the same way:
//   probe_chain      benches/tpu_mul_bench.py:40 make_kernel(dtype, op):
//                    acc = op(acc, y), REPS times (a fori_loop), over one
//                    (8, 512) tile;
//   probe_xor_chain  benches/micro_vpu.py:46 make_kernel(op, dtype, reps):
//                    acc = op(acc, x) ^ i (int32) or + (i & 3) (float32),
//                    over a grid of (1, 8, 256) blocks;
//   probe_accum      benches/micro_mul.py:57 make_vpu_kernel(op, dtype):
//                    acc += op(a + i, b) (int32) or op(a, b) (float32) for
//                    i < REP, over a grid of (1, 8, 128) blocks.
// The op lists and their order are those of the benches (ops/probes.py).
//
// Bound on this card: operations.  A lane reads 4 or 8 bytes and writes 4,
// then runs a dependent chain of hundreds to thousands of operations, so
// the float32 rate outside the tensor cores (67 TFLOP/s) bounds the time
// from below; a chain of one lane runs at the latency of its operations,
// so a shape that fills few of the card's 270,336 resident threads (the
// (8, 512) tile fills 1.5%) gives a latency figure, not a rate.
//
// Design: the chain loops at run time (unrolled by 4 at most).  The
// loop-carried dependence alone does not stop the compilers, because
// integer adds and multiplies are associative (seen on the card and in
// the SASS): nvcc's front end folds acc + y, 4,096 times, into a closed
// form, and ptxas rewrites an unrolled body acc * y * y * y * y as two
// products by y^2.  So every step passes the accumulator, and probe_accum
// the op's operand a + i, through opaque() (an empty asm nvcc must assume
// rewrites the register; it costs no instruction, and ptxas never sees
// it), and probe_chain, whose y is the same every step, does not unroll.
// probe_accum's float32 op(a, b) is the same every step, so it is
// computed once and its rows time 64 dependent adds.  int32 is computed
// in uint32_t, where overflow wraps as in JAX and torch; >> on int32 is an
// arithmetic shift of the signed value.  float32 uses __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA, so
// a * y + y rounds twice, as the plain version does.
#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;

__device__ __forceinline__ void opaque(u32 &v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void opaque(float &v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ u32 sar(u32 a, int s) { return (u32)((int32_t)a >> s); }
__device__ __forceinline__ u32 sext16(u32 a) { return (u32)(int32_t)(int16_t)(uint16_t)a; }

// ---- probe_chain: tpu_mul_bench op list ----------------------------------
// 0 i32 mul, 1 i32 mul-add, 2 i32 add, 3 i32 shift+mask,
// 4 f32 mul, 5 f32 mul-add, 6 f32 add, 7 f32 carry (floor-div-mulsub)
template <int OP>
__device__ __forceinline__ u32 chain_i(u32 a, u32 y) {
  if (OP == 0) return a * y;
  if (OP == 1) return a * y + y;
  if (OP == 2) return a + y;
  return (a & 0x1FFFu) + sar(a, 13) + y;
}

template <int OP>
__device__ __forceinline__ float chain_f(float a, float y) {
  if (OP == 4) return __fmul_rn(a, y);
  if (OP == 5) return __fadd_rn(__fmul_rn(a, y), y);
  if (OP == 6) return __fadd_rn(a, y);
  float q = floorf(__fmul_rn(a, 1.0f / 512.0f));
  return __fadd_rn(__fsub_rn(a, __fmul_rn(q, 512.0f)), y);
}

template <int OP>
__global__ void chain_kernel(const void *__restrict__ xv, const void *__restrict__ yv,
                             void *__restrict__ ov, long long n, int reps) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  if (OP < 4) {
    u32 acc = ((const u32 *)xv)[k], y = ((const u32 *)yv)[k];
#pragma unroll 1
    for (int i = 0; i < reps; i++) {
      acc = chain_i<OP>(acc, y);
      opaque(acc);
    }
    ((u32 *)ov)[k] = acc;
  } else {
    float acc = ((const float *)xv)[k], y = ((const float *)yv)[k];
#pragma unroll 1
    for (int i = 0; i < reps; i++) {
      acc = chain_f<OP>(acc, y);
      opaque(acc);
    }
    ((float *)ov)[k] = acc;
  }
}

// ---- probe_xor_chain: micro_vpu OPS ---------------------------------------
// 0 baseline_xor, 1 i32_mul, 2 i32_add, 3 i32_mul_mask, 4 i32_shift,
// 5 f32_mul, 6 f32_add, 7 f32_fma, 8 i32_to_f32, 9 f32_floor
template <int OP>
__device__ __forceinline__ u32 xor_i(u32 a, u32 b) {
  if (OP == 0) return a;
  if (OP == 1) return a * b;
  if (OP == 2) return a + b;
  if (OP == 3) return (a * b) & 0x1FFFu;
  if (OP == 4) return sar(a, 13) + b;
  // i32_to_f32: int32(float(a) + float(b)); the conversion back truncates
  // toward zero and saturates out of range (never reached by the probe's
  // inputs, whose chains stay below 2^31)
  return (u32)__float2int_rz(__fadd_rn(__int2float_rn((int32_t)a), __int2float_rn((int32_t)b)));
}

template <int OP>
__device__ __forceinline__ float xor_f(float a, float b) {
  if (OP == 5) return __fmul_rn(a, b);
  if (OP == 6) return __fadd_rn(a, b);
  if (OP == 7) return __fadd_rn(__fmul_rn(a, b), b);
  return __fadd_rn(floorf(__fmul_rn(a, 0.5f)), b);
}

template <int OP>
__global__ void xor_chain_kernel(const void *__restrict__ xv, void *__restrict__ ov, long long n,
                                 int reps) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  if (OP <= 4 || OP == 8) {
    u32 x = ((const u32 *)xv)[k], acc = x;
#pragma unroll 4
    for (int i = 0; i < reps; i++) {
      acc = xor_i<OP>(acc, x) ^ (u32)i;
      opaque(acc);
    }
    ((u32 *)ov)[k] = acc;
  } else {
    float x = ((const float *)xv)[k], acc = x;
#pragma unroll 4
    for (int i = 0; i < reps; i++) {
      acc = __fadd_rn(xor_f<OP>(acc, x), (float)(i & 3));
      opaque(acc);
    }
    ((float *)ov)[k] = acc;
  }
}

// ---- probe_accum: micro_mul bench_vpu list --------------------------------
// 0 i32 mul, 1 i32 add, 2 i32 shift+and, 3 f32 mul, 4 f32 fma(a*b+a),
// 5 i32 mul16 (masked), 6 i32 mul16 (sext), 7 i32 mul16 (one side)
template <int OP>
__device__ __forceinline__ u32 accum_i(u32 a, u32 b) {
  if (OP == 0) return a * b;
  if (OP == 1) return a + b;
  if (OP == 2) return sar(a, 7) & 0x3Fu;
  if (OP == 5) return (a & 0xFFFFu) * (b & 0xFFFFu);
  if (OP == 6) return sext16(a) * sext16(b);
  return (a & 0xFFFFu) * b;
}

template <int OP>
__device__ __forceinline__ float accum_f(float a, float b) {
  if (OP == 3) return __fmul_rn(a, b);
  return __fadd_rn(__fmul_rn(a, b), a);
}

template <int OP>
__global__ void accum_kernel(const void *__restrict__ av, const void *__restrict__ bv,
                             void *__restrict__ ov, long long n, int rep) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  if (OP == 3 || OP == 4) {
    float a = ((const float *)av)[k], b = ((const float *)bv)[k], acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < rep; i++) {
      acc = __fadd_rn(acc, accum_f<OP>(a, b));
      opaque(acc);
    }
    ((float *)ov)[k] = acc;
  } else {
    u32 a = ((const u32 *)av)[k], b = ((const u32 *)bv)[k], acc = 0;
#pragma unroll 4
    for (int i = 0; i < rep; i++) {
      u32 ai = a + (u32)i;
      opaque(ai);
      acc += accum_i<OP>(ai, b);
      opaque(acc);
    }
    ((u32 *)ov)[k] = acc;
  }
}

// ---- launchers --------------------------------------------------------------

static const int THREADS = 256;

static unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

#define CASE_CHAIN(OP)                                                           \
  case OP:                                                                       \
    chain_kernel<OP><<<blocks_for(n), THREADS, 0, s>>>(x, y, out, n, reps);      \
    break;
#define CASE_XOR(OP)                                                             \
  case OP:                                                                       \
    xor_chain_kernel<OP><<<blocks_for(n), THREADS, 0, s>>>(x, out, n, reps);     \
    break;
#define CASE_ACCUM(OP)                                                           \
  case OP:                                                                       \
    accum_kernel<OP><<<blocks_for(n), THREADS, 0, s>>>(a, b, out, n, rep);       \
    break;

// x, y, out: n int32 or float32 lanes (float32 for op >= 4)
extern "C" int bp_probe_chain(const void *x, const void *y, void *out, long long n, int reps,
                              int op, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || reps < 0) return n == 0 ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  switch (op) {
    CASE_CHAIN(0) CASE_CHAIN(1) CASE_CHAIN(2) CASE_CHAIN(3)
    CASE_CHAIN(4) CASE_CHAIN(5) CASE_CHAIN(6) CASE_CHAIN(7)
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out: n int32 lanes (op <= 4 and op 8) or float32 lanes (ops 5, 6, 7, 9)
extern "C" int bp_probe_xor_chain(const void *x, void *out, long long n, int reps, int op,
                                  void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || reps < 0) return n == 0 ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  switch (op) {
    CASE_XOR(0) CASE_XOR(1) CASE_XOR(2) CASE_XOR(3) CASE_XOR(4)
    CASE_XOR(5) CASE_XOR(6) CASE_XOR(7) CASE_XOR(8) CASE_XOR(9)
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, b, out: n int32 lanes, or float32 lanes for ops 3 and 4
extern "C" int bp_probe_accum(const void *a, const void *b, void *out, long long n, int rep,
                              int op, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || rep < 0) return n == 0 ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  switch (op) {
    CASE_ACCUM(0) CASE_ACCUM(1) CASE_ACCUM(2) CASE_ACCUM(3)
    CASE_ACCUM(4) CASE_ACCUM(5) CASE_ACCUM(6) CASE_ACCUM(7)
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
