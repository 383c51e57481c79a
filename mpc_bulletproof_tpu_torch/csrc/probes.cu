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
// Bound on this card: instruction issue.  A lane reads 4 or 8 bytes and
// writes 4, then runs a chain of tens to thousands of operations, so the
// time is that of issuing the op's instructions on their pipes (FP32 at
// 128 lanes a clock an SM, integer ALU and FMA-pipe integer at 64 each,
// conversions at 16, and at most 128 lanes of any a clock), counted from
// what each op needs in chip_smoke.py; a chain of one lane runs at the latency of its
// operations, so a shape that fills few of the card's 270,336 resident
// threads (the (8, 512) tile fills 1.5%) gives a latency figure, not a rate.
//
// Design.  The compilers must not shorten the chains, and they try: integer
// adds and multiplies are associative.  nvcc's front end folds acc + y,
// 4,096 times, into a closed form, so every step passes the accumulator
// (and probe_accum the op's operand a + i) through opaque(), an empty asm
// that nvcc must assume rewrites the register; it costs no instruction,
// and it ends in the front end: ptxas never sees it.  ptxas then sees the
// unrolled chain, and folds two steps of acc + y into one three-input
// IADD3 (acc + y + y), halving the i32_add chain; its products it leaves
// one IMAD a step (-Xptxas -O1 does the same).  So the i32_mul and
// i32_add steps take a third operand z, a kernel argument that is 0 at run
// time: acc * y + z is one IMAD, and (acc + y) + z, with an opaque() after
// the first add so that nvcc cannot form y + z once, two adds that ptxas
// fuses into one IADD3; a step has no third input left for the next step's
// add, so the SASS keeps one instruction a step (chip_smoke.py prints each
// main loop's opcodes).  probe_chain unrolls CHAIN_STEPS = 32 steps an
// iteration, the rest a step an iteration, so the loop's counter, compare
// and branch are paid once every 32 steps instead of every step.  The
// float rows need no operand: __fmul_rn / __fadd_rn are never reassociated.
// probe_accum: each thread takes 4 lanes through 16-byte loads and stores
// (read-only path for a and b) and runs their 4 accumulations interleaved,
// with the op's operand a + i kept as a running sum a lane (one add a step,
// not an offset i + k a step and an add), unrolled ACCUM_STEPS = 64 steps
// an iteration; the grid is one wave (at the TPU shape 512 blocks of 256
// threads against 1,056 resident) and strides over the rest.  i32_mul
// needs an IMAD and an add a lane-step, one for each of the two 64-lane
// integer pipes, but ptxas issued 13 of every 32 adds as VIADD on the FMA
// pipe beside the IMADs; written (a + 1) + z, z a kernel argument that is
// 0 at run time, with an opaque() between, the add is one three-input
// IADD3, which only the ALU issues.  The mul16 rows keep the plain add:
// their mask already fills the ALU, and ptxas's VIADDs balance the two
// pipes (forced onto the ALU they ran 6 to 9% slower).  A lane count that
// is not a multiple of 4, or an operand that is not 16-byte aligned (a view
// at an offset), takes the scalar path, a lane a thread.  probe_accum's float32 op(a, b) is the same every step,
// so it is computed once and its rows time 64 dependent adds a lane.
// probe_xor_chain is as ported: a lane a thread, unrolled by 4.
// int32 is computed in uint32_t, where overflow wraps as in JAX and torch;
// >> on int32 is an arithmetic shift of the signed value.  float32 uses
// __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
// FMA, so a * y + y rounds twice, as the plain version does.
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
static const int CHAIN_STEPS = 32;  // steps an iteration of the unrolled loop

// z is 0 at run time (see the top of the file)

template <int OP>
__device__ __forceinline__ u32 chain_i(u32 a, u32 y, u32 z) {
  if (OP == 0) return a * y + z;
  if (OP == 1) return a * y + y;
  if (OP == 2) {
    a += y;
    opaque(a);  // or nvcc adds y + z once, and ptxas folds two steps again
    return a + z;
  }
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

template <int OP, typename T>
__device__ __forceinline__ T chain_step(T a, T y, u32 z) {
  if constexpr (OP < 4) return chain_i<OP>(a, y, z);
  else return chain_f<OP>(a, y);
}

// reps / CHAIN_STEPS iterations of CHAIN_STEPS steps, then the rest one step
// an iteration; reps = 0 leaves acc = x
template <int OP, typename T>
__device__ __forceinline__ T chain_run(T acc, T y, int reps, u32 z) {
  const int iters = reps / CHAIN_STEPS, rest = reps % CHAIN_STEPS;
#pragma unroll 1
  for (int t = 0; t < iters; t++) {
#pragma unroll
    for (int j = 0; j < CHAIN_STEPS; j++) {
      acc = chain_step<OP>(acc, y, z);
      opaque(acc);
    }
  }
#pragma unroll 1
  for (int t = 0; t < rest; t++) {
    acc = chain_step<OP>(acc, y, z);
    opaque(acc);
  }
  return acc;
}

template <int OP>
__global__ void chain_kernel(const void *__restrict__ xv, const void *__restrict__ yv,
                             void *__restrict__ ov, long long n, int reps, u32 z) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  if constexpr (OP < 4)
    ((u32 *)ov)[k] = chain_run<OP>(((const u32 *)xv)[k], ((const u32 *)yv)[k], reps, z);
  else
    ((float *)ov)[k] = chain_run<OP>(((const float *)xv)[k], ((const float *)yv)[k], reps, z);
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
static const int ACCUM_LANES = 4;  // lanes a thread on the vector path: one 16-byte load each of a and b
static const int ACCUM_STEPS = 64; // steps an iteration of the unrolled loop (the bench's REP)

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

// W lanes' accumulations, interleaved step by step; a and b as raw 32-bit
// words in, the sums' words out in a.  The int32 operand a + i is kept as
// a running sum in a, one add a step; for i32_mul that add is (a + 1) +
// z, z = 0 at run time, which ptxas issues as one IADD3 on the ALU beside
// the IMAD on the FMA pipe (see the top of the file).
template <int OP, int W>
__device__ __forceinline__ void accum_run(u32 (&a)[W], const u32 (&b)[W], int rep, u32 z) {
  if constexpr (OP == 3 || OP == 4) {
    float p[W], acc[W];
#pragma unroll
    for (int v = 0; v < W; v++) {
      p[v] = accum_f<OP>(__uint_as_float(a[v]), __uint_as_float(b[v]));
      acc[v] = 0.0f;
    }
#pragma unroll ACCUM_STEPS
    for (int i = 0; i < rep; i++) {
#pragma unroll
      for (int v = 0; v < W; v++) {
        acc[v] = __fadd_rn(acc[v], p[v]);
        opaque(acc[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < W; v++) a[v] = __float_as_uint(acc[v]);
  } else {
    u32 acc[W];
#pragma unroll
    for (int v = 0; v < W; v++) acc[v] = 0;
#pragma unroll ACCUM_STEPS
    for (int i = 0; i < rep; i++) {
#pragma unroll
      for (int v = 0; v < W; v++) {  // a[v] = a + i
        opaque(a[v]);
        acc[v] += accum_i<OP>(a[v], b[v]);
        opaque(acc[v]);
        if constexpr (OP == 0) {
          u32 t = a[v] + 1u;
          opaque(t);  // or nvcc adds 1 + z once
          a[v] = t + z;
        } else {
          a[v] += 1u;
        }
      }
    }

#pragma unroll
    for (int v = 0; v < W; v++) a[v] = acc[v];
  }
}

// groups: lanes / 4 when a, b and out are 16-byte aligned (the vector
// path, a group a thread), else 0; the lanes past 4 groups take the scalar
// path, a lane a thread.  The grid strides over both.  z is 0 at run time.
template <int OP>
__global__ void accum_kernel(const void *__restrict__ av, const void *__restrict__ bv,
                             void *__restrict__ ov, long long n, long long groups, int rep,
                             u32 z) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long g = t; g < groups; g += stride) {
    uint4 a4 = __ldg((const uint4 *)av + g), b4 = __ldg((const uint4 *)bv + g);
    u32 a[ACCUM_LANES] = {a4.x, a4.y, a4.z, a4.w};
    const u32 b[ACCUM_LANES] = {b4.x, b4.y, b4.z, b4.w};
    accum_run<OP>(a, b, rep, z);
    ((uint4 *)ov)[g] = make_uint4(a[0], a[1], a[2], a[3]);
  }
  for (long long k = ACCUM_LANES * groups + t; k < n; k += stride) {
    u32 a[1] = {__ldg((const u32 *)av + k)};
    const u32 b[1] = {__ldg((const u32 *)bv + k)};
    accum_run<OP>(a, b, rep, z);
    ((u32 *)ov)[k] = a[0];
  }
}

// ---- launchers --------------------------------------------------------------

static const int THREADS = 256;

static unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// Blocks of THREADS threads the card holds at once for this kernel.
static int resident_blocks(const void *fn) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// One wave at most: the vector path when all three pointers are 16-byte
// aligned, a thread per group (or per lane, scalar), the grid capped at
// what is resident and striding over the rest.
template <int OP>
static void launch_accum(const void *a, const void *b, void *out, long long n, int rep,
                         cudaStream_t s) {
  static const int resident = resident_blocks((const void *)accum_kernel<OP>);
  bool vec = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) == 0;
  long long groups = vec ? n / ACCUM_LANES : 0, rest = n - ACCUM_LANES * groups;
  long long blocks = blocks_for(groups > rest ? groups : rest);
  accum_kernel<OP><<<(unsigned)(blocks < resident ? blocks : resident), THREADS, 0, s>>>(
      a, b, out, n, groups, rep, 0u);
}

#define CASE_CHAIN(OP)                                                           \
  case OP:                                                                       \
    chain_kernel<OP><<<blocks_for(n), THREADS, 0, s>>>(x, y, out, n, reps, 0u);  \
    break;
#define CASE_XOR(OP)                                                             \
  case OP:                                                                       \
    xor_chain_kernel<OP><<<blocks_for(n), THREADS, 0, s>>>(x, out, n, reps);     \
    break;
#define CASE_ACCUM(OP)                                                           \
  case OP:                                                                       \
    launch_accum<OP>(a, b, out, n, rep, s);                                      \
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
