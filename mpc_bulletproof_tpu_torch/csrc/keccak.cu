// Keccak-256 (pre-NIST padding 0x01 .. 0x80): the generator chains and the
// Fiat-Shamir transcript.
//
// Replaces no Pallas kernel.  The JAX package walks its generator chains
// with its native engine (mpc_bulletproof_tpu/ops/keccak.py keccak256 ->
// utils/native.py keccak256, called by generators.py GeneratorsChain), a
// C++ hash on the host, and hashes its on-device transcript with jnp
// (ops/keccak_jax.py keccak256_device), which XLA compiles into the fused
// prover's one program.  These are the card's counterparts:
//
//   state_0 = keccak256(pad_label("GeneratorsChain" || label))   (host, once)
//   state_{i+1} = keccak256(state_i)
//   generator_i = hash_to_scalar(state_{i+1}) B,
//   hash_to_scalar(s) = LE(s || keccak256(s)) mod r
//
//   absorb:    state' = keccak256(state || pad_label(label) || msg)
//   challenge: state' = keccak256(state || pad_label(label)), and the
//              challenge u = LE(state' || keccak256(state')) mod r
//
// Both chains are serial by definition: each permutation waits for the one
// before, so their time is a latency chain.  Three entry points:
// - bp_keccak_chain: a warp a chain (several chains a block).  Each warp
//   walks `skip` steps without writing, then `count` steps, writing each
//   state.
// - bp_keccak_transcript: a block a transcript runs a sequence of absorbs
//   and challenges (each one 136-byte block whose first 32 bytes are the
//   running state) from a host-built template of 17 words a block (labels,
//   host constants, padding) and the transcript's message words, which the
//   kernel places itself; a second warp hashes and reduces each challenge
//   off the chain (keccak_transcript_kernel below).  Every byte a verifier
//   absorbs is in its proof, so a verification's whole replay, or several
//   transcripts, is one launch.
// - bp_keccak256_32: one thread a 32-byte message, all in parallel: the
//   second keccak of hash_to_scalar over every walked state.  Bound by the
//   ALU pipe: ~2,930 LOP3 and ~1,390 SHF a permutation (32-bit halves of
//   the 64-bit lanes), against 64 bytes of traffic.
//
// The warp design (keccak_f_warp).  Thread t < 25 of a warp holds state
// word t = x + 5 y; threads 25-31 run along on copies and are never read.
// A round: the four other words of column x by four shuffles, the parity
// C[x] by an xor tree; C[x - 1] and C[x + 1] by two shuffles from the
// neighbours in the row, theta as one xor with rot(C[x + 1], 1); rho as a
// pair of funnel shifts by the thread's own amount mod 32, the halves
// swapped first (one select each) where it is 32 or more; pi and chi
// together by three shuffles of the rotated words (B[t] and the next two
// words of its row, each from its pi source); iota is folded into the next
// round's parity (column 0 adds the constant, word 0 takes it while the
// shuffles fly).  The dependent path of a round is 3 shuffles and 7 ALU
// instructions (2 for the parity, the rotation by one, theta, the select,
// rho's shift, chi), against 6 ALU instructions for the thread design;
// each thread issues ~42 instructions a round (18 of them SHFL halves)
// where the thread design issued ~180 alone.  A 64-bit shuffle is two
// 32-bit ones.
//
// The thread design (keccak_f) keeps the state's 25 64-bit lanes (index
// x + 5 y) in registers, the 24 rounds unrolled with compile-time
// rotations, so every rotation is a pair of funnel shifts.  A 32-byte
// message is one block: lanes 0-3 the message, lane 4 the padding byte
// 0x01, lane 16 the final 0x80.  Chain bytes are read and written as
// little-endian 64-bit words (the wrapper checks 8-byte alignment), and so
// are the transcript's states, messages and challenges: every label pads
// to 32 bytes and every message is whole words (scalars 4, points 8, u64s
// 1), so a transcript block is whole words.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

__constant__ u64 KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

template <int R>
__device__ __forceinline__ u64 rotl64(u64 x) {
  return R == 0 ? x : (x << R) | (x >> ((64 - R) & 63));
}

__device__ __forceinline__ void keccak_f(u64 a[25]) {
#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    u64 c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      u64 d = c[(x + 4) % 5] ^ rotl64<1>(c[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
    // rho and pi: b[y + 5 ((2 x + 3 y) mod 5)] = rotl(a[x + 5 y], ROT[x][y])
    b[0] = rotl64<0>(a[0]);
    b[1] = rotl64<44>(a[6]);
    b[2] = rotl64<43>(a[12]);
    b[3] = rotl64<21>(a[18]);
    b[4] = rotl64<14>(a[24]);
    b[5] = rotl64<28>(a[3]);
    b[6] = rotl64<20>(a[9]);
    b[7] = rotl64<3>(a[10]);
    b[8] = rotl64<45>(a[16]);
    b[9] = rotl64<61>(a[22]);
    b[10] = rotl64<1>(a[1]);
    b[11] = rotl64<6>(a[7]);
    b[12] = rotl64<25>(a[13]);
    b[13] = rotl64<8>(a[19]);
    b[14] = rotl64<18>(a[20]);
    b[15] = rotl64<27>(a[4]);
    b[16] = rotl64<36>(a[5]);
    b[17] = rotl64<10>(a[11]);
    b[18] = rotl64<15>(a[17]);
    b[19] = rotl64<56>(a[23]);
    b[20] = rotl64<62>(a[2]);
    b[21] = rotl64<55>(a[8]);
    b[22] = rotl64<39>(a[14]);
    b[23] = rotl64<41>(a[15]);
    b[24] = rotl64<2>(a[21]);
    // chi, then iota
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x) a[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
    }
    a[0] ^= KECCAK_RC[rnd];
  }
}

// keccak256 of the 32-byte message m[0..3] (little-endian lanes) into m.
__device__ __forceinline__ void keccak256_32(u64 m[4]) {
  u64 a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = m[i];
  a[4] = 0x01ull;
  a[16] = 0x8000000000000000ull;
  keccak_f(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = a[i];
}

// ---- the warp design --------------------------------------------------------

static const unsigned FULL_MASK = 0xffffffffu;

// rho amount and pi source of each word (index x + 5 y)
__constant__ unsigned char KECCAK_ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                             25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
__constant__ unsigned char KECCAK_PI_SRC[25] = {0, 6,  12, 18, 24, 3, 9,  10, 16, 22, 1, 7, 13,
                                                19, 20, 4, 5,  11, 17, 23, 2, 8, 14, 15, 21};

// A thread's shuffle sources and masks, fixed for the whole walk.
struct WarpLane {
  int mate0, mate1, mate2, mate3;  // the other four words of column x
  int cm, cp;                      // the words of columns x - 1 and x + 1 in row y
  int pi0, pi1, pi2;               // pi sources of B[t] and the next two words of row y
  unsigned rot;                    // rho amount mod 32
  bool swap;                       // rho amount >= 32: swap the halves first
  u64 col0, self0;                 // all ones in column 0 / in word 0, else 0
};

__device__ __forceinline__ WarpLane warp_lane(int t) {
  const int w = t < 25 ? t : t - 25;  // threads 25-31 shadow words 0-6
  const int x = w % 5, y = w / 5;
  WarpLane l;
  l.mate0 = x + 5 * ((y + 1) % 5);
  l.mate1 = x + 5 * ((y + 2) % 5);
  l.mate2 = x + 5 * ((y + 3) % 5);
  l.mate3 = x + 5 * ((y + 4) % 5);
  l.cm = (x + 4) % 5 + 5 * y;
  l.cp = (x + 1) % 5 + 5 * y;
  l.pi0 = KECCAK_PI_SRC[w];
  l.pi1 = KECCAK_PI_SRC[(x + 1) % 5 + 5 * y];
  l.pi2 = KECCAK_PI_SRC[(x + 2) % 5 + 5 * y];
  l.rot = KECCAK_ROT[w] & 31u;
  l.swap = KECCAK_ROT[w] >= 32;
  l.col0 = x == 0 ? ~0ull : 0ull;
  l.self0 = t == 0 ? ~0ull : 0ull;
  return l;
}

// rotl(v, r) for the thread's own r: the halves swapped where r >= 32, then
// a funnel shift each by r mod 32
__device__ __forceinline__ u64 rho_lane(u64 v, const WarpLane &l) {
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  const unsigned p = l.swap ? hi : lo, q = l.swap ? lo : hi;
  return ((u64)__funnelshift_l(p, q, l.rot) << 32) | __funnelshift_l(q, p, l.rot);
}

// One keccak-f[1600] over a warp: `a` is word t of the state in thread t
// (t < 25); returns word t of the permuted state.  Every thread of the warp
// must call it.
__device__ __forceinline__ u64 keccak_f_warp(u64 a, const WarpLane &l) {
  u64 rc = 0;  // the previous round's iota, folded into this round's parity
#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    const u64 v0 = __shfl_sync(FULL_MASK, a, l.mate0), v1 = __shfl_sync(FULL_MASK, a, l.mate1);
    const u64 v2 = __shfl_sync(FULL_MASK, a, l.mate2), v3 = __shfl_sync(FULL_MASK, a, l.mate3);
    const u64 c = a ^ (rc & l.col0) ^ v0 ^ v1 ^ v2 ^ v3;
    a ^= rc & l.self0;
    const u64 cm = __shfl_sync(FULL_MASK, c, l.cm), cp = __shfl_sync(FULL_MASK, c, l.cp);
    const u64 r = rho_lane(a ^ cm ^ rotl64<1>(cp), l);
    const u64 b0 = __shfl_sync(FULL_MASK, r, l.pi0), b1 = __shfl_sync(FULL_MASK, r, l.pi1);
    const u64 b2 = __shfl_sync(FULL_MASK, r, l.pi2);
    a = b0 ^ (~b1 & b2);
    rc = KECCAK_RC[rnd];
  }
  return a ^ (rc & l.self0);
}

// The padding words of keccak256 of a 32-byte message (words 0-3).
__device__ __forceinline__ u64 pad32_word(int t) {
  return t == 4 ? 0x01ull : t == 16 ? 0x8000000000000000ull : 0ull;
}

// CHAIN_WARPS chains a block, a warp each; a warp past the last chain leaves
// at once (the whole warp, so the shuffles stay full).
static const int CHAIN_WARPS = 4;

__global__ void keccak_chain_kernel(const u64 *__restrict__ starts, u64 *__restrict__ out,
                                    long long chains, long long skip, long long count) {
  const long long c = (long long)blockIdx.x * CHAIN_WARPS + (threadIdx.x >> 5);
  if (c >= chains) return;
  const int t = threadIdx.x & 31;
  const WarpLane l = warp_lane(t);
  const u64 pad = pad32_word(t);
  u64 a = t < 4 ? starts[4 * c + t] : 0ull;
  u64 *dst = out + 4 * count * c;
  for (long long i = 0; i < skip + count; ++i) {
    a = keccak_f_warp(t < 4 ? a : pad, l);
    if (i >= skip && t < 4) dst[4 * (i - skip) + t] = a;
  }
}

// ---- the transcript --------------------------------------------------------

static const int RATE_WORDS = 17;           // a block: 136 bytes
static const int TRANSCRIPT_THREADS = 128;  // 4 warps stage the run; warps 0 and 1 then work
static const int SPIN_LIMIT = 1 << 26;      // ~4 s of 64 ns sleeps: a lost hand-over traps, not hangs

// A 256-bit little-endian value mod r: q = v >> 251 (< 32), then v - q r,
// which lies in (-2^202, 2^251) since r - 2^251 < 2^197, plus r on a
// borrow (fe_sub's correction).
__device__ __forceinline__ Fe fr_reduce_u256(const u64 w[4]) {
  const u32 q = (u32)(w[3] >> 59);
  u64 p[8];
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] = mad_wide(mlimb<FrConst>(j), q, 0ull);
  Fe qr;  // q r < 31 r < 2^256: eight limbs
  qr.v[0] = lo32(p[0]);
  qr.v[1] = add_cc(lo32(p[1]), hi32(p[0]));
#pragma unroll
  for (int j = 2; j < 7; j++) qr.v[j] = addc_cc(lo32(p[j]), hi32(p[j - 1]));
  qr.v[7] = addc(lo32(p[7]), hi32(p[6]));
  return fe_sub<FrConst>(fe_from_words(w[0], w[1], w[2], w[3]), qr);
}

// hash_to_scalar's reduction: LE(lo || hi) mod r = lo' + hi' 2^256 mod r
// with lo', hi' the halves mod r, and hi' 2^256 = mont(hi', R^2) for R = 2^256.
__device__ __forceinline__ Fe fr_reduce_u512(const u64 lo[4], const u64 hi[4]) {
  return fe_add<FrConst>(fr_reduce_u256(lo),
                         fe_mont_mul<FrConst>(fr_reduce_u256(hi), fe_r2<FrConst>()));
}

// Word t of block i of the staged run (0 for the state's words 0-3 and the
// capacity's 17-24): the template's word, or'ed with the transcript's
// message word that the layout puts there (layout row i: the first message
// word's position in the block, the message's words, their offset in the
// transcript's message row, the challenge flag).
__device__ __forceinline__ u64 staged_word(const u64 *tmpl, const long long *layout, const u64 *msg,
                                           long long i, int t) {
  if (t < 4 || t >= RATE_WORDS) return 0ull;
  const long long *row = layout + 4 * i;
  const long long k = t - row[0];
  const u64 w = tmpl[RATE_WORDS * i + t];
  return k >= 0 && k < row[1] ? w | msg[row[2] + k] : w;
}

// keccak256(s) (s: word t in lane t < 4) and LE(s || keccak256(s)) mod r
// into column c of `out` (NW x challenges words); every lane of the warp
// calls it.
__device__ __forceinline__ void squeeze_challenge(u64 s, const WarpLane &l, int t, u64 *out,
                                                  long long challenges, long long c) {
  const u64 h = keccak_f_warp(t < 4 ? s : pad32_word(t), l);
  u64 lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    lo[j] = __shfl_sync(FULL_MASK, s, j);
    hi[j] = __shfl_sync(FULL_MASK, h, j);
  }
  if (t == 0) {
    const Fe u = fr_reduce_u512(lo, hi);
#pragma unroll
    for (int j = 0; j < 4; j++) out[j * challenges + c] = (u64)u.v[2 * j] | ((u64)u.v[2 * j + 1] << 32);
  }
}

// A transcript's run in shared memory: the template (nblocks x 17), the
// message row, a state' slot a challenge, the layout (nblocks x 4) and the
// count of challenges handed over.
struct StagedRun {
  u64 *tmpl, *msg, *slot;
  long long *layout;
  int *ready;
};

// Stage the run, every thread of the block loading in turn (coalesced
// 8-byte loads), and zero the counter; ends in a barrier.
__device__ __forceinline__ StagedRun stage_run(u64 *smem, const u64 *tmpl, const long long *layout,
                                               const u64 *msg, long long nblocks, long long msg_words,
                                               long long challenges) {
  StagedRun run;
  run.tmpl = smem;
  run.msg = run.tmpl + RATE_WORDS * nblocks;
  run.slot = run.msg + msg_words;
  run.layout = (long long *)(run.slot + 4 * challenges);
  run.ready = (int *)(run.layout + 4 * nblocks);
  const long long n_tmpl = RATE_WORDS * nblocks, n_layout = 4 * nblocks;
  const long long n_stage = n_tmpl > msg_words ? n_tmpl : msg_words;
  for (long long k = threadIdx.x; k < n_stage; k += blockDim.x) {
    if (k < n_tmpl) run.tmpl[k] = tmpl[k];
    if (k < msg_words) run.msg[k] = msg[k];
    if (k < n_layout) run.layout[k] = layout[k];
  }
  if (threadIdx.x == 0) *run.ready = 0;
  __syncthreads();
  return run;
}

// One block a transcript.  The run is staged in shared memory by all four
// warps; then warp 0 (the chain) permutes block after block, each block's
// words read from shared memory one permutation ahead, and at each
// challenge hands state' to warp 1 through a slot and a counter in shared
// memory.  Warp 1 (the side warp, on another scheduler) runs
// keccak256(state') on keccak_f_warp and the reduction mod r (lane 0,
// csrc/field.cuh) while the chain goes on, so the chain's dependent path is
// the run's own permutations.  The layout's challenge flags number
// `challenges` (the wrapper's plan checks it): a missing hand-over traps.
__global__ void __launch_bounds__(TRANSCRIPT_THREADS)
keccak_transcript_kernel(const u64 *__restrict__ starts, const u64 *__restrict__ tmpl,
                         const long long *__restrict__ layout, const u64 *__restrict__ msgs,
                         long long nblocks, long long msg_words, long long challenges,
                         u64 *__restrict__ states, u64 *__restrict__ chals) {
  extern __shared__ u64 smem[];
  const long long tr = blockIdx.x;
  // the start state's load in flight with every staging load of a thread:
  // one memory latency before the chain for a short run
  u64 a = threadIdx.x < 4 ? starts[4 * tr + threadIdx.x] : 0ull;
  const StagedRun run = stage_run(smem, tmpl, layout, msgs + msg_words * tr, nblocks, msg_words, challenges);
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  if (warp > 1) return;
  const WarpLane l = warp_lane(t);
  u64 *out = chals + 4 * challenges * tr;  // this transcript's (NW, challenges) words

  if (warp == 1) {  // the side warp: the challenges in run order
    for (long long c = 0; c < challenges; ++c) {
      int spins = 0;
      while (*(volatile int *)run.ready <= c) {
        __nanosleep(64);
        if (++spins > SPIN_LIMIT) __trap();
      }
      __threadfence_block();
      squeeze_challenge(t < 4 ? ((volatile u64 *)run.slot)[4 * c + t] : 0ull, l, t, out, challenges, c);
    }
    return;
  }

  u64 next = nblocks > 0 ? staged_word(run.tmpl, run.layout, run.msg, 0, t) : 0ull;
  long long c = 0;
  for (long long i = 0; i < nblocks; ++i) {
    const u64 in = t < 4 ? a : next;
    const bool challenge = run.layout[4 * i + 3] != 0;
    next = i + 1 < nblocks ? staged_word(run.tmpl, run.layout, run.msg, i + 1, t) : 0ull;
    a = keccak_f_warp(in, l);
    if (challenge && c < challenges) {
      if (t < 4) run.slot[4 * c + t] = a;
      __threadfence_block();
      __syncwarp();
      if (t == 0) *(volatile int *)run.ready = (int)(c + 1);
      ++c;
    }
  }
  if (t < 4) states[4 * tr + t] = a;
}

// Shared memory of a transcript block for a run's sizes: what the kernel
// stages and the counter.
static long long transcript_smem(long long nblocks, long long msg_words, long long challenges) {
  return 8 * (RATE_WORDS * nblocks + msg_words + 4 * challenges + 4 * nblocks) + 16;
}

static const long long TRANSCRIPT_SMEM_MAX = 232448;  // a block's dynamic shared memory on Hopper

typedef void (*TranscriptKernel)(const u64 *, const u64 *, const long long *, const u64 *, long long,
                                 long long, long long, u64 *, u64 *);

// Launch `kernel` (keccak_transcript_kernel's signature), a block of
// TRANSCRIPT_THREADS a transcript, with the run's shared memory.
static int launch_transcript(TranscriptKernel kernel, const void *starts, const void *tmpl,
                             const void *layout, const void *msgs, long long transcripts,
                             long long nblocks, long long msg_words, long long challenges, void *states,
                             void *chals, void *stream) {
  if (transcripts < 0 || nblocks < 0 || msg_words < 0 || challenges < 0 || challenges > nblocks)
    return (int)cudaErrorInvalidValue;
  const long long smem = transcript_smem(nblocks, msg_words, challenges);
  if (smem > TRANSCRIPT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (transcripts > 0)
    kernel<<<(unsigned)transcripts, TRANSCRIPT_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const u64 *)starts, (const u64 *)tmpl, (const long long *)layout, (const u64 *)msgs, nblocks,
        msg_words, challenges, (u64 *)states, (u64 *)chals);
  return (int)cudaGetLastError();
}

__global__ void keccak256_32_kernel(const u64 *__restrict__ msgs, u64 *__restrict__ out,
                                    long long n) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  u64 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = msgs[4 * k + i];
  keccak256_32(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[4 * k + i] = s[i];
}

static const int HASH_THREADS = 128;

extern "C" int bp_keccak_chain(const void *starts, void *out, long long chains, long long skip,
                               long long count, void *stream) {
  if (chains < 0 || skip < 0 || count < 0) return (int)cudaErrorInvalidValue;
  if (chains > 0 && (skip > 0 || count > 0)) {
    long long blocks = (chains + CHAIN_WARPS - 1) / CHAIN_WARPS;
    int warps = chains < CHAIN_WARPS ? (int)chains : CHAIN_WARPS;
    keccak_chain_kernel<<<(unsigned)blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
        (const u64 *)starts, (u64 *)out, chains, skip, count);
  }
  return (int)cudaGetLastError();
}

extern "C" int bp_keccak_transcript(const void *starts, const void *tmpl, const void *layout,
                                    const void *msgs, long long transcripts, long long nblocks,
                                    long long msg_words, long long challenges, void *states,
                                    void *chals, void *stream) {
  return launch_transcript(keccak_transcript_kernel, starts, tmpl, layout, msgs, transcripts, nblocks,
                           msg_words, challenges, states, chals, stream);
}

extern "C" int bp_keccak256_32(const void *msgs, void *out, long long n, void *stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long blocks = (n + HASH_THREADS - 1) / HASH_THREADS;
    keccak256_32_kernel<<<(unsigned)blocks, HASH_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64 *)msgs, (u64 *)out, n);
  }
  return (int)cudaGetLastError();
}
