// Keccak-256 (pre-NIST padding 0x01 .. 0x80) for the generator chains.
//
// Replaces no Pallas kernel: the JAX package walks its generator chains
// with its native engine (mpc_bulletproof_tpu/ops/keccak.py keccak256 ->
// utils/native.py keccak256, called by generators.py GeneratorsChain), a
// C++ hash on the host.  This is the card's counterpart for the chains:
//
//   state_0 = keccak256(pad_label("GeneratorsChain" || label))   (host, once)
//   state_{i+1} = keccak256(state_i)
//   generator_i = hash_to_scalar(state_{i+1}) B,
//   hash_to_scalar(s) = LE(s || keccak256(s)) mod r
//
// Two entry points:
// - bp_keccak_chain: one thread a chain.  Each thread walks `skip` steps
//   without writing, then `count` steps, writing each state.  A chain is
//   serial by definition, so its time is a latency chain: (skip + count)
//   times the dependent depth of one keccak-f, 6 32-bit instructions a round
//   (two LOP3 levels for a column's parity, one SHF for its rotation, one
//   LOP3 for theta, one SHF for rho, one LOP3 for chi; iota folds into the
//   next parity), 144 a permutation.  One thread issues all ~4,300 32-bit
//   instructions of a permutation itself, so it sits well above that bound;
//   the chains of a launch share a warp (they run in lock step, one chain or
//   32 cost the same).  A warp a chain (lanes as state words, theta by
//   __shfl) is the redesign that would spread the issue.
// - bp_keccak256_32: one thread a 32-byte message, all in parallel: the
//   second keccak of hash_to_scalar over every walked state.  Bound by the
//   ALU pipe: ~2,930 LOP3 and ~1,390 SHF a permutation (32-bit halves of
//   the 64-bit lanes), against 64 bytes of traffic.
//
// The state is 25 64-bit lanes (index x + 5 y) in registers, the 24 rounds
// unrolled with compile-time rotations, so every rotation is a pair of
// funnel shifts.  A 32-byte message is one block: lanes 0-3 the message,
// lane 4 the padding byte 0x01, lane 16 the final 0x80.  Bytes are read and
// written as little-endian 64-bit words (the wrapper checks 8-byte
// alignment).
#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

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

__global__ void keccak_chain_kernel(const u64 *__restrict__ starts, u64 *__restrict__ out,
                                    long long chains, long long skip, long long count) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  u64 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = starts[4 * c + i];
  for (long long i = 0; i < skip; ++i) keccak256_32(s);
  u64 *dst = out + 4 * count * c;
  for (long long i = 0; i < count; ++i) {
    keccak256_32(s);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[4 * i + j] = s[j];
  }
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

// 32 chains a block: the chains of a warp run in lock step, and a launch of
// a few chains spreads its warps over the SMs.
static const int CHAIN_THREADS = 32;
static const int HASH_THREADS = 128;

extern "C" int bp_keccak_chain(const void *starts, void *out, long long chains, long long skip,
                               long long count, void *stream) {
  if (chains < 0 || skip < 0 || count < 0) return (int)cudaErrorInvalidValue;
  if (chains > 0 && (skip > 0 || count > 0)) {
    long long blocks = (chains + CHAIN_THREADS - 1) / CHAIN_THREADS;
    keccak_chain_kernel<<<(unsigned)blocks, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64 *)starts, (u64 *)out, chains, skip, count);
  }
  return (int)cudaGetLastError();
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
