// Other designs of the warp keccak-f[1600], timed against csrc/keccak.cu's
// keccak_f_warp by tools/keccak_warp_ab.py (built beside the port's
// library; on no path of the port).
//
// ab_chain(variant): the generator chain walk of bp_keccak_chain on
//   0: keccak_f_warp itself (3 shuffle levels a round, 18 SHFL);
//   1: theta's two parities C[x - 1], C[x + 1] from ten gathered words
//      (2 shuffle levels a round, 26 SHFL);
//   2: every exchange through shared memory (3 buffers, a syncwarp each);
//   3: the column gather through shared memory, the rest by shuffles.
// ab_transcript: bp_keccak_transcript with a run's bytes staged in shared
//   memory first (up to 64 blocks a pass) instead of each block's words
//   loaded by their threads one permutation ahead.
#include "keccak.cu"

// ---- variant 1: theta's two parities from ten gathered words (one shuffle level) ----
struct WarpLaneB {
  int m[5], p[5];
  int pi0, pi1, pi2;
  unsigned rot;
  bool swap;
  u64 m0, p0, self0;
};

__device__ __forceinline__ WarpLaneB warp_lane_b(int t) {
  const int w = t < 25 ? t : t - 25;
  const int x = w % 5, y = w / 5;
  WarpLaneB l;
#pragma unroll
  for (int k = 0; k < 5; ++k) { l.m[k] = (x + 4) % 5 + 5 * k; l.p[k] = (x + 1) % 5 + 5 * k; }
  l.pi0 = KECCAK_PI_SRC[w];
  l.pi1 = KECCAK_PI_SRC[(x + 1) % 5 + 5 * y];
  l.pi2 = KECCAK_PI_SRC[(x + 2) % 5 + 5 * y];
  l.rot = KECCAK_ROT[w] & 31u;
  l.swap = KECCAK_ROT[w] >= 32;
  l.m0 = x == 1 ? ~0ull : 0ull;   // column x - 1 is column 0
  l.p0 = x == 4 ? ~0ull : 0ull;   // column x + 1 is column 0
  l.self0 = t == 0 ? ~0ull : 0ull;
  return l;
}

__device__ __forceinline__ u64 rho_b(u64 v, const WarpLaneB &l) {
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  const unsigned p = l.swap ? hi : lo, q = l.swap ? lo : hi;
  return ((u64)__funnelshift_l(p, q, l.rot) << 32) | __funnelshift_l(q, p, l.rot);
}

__device__ __forceinline__ u64 keccak_f_warp_b(u64 a, const WarpLaneB &l) {
  u64 rc = 0;
#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    u64 cm = rc & l.m0, cp = rc & l.p0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      cm ^= __shfl_sync(FULL_MASK, a, l.m[k]);
      cp ^= __shfl_sync(FULL_MASK, a, l.p[k]);
    }
    a ^= rc & l.self0;
    const u64 r = rho_b(a ^ cm ^ rotl64<1>(cp), l);
    const u64 b0 = __shfl_sync(FULL_MASK, r, l.pi0), b1 = __shfl_sync(FULL_MASK, r, l.pi1);
    const u64 b2 = __shfl_sync(FULL_MASK, r, l.pi2);
    a = b0 ^ (~b1 & b2);
    rc = KECCAK_RC[rnd];
  }
  return a ^ (rc & l.self0);
}


// ---- variant 2: every exchange through shared memory (3 buffers, 3 syncwarps a round);
// ---- variant 3: the column gather through shared memory, the rest by shuffles
template <bool ALL>
__device__ __forceinline__ u64 keccak_f_smem(u64 a, const WarpLane &l, u64 *sa, u64 *sc, u64 *sr, int t) {
  u64 rc = 0;
#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    sa[t] = a;
    __syncwarp();
    const u64 c = a ^ (rc & l.col0) ^ sa[l.mate0] ^ sa[l.mate1] ^ sa[l.mate2] ^ sa[l.mate3];
    a ^= rc & l.self0;
    u64 cm, cp;
    if (ALL) {
      sc[t] = c;
      __syncwarp();
      cm = sc[l.cm];
      cp = sc[l.cp];
    } else {
      cm = __shfl_sync(FULL_MASK, c, l.cm);
      cp = __shfl_sync(FULL_MASK, c, l.cp);
    }
    const u64 r = rho_lane(a ^ cm ^ rotl64<1>(cp), l);
    u64 b0, b1, b2;
    if (ALL) {
      sr[t] = r;
      __syncwarp();
      b0 = sr[l.pi0]; b1 = sr[l.pi1]; b2 = sr[l.pi2];
    } else {
      b0 = __shfl_sync(FULL_MASK, r, l.pi0);
      b1 = __shfl_sync(FULL_MASK, r, l.pi1);
      b2 = __shfl_sync(FULL_MASK, r, l.pi2);
    }
    a = b0 ^ (~b1 & b2);
    rc = KECCAK_RC[rnd];
    if (!ALL) __syncwarp();  // every read of sa done before the next round writes it
  }
  return a ^ (rc & l.self0);
}

template <int V>
__global__ void ab_chain_kernel(const u64 *__restrict__ starts, u64 *__restrict__ out, long long chains,
                                long long skip, long long count) {
  const long long c = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (c >= chains) return;
  const int t = threadIdx.x & 31;
  const WarpLane l = warp_lane(t);
  const WarpLaneB lb = warp_lane_b(t);
  const u64 pad = pad32_word(t);
  __shared__ u64 buf[4][3][32];
  u64 *sa = buf[threadIdx.x >> 5][0], *sc = buf[threadIdx.x >> 5][1], *sr = buf[threadIdx.x >> 5][2];
  u64 a = t < 4 ? starts[4 * c + t] : 0ull;
  u64 *dst = out + 4 * count * c;
  for (long long i = 0; i < skip + count; ++i) {
    const u64 in = t < 4 ? a : pad;
    a = V == 0 ? keccak_f_warp(in, l) : V == 1 ? keccak_f_warp_b(in, lb)
      : V == 2 ? keccak_f_smem<true>(in, l, sa, sc, sr, t) : keccak_f_smem<false>(in, l, sa, sc, sr, t);
    if (i >= skip && t < 4) dst[4 * (i - skip) + t] = a;
  }
}

extern "C" int ab_chain(const void *starts, void *out, long long chains, long long skip, long long count,
                        int variant, void *stream) {
  long long blocks = (chains + 3) / 4;
  int warps = chains < 4 ? (int)chains : 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) ab_chain_kernel<0><<<(unsigned)blocks, 32 * warps, 0, st>>>((const u64 *)starts, (u64 *)out, chains, skip, count);
  if (variant == 1) ab_chain_kernel<1><<<(unsigned)blocks, 32 * warps, 0, st>>>((const u64 *)starts, (u64 *)out, chains, skip, count);
  if (variant == 2) ab_chain_kernel<2><<<(unsigned)blocks, 32 * warps, 0, st>>>((const u64 *)starts, (u64 *)out, chains, skip, count);
  if (variant == 3) ab_chain_kernel<3><<<(unsigned)blocks, 32 * warps, 0, st>>>((const u64 *)starts, (u64 *)out, chains, skip, count);
  return (int)cudaGetLastError();
}

// ---- the transcript with a run's bytes staged in shared memory ----
static const int STAGE_BLOCKS = 64;

__global__ void ab_transcript_staged(const long long *__restrict__ state, const long long *__restrict__ blocks,
                                     long long nblocks, int high, long long *__restrict__ out) {
  __shared__ __align__(16) unsigned char sb[STAGE_BLOCKS * 136];
  const int t = threadIdx.x;
  const WarpLane l = warp_lane(t);
  const bool data = t >= 4 && t < 17;
  u64 a = t < 4 ? load_byte_word(state + 8 * t) : 0ull;
  for (long long base = 0; base < nblocks; base += STAGE_BLOCKS) {
    const long long n = nblocks - base < STAGE_BLOCKS ? nblocks - base : STAGE_BLOCKS;
    const long long *src = blocks + 136 * base;
#pragma unroll 8
    for (long long k = t; k < 136 * n; k += 32) sb[k] = (unsigned char)src[k];
    __syncwarp();
    for (long long i = 0; i < n; ++i) {
      const u64 w = data ? *(const u64 *)(sb + 136 * i + 8 * t) : 0ull;
      a = keccak_f_warp(t < 4 ? a : w, l);
    }
    __syncwarp();
  }
  if (t < 4)
    for (int k = 0; k < 8; ++k) out[8 * t + k] = (long long)((a >> (8 * k)) & 0xff);
  if (high) {
    a = keccak_f_warp(t < 4 ? a : pad32_word(t), l);
    if (t < 4)
      for (int k = 0; k < 8; ++k) out[32 + 8 * t + k] = (long long)((a >> (8 * k)) & 0xff);
  }
}

extern "C" int ab_transcript(const void *state, const void *blocks, long long nblocks, int high, void *out,
                             void *stream) {
  ab_transcript_staged<<<1, 32, 0, (cudaStream_t)stream>>>((const long long *)state, (const long long *)blocks,
                                                           nblocks, high, (long long *)out);
  return (int)cudaGetLastError();
}
