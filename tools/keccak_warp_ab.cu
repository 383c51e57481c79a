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
// ab_transcript: bp_keccak_transcript with each challenge's hash and
//   reduction run by the chain warp itself instead of by the side warp
//   beside the chain (the same staging and epilogue).
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

// ---- the transcript with every challenge on the chain warp ----
__global__ void __launch_bounds__(TRANSCRIPT_THREADS)
ab_transcript_inline(const u64 *__restrict__ starts, const u64 *__restrict__ tmpl,
                     const long long *__restrict__ layout, const u64 *__restrict__ msgs, long long nblocks,
                     long long msg_words, long long challenges, u64 *__restrict__ states,
                     u64 *__restrict__ chals) {
  extern __shared__ u64 smem[];
  const long long tr = blockIdx.x;
  u64 a = threadIdx.x < 4 ? starts[4 * tr + threadIdx.x] : 0ull;
  const StagedRun run = stage_run(smem, tmpl, layout, msgs + msg_words * tr, nblocks, msg_words, challenges);
  if (threadIdx.x >= 32) return;
  const int t = threadIdx.x;
  const WarpLane l = warp_lane(t);
  u64 *out = chals + 4 * challenges * tr;
  u64 next = nblocks > 0 ? staged_word(run.tmpl, run.layout, run.msg, 0, t) : 0ull;
  long long c = 0;
  for (long long i = 0; i < nblocks; ++i) {
    const u64 in = t < 4 ? a : next;
    const bool challenge = run.layout[4 * i + 3] != 0;
    next = i + 1 < nblocks ? staged_word(run.tmpl, run.layout, run.msg, i + 1, t) : 0ull;
    a = keccak_f_warp(in, l);
    if (challenge && c < challenges) squeeze_challenge(a, l, t, out, challenges, c++);
  }
  if (t < 4) states[4 * tr + t] = a;
}

extern "C" int ab_transcript(const void *starts, const void *tmpl, const void *layout, const void *msgs,
                             long long transcripts, long long nblocks, long long msg_words,
                             long long challenges, void *states, void *chals, void *stream) {
  return launch_transcript(ab_transcript_inline, starts, tmpl, layout, msgs, transcripts, nblocks, msg_words,
                           challenges, states, chals, stream);
}
