// The transcript kernel's epilogue on chosen values: fr_reduce_u512 of
// csrc/keccak.cu, LE(lo || hi) mod r, over (n, 8) words (lo then hi), a
// thread a value.  chip_smoke.py's transcript phase builds it beside the
// port's libraries and holds it to Python's v mod r at values that no
// keccak output of a run reaches (the borrow of fr_reduce_u256 among
// them).  On no path of the port.
#include "keccak.cu"

__global__ void fr_reduce_u512_kernel(const u64 *__restrict__ in, u64 *__restrict__ out, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  u64 lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    lo[j] = in[8 * k + j];
    hi[j] = in[8 * k + 4 + j];
  }
  const Fe u = fr_reduce_u512(lo, hi);
#pragma unroll
  for (int j = 0; j < 4; j++) out[4 * k + j] = (u64)u.v[2 * j] | ((u64)u.v[2 * j + 1] << 32);
}

extern "C" int check_fr_reduce_u512(const void *in, void *out, long long n, void *stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    fr_reduce_u512_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        (const u64 *)in, (u64 *)out, n);
  return (int)cudaGetLastError();
}
