// DyadicMultiply kernel for Hopper (sm_90a), plain C interface for ctypes.
//
//   hexl_dyadic_mul   (B, 2, M, n) x (B, 2, M, n) -> (B, 3, M, n), u64:
//                     out0 = x0*y0, out1 = x0*y1 + x1*y0, out2 = x1*y1,
//                     each modulo the m-th modulus
//
// It replaces the fused kernel of hexl_fpga_tpu/ops/dyadic_pallas.py
// (DyadicRunner: _kernel, _mul_mod_core, _reduce_4q).  That one carries a u64
// as two u32 planes tiled (n/128, 128) and is compiled per moduli vector;
// this card has 64-bit integers and __umul64hi, so here q, barr and len of
// each modulus are runtime data read from a (3, M) device array and one build
// serves every moduli vector and every n.
//
// Every product is the reference MultMod (device/mod_ops.hpp:31-84): operands
// shrunk from [0, 4q) by two conditional subtracts, then Barrett with
//   len = floor(log2 q) - 1,  barr = floor(2^(len+64) / q),
//   c1 = (x*y) >> len,  c3 = hi64(c1 * barr),  c4 = lo64(x*y) - c3*q,
// one conditional subtract.  barr fits 64 bits: q >= 2^(len+1) keeps it at
// or under 2^63, so no 65th bit is carried.  The cross term is two products
// and one modular add (the traced tier of the reference,
// hexl_fpga_tpu/ops/dyadic_jax.py:43-48): it equals the Karatsuba form of the
// Pallas kernel wherever MultMod is exact, and unlike it stays defined by the
// same four MultMods for raw operands beyond 4q.
//
// Bound: one thread per (batch item, modulus, coefficient) reads four u64 and
// writes three, 56 bytes against four MultMods of about fourteen 32-bit
// multiply-adds each; on an H100 the bytes take about five times as long as
// the multiplies, so the kernel is bytes-bound and its design is only this:
// touch every operand once, consecutive threads on consecutive addresses, no
// intermediate in device memory.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 cond_sub(u64 a, u64 q) {
  return a >= q ? a - q : a;
}

// Reference MultMod; len in [0, 62].  (hi << 1) << (63 - len) is hi << (64 -
// len) without a shift by 64 when len = 0 (q = 2, 3).
__device__ __forceinline__ u64 mult_mod(u64 x, u64 y, u64 q, u64 barr,
                                        unsigned len) {
  x = cond_sub(cond_sub(x, q << 1), q);
  y = cond_sub(cond_sub(y, q << 1), q);
  const u64 lo = x * y;
  const u64 hi = __umul64hi(x, y);
  const u64 c1 = (lo >> len) | ((hi << 1) << (63u - len));
  const u64 c3 = __umul64hi(c1, barr);
  return cond_sub(lo - c3 * q, q);
}

// Grid: x over the coefficients, y the modulus, z the batch item, so no
// thread divides to find its place and n need not be a multiple of anything.
__global__ void __launch_bounds__(256)
dyadic_mul_kernel(const u64* __restrict__ op1, const u64* __restrict__ op2,
                  u64* __restrict__ out, const u64* __restrict__ meta,
                  int M, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = blockIdx.y;
  const u64 q = meta[m], barr = meta[M + m];
  const unsigned len = (unsigned)meta[2 * M + m];
  const size_t plane = (size_t)M * n;  // one polynomial over all moduli
  const size_t r = (size_t)m * n + i;
  const size_t in = (size_t)blockIdx.z * 2 * plane + r;
  const u64 x0 = op1[in], x1 = op1[in + plane];
  const u64 y0 = op2[in], y1 = op2[in + plane];
  const size_t o = (size_t)blockIdx.z * 3 * plane + r;
  out[o] = mult_mod(x0, y0, q, barr, len);
  out[o + plane] = cond_sub(
      mult_mod(x0, y1, q, barr, len) + mult_mod(x1, y0, q, barr, len), q);
  out[o + 2 * plane] = mult_mod(x1, y1, q, barr, len);
}

extern "C" int hexl_dyadic_mul(const void* op1, const void* op2, void* out,
                               const void* meta, int batch, int M, int n,
                               void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || M > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;  // beyond the grid's y and z extents
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, M, batch);
  dyadic_mul_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)op1, (const u64*)op2, (u64*)out, (const u64*)meta, M, n);
  return (int)cudaGetLastError();
}
