// Negacyclic NTT kernels for Hopper (sm_90a), plain C interface for ctypes.
//
//   hexl_ntt_fwd       batched forward NTT, any u64 in -> canonical, bit-reversed out
//   hexl_ntt_inv       batched inverse NTT, bit-reversed in -> canonical, natural out
//   hexl_ntt_fwd_tail  keyswitch tail: +fix, forward NTT, modswitch, accumulate
//
// They replace the fused MXU kernels of hexl_fpga_tpu/ops/ntt_mxu_pallas.py
// (_fwd_kernel, _inv_kernel, the raw_fwd_tail_call kernel).  Those compute the
// transform as two int8-limb matrix products because their target has no
// 64-bit integers; this card has them (__umul64hi), so the transform here is
// the Harvey butterfly network itself.
//
// Layout: rows of n contiguous u64 (passed as int64 bit patterns).  `tab` is
// a (4, n) table for one modulus: fwd, fwd_precon, inv, inv_precon.  One block
// per row; the row lives in n*8 bytes of dynamic shared memory (128 KB at
// n = 16384, opted in with cudaFuncSetAttribute).  Each entry launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
//
// Bound: per coefficient the kernels move 16..32 bytes and do log2(n)/2
// butterflies of three 64-bit multiplies (about ten 32-bit multiply-adds); by
// that count bytes and multiplies are within a factor of two of each other.
// What limits this first version is neither: it is the shared-memory traffic
// of log2(n) stages with a barrier each, and one block per SM at n = 16384.
#include <cuda_runtime.h>

#include "ntt_kernels.cuh"

extern __shared__ u64 smem_row[];

__global__ void __launch_bounds__(1024)
ntt_fwd_kernel(const u64* __restrict__ in, u64* __restrict__ out,
               const u64* __restrict__ tab, int n, u64 q, u64 q_barr) {
  u64* s = smem_row;
  const size_t base = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = barrett_canonical(in[base + i], q, q_barr);
  __syncthreads();
  fwd_stages(s, tab, tab + n, n, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = reduce4(s[i], q);
}

__global__ void __launch_bounds__(1024)
ntt_inv_kernel(const u64* __restrict__ in, u64* __restrict__ out,
               const u64* __restrict__ tab, int n, u64 q, u64 q_barr,
               u64 inv_n, u64 inv_n_p, u64 inv_n_w, u64 inv_n_w_p) {
  u64* s = smem_row;
  const size_t base = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = barrett_canonical(in[base + i], q, q_barr);
  __syncthreads();
  inv_stages(s, tab + 2 * n, tab + 3 * n, n, q);
  // last stage fused with the n^-1 scaling: the X half times n^-1, the Y
  // half times n^-1 * W_last
  const u64 twice_q = 2 * q;
  const int half = n >> 1;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const u64 X = s[i], Y = s[i + half];
    const u64 tx = cond_sub(X + Y, twice_q);
    const u64 ty = X + twice_q - Y;
    out[base + i] = cond_sub(mul_lazy(tx, inv_n, inv_n_p, q), q);
    out[base + i + half] = cond_sub(mul_lazy(ty, inv_n_w, inv_n_w_p, q), q);
  }
}

// Per element of row r:  g = NTT_q(e + fix);  a = acc mod q;
//   t1 = ReduceMod8(a + 4q - g);  delta = t1 * msf mod q;
//   out = cond_sub(res + delta, q)        (res < q is the caller's contract)
// g never leaves shared memory.
__global__ void __launch_bounds__(1024)
ntt_fwd_tail_kernel(const u64* __restrict__ e, const u64* __restrict__ acc,
                    const u64* __restrict__ res, u64* __restrict__ out,
                    const u64* __restrict__ tab, int n, u64 q, u64 q_barr,
                    u64 fix, u64 msf, u64 msf_p) {
  u64* s = smem_row;
  const size_t base = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = barrett_canonical(e[base + i] + fix, q, q_barr);
  __syncthreads();
  fwd_stages(s, tab, tab + n, n, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const u64 g = reduce4(s[i], q);
    const u64 a = barrett_canonical(acc[base + i], q, q_barr);
    u64 t1 = a + 4 * q - g;
    t1 = cond_sub(cond_sub(cond_sub(t1, 4 * q), 2 * q), q);
    const u64 delta = cond_sub(mul_lazy(t1, msf, msf_p, q), q);
    out[base + i] = cond_sub(res[base + i] + delta, q);
  }
}

static int threads_for(int n) { return n / 2 < 1024 ? n / 2 : 1024; }

template <typename K>
static cudaError_t opt_in_smem(K kernel, int n) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n * (int)sizeof(u64));
}

extern "C" int hexl_ntt_fwd(const void* in, void* out, const void* tab,
                            int rows, int n, u64 q, u64 q_barr, void* stream) {
  cudaError_t err = opt_in_smem(ntt_fwd_kernel, n);
  if (err != cudaSuccess) return (int)err;
  ntt_fwd_kernel<<<rows, threads_for(n), n * sizeof(u64),
                   (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)tab, n, q, q_barr);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ntt_inv(const void* in, void* out, const void* tab,
                            int rows, int n, u64 q, u64 q_barr, u64 inv_n,
                            u64 inv_n_p, u64 inv_n_w, u64 inv_n_w_p,
                            void* stream) {
  cudaError_t err = opt_in_smem(ntt_inv_kernel, n);
  if (err != cudaSuccess) return (int)err;
  ntt_inv_kernel<<<rows, threads_for(n), n * sizeof(u64),
                   (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)tab, n, q, q_barr, inv_n, inv_n_p,
      inv_n_w, inv_n_w_p);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ntt_fwd_tail(const void* e, const void* acc,
                                 const void* res, void* out, const void* tab,
                                 int rows, int n, u64 q, u64 q_barr, u64 fix,
                                 u64 msf, u64 msf_p, void* stream) {
  cudaError_t err = opt_in_smem(ntt_fwd_tail_kernel, n);
  if (err != cudaSuccess) return (int)err;
  ntt_fwd_tail_kernel<<<rows, threads_for(n), n * sizeof(u64),
                        (cudaStream_t)stream>>>(
      (const u64*)e, (const u64*)acc, (const u64*)res, (u64*)out,
      (const u64*)tab, n, q, q_barr, fix, msf, msf_p);
  return (int)cudaGetLastError();
}
