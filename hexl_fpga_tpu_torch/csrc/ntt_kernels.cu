// Negacyclic NTT kernels for Hopper (sm_90a), plain C interface for ctypes.
//
//   hexl_ntt_fwd       batched forward NTT, any u64 in -> canonical, bit-reversed out
//   hexl_ntt_inv       batched inverse NTT, bit-reversed in -> canonical, natural out
//   hexl_ntt_fwd_tail  keyswitch tail: +fix, forward NTT, modswitch, accumulate
//   hexl_ntt_fwd_mac   keyswitch engine: forward NTT fused with the key MAC
//   hexl_ntt_fwd_wide  hexl_ntt_fwd for a row of twice a block's shared memory
//   hexl_ntt_inv_wide  hexl_ntt_inv for such a row
//
// The first three replace the fused MXU kernels of
// hexl_fpga_tpu/ops/ntt_mxu_pallas.py (_fwd_kernel, _inv_kernel, the
// raw_fwd_tail_call kernel), and hexl_ntt_fwd_mac replaces the
// raw_fwd_mac_call kernel of the same file.  Those compute the transform as
// two int8-limb matrix products because their target has no 64-bit integers; this card has
// them (__umul64hi), so the transform here is the Harvey butterfly network
// itself.  With the wide pair they are also the counterpart of the batched
// butterfly kernels of hexl_fpga_tpu/ops/ntt_pallas.py (_fwd_kernel,
// _inv_kernel: canonical in, canonical out, a tile resident for all stages),
// which keep a (tile, n) block in a fast memory of many megabytes; a block
// here has 227 KB, so a row of n = 32768 (256 KB) is split in two halves.
//
// Layout: rows of n contiguous u64 (passed as int64 bit patterns).  `tab` is
// a (4, n) table for one modulus: fwd, fwd_precon, inv, inv_precon.
// hexl_ntt_fwd and hexl_ntt_fwd_tail run the split core of ntt_kernels.cuh
// (fwd_split): `parts` blocks per row, each with n/parts values in dynamic
// shared memory, several butterfly stages per barrier in registers; the
// caller chooses parts (ntt_cuda.row_split).
// The other entries run one block per row; the row lives in n*8 bytes of
// dynamic shared memory (128 KB at n = 16384, opted in with
// cudaFuncSetAttribute).  The wide entries run two
// blocks per row, each with one half in shared memory: forward, a block does
// the one stage that crosses the halves while it loads (it reads both halves
// from device memory and keeps its own), then its half's log2(n) - 1 stages;
// inverse, the halves' stages run first and go to `out`, and a second
// elementwise kernel of the same entry does the crossing last stage, fused
// with n^-1, in place.  Each entry launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched).
//
// Bound: per coefficient the kernels move 16..32 bytes and do log2(n)/2
// butterflies of three 64-bit multiplies (about ten 32-bit multiply-adds); by
// that count bytes and multiplies are within a factor of two of each other.
// What limits the one-block-per-row kernels is neither: it is the
// shared-memory traffic of log2(n) stages with a barrier each, and one block
// per SM at n = 16384.  The split core's design against both is in
// ntt_kernels.cuh.
#include <cuda_runtime.h>

#include "ntt_kernels.cuh"

extern __shared__ u64 smem_row[];

// threads of a split block at most: one sub-network of 2^SPLIT_R values each
constexpr int SPLIT_THREADS = 512;

// blockIdx.x = C * row + part
template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
ntt_fwd_kernel(const u64* __restrict__ in, u64* __restrict__ out,
               const u64* __restrict__ tab, int n, u64 q, u64 q_barr) {
  u64* s = smem_row;
  const int part = blockIdx.x % C, len = n / C;
  const size_t row = (size_t)(blockIdx.x / C) * n;
  fwd_split<C>(s, in + row, tab, tab + n, 31 - __clz(len), part, q, q_barr, 0);
  out += row + (size_t)part * len;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    out[i] = reduce4(s[spad(i)], q);
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
  inv_stages(s, tab + 2 * n, tab + 3 * n, n, q, 1, 0);
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
// g never leaves shared memory.  Blocks as in ntt_fwd_kernel.
template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
ntt_fwd_tail_kernel(const u64* __restrict__ e, const u64* __restrict__ acc,
                    const u64* __restrict__ res, u64* __restrict__ out,
                    const u64* __restrict__ tab, int n, u64 q, u64 q_barr,
                    u64 fix, u64 msf, u64 msf_p) {
  u64* s = smem_row;
  const int part = blockIdx.x % C, len = n / C;
  const size_t row = (size_t)(blockIdx.x / C) * n;
  fwd_split<C>(s, e + row, tab, tab + n, 31 - __clz(len), part, q, q_barr, fix);
  const size_t base = row + (size_t)part * len;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const u64 g = reduce4(s[spad(i)], q);
    const u64 a = barrett_canonical(acc[base + i], q, q_barr);
    u64 t1 = a + 4 * q - g;
    t1 = cond_sub(cond_sub(cond_sub(t1, 4 * q), 2 * q), q);
    const u64 delta = cond_sub(mul_lazy(t1, msf, msf_p, q), q);
    out[base + i] = cond_sub(res[base + i] + delta, q);
  }
}

// Keyswitch engine for one modulus q (column j of the staged keys): the
// forward NTT of source limb i of batch element b, multiplied into every key
// component k and added to out[k, b]:
//   out[k, b, x] += mul_lazy(NTT_q(data[i*B + b] mod q)[x], keys[i, k, j, x])
// The counterpart on the other target walks a (batch tile, i) grid in order
// with the accumulator block resident in fast memory across i.  Here blocks
// run in no order and a row's `comp` accumulators (2 x 128 KB at n = 16384)
// do not fit beside the row in a block's 227 KB, so the grid is (B, active
// limbs), each block one transform, and the terms meet in a zeroed `out`
// through atomicAdd on u64: wrapping 64-bit adds commute, so the sum carries
// the same bits in any order.  The transform output never reaches device
// memory.  reduce4 before the multiply fixes each term's bits whatever the
// stages leave in [0, 4q), so the kernel equals its plain version bit for
// bit; each term is in [0, 2q) and the sum below 2 * L * q.  `skip` (-1 for
// none) is the source limb left to the caller: blockIdx.y counts the others.
// keys / kp are the whole (L, comp, K, n) tensors; element (i, k, j, x) lies
// at ((i * comp + k) * K + j) * n + x.
// Bound: operations by the count (it writes comp * B rows where ntt_fwd
// writes L * B, and adds comp lazy multiplies per coefficient; chip_smoke.py
// computes both sides).  What it costs above ntt_fwd is comp * rows * n
// atomics in L2 in place of rows * n plain stores.
__global__ void __launch_bounds__(1024)
ntt_fwd_mac_kernel(const u64* __restrict__ data, const u64* __restrict__ keys,
                   const u64* __restrict__ kp, u64* __restrict__ out,
                   const u64* __restrict__ tab, int n, int B, int comp, int K,
                   int j, int skip, u64 q, u64 q_barr) {
  u64* s = smem_row;
  const int b = blockIdx.x;
  int i = blockIdx.y;
  if (skip >= 0 && i >= skip) ++i;
  const size_t base = ((size_t)i * B + b) * n;
  for (int x = threadIdx.x; x < n; x += blockDim.x)
    s[x] = barrett_canonical(data[base + x], q, q_barr);
  __syncthreads();
  fwd_stages(s, tab, tab + n, n, q, 1, 0);
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const u64 v = reduce4(s[x], q);
    for (int k = 0; k < comp; ++k) {
      const size_t at = (((size_t)i * comp + k) * K + j) * n + x;
      atomicAdd(&out[((size_t)k * B + b) * n + x],
                mul_lazy(v, keys[at], kp[at], q));
    }
  }
}

// Forward NTT of a row held as two halves, one block each (blockIdx.x =
// 2 * row + half).  Stage m = 1 pairs i with i + n/2 under the single twiddle
// tab[1]; each block computes it for its own half while loading.
__global__ void __launch_bounds__(1024)
ntt_fwd_wide_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                    const u64* __restrict__ tab, int n, u64 q, u64 q_barr) {
  u64* s = smem_row;
  const int len = n >> 1;
  const int part = blockIdx.x & 1;
  const size_t base = (size_t)(blockIdx.x >> 1) * n;
  const u64 twice_q = 2 * q;
  const u64 W = tab[1], Wp = tab[n + 1];
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const u64 tx = cond_sub(barrett_canonical(in[base + i], q, q_barr), twice_q);
    const u64 T =
        mul_lazy(barrett_canonical(in[base + i + len], q, q_barr), W, Wp, q);
    s[i] = part == 0 ? tx + T : tx + twice_q - T;
  }
  __syncthreads();
  fwd_stages(s, tab, tab + n, len, q, 2, part);
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    out[base + (size_t)part * len + i] = reduce4(s[i], q);
}

// Inverse NTT of a row held as two halves, first kernel: every stage that
// stays inside a half (m = n/2 .. 2); values in [0, 2q) go to `out`.
__global__ void __launch_bounds__(1024)
ntt_inv_wide_halves_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                           const u64* __restrict__ tab, int n, u64 q,
                           u64 q_barr) {
  u64* s = smem_row;
  const int len = n >> 1;
  const int part = blockIdx.x & 1;
  const size_t base = (size_t)(blockIdx.x >> 1) * n + (size_t)part * len;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    s[i] = barrett_canonical(in[base + i], q, q_barr);
  __syncthreads();
  inv_stages(s, tab + 2 * n, tab + 3 * n, len, q, 2, part);
  for (int i = threadIdx.x; i < len; i += blockDim.x) out[base + i] = s[i];
}

// Second kernel: the last stage (m = 1) across the halves, fused with the
// n^-1 scaling, in place on `out`; one thread owns both elements it rewrites.
__global__ void __launch_bounds__(256)
ntt_inv_wide_last_kernel(u64* __restrict__ out, int n, size_t pairs, u64 q,
                         u64 inv_n, u64 inv_n_p, u64 inv_n_w, u64 inv_n_w_p) {
  const u64 twice_q = 2 * q;
  const int half = n >> 1;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < pairs;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t at = (e / half) * n + (e % half);
    const u64 X = out[at], Y = out[at + half];
    const u64 tx = cond_sub(X + Y, twice_q);
    const u64 ty = X + twice_q - Y;
    out[at] = cond_sub(mul_lazy(tx, inv_n, inv_n_p, q), q);
    out[at + half] = cond_sub(mul_lazy(ty, inv_n_w, inv_n_w_p, q), q);
  }
}

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

static int threads_for(int n) { return n / 2 < 1024 ? n / 2 : 1024; }

template <typename K>
static cudaError_t opt_in_smem(K kernel, int n) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n * (int)sizeof(u64));
}

// The split kernels at C = parts in {1, 2, 4}; false for a (C, n) that no
// instance serves (a piece must hold 2 values).
typedef void (*FwdKernel)(const u64*, u64*, const u64*, int, u64, u64);
typedef void (*TailKernel)(const u64*, const u64*, const u64*, u64*,
                           const u64*, int, u64, u64, u64, u64, u64);

static bool split_kernels(int C, int n, FwdKernel* f, TailKernel* t) {
  *f = nullptr;
  *t = nullptr;
  if (n < 2 * C || n % C) return false;
  switch (C) {
    case 1: *f = ntt_fwd_kernel<1>; *t = ntt_fwd_tail_kernel<1>; break;
    case 2: *f = ntt_fwd_kernel<2>; *t = ntt_fwd_tail_kernel<2>; break;
    case 4: *f = ntt_fwd_kernel<4>; *t = ntt_fwd_tail_kernel<4>; break;
  }
  return *f != nullptr;
}

static int split_threads(int len) {
  const int t = len >> SPLIT_R;
  return t < 1 ? 1 : (t > SPLIT_THREADS ? SPLIT_THREADS : t);
}

static int split_smem_bytes(int len) { return (spad(len - 1) + 1) * (int)sizeof(u64); }

// rows * C blocks of split_threads each
template <typename Kernel, typename... Args>
static int launch_split(Kernel kern, int C, int rows, int n, void* stream,
                        Args... args) {
  const int len = n / C, smem = split_smem_bytes(len);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<rows * C, split_threads(len), smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// `parts` blocks per row
extern "C" int hexl_ntt_fwd(const void* in, void* out, const void* tab,
                            int rows, int n, u64 q, u64 q_barr, int parts,
                            void* stream) {
  FwdKernel f;
  TailKernel t;
  if (!split_kernels(parts, n, &f, &t)) return (int)cudaErrorInvalidValue;
  return launch_split(f, parts, rows, n, stream, (const u64*)in, (u64*)out,
                      (const u64*)tab, n, q, q_barr);
}

extern "C" int hexl_ntt_fwd_tail(const void* e, const void* acc,
                                 const void* res, void* out, const void* tab,
                                 int rows, int n, u64 q, u64 q_barr, u64 fix,
                                 u64 msf, u64 msf_p, int parts, void* stream) {
  FwdKernel f;
  TailKernel t;
  if (!split_kernels(parts, n, &f, &t)) return (int)cudaErrorInvalidValue;
  return launch_split(t, parts, rows, n, stream, (const u64*)e,
                      (const u64*)acc, (const u64*)res, (u64*)out,
                      (const u64*)tab, n, q, q_barr, fix, msf, msf_p);
}

// What the card made of a split kernel (tail = 0: ntt_fwd, 1: the tail) at
// (parts, n): out = registers per thread, local (spill) bytes per thread,
// threads per block, resident blocks per SM.
extern "C" int hexl_ntt_split_info(int tail, int parts, int n, int* out) {
  FwdKernel f;
  TailKernel t;
  if (!split_kernels(parts, n, &f, &t)) return (int)cudaErrorInvalidValue;
  const void* k = tail ? (const void*)t : (const void*)f;
  const int len = n / parts, smem = split_smem_bytes(len);
  const int threads = split_threads(len);
  cudaFuncAttributes a = {};
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = threads;
  out[3] = blocks;
  return (int)err;
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

// out (comp, B, n) needs no initialisation: it is zeroed here, on the stream.
// L source limbs, of which `skip` (-1: none) is left out; L - 1 >= 1 then.
extern "C" int hexl_ntt_fwd_mac(const void* data, const void* keys,
                                const void* kp, void* out, const void* tab,
                                int L, int B, int comp, int K, int j, int skip,
                                int n, u64 q, u64 q_barr, void* stream) {
  cudaError_t err = opt_in_smem(ntt_fwd_mac_kernel, n);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(out, 0, (size_t)comp * B * n * sizeof(u64),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, skip >= 0 ? L - 1 : L);
  ntt_fwd_mac_kernel<<<grid, threads_for(n), n * sizeof(u64),
                       (cudaStream_t)stream>>>(
      (const u64*)data, (const u64*)keys, (const u64*)kp, (u64*)out,
      (const u64*)tab, n, B, comp, K, j, skip, q, q_barr);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ntt_fwd_wide(const void* in, void* out, const void* tab,
                                 int rows, int n, u64 q, u64 q_barr,
                                 void* stream) {
  const int len = n / 2;
  cudaError_t err = opt_in_smem(ntt_fwd_wide_kernel, len);
  if (err != cudaSuccess) return (int)err;
  ntt_fwd_wide_kernel<<<2 * rows, threads_for(len), len * sizeof(u64),
                        (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)tab, n, q, q_barr);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ntt_inv_wide(const void* in, void* out, const void* tab,
                                 int rows, int n, u64 q, u64 q_barr, u64 inv_n,
                                 u64 inv_n_p, u64 inv_n_w, u64 inv_n_w_p,
                                 void* stream) {
  const int len = n / 2;
  cudaError_t err = opt_in_smem(ntt_inv_wide_halves_kernel, len);
  if (err != cudaSuccess) return (int)err;
  ntt_inv_wide_halves_kernel<<<2 * rows, threads_for(len), len * sizeof(u64),
                               (cudaStream_t)stream>>>(
      (const u64*)in, (u64*)out, (const u64*)tab, n, q, q_barr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t pairs = (size_t)rows * len;
  ntt_inv_wide_last_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(
      (u64*)out, n, pairs, q, inv_n, inv_n_p, inv_n_w, inv_n_w_p);
  return (int)cudaGetLastError();
}
