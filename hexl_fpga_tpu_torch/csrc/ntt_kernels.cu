// Negacyclic NTT kernels for Hopper (sm_90a), plain C interface for ctypes.
//
//   hexl_ntt_fwd       batched forward NTT, any u64 in -> canonical, bit-reversed out
//   hexl_ntt_inv       batched inverse NTT, bit-reversed in -> canonical, natural out
//   hexl_ntt_fwd_tail  keyswitch tail: +fix, forward NTT, modswitch, accumulate
//   hexl_ntt_fwd_mac   keyswitch engine: forward NTT fused with the key MAC
//   hexl_keyswitch_mac keyswitch engine's lazy key MAC on transformed limbs
//                      (the default schedule's, after hexl_ntt_fwd)
//
// The first three replace the fused MXU kernels of
// hexl_fpga_tpu/ops/ntt_mxu_pallas.py (_fwd_kernel, _inv_kernel, the
// raw_fwd_tail_call kernel), and hexl_ntt_fwd_mac replaces the
// raw_fwd_mac_call kernel of the same file.  Those compute the transform as
// two int8-limb matrix products because their target has no 64-bit integers; this card has
// them (__umul64hi), so the transform here is the Harvey butterfly network
// itself.  hexl_ntt_fwd and hexl_ntt_inv are also the counterpart of the
// batched butterfly kernels of hexl_fpga_tpu/ops/ntt_pallas.py (_fwd_kernel,
// _inv_kernel: canonical in, canonical out, a tile resident for all stages),
// which keep a (tile, n) block in a fast memory of many megabytes; a block
// here has 227 KB, so a row of n = 32768 (256 KB) takes C = 2 or 4 blocks.
//
// Layout: rows of n contiguous u64 (passed as int64 bit patterns).  `tab` is
// a (4, n) table for one modulus: fwd, fwd_precon, inv, inv_precon.
// The first four run a split core of ntt_kernels.cuh: `parts` blocks per
// row, each with n/parts values in dynamic shared memory, several butterfly
// stages per barrier in registers; the caller chooses parts
// (ntt_cuda.row_split, ntt_cuda.mac_split).  The forward kernels (fwd_split)
// hold contiguous pieces, the inverse (inv_split) strided ones, so that in
// both the stages that cross the pieces are done from device memory while
// loading.  hexl_ntt_fwd_mac sums over the source limbs in shared memory,
// inside a block or over a thread-block cluster, and stores each output once.
// Each entry launches one kernel on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Bound: per coefficient the kernels move 16..32 bytes and do log2(n)/2
// butterflies of three 64-bit multiplies (about ten 32-bit multiply-adds); by
// that count bytes and multiplies are within a factor of two of each other.
// What limited the first kernels here, a row in one block with a barrier a
// stage, was neither: it was the shared-memory traffic of log2(n) stages
// with a barrier each, and one block per SM.  The split cores' design
// against both is in ntt_kernels.cuh.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_kernels.cuh"

namespace cg = cooperative_groups;

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

// blockIdx.x = C * row + part; piece part is the row's values part + C * k
template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
ntt_inv_kernel(const u64* __restrict__ in, u64* __restrict__ out,
               const u64* __restrict__ tab, int n, u64 q, u64 q_barr,
               InvScale sc) {
  const int part = blockIdx.x % C, len = n / C;
  const size_t row = (size_t)(blockIdx.x / C) * n;
  inv_split<C>(smem_row, in + row, out + row + part, tab + 2 * n, tab + 3 * n,
               n, 31 - __clz(len), part, q, q_barr, sc);
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
// component k and summed over the active limbs:
//   out[k, b, x] = sum over i != skip of
//                  mul_lazy(NTT_q(data[i*B + b] mod q)[x], keys[i, k, j, x])
// The counterpart on the other target walks a (batch tile, i) grid in order
// with the accumulator block resident in fast memory across i.  Here the sum
// stays on chip and each output is written once, with a plain store:
//   block (C * b + part, rank) of a cluster of S = gridDim.y blocks runs
//   fwd_split<C> on piece `part` of the active limbs rank, rank + S, ...
//   in turn, and adds each limb's terms for components k0 .. k0 + kc - 1 into
//   accumulators in its shared memory beside the piece (each thread at its own
//   positions, so no barrier but the one before the next limb overwrites the
//   piece).  S = 1: the block stores its sums.  S > 1: after cluster.sync(),
//   rank rho sums slice rho of the piece over the cluster's accumulators
//   through distributed shared memory and stores it.
// Wrapping 64-bit adds commute, so any grouping of the terms gives the same
// bits; reduce4 before the multiply fixes each term's bits whatever the
// stages leave in [0, 4q), so the kernel equals its plain version bit for bit;
// each term is in [0, 2q) and the sum below 2 * L * q.  `skip` (-1 for none)
// is the source limb left to the caller.  keys / kp are the whole
// (L, comp, K, n) tensors; element (i, k, j, x) lies at
// ((i * comp + k) * K + j) * n + x.  Components that do not fit shared memory
// at once (kc < comp) take another round of transforms.
// Bound: operations by the count (it writes comp * B rows where ntt_fwd
// writes L * B, and adds comp lazy multiplies per coefficient; chip_smoke.py
// computes both sides).  Above its transforms it pays for the key and precon
// columns, read again for every batch row (L2 hits after the first): a
// quarter of its time at 16384_6_7_7_2, batch 32 (PERF.md §6).
template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
ntt_fwd_mac_kernel(const u64* __restrict__ data, const u64* __restrict__ keys,
                   const u64* __restrict__ kp, u64* __restrict__ out,
                   const u64* __restrict__ tab, int n, int B, int comp, int K,
                   int j, int skip, int limbs, int kc, u64 q, u64 q_barr) {
  u64* s = smem_row;
  const int part = blockIdx.x % C, b = blockIdx.x / C, len = n / C;
  const int log_len = 31 - __clz(len);
  const int S = gridDim.y, rank = blockIdx.y;
  const size_t piece = (size_t)part * len;
  u64* acc = s + spad(len - 1) + 1;
  for (int k0 = 0; k0 < comp; k0 += kc) {
    const int kn = min(kc, comp - k0);
    for (int a = rank; a < limbs; a += S) {
      const int i = (skip >= 0 && a >= skip) ? a + 1 : a;
      fwd_split<C>(s, data + ((size_t)i * B + b) * n, tab, tab + n, log_len,
                   part, q, q_barr, 0);
      for (int k = 0; k < kn; ++k) {
        const size_t col = (((size_t)i * comp + k0 + k) * K + j) * n + piece;
        const u64* key = keys + col;
        const u64* pre = kp + col;
        u64* sum = acc + k * len;
#pragma unroll 8  // the key reads of several positions in flight at once
        for (int x = threadIdx.x; x < len; x += blockDim.x) {
          const u64 t = mul_lazy(reduce4(s[spad(x)], q), __ldg(key + x),
                                 __ldg(pre + x), q);
          sum[x] = a == rank ? t : sum[x] + t;
        }
      }
      __syncthreads();  // the next limb's transform overwrites the piece
    }
    u64* dst = out + ((size_t)k0 * B + b) * n + piece;
    if (S == 1) {
      for (int k = 0; k < kn; ++k)
        for (int x = threadIdx.x; x < len; x += blockDim.x)
          dst[(size_t)k * B * n + x] = acc[k * len + x];
      continue;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int lo = (int)((long long)len * rank / S);
    const int hi = (int)((long long)len * (rank + 1) / S);
    for (int k = 0; k < kn; ++k)
      for (int x = lo + threadIdx.x; x < hi; x += blockDim.x) {
        u64 sum = 0;
        for (int rho = 0; rho < S; ++rho)
          sum += cluster.map_shared_rank(acc, rho)[k * len + x];
        dst[(size_t)k * B * n + x] = sum;
      }
    cluster.sync();  // no block leaves, or refills, while others read it
  }
}

// Keyswitch lazy key MAC of the default schedule, for one engine modulus q:
// the engine's transformed source limbs val (limbs, Bv, n) against its key
// column and precons (limbs, comp, Bk, n), Bv and Bk each 1 or B:
//   out[k, b, x] = sum_i key[i,k,b,x] * val[i,b,x]
//                  - (sum_i Q(val[i,b,x], kp[i,k,b,x])) * q          mod 2^64
//   Q(a, p) = a1*p1 + (a0*p1 >> 32) + (a1*p0 >> 32)   (32-bit halves)
// Q is the Harvey quotient without the a0*p0 partial and the low-half carry
// chain (short by at most 2), and the Q*q subtraction is deferred to once a
// sum: the torch composition it replaces (keyswitch_mac_plain) computes the
// same words, since wrapping adds commute.  The true sum is of terms in
// [0, 4q), so below 28q < 2^58 for q <= 2^52 and limbs <= 7: the input
// contract of the tails and of INTT2's Barrett.
// No TPU kernel has it: the reference composes it in XLA, as the torch glue
// did here (about 20 elementwise and reduce launches an engine over
// (limbs, comp, B, n) intermediates).  Bytes bound it: per output word
// limbs/comp val words, 2 * limbs key and precon words (L2 hits after the
// first batch row when Bk = 1) and one store, against limbs lazy terms of
// six 32-bit multiply-adds.  Each thread keeps both components' two sums
// for V adjacent coefficients in registers over the limbs, so val is read
// once for all components, and every access is V * 8 contiguous bytes along
// n (V = 2: 16-byte loads and stores where pointers and strides allow).
// Grid: x over the coefficients, y the batch row.
constexpr int KS_MAC_THREADS = 256;
constexpr int KS_MAC_MAX_COMP = 2;

struct MacStrides {  // in words; a broadcast row has stride 0
  long long val_i, val_b, key_i, key_k, key_b, kp_i, kp_k, kp_b;
};

__device__ __forceinline__ u64 mulhi_approx(u64 a, u64 p) {
  const unsigned a0 = (unsigned)a, a1 = (unsigned)(a >> 32);
  const unsigned p0 = (unsigned)p, p1 = (unsigned)(p >> 32);
  return (u64)a1 * p1 + __umulhi(a0, p1) + __umulhi(a1, p0);
}

template <int V>
__device__ __forceinline__ void load_words(u64 (&v)[V], const u64* p) {
  if constexpr (V == 2) {
    const ulonglong2 t = __ldg(reinterpret_cast<const ulonglong2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__global__ void __launch_bounds__(KS_MAC_THREADS)
keyswitch_mac_kernel(const u64* __restrict__ val, const u64* __restrict__ key,
                     const u64* __restrict__ kp, u64* __restrict__ out,
                     MacStrides st, int limbs, int comp, int B, int n, u64 q) {
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (x >= n) return;
  const long long b = blockIdx.y;
  u64 wx[KS_MAC_MAX_COMP][V] = {}, qs[KS_MAC_MAX_COMP][V] = {};
  for (int i = 0; i < limbs; ++i) {
    u64 v[V];
    load_words<V>(v, val + i * st.val_i + b * st.val_b + x);
#pragma unroll
    for (int k = 0; k < KS_MAC_MAX_COMP; ++k) {
      if (k >= comp) break;
      u64 w[V], p[V];
      load_words<V>(w, key + i * st.key_i + k * st.key_k + b * st.key_b + x);
      load_words<V>(p, kp + i * st.kp_i + k * st.kp_k + b * st.kp_b + x);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        wx[k][e] += w[e] * v[e];
        qs[k][e] += mulhi_approx(v[e], p[e]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KS_MAC_MAX_COMP; ++k) {
    if (k >= comp) break;
    u64* dst = out + ((size_t)k * B + b) * n + x;
    if constexpr (V == 2) {
      *reinterpret_cast<ulonglong2*>(dst) =
          make_ulonglong2(wx[k][0] - qs[k][0] * q, wx[k][1] - qs[k][1] * q);
    } else {
      dst[0] = wx[k][0] - qs[k][0] * q;
    }
  }
}

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

// The split kernels: kernel (FWD, TAIL, INV, MAC) at C = parts in {1, 2, 4};
// nullptr for a (C, n) that no instance serves (a piece must hold 2 values).
enum SplitKernel { FWD = 0, TAIL = 1, INV = 2, MAC = 3 };

template <int C>
static const void* split_instance(int kernel) {
  switch (kernel) {
    case FWD: return (const void*)ntt_fwd_kernel<C>;
    case TAIL: return (const void*)ntt_fwd_tail_kernel<C>;
    case INV: return (const void*)ntt_inv_kernel<C>;
    case MAC: return (const void*)ntt_fwd_mac_kernel<C>;
  }
  return nullptr;
}

static const void* split_kernel(int kernel, int C, int n) {
  if (n < 2 * C || n % C) return nullptr;
  switch (C) {
    case 1: return split_instance<1>(kernel);
    case 2: return split_instance<2>(kernel);
    case 4: return split_instance<4>(kernel);
  }
  return nullptr;
}

static int split_threads(int len) {
  const int t = len >> SPLIT_R;
  return t < 1 ? 1 : (t > SPLIT_THREADS ? SPLIT_THREADS : t);
}

static int split_smem_bytes(int len) { return (spad(len - 1) + 1) * (int)sizeof(u64); }

// sm_90's dynamic shared memory per block at most (opted in)
constexpr int MAX_BLOCK_SMEM = 232448;

// MAC components whose accumulators fit beside a piece of len values (at
// most comp; 0: not even one)
static int mac_chunk(int len, int comp) {
  const int fit = (MAX_BLOCK_SMEM - split_smem_bytes(len)) / (len * (int)sizeof(u64));
  return fit < comp ? fit : comp;
}

// One launch of `kern` on `stream`: grid, split_threads(len), smem bytes of
// dynamic shared memory, in clusters of (1, cluster) blocks if cluster > 1.
// The argument types must be the kernel's own.
template <typename... Args>
static int launch(const void* kern, dim3 grid, int len, int smem, int cluster,
                  void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* argv[] = {(void*)&args...};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(split_threads(len));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  if (cluster > 1) {
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelExC(&cfg, kern, argv);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `parts` blocks per row
extern "C" int hexl_ntt_fwd(const void* in, void* out, const void* tab,
                            int rows, int n, u64 q, u64 q_barr, int parts,
                            void* stream) {
  const void* k = split_kernel(FWD, parts, n);
  if (!k) return (int)cudaErrorInvalidValue;
  return launch(k, dim3(rows * parts), n / parts, split_smem_bytes(n / parts), 1,
                stream, (const u64*)in, (u64*)out, (const u64*)tab, n, q, q_barr);
}

extern "C" int hexl_ntt_fwd_tail(const void* e, const void* acc,
                                 const void* res, void* out, const void* tab,
                                 int rows, int n, u64 q, u64 q_barr, u64 fix,
                                 u64 msf, u64 msf_p, int parts, void* stream) {
  const void* k = split_kernel(TAIL, parts, n);
  if (!k) return (int)cudaErrorInvalidValue;
  return launch(k, dim3(rows * parts), n / parts, split_smem_bytes(n / parts), 1,
                stream, (const u64*)e, (const u64*)acc, (const u64*)res,
                (u64*)out, (const u64*)tab, n, q, q_barr, fix, msf, msf_p);
}

extern "C" int hexl_ntt_inv(const void* in, void* out, const void* tab,
                            int rows, int n, u64 q, u64 q_barr, u64 inv_n,
                            u64 inv_n_p, u64 inv_n_w, u64 inv_n_w_p, int parts,
                            void* stream) {
  const void* k = split_kernel(INV, parts, n);
  if (!k) return (int)cudaErrorInvalidValue;
  const InvScale sc = {inv_n, inv_n_p, inv_n_w, inv_n_w_p};
  return launch(k, dim3(rows * parts), n / parts, split_smem_bytes(n / parts), 1,
                stream, (const u64*)in, (u64*)out, (const u64*)tab, n, q, q_barr,
                sc);
}

// out (comp, B, n) needs no initialisation: every element is stored once.
// L source limbs, of which `skip` (-1: none) is left out; L - 1 >= 1 then.
// B * parts blocks, each in a cluster of `cluster` (1 .. min(8, active limbs))
// that shares the limbs.
extern "C" int hexl_ntt_fwd_mac(const void* data, const void* keys,
                                const void* kp, void* out, const void* tab,
                                int L, int B, int comp, int K, int j, int skip,
                                int n, u64 q, u64 q_barr, int parts, int cluster,
                                void* stream) {
  const void* k = split_kernel(MAC, parts, n);
  const int limbs = skip >= 0 ? L - 1 : L;
  if (!k || cluster < 1 || cluster > 8 || cluster > limbs)
    return (int)cudaErrorInvalidValue;
  const int len = n / parts, kc = mac_chunk(len, comp);
  if (kc < 1) return (int)cudaErrorInvalidValue;
  const int smem = split_smem_bytes(len) + kc * len * (int)sizeof(u64);
  return launch(k, dim3(B * parts, cluster), len, smem, cluster, stream,
                (const u64*)data, (const u64*)keys, (const u64*)kp, (u64*)out,
                (const u64*)tab, n, B, comp, K, j, skip, limbs, kc, q, q_barr);
}

// out (comp, B, n), contiguous, every element stored once.  Strides in
// words (0 for a broadcast row); the last dimension is contiguous.  vec = 2
// asks for 16-byte accesses: every pointer 16-byte aligned, every stride and
// n even (the caller checks).
extern "C" int hexl_keyswitch_mac(const void* val, const void* key,
                                  const void* kp, void* out, int limbs,
                                  int comp, int B, int n, long long val_i,
                                  long long val_b, long long key_i,
                                  long long key_k, long long key_b,
                                  long long kp_i, long long kp_k,
                                  long long kp_b, u64 q, int vec,
                                  void* stream) {
  if (limbs < 1 || comp < 1 || comp > KS_MAC_MAX_COMP || B < 1 || B > 65535 ||
      n < 1 || (vec != 1 && vec != 2) || n % vec)
    return (int)cudaErrorInvalidValue;
  const MacStrides st = {val_i, val_b, key_i, key_k, key_b, kp_i, kp_k, kp_b};
  const int per_block = KS_MAC_THREADS * vec;
  const dim3 grid((n + per_block - 1) / per_block, B);
  const auto kern = vec == 2 ? keyswitch_mac_kernel<2> : keyswitch_mac_kernel<1>;
  kern<<<grid, KS_MAC_THREADS, 0, (cudaStream_t)stream>>>(
      (const u64*)val, (const u64*)key, (const u64*)kp, (u64*)out, st, limbs,
      comp, B, n, q);
  return (int)cudaGetLastError();
}

// What the card made of a split kernel (FWD, TAIL, INV, MAC; the MAC with
// `comp` components in clusters of `cluster`) at (parts, n): out = registers
// per thread, local (spill) bytes per thread, threads per block, resident
// blocks per SM, dynamic shared memory bytes per block, and for cluster > 1
// the clusters the card runs at once (else 0).
extern "C" int hexl_ntt_split_info(int kernel, int parts, int n, int comp,
                                   int cluster, int* out) {
  const void* k = split_kernel(kernel, parts, n);
  if (!k) return (int)cudaErrorInvalidValue;
  const int len = n / parts, threads = split_threads(len);
  int smem = split_smem_bytes(len);
  if (kernel == MAC) {
    const int kc = mac_chunk(len, comp);
    if (kc < 1) return (int)cudaErrorInvalidValue;
    smem += kc * len * (int)sizeof(u64);
  }
  cudaFuncAttributes a = {};
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0, clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  if (err == cudaSuccess && cluster > 1) {
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = cluster;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = threads;
  out[3] = blocks;
  out[4] = smem;
  out[5] = clusters;
  return (int)err;
}
