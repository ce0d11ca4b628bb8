// BEHZ base conversions for Hopper (sm_90a), plain C interface for ctypes.
//
//   hexl_behz_extend    (k, R, n) canonical under q -> (k+1, R, n) canonical
//                       under Bsk = B u {m_sk}: the fast conversion q -> Bsk
//                       with SmMRq's m_tilde = 2^32 correction
//                       (rns_behz.BehzTool.extend_to_bsk)
//   hexl_behz_floor_sk  (k, R, n) under q and (k+1, R, n) under Bsk ->
//                       (k, R, n) canonical under q: the fast floor of the
//                       t-scaled tensor product, then the exact
//                       Shenoy-Kumaresan conversion B -> q
//                       (BehzTool.fast_floor, then BehzTool.fastbconv_sk)
//
// They replace no TPU kernel: the reference writes these conversions as XLA
// lane math (hexl_fpga_tpu/ops/rns_behz_tpu.py, BehzTpu._extend_to_bsk,
// _fast_floor, _fastbconv_sk), and the port's plain versions
// (ops/rns_behz_cuda.py, BehzCuda._extend_to_bsk_plain, _floor_sk_plain) are
// torch ops over whole (k, D, R, n) tensors of lazy terms, a few hundred
// launches a multiply.  Here one thread takes one coefficient column (one of
// the R * n) through a whole conversion with every intermediate in
// registers (up to BEHZ_MAX_K limbs): it reads its k (or 2k + 1) words,
// writes its k + 1 (or k), and nothing else reaches device memory.
//
// Constants: one packed table of u64 per BehzCuda, in the order of
// BehzCuda._pack's list (ops/rns_behz_cuda.py; Layout below is the one other
// statement of it).  A constant c mod m is followed, after all the constants
// of its group, by its Harvey precon floor(c 2^64 / m).
//
// Any k: the kernels are templates on K = k, so that a column's limbs live in
// registers and each block copies the table into shared memory, for k up to
// BEHZ_MAX_K (the reference's decomp <= 7, the cell's k = 6).  K = 0 is the
// same code for every larger k: a column's limbs live in a scratch tensor of
// the caller's, one row of words per limb (coalesced like the data), and the
// table, which at large k outgrows shared memory, is read in place through
// the cache.  The bits are the same either way.
//
// Exactness: every step ends canonical, as in the plain versions, so any
// exact order of operations gives their bits.  A conversion sum adds Harvey
// lazy terms (each below 2m) into a running sum kept below 2m, so nothing
// passes 4m < 2^64 for every modulus below 2^62 (the port's ceiling,
// rns_behz_cuda.fits), 61-bit Bsk primes included.  m_tilde = 2^32
// arithmetic is uint32 arithmetic.
//
// Bound: per column about 62 (extension) and 117 (floor + SK, at k = 6)
// Harvey products of about ten 32-bit multiply-adds each, against 104 and
// 152 bytes: on an H100 operations bound both, at 1.2 and 1.5 times the
// bytes' time.  The design is only this: one pass over the data, loads and
// stores along n across the threads of a warp, the constants in shared
// memory (every thread of a warp reads the same word: a broadcast).
// Each entry launches one kernel on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 = launched).
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int BEHZ_THREADS = 256;
constexpr int BEHZ_MAX_K = 8;  // rns_behz_cuda.MAX_K

// Offsets into the packed table, in words, for k q moduli and D = k + 1 Bsk
// moduli; a Harvey group of L constants takes 2L words (constants, then
// precons), a (k, D) matrix is row-major.
struct Layout {
  long long Q, BSK, EXT, QHAT_MT, NEG_INV_Q_MT, Q_TO_BSK, Q_MOD_BSK, INV_MT_BSK,
      FLOOR, T_BSK, INV_Q_BSK, SK, B_TO_QMSK, INV_B_MSK, B_MOD_Q, SIZE;
  __host__ __device__ constexpr explicit Layout(long long k)
      : Q(0),                                    // q_i
        BSK(Q + k),                              // b_j, then m_sk
        EXT(BSK + k + 1),                        // m_tilde q^_i^-1 mod q_i
        QHAT_MT(EXT + 2 * k),                    // q^_i mod 2^32
        NEG_INV_Q_MT(QHAT_MT + k),               // -q^-1 mod 2^32
        Q_TO_BSK(NEG_INV_Q_MT + 1),              // q^_i mod Bsk_d
        Q_MOD_BSK(Q_TO_BSK + 2 * k * (k + 1)),   // q mod Bsk_d
        INV_MT_BSK(Q_MOD_BSK + 2 * (k + 1)),     // m_tilde^-1 mod Bsk_d
        FLOOR(INV_MT_BSK + 2 * (k + 1)),         // t q^_i^-1 mod q_i
        T_BSK(FLOOR + 2 * k),                    // t mod Bsk_d
        INV_Q_BSK(T_BSK + 2 * (k + 1)),          // q^-1 mod Bsk_d
        SK(INV_Q_BSK + 2 * (k + 1)),             // b^_j^-1 mod b_j
        B_TO_QMSK(SK + 2 * k),                   // b^_j mod q_i, then mod m_sk
        INV_B_MSK(B_TO_QMSK + 2 * k * (k + 1)),  // B^-1 mod m_sk
        B_MOD_Q(INV_B_MSK + 2),                  // B mod q_i
        SIZE(B_MOD_Q + 2 * k) {}
};

// A column's k limbs: registers for K = k; for K = 0 (any k) row `first` on
// of the scratch, one word per column.
template <int K>
struct Limbs {
  u64 v[K];
  __device__ __forceinline__ Limbs(u64*, int, long long, long long) {}
  __device__ __forceinline__ u64& operator[](int i) { return v[i]; }
};

template <>
struct Limbs<0> {
  u64* p;
  long long cols;
  __device__ __forceinline__ Limbs(u64* scratch, int first, long long c, long long n)
      : p(scratch + first * n + c), cols(n) {}
  __device__ __forceinline__ u64& operator[](int i) { return p[i * cols]; }
};

__device__ __forceinline__ u64 cond_sub(u64 a, u64 m) {
  return a >= m ? a - m : a;
}

// x * c mod m in [0, 2m) for any u64 x, c < m < 2^63, pre its Harvey precon
__device__ __forceinline__ u64 mul_lazy(u64 x, u64 c, u64 pre, u64 m) {
  return x * c - __umul64hi(x, pre) * m;
}

// x * g[at] mod m, canonical, for the Harvey group g of `len` constants
__device__ __forceinline__ u64 mul_mod(u64 x, const u64* g, int at, int len,
                                       u64 m) {
  return cond_sub(mul_lazy(x, g[at], g[len + at], m), m);
}

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 m) {
  return cond_sub(a + b, m);
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 m) {
  return a >= b ? a - b : a + (m - b);
}

// sum_i x[i] * C[i][d] mod m, canonical, for the (k, k + 1) Harvey matrix C
// at g
template <int K>
__device__ __forceinline__ u64 convert(Limbs<K>& x, int k, const u64* g, int d,
                                       u64 m) {
  const int D = k + 1;
  const u64 m2 = 2 * m;
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < k; ++i)
    acc = cond_sub(acc + mul_lazy(x[i], g[i * D + d], g[k * D + i * D + d], m), m2);
  return cond_sub(acc, m);
}

// Where the kernel reads the table: shared memory, filled by the block, for
// K = k; in place for K = 0.
template <int K>
__device__ __forceinline__ const u64* stage_table(u64* s, const u64* table,
                                                  long long size) {
  if (K == 0) return table;
  for (int i = threadIdx.x; i < size; i += blockDim.x) s[i] = table[i];
  __syncthreads();
  return s;
}

// Grid: x over the R * n columns; limb i of a column c is word i * cols + c.
// k_any is k where K = 0, and unread otherwise; so is scratch, (k, cols).
template <int K>
__global__ void __launch_bounds__(BEHZ_THREADS)
behz_extend_kernel(const u64* __restrict__ x, const u64* __restrict__ table,
                   u64* __restrict__ out, u64* __restrict__ scratch, int k_any,
                   long long cols) {
  const int k = K ? K : k_any, D = k + 1;
  const Layout L(k);
  __shared__ u64 smem[K ? Layout(K).SIZE : 1];
  const u64* t = stage_table<K>(smem, table, L.SIZE);
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  Limbs<K> xt(scratch, 0, c, cols);
  u32 r = 0;  // the fast conversion's m_tilde residue
#pragma unroll
  for (int i = 0; i < k; ++i) {
    const u64 v = mul_mod(x[i * cols + c], t + L.EXT, i, k, t[L.Q + i]);
    xt[i] = v;
    r += (u32)v * (u32)t[L.QHAT_MT + i];
  }
  r *= (u32)t[L.NEG_INV_Q_MT];
  const bool neg = r >> 31;  // r as a signed residue in [-2^31, 2^31)
  const u64 rmag = neg ? (1ull << 32) - r : r;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const u64 m = t[L.BSK + d];
    const u64 s = convert<K>(xt, k, t + L.Q_TO_BSK, d, m);
    const u64 corr = mul_mod(rmag, t + L.Q_MOD_BSK, d, D, m);
    out[d * cols + c] = mul_mod(neg ? sub_mod(s, corr, m) : add_mod(s, corr, m),
                                t + L.INV_MT_BSK, d, D, m);
  }
}

// As behz_extend_kernel; scratch (2k, cols) where K = 0.
template <int K>
__global__ void __launch_bounds__(BEHZ_THREADS)
behz_floor_sk_kernel(const u64* __restrict__ d_q, const u64* __restrict__ d_bsk,
                     const u64* __restrict__ table, u64* __restrict__ out,
                     u64* __restrict__ scratch, int k_any, long long cols) {
  const int k = K ? K : k_any, D = k + 1;
  const Layout L(k);
  __shared__ u64 smem[K ? Layout(K).SIZE : 1];
  const u64* t = stage_table<K>(smem, table, L.SIZE);
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  // fast floor: (t d_bsk - conv(t d_q)) q^-1 under Bsk
  Limbs<K> ft(scratch, 0, c, cols);
#pragma unroll
  for (int i = 0; i < k; ++i)
    ft[i] = mul_mod(d_q[i * cols + c], t + L.FLOOR, i, k, t[L.Q + i]);
  Limbs<K> g(scratch, k, c, cols);  // the B part already scaled by b^_j^-1 for SK
  u64 g_msk = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const u64 m = t[L.BSK + d];
    const u64 f = convert<K>(ft, k, t + L.Q_TO_BSK, d, m);
    const u64 td = mul_mod(d_bsk[d * cols + c], t + L.T_BSK, d, D, m);
    const u64 gd = mul_mod(sub_mod(td, f, m), t + L.INV_Q_BSK, d, D, m);
    if (d < k)
      g[d] = mul_mod(gd, t + L.SK, d, k, m);
    else
      g_msk = gd;
  }
  // Shenoy-Kumaresan: alpha from m_sk, then the +-|alpha| B correction
  const u64 msk = t[L.BSK + k];
  const u64 h = convert<K>(g, k, t + L.B_TO_QMSK, k, msk);
  const u64 alpha = mul_mod(sub_mod(h, g_msk, msk), t + L.INV_B_MSK, 0, 1, msk);
  const bool neg = alpha > (msk >> 1);
  const u64 amag = neg ? msk - alpha : alpha;
#pragma unroll
  for (int i = 0; i < k; ++i) {
    const u64 q = t[L.Q + i];
    const u64 s = convert<K>(g, k, t + L.B_TO_QMSK, i, q);
    const u64 corr = mul_mod(amag, t + L.B_MOD_Q, i, k, q);
    out[i * cols + c] = neg ? add_mod(s, corr, q) : sub_mod(s, corr, q);
  }
}

static unsigned blocks(long long cols) {
  return (unsigned)((cols + BEHZ_THREADS - 1) / BEHZ_THREADS);
}

template <int K>
static void extend(const void* x, const void* table, void* out, void* scratch,
                   int k, long long cols, cudaStream_t stream) {
  behz_extend_kernel<K><<<blocks(cols), BEHZ_THREADS, 0, stream>>>(
      (const u64*)x, (const u64*)table, (u64*)out, (u64*)scratch, k, cols);
}

template <int K>
static void floor_sk(const void* d_q, const void* d_bsk, const void* table,
                     void* out, void* scratch, int k, long long cols,
                     cudaStream_t stream) {
  behz_floor_sk_kernel<K><<<blocks(cols), BEHZ_THREADS, 0, stream>>>(
      (const u64*)d_q, (const u64*)d_bsk, (const u64*)table, (u64*)out,
      (u64*)scratch, k, cols);
}

typedef void (*ExtendFn)(const void*, const void*, void*, void*, int, long long,
                         cudaStream_t);
typedef void (*FloorSkFn)(const void*, const void*, const void*, void*, void*, int,
                          long long, cudaStream_t);
// by K: k for k <= BEHZ_MAX_K, else 0
static const ExtendFn EXTEND[BEHZ_MAX_K + 1] = {
    extend<0>, extend<1>, extend<2>, extend<3>, extend<4>,
    extend<5>, extend<6>, extend<7>, extend<8>};
static const FloorSkFn FLOOR_SK[BEHZ_MAX_K + 1] = {
    floor_sk<0>, floor_sk<1>, floor_sk<2>, floor_sk<3>, floor_sk<4>,
    floor_sk<5>, floor_sk<6>, floor_sk<7>, floor_sk<8>};

// The kernel index of k, or -1 where the arguments are refused: the table
// not Layout(k)'s size, no scratch where K = 0, or a grid beyond CUDA's.
static int kernel_of(int k, long long words, const void* scratch, long long cols) {
  if (k < 1 || words != Layout(k).SIZE || cols < 1 ||
      (cols + BEHZ_THREADS - 1) / BEHZ_THREADS > 0x7fffffffLL)
    return -1;
  if (k <= BEHZ_MAX_K) return k;
  return scratch ? 0 : -1;
}

// x (k, cols) and out (k + 1, cols), contiguous; table the `words` words of
// Layout(k); scratch (k, cols) for k > BEHZ_MAX_K, else unused.
extern "C" int hexl_behz_extend(const void* x, const void* table, long long words,
                                void* out, void* scratch, int k, long long cols,
                                void* stream) {
  const int K = kernel_of(k, words, scratch, cols);
  if (K < 0) return (int)cudaErrorInvalidValue;
  EXTEND[K](x, table, out, scratch, k, cols, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// d_q (k, cols), d_bsk (k + 1, cols) and out (k, cols), contiguous; scratch
// (2k, cols) for k > BEHZ_MAX_K, else unused.
extern "C" int hexl_behz_floor_sk(const void* d_q, const void* d_bsk,
                                  const void* table, long long words, void* out,
                                  void* scratch, int k, long long cols,
                                  void* stream) {
  const int K = kernel_of(k, words, scratch, cols);
  if (K < 0) return (int)cudaErrorInvalidValue;
  FLOOR_SK[K](d_q, d_bsk, table, out, scratch, k, cols, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
