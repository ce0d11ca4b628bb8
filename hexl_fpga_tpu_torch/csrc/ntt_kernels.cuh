// Shared device code of the negacyclic NTT kernels: 64-bit modular
// primitives, the in-shared-memory Harvey butterfly stages, and the split
// forward core of ntt_fwd / ntt_fwd_tail.
//
// One thread block owns one polynomial row, resident in dynamic shared
// memory for all log2(n) stages; or, for a row wider than a block's shared
// memory, one of its `parts` contiguous pieces, after the stages that cross
// the pieces were done from device memory (forward) or before they are
// (inverse).  q, floor(2^64/q) and the tables are runtime arguments, so one
// build serves every modulus q < 2^62 (4q must fit 64 bits).
#pragma once

typedef unsigned long long u64;

__device__ __forceinline__ u64 cond_sub(u64 a, u64 q) {
  return a >= q ? a - q : a;
}

// Any u64 representative -> [0, q).  q_barr = floor(2^64 / q): the quotient
// estimate is short by at most 2, hence two corrections.
__device__ __forceinline__ u64 barrett_canonical(u64 x, u64 q, u64 q_barr) {
  u64 r = x - __umul64hi(x, q_barr) * q;
  return cond_sub(cond_sub(r, q), q);
}

// Harvey lazy multiply: (x * w) mod q in [0, 2q), for w < q,
// wp = floor(w * 2^64 / q), any u64 x.
__device__ __forceinline__ u64 mul_lazy(u64 x, u64 w, u64 wp, u64 q) {
  return w * x - __umul64hi(x, wp) * q;
}

// [0, 4q) -> [0, q)
__device__ __forceinline__ u64 reduce4(u64 x, u64 q) {
  return cond_sub(cond_sub(x, 2 * q), q);
}

// Forward (Cooley-Tukey, natural in -> bit-reversed out) stages on `len`
// values in shared memory: the whole row (parts = 1, part = 0), or piece
// `part` of a row of parts * len, whose stages m < parts the caller has done
// already.  Stage m of the whole row is stage m / parts here, and its
// butterfly group j lies in piece part at position j - part * m / parts, so
// with ml = m / parts the twiddle index m + j is (parts + part) * ml + jl.
// Input values < 4q; every stage keeps them < 4q.  `w`/`wp` are the
// bit-reversed root powers and their precons (twiddles.NttTables.fwd /
// fwd_precon).  The caller has synchronised after filling `s`; the function
// returns synchronised.
__device__ __forceinline__ void fwd_stages(u64* s, const u64* __restrict__ w,
                                           const u64* __restrict__ wp, int len,
                                           u64 q, int parts, int part) {
  const u64 twice_q = 2 * q;
  const int half = len >> 1;
  const int tw = parts + part;
  int log_t = 31 - __clz(half);
  for (int ml = 1; ml < len; ml <<= 1, --log_t) {
    const int t = 1 << log_t;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i >> log_t;      // butterfly group inside the piece
      const int k = i & (t - 1);     // offset inside the group
      const int ix = 2 * i - k;      // = j * 2t + k
      const u64 W = w[tw * ml + j], Wp = wp[tw * ml + j];
      const u64 tx = cond_sub(s[ix], twice_q);
      const u64 T = mul_lazy(s[ix + t], W, Wp, q);
      s[ix] = tx + T;
      s[ix + t] = tx + twice_q - T;
    }
    __syncthreads();
  }
}

// Inverse (Gentleman-Sande, bit-reversed in -> natural out) stages on `len`
// values in shared memory; values stay in [0, 2q).  With parts = 1 these are
// the row's stages m = n/2 .. 2, and the last stage (m = 1) is left to the
// caller, which fuses n^-1 into it.  With parts > 1 they are the stages
// m = n/2 .. parts of piece `part` of a row of n = parts * len (all log2(len)
// stages inside the piece); the stages that cross pieces are the caller's.
// `w`/`wp` are the scan-order inverse root powers with the leading 1
// (NttTables.inv / inv_precon): stage m of the whole row starts at index
// n - 2m + 1, and group j of it is group j - part * m / parts of the piece.
__device__ __forceinline__ void inv_stages(u64* s, const u64* __restrict__ w,
                                           const u64* __restrict__ wp, int len,
                                           u64 q, int parts, int part) {
  const u64 twice_q = 2 * q;
  const int half = len >> 1;
  const int n = parts * len;
  const int last = parts > 1 ? 1 : 2;  // smallest stage done here, in ml
  int log_t = 0;
  for (int ml = half; ml >= last; ml >>= 1, ++log_t) {
    const int t = 1 << log_t;
    const int root = n - 2 * parts * ml + 1 + part * ml;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i >> log_t;
      const int k = i & (t - 1);
      const int ix = 2 * i - k;
      const u64 W = w[root + j], Wp = wp[root + j];
      const u64 X = s[ix], Y = s[ix + t];
      s[ix] = cond_sub(X + Y, twice_q);
      s[ix + t] = mul_lazy(X + twice_q - Y, W, Wp, q);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Split forward core of ntt_fwd and ntt_fwd_tail.
//
// Replaces the forward transform inside the fused MXU kernels of
// hexl_fpga_tpu/ops/ntt_mxu_pallas.py (_fwd_kernel, :213, and the
// raw_fwd_tail_call kernel, :422).  Bound on this card: bytes (chip_smoke.py
// `bound`: 16 bytes a coefficient, 32 in the tail, against log2(n)/2
// butterflies of about ten 32-bit multiply-adds).  What the design does:
//
//  * Fill.  A row is held by C = `parts` blocks (1, 2 or 4), each with n/C
//    contiguous values in shared memory, so rows * C blocks, several to an
//    SM, take about one wave of the 132 SMs (the wrapper chooses C from rows
//    and n).  The log2(C) stages that cross the pieces are done while
//    loading: each block reads the C values of its index from device memory,
//    runs the crossing stages in registers and keeps its own (C reads of the
//    input, the extra ones L2 hits; a thread-block cluster exchanging them
//    through distributed shared memory measured slower at every shape).
//  * Barriers.  Each thread keeps a closed sub-network of 2^r values in
//    registers and runs r <= SPLIT_R stages on it between shared-memory
//    exchanges, so the log2(n/C) stages of a piece take
//    ceil(log2(n/C) / SPLIT_R) passes and as many barriers, not one each.
//    A pass loads its 2^r - 1 twiddles once per sub-network.  Shared memory is padded by one u64 every 16 (`spad`) so
//    the strided accesses of the late passes spread over the banks.
//
// The butterfly is fwd_stages' own (cond_sub by 2q, mul_lazy, values in
// [0, 4q)): every butterfly sees the same inputs in any schedule, so the
// output is bit-identical to fwd_stages and to the plain versions.
// ---------------------------------------------------------------------------

// stages per register pass (2 and 4 measured slower at the paths' shapes)
constexpr int SPLIT_R = 3;

// shared-memory index of piece value i: one spare u64 every 16
__host__ __device__ __forceinline__ int spad(int i) { return i + (i >> 4); }

__device__ __forceinline__ void fwd_butterfly(u64& x, u64& y, u64 W, u64 Wp,
                                              u64 q) {
  const u64 twice_q = 2 * q;
  const u64 tx = cond_sub(x, twice_q);
  const u64 T = mul_lazy(y, W, Wp, q);
  x = tx + T;
  y = tx + twice_q - T;
}

// r stages on a closed sub-network v[0, 2^r): stage j pairs k and
// k + 2^(r-1-j), and sub-group c of it (k >> (r - j) == c) takes twiddle
// (tw0 << j) + c, tw0 being the sub-network's twiddle index at its first
// stage.
template <int r>
__device__ __forceinline__ void fwd_subnet(u64 (&v)[1 << r],
                                           const u64* __restrict__ w,
                                           const u64* __restrict__ wp,
                                           int tw0, u64 q) {
#pragma unroll
  for (int j = 0; j < r; ++j) {
    const int h = 1 << (r - 1 - j);
#pragma unroll
    for (int c = 0; c < (1 << j); ++c) {
      const int at = (tw0 << j) + c;
      const u64 W = __ldg(w + at), Wp = __ldg(wp + at);
#pragma unroll
      for (int k = 2 * h * c; k < 2 * h * c + h; ++k)
        fwd_butterfly(v[k], v[k + h], W, Wp, q);
    }
  }
}

// One pass over a piece of 2^log_len values in shared memory: the r stages
// that start at the piece's stage e0 (ml = 2^e0 groups).  Sub-network u has
// first-stage group g = u >> log_s and offset o = u & (s - 1), s = 2^log_s
// being the stride of its last stage; its values sit at (g * 2^r + k) * s + o.
// `tw` = parts + part: the piece's group g of stage e0 takes twiddle
// tw * 2^e0 + g (fwd_stages' index).  Each thread rewrites only the values it
// read; the caller synchronises after the pass.
template <int r>
__device__ __forceinline__ void fwd_pass(u64* s, const u64* __restrict__ w,
                                         const u64* __restrict__ wp,
                                         int log_len, int e0, int tw, u64 q) {
  const int log_s = log_len - e0 - r;
  const int subnets = 1 << (log_len - r);
  for (int u = threadIdx.x; u < subnets; u += blockDim.x) {
    const int g = u >> log_s;
    const int base = (g << (r + log_s)) + (u & ((1 << log_s) - 1));
    u64 v[1 << r];
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) v[k] = s[spad(base + (k << log_s))];
    fwd_subnet<r>(v, w, wp, (tw << e0) + g, q);
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) s[spad(base + (k << log_s))] = v[k];
  }
}

// fwd_pass for a runtime r in [1, R] (a piece's last passes may be shorter)
template <int R>
__device__ __forceinline__ void fwd_pass_r(int r, u64* s, const u64* w,
                                           const u64* wp, int log_len, int e0,
                                           int tw, u64 q) {
  if (r == R) {
    fwd_pass<R>(s, w, wp, log_len, e0, tw, q);
  } else if constexpr (R > 1) {
    fwd_pass_r<R - 1>(r, s, w, wp, log_len, e0, tw, q);
  }
}

// The log2(C) stages that cross the pieces, on the values v[c] at one index
// of every piece c: stage m (m groups, pieces c and c + C / 2m paired, group
// c / (C / m)) takes twiddle m + group.  Returns piece `part`'s value.
template <int C>
__device__ __forceinline__ u64 fwd_cross(u64 (&v)[C], const u64* __restrict__ w,
                                         const u64* __restrict__ wp, u64 q,
                                         int part) {
#pragma unroll
  for (int m = 1; m < C; m <<= 1) {
    const int h = C / (2 * m);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c & h) continue;
      const int at = m + c / (2 * h);
      fwd_butterfly(v[c], v[c + h], __ldg(w + at), __ldg(wp + at), q);
    }
  }
  u64 mine = v[0];
#pragma unroll
  for (int c = 1; c < C; ++c)
    if (c == part) mine = v[c];
  return mine;
}

// The first pass read from device memory: each value is (row[c * len + i] +
// fix) mod q for every piece c, crossed in registers (fwd_cross); then the
// pass's r stages; stored to shared memory.  e0 = 0, so g = 0 and u = o.
template <int C, int r>
__device__ __forceinline__ void fwd_pass_load(u64* s, const u64* __restrict__ row,
                                              const u64* __restrict__ w,
                                              const u64* __restrict__ wp,
                                              int log_len, int part, u64 q,
                                              u64 q_barr, u64 fix) {
  const int log_s = log_len - r;
  const int len = 1 << log_len;
  for (int o = threadIdx.x; o < (1 << log_s); o += blockDim.x) {
    u64 v[1 << r];
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) {
      const int i = o + (k << log_s);
      u64 x[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        x[c] = barrett_canonical(row[(size_t)c * len + i] + fix, q, q_barr);
      v[k] = fwd_cross<C>(x, w, wp, q, part);
    }
    fwd_subnet<r>(v, w, wp, C + part, q);
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) s[spad(o + (k << log_s))] = v[k];
  }
}

// fwd_pass_load for a runtime r in [1, R]
template <int C, int R>
__device__ __forceinline__ void fwd_pass_load_r(int r, u64* s, const u64* row,
                                                const u64* w, const u64* wp,
                                                int log_len, int part, u64 q,
                                                u64 q_barr, u64 fix) {
  if (r == R) {
    fwd_pass_load<C, R>(s, row, w, wp, log_len, part, q, q_barr, fix);
  } else if constexpr (R > 1) {
    fwd_pass_load_r<C, R - 1>(r, s, row, w, wp, log_len, part, q, q_barr, fix);
  }
}

// Forward transform of piece `part` of a row of C * 2^log_len values into
// shared memory `s` (spad layout): row[x] + fix reduced on load, every stage,
// values in [0, 4q) when it returns (synchronised).  log_len >= 1.
template <int C>
__device__ __forceinline__ void fwd_split(u64* s, const u64* __restrict__ row,
                                          const u64* __restrict__ w,
                                          const u64* __restrict__ wp,
                                          int log_len, int part, u64 q,
                                          u64 q_barr, u64 fix) {
  const int passes = (log_len + SPLIT_R - 1) / SPLIT_R;
  const int base_r = log_len / passes, longer = log_len % passes;
  int r = base_r + (longer > 0);
  fwd_pass_load_r<C, SPLIT_R>(r, s, row, w, wp, log_len, part, q, q_barr, fix);
  __syncthreads();
  int e0 = r;
  for (int p = 1; p < passes; ++p) {
    r = base_r + (p < longer);
    fwd_pass_r<SPLIT_R>(r, s, w, wp, log_len, e0, C + part, q);
    __syncthreads();
    e0 += r;
  }
}
