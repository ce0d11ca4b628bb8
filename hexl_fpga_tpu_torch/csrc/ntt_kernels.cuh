// Shared device code of the negacyclic NTT kernels: 64-bit modular
// primitives and the in-shared-memory Harvey butterfly stages.
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
