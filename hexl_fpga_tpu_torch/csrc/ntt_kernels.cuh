// Shared device code of the negacyclic NTT kernels: 64-bit modular
// primitives, the split forward core of ntt_fwd / ntt_fwd_tail / ntt_fwd_mac
// and the split inverse core of ntt_inv.
//
// A row of n values is held by `parts` thread blocks, each with one piece of
// n/parts values resident in dynamic shared memory for all the stages inside
// it; the stages that cross the pieces are done while loading from device
// memory.  A row of n <= 16384 may take one block (128 KB); a row of 32768
// values (256 KB, more than a block's 227 KB) takes 2 or 4.  q, floor(2^64/q)
// and the tables are runtime arguments, so one build serves every modulus
// q < 2^62 (4q must fit 64 bits).
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
// The butterfly (cond_sub by 2q, mul_lazy, values in [0, 4q)) sees the same
// inputs in any schedule, so every C gives the bits of the plain versions.
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
// tw * 2^e0 + g (stage m of the row takes twiddle m + its group).  Each thread rewrites only the values it
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


// ---------------------------------------------------------------------------
// Split inverse core of ntt_inv.
//
// Replaces the inverse transform of hexl_fpga_tpu/ops/ntt_mxu_pallas.py
// (_inv_kernel, :230, through raw_inv_call, :411).  Bound on this card: bytes
// (16 bytes a coefficient against log2(n)/2 butterflies; chip_smoke.py
// `bound`).  The mirror of fwd_split:
//
//  * Pieces.  A row is held by C = `parts` blocks (1, 2 or 4); piece c holds
//    the row's values at c, c + C, c + 2C, ... (strided, not contiguous).  In
//    the Gentleman-Sande network (bit-reversed in, natural out) the stages of
//    distance t < C are the first log2(C), and each closes on an aligned
//    group of C neighbours; every later stage pairs values of one residue
//    class mod C, so of one piece.  Each block reads the C contiguous values
//    at its index from device memory, reduces them, runs the crossing stages
//    in registers (inv_cross: only the butterfly sides that lead to its own
//    piece) and keeps its own value; the extra reads are L2 hits.
//  * Twiddles.  A piece's stage of distance t has the row's m = n / 2t
//    groups, and its group j is the row's group j, so it takes the row's
//    twiddles n - 2m + 1 + j (the scan-order inverse table: stage m starts
//    at n - 2m + 1).
//  * Barriers.  As in fwd_split: closed sub-networks of 2^r values in
//    registers, r <= SPLIT_R stages per shared-memory exchange, 2^r - 1
//    twiddles loaded once per sub-network, `spad` padding.  The load (the
//    crossing) goes to shared memory on its own: the first pass's
//    sub-networks are runs of 2^r neighbours, and reading them (C times
//    over) straight from device memory left neighbouring threads 8C values
//    apart, which measured slower.  The last pass writes device memory:
//    ceil(log2(n/C) / SPLIT_R) passes, as many barriers.
//  * The last stage (m = 1) lies inside a piece and stays fused with n^-1 and
//    n^-1 * W_last; the last pass stores canonical values straight to device
//    memory, strided by C (index C * k + c).
//
// The butterfly (cond_sub by 2q, mul_lazy, values in [0, 2q)) is the same in
// every schedule, so every C gives the bits of the plain versions.
// ---------------------------------------------------------------------------

struct InvScale {
  u64 inv_n, inv_n_p, inv_n_w, inv_n_w_p;  // n^-1, n^-1 * W_last, precons
};

__device__ __forceinline__ void inv_butterfly(u64& x, u64& y, u64 W, u64 Wp,
                                              u64 q) {
  const u64 twice_q = 2 * q;
  const u64 X = x, Y = y;
  x = cond_sub(X + Y, twice_q);
  y = mul_lazy(X + twice_q - Y, W, Wp, q);
}

// the row's last stage (m = 1, pairs i and i + n/2) with the n^-1 scaling:
// the sum times n^-1, the difference times n^-1 * W_last, both canonical
__device__ __forceinline__ void inv_last_butterfly(u64& x, u64& y,
                                                   const InvScale& sc, u64 q) {
  const u64 twice_q = 2 * q;
  const u64 X = x, Y = y;
  x = cond_sub(mul_lazy(cond_sub(X + Y, twice_q), sc.inv_n, sc.inv_n_p, q), q);
  y = cond_sub(mul_lazy(X + twice_q - Y, sc.inv_n_w, sc.inv_n_w_p, q), q);
}

// r stages on a closed sub-network v[0, 2^r): stage jj pairs k and k + 2^jj;
// it is a stage of the row with m0 >> jj groups, and sub-group c of it
// (k >> (jj + 1) == c) is the row's group (g << (r - 1 - jj)) + c.  LAST: the
// pass ends at the row's last stage, which is scaled (inv_last_butterfly).
template <int r, bool LAST>
__device__ __forceinline__ void inv_subnet(u64 (&v)[1 << r],
                                           const u64* __restrict__ w,
                                           const u64* __restrict__ wp, int n,
                                           int m0, int g, u64 q,
                                           const InvScale& sc) {
#pragma unroll
  for (int jj = 0; jj < r; ++jj) {
    const int h = 1 << jj;
    if (LAST && jj == r - 1) {
#pragma unroll
      for (int k = 0; k < h; ++k) inv_last_butterfly(v[k], v[k + h], sc, q);
      continue;
    }
    const int root = n - 2 * (m0 >> jj) + 1 + (g << (r - 1 - jj));
#pragma unroll
    for (int c = 0; c < (1 << (r - 1 - jj)); ++c) {
      const u64 W = __ldg(w + root + c), Wp = __ldg(wp + root + c);
#pragma unroll
      for (int k = 2 * h * c; k < 2 * h * c + h; ++k)
        inv_butterfly(v[k], v[k + h], W, Wp, q);
    }
  }
}

// The log2(C) stages that cross the pieces, on the values x[c] at row index
// C * i + c: stage t (the row's stage of n / 2t groups) pairs c and c + t in
// group (C * i + c) / 2t.  Only the pairs and sides that lead to piece `part`
// are computed: part's bit t picks the sum or the twiddled difference (a
// branch that is uniform over the block).  Returns piece part's value.
template <int C>
__device__ __forceinline__ u64 inv_cross(u64 (&x)[C], const u64* __restrict__ w,
                                         const u64* __restrict__ wp, int n,
                                         int i, u64 q, int part) {
  const u64 twice_q = 2 * q;
#pragma unroll
  for (int t = 1; t < C; t <<= 1) {
    const int root = n - n / t + 1;  // n - 2m + 1, m = n / 2t
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if ((c & t) || (c & (t - 1)) != (part & (t - 1))) continue;
      if (part & t) {
        const int at = root + (C * i + c) / (2 * t);
        x[c + t] = mul_lazy(x[c] + twice_q - x[c + t], __ldg(w + at),
                            __ldg(wp + at), q);
      } else {
        x[c] = cond_sub(x[c] + x[c + t], twice_q);
      }
    }
  }
  u64 mine = x[0];
#pragma unroll
  for (int c = 1; c < C; ++c)
    if (c == part) mine = x[c];
  return mine;
}

// Where a pass leaves piece value k: shared memory, or (LAST) its canonical
// place C * k in the row's output, `out` pointing at the piece's first value.
template <int C, bool LAST>
__device__ __forceinline__ void inv_put(u64* s, u64* __restrict__ out, int k,
                                        u64 v) {
  if (LAST)
    out[(size_t)C * k] = v;
  else
    s[spad(k)] = v;
}

// The load: piece value i from the C contiguous values row[C * i ..], each
// reduced, crossed (inv_cross), into shared memory.  Neighbouring threads
// read neighbouring values, INV_LOADS piece values of each thread in flight
// at once: a row is read at one block an SM, so what bounds the load is
// device memory's latency, not its rate.  8 at C = 1 and 4 above measured
// fastest of 4, 8 and 16 (utils/ablate_kernels.py, PERF.md §6).
template <int C>
__device__ __forceinline__ void inv_load(u64* s, const u64* __restrict__ row,
                                         const u64* __restrict__ w,
                                         const u64* __restrict__ wp, int n,
                                         int len, int part, u64 q, u64 q_barr) {
  constexpr int INV_LOADS = C == 1 ? 8 : 4;
  for (int i0 = threadIdx.x; i0 < len; i0 += INV_LOADS * blockDim.x) {
    u64 x[INV_LOADS][C];
#pragma unroll
    for (int u = 0; u < INV_LOADS; ++u) {
      const int i = i0 + u * blockDim.x;
#pragma unroll
      for (int c = 0; c < C; ++c)
        x[u][c] = i < len ? __ldg(row + (size_t)C * i + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < INV_LOADS; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= len) break;
#pragma unroll
      for (int c = 0; c < C; ++c) x[u][c] = barrett_canonical(x[u][c], q, q_barr);
      s[spad(i)] = inv_cross<C>(x[u], w, wp, n, i, q, part);
    }
  }
}

// A later pass, from shared memory: the r stages from the piece's stage e0
// (distance 2^e0).  Sub-network u has offset o = u & (2^e0 - 1) and group
// g = u >> e0; its values sit at (g << (e0 + r)) + (k << e0) + o.
template <int C, int r, bool LAST>
__device__ __forceinline__ void inv_pass(u64* s, u64* __restrict__ out,
                                         const u64* __restrict__ w,
                                         const u64* __restrict__ wp, int n,
                                         int log_len, int e0, u64 q,
                                         const InvScale& sc) {
  for (int u = threadIdx.x; u < (1 << (log_len - r)); u += blockDim.x) {
    const int g = u >> e0;
    const int base = (g << (e0 + r)) + (u & ((1 << e0) - 1));
    u64 v[1 << r];
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) v[k] = s[spad(base + (k << e0))];
    inv_subnet<r, LAST>(v, w, wp, n, 1 << (log_len - e0 - 1), g, q, sc);
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) inv_put<C, LAST>(s, out, base + (k << e0), v[k]);
  }
}

// inv_pass for a runtime r in [1, R]
template <int C, int R, bool LAST>
__device__ __forceinline__ void inv_pass_r(int r, u64* s, u64* out,
                                           const u64* w, const u64* wp, int n,
                                           int log_len, int e0, u64 q,
                                           const InvScale& sc) {
  if (r == R) {
    inv_pass<C, R, LAST>(s, out, w, wp, n, log_len, e0, q, sc);
  } else if constexpr (R > 1) {
    inv_pass_r<C, R - 1, LAST>(r, s, out, w, wp, n, log_len, e0, q, sc);
  }
}

// Inverse transform of piece `part` (values part, part + C, ...) of a row of
// n = C * 2^log_len values: row[x] any u64, reduced on load; every stage, the
// last scaled by n^-1; canonical values stored to out[C * k] (`out` at the
// piece's first value).  `w`/`wp` are the inverse tables (NttTables.inv /
// inv_precon).  log_len >= 1; `s` holds 2^log_len values in spad layout.
template <int C>
__device__ __forceinline__ void inv_split(u64* s, const u64* __restrict__ row,
                                          u64* __restrict__ out,
                                          const u64* __restrict__ w,
                                          const u64* __restrict__ wp, int n,
                                          int log_len, int part, u64 q,
                                          u64 q_barr, const InvScale& sc) {
  inv_load<C>(s, row, w, wp, n, 1 << log_len, part, q, q_barr);
  __syncthreads();
  const int passes = (log_len + SPLIT_R - 1) / SPLIT_R;
  const int base_r = log_len / passes, longer = log_len % passes;
  int e0 = 0;
  for (int p = 0; p < passes - 1; ++p) {
    const int r = base_r + (p < longer);
    inv_pass_r<C, SPLIT_R, false>(r, s, out, w, wp, n, log_len, e0, q, sc);
    __syncthreads();
    e0 += r;
  }
  // longer < passes, so the last pass is base_r stages long
  inv_pass_r<C, SPLIT_R, true>(base_r, s, out, w, wp, n, log_len, e0, q, sc);
}
