"""Exact unsigned 64-bit integer arithmetic on torch.int64 bit patterns.

A "u64" here is ONE torch.int64 element holding the value's bit pattern
(two's complement wraparound of int64 add/sub/mul is exactly arithmetic mod
2^64).  torch has no usable unsigned 64-bit arithmetic, and `int64 >> k` is an
arithmetic shift, so the unsigned pieces are spelled out: compares flip the
sign bit of both sides, right shifts mask the smeared sign bits, and the high
half of a 64x64 product is assembled from four 32x32 partial products.

The function set mirrors `hexl_fpga_tpu/ops/word64.py` (which carries each
value as a (lo, hi) pair of uint32 planes); every function returns the same
64-bit value that one does.  Static Python-int scalars may be passed wherever
a u64 is expected.  Everything runs on any torch device: these functions are
the plain versions' arithmetic on the CPU and the kernels' oracle on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)  # int64 bit pattern 0x8000...0
_U32 = np.uint64(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# host-side converters (numpy)
# ---------------------------------------------------------------------------


def to_i64_np(a) -> np.ndarray:
    """u64 numpy array -> the same bytes viewed as int64 (zero-copy)."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64)).view(np.int64)


def from_u64_np(a, device="cpu") -> torch.Tensor:
    """u64 numpy array, or a CPU int64 tensor of u64 bit patterns -> int64
    tensor of the same bit patterns on `device` (the CPU tensor shares the
    input's memory).  A tensor in pinned memory goes to the card on the
    current stream without blocking the host: leave it unchanged until an
    event recorded behind the copy has completed."""
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=a.is_pinned())
    return torch.from_numpy(to_i64_np(a)).to(device)


def to_u64_np(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> u64 numpy array of the same bit patterns (this is the
    blocking device->host copy for a CUDA tensor)."""
    return x.cpu().contiguous().numpy().view(np.uint64)


def to_host_async(x: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor -> a CPU tensor of the same values, copied on the
    current stream into pinned memory without blocking the host: read it only
    after an event recorded behind the copy has completed.  A CPU tensor is
    returned as it is."""
    if x.device.type != "cuda":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x, non_blocking=True)


def to_pair_np(a) -> Tuple[np.ndarray, np.ndarray]:
    a = np.asarray(a, dtype=np.uint64)
    return (a & _U32).astype(np.uint32), (a >> np.uint64(32)).astype(np.uint32)


def from_pair_np(lo, hi) -> np.ndarray:
    return np.asarray(lo, dtype=np.uint64) | (
        np.asarray(hi, dtype=np.uint64) << np.uint64(32)
    )


def precon64_np(k: np.ndarray, q: int) -> np.ndarray:
    """floor(k << 64 / q) elementwise, exact, vectorized — the Harvey
    precon table for a key/twiddle plane (k < q < 2^55).

    Base-2^8 long division keeps every intermediate < 2^63 in u64 lanes
    (rem*256 + digit < 2^63 for q < 2^55)."""
    k = np.asarray(k, dtype=np.uint64)
    q = int(q)
    assert 2 <= q < (1 << 55), "precon64_np supports q < 2^55"
    assert k.size == 0 or int(k.max()) < q, "precon64_np requires k < q"
    qv = np.uint64(q)
    out = np.zeros_like(k)
    rem = np.zeros_like(k)
    # N = k * 2^64: 16 base-2^8 digits = k's 8 bytes then 8 zero bytes
    for step in range(16):
        digit = (
            (k >> np.uint64(8 * (7 - step))) & np.uint64(0xFF)
            if step < 8 else np.uint64(0)
        )
        rem = (rem << np.uint64(8)) | digit
        d = rem // qv  # rem*256 + digit < q*256 => d < 256, rem' < q
        rem -= d * qv
        out = (out << np.uint64(8)) | d  # quotient < 2^64 since k < q
    return out


# ---------------------------------------------------------------------------
# scalars and 64-bit primitives
# ---------------------------------------------------------------------------


def const64(v: int) -> int:
    """A Python int as the signed value of its 64-bit pattern, so it can meet
    an int64 tensor in a torch op."""
    v = int(v) & _M64
    return v - (1 << 64) if v >> 63 else v


def _c(x):
    return const64(x) if isinstance(x, (int, np.integer)) else x


def lshr64(x, k: int):
    """Logical right shift by a static k in [0, 64)."""
    if isinstance(x, (int, np.integer)):
        return const64((int(x) & _M64) >> k)
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def add64(a, b):
    return _c(a) + _c(b)


def sub64(a, b):
    return _c(a) - _c(b)


def lt64(a, b):
    """Unsigned a < b: flipping the sign bit maps unsigned order onto
    signed order."""
    return (_c(a) ^ _SIGN) < (_c(b) ^ _SIGN)


def ge64(a, b):
    return (_c(a) ^ _SIGN) >= (_c(b) ^ _SIGN)


def select64(pred, a, b):
    return torch.where(pred, _c(a), _c(b))


def cond_sub64(a, q):
    """a - q if a >= q else a (unsigned)."""
    a = _c(a)
    return torch.where(ge64(a, q), sub64(a, q), a)


def mullo64(a, b):
    """Low 64 bits of the product."""
    return _c(a) * _c(b)


def _halves(x):
    """(low 32 bits, high 32 bits), each a nonnegative value < 2^32."""
    if isinstance(x, (int, np.integer)):
        x = int(x) & _M64
        return x & _M32, x >> 32
    return x & _M32, lshr64(x, 32)


def mulhi64(a, b):
    """High 64 bits of the 128-bit product, from four 32x32 partials (each
    < 2^64, so its int64 bit pattern is exact)."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    p00 = _c(a0 * b0)
    p01 = _c(a0 * b1)
    p10 = _c(a1 * b0)
    p11 = _c(a1 * b1)
    mid = lshr64(p00, 32) + (p01 & _M32) + (p10 & _M32)  # < 3 * 2^32
    return p11 + lshr64(p01, 32) + lshr64(p10, 32) + lshr64(mid, 32)


def mul64_full(a, b):
    """The 128-bit product as (low 64 bits, high 64 bits)."""
    return mullo64(a, b), mulhi64(a, b)


def add128(a, b):
    """128-bit add of two (low 64 bits, high 64 bits) values, as mul64_full
    returns them: wrapping add of the halves, the carry out of the low half
    from an unsigned compare.  A carry out of the top is lost — callers bound
    the true sum below 2^128 (`hexl_fpga_tpu/ops/word64.py` add128 on four
    32-bit limbs)."""
    lo = add64(a[0], b[0])
    carry = lt64(lo, a[0]).to(torch.int64)
    return lo, add64(add64(a[1], b[1]), carry)


def shift128_right(lo, hi, s):
    """Low 64 bits of the 128-bit value (hi, lo) >> s, for tensors lo, hi and
    s in [0, 63]: an int, or an int64 tensor that broadcasts against lo (one
    shift per modulus).  Written so that s = 0 shifts nothing by 64: the
    smeared sign bits of `lo >> s` are masked with ~((-1 << (63 - s)) << 1),
    and the high word enters as (hi << 1) << (63 - s)."""
    if isinstance(s, (int, np.integer)):
        s = int(s)
        if not 0 <= s <= 63:
            raise ValueError(f"shift128_right: s must be in [0, 63], got {s}")
        up = 63 - s
        keep = const64(~((-1 << up) << 1))
    else:
        up = 63 - s
        keep = ~(torch.bitwise_left_shift(torch.full_like(up, -1), up) << 1)
    return ((lo >> s) & keep) | ((hi << 1) << up)


def mulhi64_approx(a, b):
    """High 64 bits of a*b UNDERestimating by at most 2: the a_lo*b_lo
    partial product and the whole low-half carry chain are dropped — exactly
    the terms `hexl_fpga_tpu/ops/word64.py:249-264` drops, so lazy sums built
    on it carry the same bits."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    return _c(a1 * b1) + lshr64(_c(a0 * b1), 32) + lshr64(_c(a1 * b0), 32)


# ---------------------------------------------------------------------------
# modular primitives
# ---------------------------------------------------------------------------


def add_mod(a, b, q):
    """(a + b) mod q for a, b < q < 2^63."""
    return cond_sub64(add64(a, b), q)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b < q."""
    return cond_sub64(add64(sub64(a, b), q), q)


def mul_mod_lazy(x, w, w_precon, q):
    """(x * w) mod q in [0, 2q): the Harvey lazy multiply, for w < q,
    w_precon = floor(w << 64 / q) and any u64 x."""
    Q = mulhi64(x, w_precon)
    return sub64(mullo64(w, x), mullo64(Q, q))


def barrett_reduce64(x, q, q_barr):
    """x mod q, fully reduced, for any x < 2^63 (q_barr = floor(2^64/q));
    one correction, as the reference's BarrettReduce64."""
    Q = mulhi64(x, q_barr)
    return cond_sub64(sub64(x, mullo64(Q, q)), q)


def barrett_canonical(x, q, q_barr):
    """ANY u64 representative -> [0, q): the quotient estimate is short by at
    most 2, so two corrections (`ntt_mxu_pallas._barrett_canonical`)."""
    Q = mulhi64(x, q_barr)
    r = sub64(x, mullo64(Q, q))
    return cond_sub64(cond_sub64(r, q), q)


def reduce_mod_factor(x, q, factor: int):
    """Reduce x in [0, factor*q) to [0, q) by conditional subtracts
    (reference ReduceMod). factor in {1, 2, 4, 8}."""
    assert factor in (1, 2, 4, 8)
    f = factor
    while f > 1:
        f >>= 1
        x = cond_sub64(x, q * f)
    return x


def mul_mod_traced(x, y, q, barr, length):
    """(x * y) mod q with per-element (runtime) moduli: the reference MultMod
    (`device/mod_ops.hpp:31-84`), as `hexl_fpga_tpu/ops/word64.py`
    mul_mod_traced computes it.

      length = floor(log2 q) - 1,  barr = floor(2^(length+64) / q) (64 bits),
      x, y shrunk from [0, 4q) by two conditional subtracts (larger raw values
      lose 3q at most and stay exact while the product is below 2^(length+64)),
      c1 = (x*y) >> length (low 64 bits), c3 = mulhi64(c1, barr),
      c4 = lo64(x*y) - c3*q, one conditional subtract.

    q, barr: ints or int64 tensors broadcastable against x; length: an int or
    an integer tensor in [0, 62]."""
    twice_q = _c(q) << 1
    x = cond_sub64(cond_sub64(x, twice_q), q)
    y = cond_sub64(cond_sub64(y, twice_q), q)
    lo, hi = mul64_full(x, y)
    c1 = shift128_right(lo, hi, length)
    c3 = mulhi64(c1, barr)
    return cond_sub64(sub64(lo, mullo64(c3, q)), q)


def mul_mod_static(x, y, q: int):
    """(x * y) mod q exactly, for x, y < q < 2^62 with a static modulus:
    Barrett with r = floor(2^(2k)/q), k = ceil(log2 q) — the same recipe,
    truncation and two corrections as the reference's MultiplyUIntMod."""
    from . import nt

    q = int(q)
    k = nt.precompute_modulus_k(q)
    r = (1 << (2 * k)) // q
    lo, hi = mullo64(x, y), mulhi64(x, y)
    if 2 * k >= 64:
        s = 2 * k - 64
        t = lo if s == 0 else (lshr64(lo, s) | (_c(hi) << (64 - s)))
        qhat = mulhi64(t, r)
    else:
        # product < 2^(2k) < 2^64: (product * r) >> 2k, low 64 bits
        s = 2 * k
        qhat = lshr64(mullo64(lo, r), s) | (mulhi64(lo, r) << (64 - s))
    c = sub64(lo, mullo64(qhat, q))
    return cond_sub64(cond_sub64(c, q), q)
