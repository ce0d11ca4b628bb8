"""52-bit wire packing for host<->device ciphertext transport.

The counterpart of `hexl_fpga_tpu/ops/wirepack.py`.  Every value the library
moves across the host link is a residue below a <= 52-bit modulus
(`hexl-fpga.h`: moduli in [2^16, 2^52]), so the transport can carry 52 bits
a coefficient instead of 64: 13/16 of the bytes.

Layout (the reference's, byte for byte): groups of 8 coefficients, 8 x 52 =
416 bits = 13 u32 words, value j of a group at bits [52j, 52j + 52) of the
group's little-endian bit stream.  Out-of-domain bits are MASKED OFF, so a
value >= 2^52 corrupts only its own field, never a neighbour's.

  pack_u64_np / unpack_u64_np
                         the host codec on u64 arrays (..., n) <-> (..., 13n/8)
                         u32, in NumPy: two groups at a time as 13 u64 words,
                         one pass per word over contiguous planes
  pack_u64_native / unpack_u64_native
                         the same on the host in C++ (`cpp/src/capi.cpp`
                         hexl_tpu_pack52 / hexl_tpu_unpack52, OpenMP over
                         groups), from this package's build of `cpp/`
                         (`_native.build_library`, at first use): the host
                         codec of the packed route to every device, the NumPy
                         one its plain version; a failed build raises
  pack_np / unpack_np    the reference's interface to it, on the interleaved
                         u32 layout (..., 2n)
  pack / unpack          the device codec on int64 bit patterns (..., n) <->
                         int32 packed words (..., 13n/8): torch ops on int64
                         only (torch has no uint32 shifts on the CPU)
"""

from __future__ import annotations

import numpy as np
import torch

from . import _native

BITS = 52
GROUP = 8                      # coefficients per pack group
WORDS_IN = 2 * GROUP           # interleaved u32 words in (lo, hi pairs)
WORDS_OUT = BITS * GROUP // 32  # 13 packed u32 words
_MASK52 = (1 << BITS) - 1
_M32 = 0xFFFFFFFF


def _stream_terms(src_bits: int, dst_bits: int, count: int):
    """Per destination field d of a group: the (source field, left shift)
    pairs whose bits overlap it, for `count` source fields of src_bits laid
    end to end (a negative shift is a right shift).  Both codecs, both ways,
    are generated from the bit layout by this one function."""
    total = src_bits * count
    terms = []
    for d in range(total // dst_bits):
        lo, hi = dst_bits * d, dst_bits * (d + 1)
        terms.append([(s, src_bits * s - lo) for s in range(count)
                      if src_bits * s < hi and src_bits * (s + 1) > lo])
    return terms


# host: 16 values <-> 13 u64 words (two groups; the u64 words' little-endian
# u32 halves are the groups' 26 u32 words, in order)
_PACK_NP = _stream_terms(BITS, 64, 2 * GROUP)
_UNPACK_NP = _stream_terms(64, BITS, WORDS_OUT)


def _shift_or_np(planes, terms, mask):
    """Destination planes from source planes (field index first, contiguous):
    each the OR of its shifted sources, masked."""
    out = np.empty((len(terms),) + planes.shape[1:], dtype=np.uint64)
    for d, tlist in enumerate(terms):
        acc = None
        for s, sh in tlist:
            v = planes[s] << np.uint64(sh) if sh >= 0 else planes[s] >> np.uint64(-sh)
            acc = v if acc is None else acc | v
        out[d] = acc if mask is None else acc & np.uint64(mask)
    return out


def pack_u64_np(x: np.ndarray) -> np.ndarray:
    """(..., n) u64 -> (..., 13n/8) packed u32 (n a multiple of 8); bits at 52
    and above are masked off."""
    x = np.asarray(x, dtype=np.uint64)
    n = x.shape[-1]
    assert n % GROUP == 0, "last dim must be a multiple of 8 values"
    flat = x.reshape(-1)
    odd = (flat.size // GROUP) % 2  # a last group of 8 pairs with zeros
    if odd:
        flat = np.concatenate([flat, np.zeros(GROUP, dtype=np.uint64)])
    planes = np.ascontiguousarray((flat & np.uint64(_MASK52)).reshape(-1, 2 * GROUP).T)
    words = np.ascontiguousarray(_shift_or_np(planes, _PACK_NP, None).T).view(np.uint32)
    words = words.reshape(-1)[: words.size - odd * WORDS_OUT]
    return words.reshape(x.shape[:-1] + (n // GROUP * WORDS_OUT,))


def unpack_u64_np(p32: np.ndarray) -> np.ndarray:
    """(..., 13n/8) packed u32 -> (..., n) u64."""
    p32 = np.asarray(p32, dtype=np.uint32)
    m = p32.shape[-1]
    assert m % WORDS_OUT == 0, "last dim must be 13*k u32 words"
    flat = p32.reshape(-1)
    odd = (flat.size // WORDS_OUT) % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(WORDS_OUT, dtype=np.uint32)])
    planes = np.ascontiguousarray(flat.view(np.uint64).reshape(-1, WORDS_OUT).T)
    vals = np.ascontiguousarray(_shift_or_np(planes, _UNPACK_NP, _MASK52).T).reshape(-1)
    vals = vals[: vals.size - odd * GROUP]
    return vals.reshape(p32.shape[:-1] + (m // WORDS_OUT * GROUP,))


def pack_u64_native(x: np.ndarray) -> np.ndarray:
    """pack_u64_np's bits, by the C++ library's codec."""
    x = np.ascontiguousarray(x, dtype=np.uint64)
    n = x.shape[-1]
    if n % GROUP:
        raise ValueError(f"the last dimension ({n}) must be a multiple of {GROUP}")
    out = np.empty(x.shape[:-1] + (n // GROUP * WORDS_OUT,), dtype=np.uint32)
    _native.codec_library().hexl_tpu_pack52(x.ctypes.data, out.ctypes.data, x.size)
    return out


def unpack_u64_native(p32: np.ndarray) -> np.ndarray:
    """unpack_u64_np's bits, by the C++ library's codec."""
    p32 = np.ascontiguousarray(p32, dtype=np.uint32)
    m = p32.shape[-1]
    if m % WORDS_OUT:
        raise ValueError(f"the last dimension ({m}) must be a multiple of {WORDS_OUT}")
    out = np.empty(p32.shape[:-1] + (m // WORDS_OUT * GROUP,), dtype=np.uint64)
    _native.codec_library().hexl_tpu_unpack52(p32.ctypes.data, out.ctypes.data, out.size)
    return out


def pack_np(x32: np.ndarray) -> np.ndarray:
    """The reference's interface: (..., 2n) interleaved u32 (the u64 values'
    little-endian halves) -> (..., 13n/8) packed u32."""
    x32 = np.ascontiguousarray(x32, dtype=np.uint32)
    assert x32.shape[-1] % WORDS_IN == 0, "last dim must be 16*k u32 words"
    return pack_u64_np(x32.view(np.uint64))


def unpack_np(p32: np.ndarray) -> np.ndarray:
    """(..., 13n/8) packed u32 -> (..., 2n) interleaved u32."""
    return unpack_u64_np(p32).view(np.uint32)


# -- device codec on int64 bit patterns ---------------------------------------


_PACK64 = _stream_terms(BITS, 32, GROUP)         # 13 words from 8 values
_UNPACK64 = _stream_terms(32, BITS, WORDS_OUT)   # 8 values from 13 words


def _gather(fields, terms, mask):
    """OR the shifted source fields of each destination field, masked.  Every
    source field is non-negative and below 2^52, so a right shift is logical
    and a left shift's wrap beyond bit 63 lies outside the mask."""
    outs = []
    for tlist in terms:
        acc = None
        for s, sh in tlist:
            v = fields[..., s]
            v = v << sh if sh >= 0 else v >> -sh
            acc = v if acc is None else acc | v
        outs.append(acc & mask)
    return torch.stack(outs, dim=-1)


def pack(x: torch.Tensor) -> torch.Tensor:
    """(..., n) int64 bit patterns -> (..., 13n/8) int32 words whose bytes are
    pack_u64_np's, on x's device.  Bits at 52 and above are masked off."""
    if x.dtype != torch.int64:
        raise TypeError(f"pack: expected int64 bit patterns, got {x.dtype}")
    n = x.shape[-1]
    if n % GROUP:
        raise ValueError(f"pack: the last dimension ({n}) must be a multiple of {GROUP}")
    g = (x & _MASK52).reshape(x.shape[:-1] + (n // GROUP, GROUP))
    words = _gather(g, _PACK64, _M32)
    # u32 value -> the int32 of the same bits
    words = words - ((words & (1 << 31)) << 1)
    return words.to(torch.int32).reshape(x.shape[:-1] + (n // GROUP * WORDS_OUT,))


def unpack(p: torch.Tensor) -> torch.Tensor:
    """(..., 13n/8) int32 packed words -> (..., n) int64 values < 2^52."""
    if p.dtype != torch.int32:
        raise TypeError(f"unpack: expected int32 packed words, got {p.dtype}")
    m = p.shape[-1]
    if m % WORDS_OUT:
        raise ValueError(f"unpack: the last dimension ({m}) must be a multiple of {WORDS_OUT}")
    g = (p.to(torch.int64) & _M32).reshape(p.shape[:-1] + (m // WORDS_OUT, WORDS_OUT))
    vals = _gather(g, _UNPACK64, _MASK52)
    return vals.reshape(p.shape[:-1] + (m // WORDS_OUT * GROUP,))


def to_device(p32: np.ndarray, device) -> torch.Tensor:
    """Packed u32 words -> an int32 tensor of the same bytes on `device`."""
    return torch.from_numpy(np.ascontiguousarray(p32, dtype=np.uint32).view(np.int32)).to(device)
