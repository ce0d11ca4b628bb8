"""Operands across the two packages' device representations.

`hexl_fpga_tpu` carries every u64 as a (lo, hi) pair of uint32 planes and
stages keyswitch operands as `(klo, khi, plo, phi)` key/precon planes and a
`(K, 4)` uint32 `msf4` table, and moves DyadicMultiply and NTT batches as
interleaved uint32 `[lo_j, hi_j]` arrays of twice the width, as its device
handles do (`DeviceCiphertext.data32`, `DeviceTarget.data32`), and keeps a
hoisted decomposition as `(dlo, dhi)` planes; this package carries one int64
bit pattern per value.  These converters let a test feed
both packages the same staged operands and hold one's outputs against the
other's.  Inputs are anything `np.asarray` accepts (numpy or
device arrays of the other package); nothing of that package is imported.
The scheme layer's state crosses the same way: a CKKS, BGV or BFV context
from its parameters, secret and keys, and a CKKS ciphertext handle from the
reference's interleaved `data32`.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import word64 as w


def pair_to_i64(lo, hi, device="cpu") -> torch.Tensor:
    """(lo, hi) uint32 planes -> int64 tensor of the joined bit patterns."""
    return w.from_u64_np(w.from_pair_np(np.asarray(lo), np.asarray(hi)), device)


def i64_to_pair(x: torch.Tensor):
    """int64 tensor -> (lo, hi) uint32 numpy planes."""
    return w.to_pair_np(w.to_u64_np(x))


def interleaved_to_i64(x32, device="cpu") -> torch.Tensor:
    """(..., 2n) interleaved uint32 `[lo_j, hi_j]` (little-endian u64 bytes) ->
    (..., n) int64 tensor of the joined bit patterns."""
    x32 = np.array(x32, dtype=np.uint32, order="C")  # a writable copy
    return w.from_u64_np(x32.view(np.uint64), device)


def staged_keys_from_pairs(klo, khi, plo, phi, device="cuda"):
    """The reference's staged `(klo, khi, plo, phi)` key and precon planes,
    each (L, comp, K, n) uint32 -> this package's (keys, precons) int64
    tensors of the same shape, on `device` (the card unless the caller asks
    for the CPU, as the reference stages them on its accelerator)."""
    return pair_to_i64(klo, khi, device), pair_to_i64(plo, phi, device)


def msf_from_msf4(msf4) -> np.ndarray:
    """(K, 4) uint32 [msf_lo, msf_hi, precon_lo, precon_hi] rows -> the (K, 2)
    u64 host array of [msf, precon] rows that `KeySwitchContext._build` takes."""
    m = np.asarray(msf4, dtype=np.uint32).reshape(-1, 4)
    return np.stack(
        [w.from_pair_np(m[:, 0], m[:, 1]), w.from_pair_np(m[:, 2], m[:, 3])],
        axis=1,
    )


def i64_to_interleaved(x: torch.Tensor) -> np.ndarray:
    """(..., n) int64 tensor -> (..., 2n) interleaved uint32 `[lo_j, hi_j]`, the
    layout of the reference's `data32`."""
    return w.to_u64_np(x).view(np.uint32)


def handle_from_data32(data32, ctx):
    """A reference handle's `data32` ((B, comp, L, 2n) of a DeviceCiphertext or
    (B, L, 2n) of a DeviceTarget) -> this package's handle of the same kind on
    ctx's device."""
    from .ops import keyswitch_cuda as ks

    data = interleaved_to_i64(data32, ctx.device)
    kind = {4: ks.DeviceCiphertext, 3: ks.DeviceTarget}[data.dim()]
    return kind(data, ctx)


def decomposition_from_pairs(dlo, dhi, ctx):
    """A reference DeviceDecomposition's `(dlo, dhi)` planes, each
    (L+1, L*B, n) uint32 -> this package's DeviceDecomposition on ctx's device
    (the same lazy representatives, which every consumer reduces)."""
    from .ops import keyswitch_cuda as ks

    return ks.DeviceDecomposition(pair_to_i64(dlo, dhi, ctx.device), ctx)


def scheme_context_from_state(n, moduli, s, relin_keys, rot_keys=None,
                              scale=None, t=None, seed=0, scheme=None):
    """A scheme context of this package from the reference's state, as plain
    numpy arrays and lists: ring degree n, the moduli (special prime last),
    the secret s (n small integers), the relinearization keys and the
    rotation keys by Galois element ({g: key arrays}).  `scheme` names the
    context: "ckks" (of the given scale), "bgv" or "bfv" (plaintext modulus
    t); left None it is "bgv" with t given, else "ckks".  No key is drawn:
    both packages then compute on the same keys.  seed starts the context's
    generator (later encryptions and keys)."""
    from .integrations import bfv, bgv, ckks

    if scheme is None:
        scheme = "ckks" if t is None else "bgv"
    if scheme not in ("ckks", "bgv", "bfv") or (scheme == "ckks") != (t is None):
        raise ValueError(f"scheme {scheme!r} with t = {t}: CKKS takes no t, "
                         "BGV and BFV take one")
    if scheme == "ckks":
        ctx = ckks.CkksContext.__new__(ckks.CkksContext)
        ctx._setup(n, moduli, scale, seed)
    else:
        cls = bgv.BgvContext if scheme == "bgv" else bfv.BfvContext
        ctx = cls.__new__(cls)
        ctx.t = int(t)
        if scheme == "bgv":
            ctx._noise_scale = ctx.t
        ctx._setup(n, moduli, 1.0, seed)
        ctx.encoder = bgv.BatchEncoder(n, ctx.t)
    ctx.s = [int(v) for v in s]
    ctx.relin_keys = [np.array(k, dtype=np.uint64) for k in relin_keys]
    ctx._rot_keys = {int(g): [np.array(k, dtype=np.uint64) for k in keys]
                     for g, keys in dict(rot_keys or {}).items()}
    return ctx


def ckks_handle_from_data32(data32, level, scale, device="cuda"):
    """A reference DeviceCkksCiphertext's interleaved u32 `data32`
    ((2, level+1, 2n)) with its level and scale -> this package's
    DeviceCkksCiphertext (one (2, level+1, n) int64 tensor on `device`, the
    card unless the caller asks for the CPU)."""
    from .integrations.ckks import DeviceCkksCiphertext

    return DeviceCkksCiphertext(interleaved_to_i64(data32, device), int(level),
                                float(scale))


def ckks_handle_to_data32(h) -> np.ndarray:
    """This package's DeviceCkksCiphertext -> the reference's interleaved u32
    `data32` array (2, level+1, 2n)."""
    return i64_to_interleaved(h.data)
