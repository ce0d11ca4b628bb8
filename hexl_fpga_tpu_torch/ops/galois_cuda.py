"""Galois automorphism in the NTT domain: one index gather.

The counterpart of `hexl_fpga_tpu/ops/galois_mxu.py`.  The hoisted keyswitch
apply needs one NTT-domain permutation of the output ciphertext per rotation,
`out == x[..., sigma_g]`.  The reference factors that permutation into one-hot
matrix products on 8-bit limbs because a lane gather is slow on its target;
a gather along the contiguous axis is an ordinary memory-bound pass on a GPU,
so here the apply is `torch.index_select` with an index cached on the device
per (n, g) and none of the factorisation (`build_galois_operands`,
`stage_operands`, `apply_galois_mxu_pair`, `hi_limb_count`) comes across.

With the limb split goes its precondition: the reference's pair apply carries
only the limbs a canonical residue can occupy and truncates anything above
them.  `apply_galois` is a pure permutation of ANY 64-bit pattern.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import nt


def _bit_reverse(n: int) -> np.ndarray:
    """br[p] = p with its log2(n) bits reversed."""
    br = np.zeros(n, dtype=np.int64)
    half, step = n >> 1, 1
    while step < n:
        br[step : 2 * step] = br[:step] + half
        half >>= 1
        step <<= 1
    return br


def ntt_galois_sigma(n: int, g: int) -> np.ndarray:
    """sigma with NTT(tau_g m) = NTT(m)[sigma] in the library's bit-reversed
    NTT layout, for the Galois element g (odd, taken mod 2n): position p holds
    the evaluation at exponent e(p) = 2 * bitrev(p) + 1, and tau_g moves the
    evaluation at exponent g * e(p) there."""
    if not (nt.is_power_of_two(n) and n >= 2):
        raise ValueError(f"n must be a power of two >= 2, got {n}")
    g = int(g) % (2 * n)
    if g % 2 == 0:
        raise ValueError(f"a Galois element is odd, got {g}")
    e = 2 * _bit_reverse(n) + 1
    e_inv = np.zeros(2 * n, dtype=np.int64)
    e_inv[e] = np.arange(n)
    return e_inv[(g * e) % (2 * n)]


@functools.lru_cache(maxsize=64)
def _galois_index(n: int, g: int, device: str) -> torch.Tensor:
    return torch.from_numpy(ntt_galois_sigma(n, g)).to(device)


def galois_index(n: int, g: int, device="cuda") -> torch.Tensor:
    """sigma_g as an int64 index tensor on `device` (the card unless the caller
    asks for the CPU), cached per (n, g, device)."""
    return _galois_index(int(n), int(g) % (2 * int(n)), str(torch.device(device)))


def apply_galois(x: torch.Tensor, g: int) -> torch.Tensor:
    """out[..., p] = x[..., sigma_g[p]] for x (..., n) int64 on any device: the
    NTT-domain automorphism tau_g of every row.  Any 64-bit pattern passes
    through unchanged; nothing is assumed canonical."""
    if x.dtype != torch.int64:
        raise TypeError(f"apply_galois: expected int64 bit patterns, got {x.dtype}")
    return x.index_select(-1, galois_index(x.shape[-1], g, x.device))
