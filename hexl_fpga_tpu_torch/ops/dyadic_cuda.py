"""DyadicMultiply (ciphertext x ciphertext product) on the card.

Counterpart of `hexl_fpga_tpu/ops/dyadic_pallas.py` (the fused kernel,
`DyadicRunner`) and `hexl_fpga_tpu/ops/dyadic_jax.py` (its XLA composition):

    out0 = x0*y0,  out1 = x0*y1 + x1*y0,  out2 = x1*y1     (mod each modulus)

for operands `(B, 2, M, n)` and a result `(B, 3, M, n)`, every product the
reference MultMod (`word64.mul_mod_traced`: operands shrunk from [0, 4q),
Barrett with len = floor(log2 q) - 1, barr = floor(2^(len+64) / q)).

  dyadic_multiply        the wrapper over the CUDA kernel `dyadic_mul` of
                         `csrc/dyadic_kernels.cu`, with its launch counter
  dyadic_multiply_plain  the plain PyTorch version, device-agnostic

One route serves every n and every moduli vector: q, barr and len are runtime
data in a `(3, M)` device array (`runner` caches it per moduli vector and
device), where the reference compiles one kernel per moduli vector for n a
multiple of 128 and runs a second tier for everything else.  On an H100 the
kernel is bytes-bound (56 bytes a coefficient against four MultMods; times in
`PERF.md`).

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; a CUDA tensor never reaches the plain version through
a wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _build, word64 as w

# launches since the last reset; the wrapper adds one exactly where it
# launches its kernel
LAUNCHES = {"dyadic_mul": 0}
_launches_lock = threading.Lock()  # NUM_DEV > 1: several workers launch

KERNEL_SOURCE = "dyadic_kernels.cu"


def reset_launch_counts() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def moduli_meta(moduli):
    """Per-modulus (len, barr) as in FPGAObject_DyadicMultiply::fill_in_data:
    len = floor(log2 q) - 1, barr = floor(2^(len+64) / q) (it fits 64 bits:
    q >= 2^(len+1))."""
    moduli = np.asarray(moduli, dtype=np.uint64)
    if moduli.size == 0 or int(moduli.min()) < 2:
        raise ValueError("DyadicMultiply needs at least one modulus, each >= 2")
    lens = np.array([int(q).bit_length() - 2 for q in moduli], dtype=np.uint32)
    barrs = np.array(
        [((1 << (int(l) + 64)) // int(q)) & ((1 << 64) - 1)
         for q, l in zip(moduli, lens)],
        dtype=np.uint64,
    )
    return lens, barrs


@dataclass(frozen=True, eq=False)
class DyadicRunner:
    """One moduli vector's constants on one device."""

    moduli: tuple
    meta: torch.Tensor  # (3, M) int64 patterns: q, barr, len

    def run(self, op1: torch.Tensor, op2: torch.Tensor) -> torch.Tensor:
        return dyadic_multiply(op1, op2, self.meta)


@functools.lru_cache(maxsize=64)
def _runner(moduli: tuple, device: str) -> DyadicRunner:
    q = np.asarray(moduli, dtype=np.uint64)
    lens, barrs = moduli_meta(q)
    meta = np.stack([q, barrs, lens.astype(np.uint64)])
    return DyadicRunner(moduli, w.from_u64_np(meta, device))


def runner(moduli, device="cuda") -> DyadicRunner:
    """The cached runner for a moduli vector on `device` (the card unless the
    caller asks for the CPU; any n); its constants are uploaded once."""
    return _runner(tuple(int(q) for q in moduli), str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hexl_dyadic_mul.argtypes = [p, p, p, p, i, i, i, p]
    lib.hexl_dyadic_mul.restype = ctypes.c_int
    return lib


def build_kernels() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _lib()


def _check(op1: torch.Tensor, op2: torch.Tensor, meta: torch.Tensor, name: str):
    for x in (op1, op2, meta):
        if x.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64 bit patterns, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if x.device != op1.device:
            raise ValueError(f"{name}: tensors on {x.device} and {op1.device}")
    if op1.dim() != 4 or op1.shape[1] != 2 or op1.shape != op2.shape or op1.numel() == 0:
        raise ValueError(
            f"{name}: expected two (B, 2, M, n) operands, got "
            f"{tuple(op1.shape)} and {tuple(op2.shape)}"
        )
    if op1.shape[0] > 65535 or op1.shape[2] > 65535:
        raise ValueError(f"{name}: at most 65535 batch items and 65535 moduli")
    if tuple(meta.shape) != (3, op1.shape[2]):
        raise ValueError(
            f"{name}: expected (3, {op1.shape[2]}) constants, got {tuple(meta.shape)}"
        )


def dyadic_multiply_plain(op1: torch.Tensor, op2: torch.Tensor,
                          meta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of dyadic_multiply (any device)."""
    _check(op1, op2, meta, "dyadic_multiply_plain")
    q, barr, length = (meta[k].view(1, -1, 1) for k in range(3))
    x0, x1 = op1[:, 0], op1[:, 1]
    y0, y1 = op2[:, 0], op2[:, 1]

    def mm(a, b):
        return w.mul_mod_traced(a, b, q, barr, length)

    out1 = w.cond_sub64(w.add64(mm(x0, y1), mm(x1, y0)), q)
    return torch.stack([mm(x0, y0), out1, mm(x1, y1)], dim=1)


def dyadic_multiply(op1: torch.Tensor, op2: torch.Tensor,
                    meta: torch.Tensor) -> torch.Tensor:
    """(B, 2, M, n) x (B, 2, M, n) int64 patterns -> (B, 3, M, n) under the M
    moduli of `meta` (a runner's (3, M) constants).  Exact for operands in
    [0, 4q), and beyond while x*y < 2^(len+64) as the reference MultMod is;
    on any other u64 it computes what the plain version computes."""
    _check(op1, op2, meta, "dyadic_multiply")
    if op1.device.type == "cpu":
        return dyadic_multiply_plain(op1, op2, meta)
    B, _, M, n = op1.shape
    out = torch.empty((B, 3, M, n), dtype=torch.int64, device=op1.device)
    with torch.cuda.device(op1.device):
        err = _lib().hexl_dyadic_mul(
            op1.data_ptr(), op2.data_ptr(), out.data_ptr(), meta.data_ptr(),
            B, M, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dyadic_mul: kernel launch failed (cudaError {err})")
    with _launches_lock:
        LAUNCHES["dyadic_mul"] += 1
    return out


def dyadic_multiply_np(op1, op2, n: int, moduli, n_moduli: int,
                       device="cuda") -> np.ndarray:
    """numpy convenience with the public-API layout
    (`host/inc/hexl-fpga.h:41-43`): op [2][M][n] -> out [3][M][n], flat."""
    moduli = np.asarray(moduli, dtype=np.uint64)[:n_moduli]
    r = runner(moduli, device)
    x = w.from_u64_np(np.asarray(op1, dtype=np.uint64).reshape(1, 2, n_moduli, n), device)
    y = w.from_u64_np(np.asarray(op2, dtype=np.uint64).reshape(1, 2, n_moduli, n), device)
    return w.to_u64_np(r.run(x, y)).reshape(-1)
