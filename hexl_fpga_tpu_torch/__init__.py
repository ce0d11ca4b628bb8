"""hexl_fpga_tpu_torch: the PyTorch/CUDA port of hexl_fpga_tpu.

Exact-integer homomorphic-encryption primitives over word-sized primes on an
NVIDIA H100, behind the asynchronous worksize/Completed host API of Intel
HEXL-FPGA.  All 14 functions of `hexl-fpga.h` run on the card: KeySwitch,
DyadicMultiply and the deprecated NTT/INTT pair, over hand-written CUDA
kernels (`csrc/`); see `hexl_fpga_tpu_torch.api`.
"""

from .api import (  # noqa: F401
    DyadicMultiply,
    DyadicMultiplyCompleted,
    KeySwitch,
    KeySwitchCompleted,
    _INTT,
    _INTTCompleted,
    _NTT,
    _NTTCompleted,
    _set_worksize_INTT,
    _set_worksize_NTT,
    acquire_FPGA_resources,
    acquire_GPU_resources,
    release_FPGA_resources,
    release_GPU_resources,
    set_worksize_DyadicMultiply,
    set_worksize_KeySwitch,
)

__version__ = "0.1.0"
