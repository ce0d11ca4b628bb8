"""hexl_fpga_tpu_torch: the PyTorch/CUDA port of hexl_fpga_tpu.

Exact-integer homomorphic-encryption primitives over word-sized primes on an
NVIDIA H100, behind the asynchronous worksize/Completed host API of Intel
HEXL-FPGA.  Ported so far: KeySwitch, over hand-written CUDA NTT kernels
(`csrc/`); see `hexl_fpga_tpu_torch.api`.
"""

from .api import (  # noqa: F401
    DyadicMultiply,
    KeySwitch,
    KeySwitchCompleted,
    _INTT,
    _NTT,
    acquire_FPGA_resources,
    acquire_GPU_resources,
    release_FPGA_resources,
    release_GPU_resources,
    set_worksize_KeySwitch,
)

__version__ = "0.1.0"
