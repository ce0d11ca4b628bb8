"""Environment-variable configuration.

Reproduces the reference's env config table (`host/src/fpga_int.cpp:40-141`),
read once at first use:

  RUN_CHOICE    0 = CPU golden model (the Intel-HEXL-fallback analog),
                1 = emulation (the same torch code on device="cpu", with
                    the kernels' plain versions — the FPGA_EMULATOR analog),
                2 = accelerated (CUDA; raises when no CUDA device is visible).
  BATCH_SIZE_DYADIC_MULTIPLY / BATCH_SIZE_NTT / BATCH_SIZE_INTT /
  BATCH_SIZE_KEYSWITCH      max ops batched into one device submission
                            (default 1; keyswitch capped at 1024).
  FPGA_BUFSIZE  work-queue capacity (default 1024).
  NUM_DEV       number of devices to drain the shared queue (default 1).
  FPGA_DEBUG    1/2 = timing prints (host timers of `fpga.cpp:882-920`).
  FPGA_KERNEL   accepted for compatibility (kernel selection is automatic).
  FPGA_BITSTREAM  accepted for compatibility (the reference's explicit
                  kernel-.so path, `host/src/fpga.cpp:557-562`; compiled
                  kernels are built from csrc/ at first use here).
  COEFF_SIZE / MODULUS_SIZE    accepted for compatibility (buffer presizing
                               is unnecessary here).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int, lo: int | None = None, hi: int | None = None) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        v = default
    if lo is not None:
        v = max(lo, v)
    if hi is not None:
        v = min(hi, v)
    return v


@dataclass
class Config:
    run_choice: int = field(default_factory=lambda: _env_int("RUN_CHOICE", 2, 0, 2))
    batch_size_dyadic_multiply: int = field(
        default_factory=lambda: _env_int("BATCH_SIZE_DYADIC_MULTIPLY", 1, 1)
    )
    batch_size_ntt: int = field(default_factory=lambda: _env_int("BATCH_SIZE_NTT", 1, 1))
    batch_size_intt: int = field(default_factory=lambda: _env_int("BATCH_SIZE_INTT", 1, 1))
    batch_size_keyswitch: int = field(
        default_factory=lambda: _env_int("BATCH_SIZE_KEYSWITCH", 1, 1, 1024)
    )
    bufsize: int = field(default_factory=lambda: _env_int("FPGA_BUFSIZE", 1024, 1))
    num_dev: int = field(default_factory=lambda: _env_int("NUM_DEV", 1, 1))
    debug: int = field(default_factory=lambda: _env_int("FPGA_DEBUG", 0, 0, 2))
    kernel: str = field(
        default_factory=lambda: os.environ.get("FPGA_KERNEL", "DYADIC_MULTIPLY_KEYSWITCH")
    )
    bitstream: str = field(
        default_factory=lambda: os.environ.get("FPGA_BITSTREAM", "")
    )
    # HEXL_TPU_PROFILE=<dir>: capture a torch.profiler trace between
    # acquire_FPGA_resources() and release_FPGA_resources() (the analog of
    # the reference's SYCL queue-profiling toggle,
    # `host/src/fpga.cpp:617-622`); a chrome trace is written into <dir>.
    profile_dir: str = field(
        default_factory=lambda: os.environ.get("HEXL_TPU_PROFILE", "")
    )


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> None:
    """Re-read the environment (used by tests)."""
    global _config
    _config = None


@contextlib.contextmanager
def run_choice_for(device=None):
    """RUN_CHOICE for the runtimes (the API's workers, the C++ pool) created
    inside the block, and what BFV's multiply_rns follows there: 1 (the
    kernels' plain versions on the CPU) for device "cpu", else 2 (the card;
    with no CUDA device this raises here).  Yields the device's name.  The
    environment and the configuration are put back on the way out."""
    import torch

    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        name = "cpu (the kernels' plain versions)"
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions")
    else:
        name = torch.cuda.get_device_name(torch.device(device or "cuda"))
    keep = os.environ.get("RUN_CHOICE")
    os.environ["RUN_CHOICE"] = "1" if cpu else "2"
    reset_config()
    try:
        yield name
    finally:
        if keep is None:
            del os.environ["RUN_CHOICE"]
        else:
            os.environ["RUN_CHOICE"] = keep
        reset_config()
