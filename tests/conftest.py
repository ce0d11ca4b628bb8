"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Mirrors the reference's emulation-mode testing strategy (`RUN_CHOICE=1`,
`device/CMakeLists.txt:4-8`): the same kernels run on CPU so CI needs no
accelerator; multi-chip sharding is tested on a virtual device mesh.

Set HEXL_TPU_HW_TESTS=1 to leave the platform as configured (real TPU) and
enable tests/test_tpu_hw.py — the on-hardware validation tier.
"""

import os

import pytest

_HW = os.environ.get("HEXL_TPU_HW_TESTS") == "1"

if not _HW:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    # XLA:CPU's LLVM optimization pipeline takes 40+ MINUTES on the big
    # interpret-mode fused-keyswitch programs (measured, 1-core host) and
    # buys nothing here — the CPU tier checks exact integer CORRECTNESS,
    # not speed.  opt level 0 compiles the same program in ~30 s,
    # bit-identically (integer semantics don't depend on optimization).
    # The HW tier never sees this: it keeps the default pipeline.
    if "xla_backend_optimization_level" not in flags:
        flags = (flags + " --xla_backend_optimization_level=0").strip()
    os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

if not _HW:
    # jax may already be imported (site customization); the env var is then
    # ignored, so set the config knob too.
    jax.config.update("jax_platforms", "cpu")

from hexl_fpga_tpu.utils.cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: XLA CPU compiles of the big fused programs
# dominate suite time on small machines (60s+ each on one core); cached
# re-runs drop to ~1s per program.  Backend-gated (utils/cache.py): in the
# HW tier (real TPU) cache writes stall compiles, so it stays off there.
enable_compile_cache(os.path.dirname(os.path.dirname(__file__)))


# Smoke tier (HEXL_TPU_SMOKE_TESTS=1): the host-math + runtime + one-config
# keyswitch subset that genuinely runs in minutes on a 1-core box (measured
# time in README).  Everything interpret-mode-Pallas-heavy stays in the
# default (fast) tier; the heavy marker gates big shapes / full sweeps.
SMOKE_FILES = {
    "test_golden.py",
    "test_nt.py",
    "test_word64.py",
    "test_api.py",
    "test_scheduler.py",
    "test_scheduler_release.py",
    "test_validation.py",
    "test_wirepack.py",
    "test_keyswitch_golden.py",
    "test_keyswitch_vectors.py",
    "test_galois_mxu.py",
    "test_rns_behz.py",
    "test_timing.py",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "heavy: compile-heavy tier (big shapes / full sweeps); skipped "
        "unless HEXL_TPU_HEAVY_TESTS=1 — the fast tier keeps a smaller "
        "variant of every code path",
    )
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA device (the port's hardware tier); skips without "
        "one, and without HEXL_TORCH_HW_TESTS=1",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("HEXL_TPU_SMOKE_TESTS") == "1":
        skip_smoke = pytest.mark.skip(
            reason="smoke tier runs only the host-math/runtime subset "
            "(unset HEXL_TPU_SMOKE_TESTS for the full fast tier)"
        )
        for item in items:
            if os.path.basename(str(item.fspath)) not in SMOKE_FILES:
                item.add_marker(skip_smoke)
    if os.environ.get("HEXL_TPU_HEAVY_TESTS") == "1":
        return
    skip = pytest.mark.skip(
        reason="heavy tier: set HEXL_TPU_HEAVY_TESTS=1 to run"
    )
    for item in items:
        if "heavy" in item.keywords:
            item.add_marker(skip)
