"""Public API: the 14 functions of `host/inc/hexl-fpga.h`, in Python.

Same names, same signatures (numpy arrays in place of raw pointers), same
async worksize/Completed protocol, same validation
(`host/src/{keyswitch,ntt,intt,dyadic_multiply}.cpp` FPGA_ASSERT wrappers) as
`hexl_fpga_tpu/api.py`, KeySwitch's `plain_modulus` extension included.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

from .runtime import scheduler as sched
from .utils.debug import hexl_assert


def acquire_FPGA_resources() -> None:
    """Reserve compute resources (`hexl-fpga.h:15`): starts the worker(s) on
    the device RUN_CHOICE selects.  Alias: acquire_GPU_resources."""
    sched.acquire()


def release_FPGA_resources() -> None:
    sched.release()


acquire_GPU_resources = acquire_FPGA_resources
release_GPU_resources = release_FPGA_resources


# -- DyadicMultiply section (`hexl-fpga.h:23-50`) ----------------------------


def set_worksize_DyadicMultiply(ws: int) -> None:
    hexl_assert(ws > 0, "worksize must be positive")
    sched.pool().set_worksize(sched.DYADIC_MULTIPLY, int(ws))


def DyadicMultiply(
    results: np.ndarray,
    operand1: np.ndarray,
    operand2: np.ndarray,
    n: int,
    moduli: Sequence[int],
    n_moduli: int,
) -> None:
    hexl_assert(results is not None, "requires results != nullptr")
    hexl_assert(operand1 is not None, "requires operand1 != nullptr")
    hexl_assert(operand2 is not None, "requires operand2 != nullptr")
    hexl_assert(n_moduli > 0, "requires n_moduli > 0")
    hexl_assert(n > 0, "requires n > 0")
    moduli = np.asarray(moduli, dtype=np.uint64)[:n_moduli].copy()
    fence_key = (int(n), int(n_moduli), moduli.tobytes())
    sched.pool().enqueue(
        sched.DYADIC_MULTIPLY,
        fence_key,
        {
            "results": results,
            "operand1": operand1,
            "operand2": operand2,
            "n": int(n),
            "moduli": moduli,
            "n_moduli": int(n_moduli),
        },
    )


def DyadicMultiplyCompleted() -> bool:
    return sched.pool().completed(sched.DYADIC_MULTIPLY)


# -- KeySwitch section (`hexl-fpga.h:52-86`) ---------------------------------


def set_worksize_KeySwitch(ws: int) -> None:
    hexl_assert(ws > 0, "worksize must be positive")
    sched.pool().set_worksize(sched.KEYSWITCH, int(ws))


def KeySwitch(
    result: np.ndarray,
    t_target_iter_ptr: np.ndarray,
    n: int,
    decomp_modulus_size: int,
    key_modulus_size: int,
    rns_modulus_size: int,
    key_component_count: int,
    moduli: Sequence[int],
    k_switch_keys: Sequence[np.ndarray],
    modswitch_factors: Sequence[int],
    twiddle_factors: Optional[np.ndarray] = None,
    plain_modulus: Optional[int] = None,
) -> None:
    """plain_modulus (an extension beyond the reference ABI): the BGV
    plaintext modulus t.  The reference tail is CKKS/BFV-only; with t set, the
    corrected tail keeps the subtracted value divisible by t (see
    ops/golden.keyswitch).  Switching keys must carry t-scaled errors."""
    # validation mirrors `host/src/keyswitch.cpp:15-44`
    hexl_assert(result is not None, "requires result != nullptr")
    hexl_assert(t_target_iter_ptr is not None, "requires t_target_iter_ptr != nullptr")
    hexl_assert(
        n in (1024, 2048, 4096, 8192, 16384),
        "requires n = 16384/8192/4096/2048/1024",
    )
    hexl_assert(decomp_modulus_size > 0, "requires decomp_modulus_size > 0")
    hexl_assert(key_modulus_size <= 7, "requires key_modulus_size <= 7")
    # rns_modulus_size is validated (>0) but never used by the reference's
    # computation — it is stored and compared in the batch fence only
    # (`host/src/keyswitch.cpp:28`, `host/src/fpga_int.cpp:443`); the device
    # kernel launches receive n / decomp_modulus_size / modulus_meta
    # (`host/src/fpga.cpp:1296-1301,1560-1565`).  Same here: any positive
    # value is accepted, participates in the dispatch fence, and does not
    # affect the result.
    hexl_assert(rns_modulus_size > 0, "requires rns_modulus_size > 0")
    hexl_assert(
        key_modulus_size > decomp_modulus_size,
        "requires key_modulus_size > decomp_modulus_size",
    )
    hexl_assert(key_component_count == 2, "requires key_component_count = 2")
    hexl_assert(moduli is not None, "requires moduli != nullptr")
    # check every key modulus (special prime included): the
    # deferred-quotient MAC is exact only for q <= 2^52, so an out-of-range
    # modulus must be rejected here, not mis-computed
    for i in range(key_modulus_size):
        hexl_assert(
            (1 << 16) <= int(moduli[i]) <= (1 << 52),
            "requires each modulus to be in the range of [2^16, 2^52]",
        )
    hexl_assert(k_switch_keys is not None, "requires k_switch_keys != nullptr")
    hexl_assert(modswitch_factors is not None, "requires modswitch_factors != nullptr")
    if plain_modulus is not None:
        from math import gcd

        plain_modulus = int(plain_modulus)
        hexl_assert(plain_modulus >= 2, "requires plain_modulus >= 2")
        for i in range(key_modulus_size):
            hexl_assert(
                gcd(int(moduli[i]), plain_modulus) == 1,
                "requires plain_modulus coprime to every modulus",
            )

    moduli_arr = np.asarray(moduli, dtype=np.uint64)[:key_modulus_size].copy()
    msf = np.asarray(modswitch_factors, dtype=np.uint64)[:key_modulus_size].copy()
    # fence on any config/keys change (`fpga_int.cpp:429-448`); keys are
    # identified by object identity like the reference's pointer-keyed cache
    keys_id = tuple(id(k) for k in k_switch_keys)
    fence_key = (
        int(n),
        int(decomp_modulus_size),
        int(key_modulus_size),
        int(rns_modulus_size),
        int(key_component_count),
        moduli_arr.tobytes(),
        msf.tobytes(),
        keys_id,
        plain_modulus,
    )
    sched.pool().enqueue(
        sched.KEYSWITCH,
        fence_key,
        {
            "result": result,
            "t_target": t_target_iter_ptr,
            "n": int(n),
            "decomp_modulus_size": int(decomp_modulus_size),
            "key_modulus_size": int(key_modulus_size),
            "rns_modulus_size": int(rns_modulus_size),
            "key_component_count": int(key_component_count),
            "moduli": moduli_arr,
            "k_switch_keys": list(k_switch_keys),
            "modswitch_factors": msf,
            "twiddle_factors": twiddle_factors,
            "plain_modulus": plain_modulus,
        },
    )


def KeySwitchCompleted() -> bool:
    return sched.pool().completed(sched.KEYSWITCH)


# -- Deprecated NTT/INTT section (`hexl-fpga.h:88-161`) ----------------------


def _deprecated(name: str) -> None:
    warnings.warn(
        f"{name} is deprecated since version 1.1 of the reference API",
        DeprecationWarning,
        stacklevel=3,
    )


def _set_worksize_NTT(ws: int) -> None:
    _deprecated("_set_worksize_NTT")
    hexl_assert(ws > 0, "worksize must be positive")
    sched.pool().set_worksize(sched.NTT, int(ws))


def _NTT(
    operand: np.ndarray,
    root_of_unity_powers: np.ndarray,
    precon_root_of_unity_powers: np.ndarray,
    coeff_modulus: int,
    n: int,
) -> None:
    _deprecated("_NTT")
    # `host/src/ntt.cpp:25`: the shipped kernel only supports n == 16384, but
    # like the emulation build we accept any supported power of two.
    hexl_assert(
        n in (1024, 2048, 4096, 8192, 16384, 32768),
        "requires supported power-of-two n",
    )
    hexl_assert(operand is not None and len(operand) == n, "operand size mismatch")
    fence_key = (int(n), int(coeff_modulus))
    sched.pool().enqueue(
        sched.NTT,
        fence_key,
        {
            "operand": operand,
            "root_of_unity_powers": np.asarray(root_of_unity_powers, dtype=np.uint64),
            "precon": np.asarray(precon_root_of_unity_powers, dtype=np.uint64),
            "coeff_modulus": int(coeff_modulus),
            "n": int(n),
        },
    )


def _NTTCompleted() -> bool:
    return sched.pool().completed(sched.NTT)


def _set_worksize_INTT(ws: int) -> None:
    _deprecated("_set_worksize_INTT")
    hexl_assert(ws > 0, "worksize must be positive")
    sched.pool().set_worksize(sched.INTT, int(ws))


def _INTT(
    operand: np.ndarray,
    inv_root_of_unity_powers: np.ndarray,
    precon_inv_root_of_unity_powers: np.ndarray,
    coeff_modulus: int,
    inv_n: int,
    inv_n_w: int,
    n: int,
) -> None:
    _deprecated("_INTT")
    hexl_assert(
        n in (1024, 2048, 4096, 8192, 16384, 32768),
        "requires supported power-of-two n",
    )
    hexl_assert(operand is not None and len(operand) == n, "operand size mismatch")
    fence_key = (int(n), int(coeff_modulus))
    sched.pool().enqueue(
        sched.INTT,
        fence_key,
        {
            "operand": operand,
            "inv_root_of_unity_powers": np.asarray(
                inv_root_of_unity_powers, dtype=np.uint64
            ),
            "precon": np.asarray(precon_inv_root_of_unity_powers, dtype=np.uint64),
            "coeff_modulus": int(coeff_modulus),
            "inv_n": int(inv_n),
            "inv_n_w": int(inv_n_w),
            "n": int(n),
        },
    )


def _INTTCompleted() -> bool:
    return sched.pool().completed(sched.INTT)
