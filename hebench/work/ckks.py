"""The least work of one CKKS op, for its roofline: a rotation or a BSGS
matrix-vector product (the cell's HEBENCH_CKKS_OP), at the configuration's
level (L active moduli, K key moduli, two key components).

Counted per operation from the configuration, not per launch, so the share
reads the same whatever kernels carry the work; the unit costs are
work/keyswitch.py's, and a KeySwitch counts as it counts one.

  rotation  one KeySwitch (62 transforms and its MAC at L = 6, K = 7); a
            gather moves words and multiplies nothing
  matvec    one hoisted decomposition (L INTT and (L + 1) L NTT), for each
            hoisted baby step a KeySwitch less that decomposition (its MAC,
            INTT2 and tails), a full KeySwitch for each giant step, and one
            modular product a word of the (2, L, n) ciphertext for each
            diagonal; the modular sums multiply nothing
Bytes: the ciphertext (2, L, n) read and the result written once, every key
set once an op (the batch is 1: L * 2 * K * n words a set, precons left
out, as work/keyswitch.py counts keys) and the matvec's diagonal planes
(D, L, n) once.
"""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "hebench_work_keyswitch_for_ckks", os.path.join(os.path.dirname(__file__),
                                                    "keyswitch.py"))
_ks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ks)

WORD = _ks.WORD


def _shape(cfg):
    n, K = cfg["n"], len(cfg["moduli"])
    return n, int(cfg["level"]) + 1, K


def _keyswitch(cfg) -> dict:
    """work/keyswitch.py's configuration for one KeySwitch of this chain."""
    n, L, K = _shape(cfg)
    return {"n": n, "decomp_modulus_size": L, "key_modulus_size": K,
            "key_component_count": 2}


def per_op(cfg) -> dict:
    n, L, K = _shape(cfg)
    ks_cfg = _keyswitch(cfg)
    keyswitch = _ks.per_op(ks_cfg)["imad32"]
    key_set = _ks.per_batch(ks_cfg)["bytes"]
    ct = WORD * 2 * L * n
    if os.environ.get("HEBENCH_CKKS_OP", "rotate") == "rotate":
        return {"imad32": keyswitch, "bytes": 2 * ct + key_set}
    D, n1 = int(cfg["matvec_diagonals"]), int(cfg["matvec_n1"])
    baby, giant = min(n1, D) - 1, -(-D // n1) - 1
    decompose = (L + (L + 1) * L) * (n // 2) * (n.bit_length() - 1) * _ks.HARVEY
    products = D * 2 * L * n * _ks.MULTMOD
    return {
        "imad32": (decompose + baby * (keyswitch - decompose) + giant * keyswitch
                   + products),
        "bytes": 2 * ct + (baby + giant) * key_set + WORD * D * L * n,
    }


def per_batch(cfg) -> dict:
    return {"imad32": 0, "bytes": 0}
