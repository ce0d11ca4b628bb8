"""The least work of one KeySwitch, for its roofline.

Counted per operation from the configuration, not per launch, so the share
reads the same whatever kernels carry the work.  Operations are 32-bit
multiply-adds: 10 per Harvey butterfly or MAC term, 7 per Barrett
reduction, 14 per modular multiply (the 64-bit products the kernels are made
of).  Bytes: each input and output once; the keys once per batch.
"""

HARVEY, BARRETT, MULTMOD = 10, 7, 14
WORD = 8


def transforms(cfg) -> int:
    """Length-n transforms an op needs: INTT1 of each decomp limb, the
    forward NTT of every limb under every active engine (L decomp moduli and
    the special one), INTT2 of each component, and each component's tail
    NTT under every decomp modulus."""
    L, comp = cfg["decomp_modulus_size"], cfg["key_component_count"]
    return L + (L + 1) * L + comp + comp * L


def per_op(cfg) -> dict:
    n, L = cfg["n"], cfg["decomp_modulus_size"]
    comp = cfg["key_component_count"]
    butterflies = transforms(cfg) * (n // 2) * (n.bit_length() - 1)
    mac_terms = comp * (L + 1) * L * n
    tail = comp * n * BARRETT + comp * L * n * (BARRETT + MULTMOD)
    return {
        "imad32": butterflies * HARVEY + mac_terms * HARVEY + tail,
        # target (L limbs), accumulator in and result out (comp * L each)
        "bytes": WORD * n * (L + 2 * comp * L),
    }


def per_batch(cfg) -> dict:
    n, L, K = cfg["n"], cfg["decomp_modulus_size"], cfg["key_modulus_size"]
    return {"imad32": 0, "bytes": WORD * L * cfg["key_component_count"] * K * n}
