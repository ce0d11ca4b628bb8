"""The least work of one DyadicMultiply, for its roofline: four modular
products a coefficient (14 32-bit multiply-adds each, as in the keyswitch
count), two operands of (2, M, n) words read and (3, M, n) written once."""

MULTMOD = 14
WORD = 8


def per_op(cfg) -> dict:
    elems = cfg["n_moduli"] * cfg["n"]
    return {"imad32": 4 * MULTMOD * elems, "bytes": WORD * elems * (2 + 2 + 3)}


def per_batch(cfg) -> dict:
    return {"imad32": 0, "bytes": 0}
