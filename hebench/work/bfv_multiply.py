"""The least work of one BFV multiply (BEHZ), for its roofline.

Counted per operation from the configuration, not per launch, so the share
reads the same whatever kernels carry the work; the unit costs are
work/keyswitch.py's: 10 32-bit multiply-adds per Harvey butterfly or lazy
MAC term, 7 per Barrett reduction, 14 per modular multiply.  At k ciphertext
moduli (Bsk has k + 1, and m~ = 2^32 is a mask):

  transforms   4k INTT of the inputs, 4(k + 1) NTT under Bsk, 3(2k + 1)
               INTT of the tensor and 3k NTT back: 109 at k = 6
  MAC terms    the three base conversions, per coefficient: the extension
               4k(k + 2) (to Bsk and m~), the fast floor 3k(k + 1) and
               Shenoy-Kumaresan 3k(k + 1) (to q and m_sk): 444 at k = 6
  reductions   one Barrett a conversion sum: 4(k + 1) + 3(k + 1) + 3(k + 1)
  multiplies   by constants: 4k + 8(k + 1) in the extension (the prologue,
               SmMRq's Q r and m~^-1), 3k + 6(k + 1) in the floor (the
               prologue, t, Q^-1), 3k + 3 + 3k in Shenoy-Kumaresan (the
               prologue, B^-1, alpha B); the tensor's 4 over 2k + 1 moduli
Bytes: both inputs (2, k, n) read and the (3, k, n) output written once.
"""

HARVEY, BARRETT, MULTMOD = 10, 7, 14
WORD = 8


def transforms(cfg) -> int:
    k = len(cfg["moduli"])
    return 4 * k + 4 * (k + 1) + 3 * (2 * k + 1) + 3 * k


def per_op(cfg) -> dict:
    n, k = cfg["n"], len(cfg["moduli"])
    butterflies = transforms(cfg) * (n // 2) * (n.bit_length() - 1)
    mac_terms = (4 * k * (k + 2) + 6 * k * (k + 1)) * n
    reductions = 10 * (k + 1) * n
    multiplies = (4 * k + 8 * (k + 1) + 3 * k + 6 * (k + 1) + 6 * k + 3
                  + 4 * (2 * k + 1)) * n
    return {
        "imad32": (butterflies + mac_terms) * HARVEY + reductions * BARRETT
                  + multiplies * MULTMOD,
        "bytes": WORD * n * k * (2 * 2 + 3),
    }


def per_batch(cfg) -> dict:
    return {"imad32": 0, "bytes": 0}
