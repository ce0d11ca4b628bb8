"""Launch each of the port's kernels once at small corner shapes and hold it
against its plain version: the program `chip_smoke.py` runs under
`compute-sanitizer` (memcheck, racecheck, synccheck, initcheck).

    python -m hexl_fpga_tpu_torch.utils.sanitize_kernels
    compute-sanitizer --tool racecheck python -m hexl_fpga_tpu_torch.utils.sanitize_kernels

Needs a CUDA device; builds the kernels (or loads the build that is there).
The shapes cover every launch form of the six TPU kernels' ports:
the split cores at C = 1 (n = 1024), C = 2 (n = 16384, one row) and C = 4
(n = 32768), for `ntt_fwd` (B1, B6) and `ntt_inv` (B2, B6); `ntt_fwd_tail`
(B3) at (2, 1024); `ntt_fwd_mac` (B5) in its cluster of 2 at n = 16384,
without a skipped limb and with one; `dyadic_mul` (B4) at (1, 2, 3, 1024);
and `keyswitch_mac`, the default schedule's key MAC, at (3, 2, 2, 1024) with
16-byte accesses and on operands 8 bytes off 16 (one-word accesses).
Operands are drawn with numpy from a seed and copied to the card, so the
only device work is the kernels' and the copies; the plain versions run on
the CPU.  Prints one JSON line; exit code 0 only if every kernel equals its
plain version bit for bit.
"""

from __future__ import annotations

import json
import sys
from functools import partial

import numpy as np
import torch

from ..ops import dyadic_cuda, nt, ntt_cuda, word64 as w

SEED = 12
# (kernel, rows, n, parts): the split cores at each C
TRANSFORMS = (("ntt_fwd", 1, 1024, 1), ("ntt_fwd", 1, 16384, 2), ("ntt_fwd", 1, 32768, 4),
              ("ntt_inv", 1, 1024, 1), ("ntt_inv", 1, 16384, 2), ("ntt_inv", 1, 32768, 4))
TAIL = (2, 1024)
MAC = {"limbs": 3, "B": 1, "comp": 2, "n": 16384, "parts": 2, "cluster": 2,
       "skip": (None, 1)}
DYADIC = (1, 2, 3, 1024)
KS_MAC = (3, 2, 2, 1024)  # (limbs, comp, B, n), one key row for the batch


def _pair(a: np.ndarray, device):
    return w.from_u64_np(a, device), w.from_u64_np(a, "cpu")


def cases(rng, device):
    """(name, kernel call, plain call) for every shape; each call returns a
    tensor (the kernel's on the card, the plain version's on the CPU)."""
    out = []
    for kernel, rows, n, parts in TRANSFORMS:
        q = int(nt.generate_primes(1, 61, n)[0])
        tabs = ntt_cuda.modulus_tables(n, q, device=device)
        ctabs = ntt_cuda.modulus_tables(n, q, device="cpu")
        x, cx = _pair(rng.integers(0, 1 << 64, size=(rows, n), dtype=np.uint64), device)
        fn, plain = getattr(ntt_cuda, kernel), getattr(ntt_cuda, f"{kernel}_plain")
        out.append((f"{kernel} ({rows}, {n}) C={parts}",
                    partial(fn, x, tabs, parts), partial(plain, cx, ctabs, parts)))

    rows, n = TAIL
    q = int(nt.generate_primes(1, 50, n)[0])
    tabs, ctabs = (ntt_cuda.modulus_tables(n, q, device=d) for d in (device, "cpu"))
    e, ce = _pair(rng.integers(0, 1 << 53, size=(rows, n), dtype=np.uint64), device)
    acc, cacc = _pair(rng.integers(0, 1 << 58, size=(rows, n), dtype=np.uint64), device)
    res, cres = _pair(rng.integers(0, q, size=(rows, n), dtype=np.uint64), device)
    msf = int(rng.integers(1, q))
    scal = (q - 4321, msf, (msf << 64) // q)
    out.append((f"ntt_fwd_tail ({rows}, {n}) C=1",
                partial(ntt_cuda.ntt_fwd_tail, e, acc, res, tabs, *scal, 1),
                partial(ntt_cuda.ntt_fwd_tail_plain, ce, cacc, cres, ctabs, *scal, 1)))

    m = MAC
    L, B, comp, n = m["limbs"], m["B"], m["comp"], m["n"]
    moduli = [int(p) for p in nt.generate_primes(L + 1, 50, n)]
    j = L  # the special prime's column
    tabs, ctabs = (ntt_cuda.modulus_tables(n, moduli[j], device=d) for d in (device, "cpu"))
    data, cdata = _pair(rng.integers(0, 1 << 64, size=(L * B, n), dtype=np.uint64), device)
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, L + 1, 1)
    k = rng.integers(0, 1 << 62, size=(L, comp, L + 1, n), dtype=np.uint64) % qcol
    kp = ((k.astype(object) << 64) // qcol.astype(object)).astype(np.uint64)
    keys, ckeys = _pair(k, device)
    prec, cprec = _pair(kp, device)
    for skip in m["skip"]:
        out.append((f"ntt_fwd_mac ({L * B}, {n}) C={m['parts']} cluster={m['cluster']} "
                    f"skip_i={skip}",
                    partial(ntt_cuda.ntt_fwd_mac, data, keys, prec, j, tabs, skip,
                            m["parts"], m["cluster"]),
                    partial(ntt_cuda.ntt_fwd_mac_plain, cdata, ckeys, cprec, j, ctabs, skip,
                            m["parts"])))

    B, _, M, n = DYADIC
    moduli = [int(p) for p in nt.generate_primes(M, 49, n)]
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, M, 1)
    x, cx = _pair(rng.integers(0, 1 << 62, size=DYADIC, dtype=np.uint64) % (4 * qcol), device)
    y, cy = _pair(rng.integers(0, 1 << 62, size=DYADIC, dtype=np.uint64) % (4 * qcol), device)
    run, crun = dyadic_cuda.runner(moduli, device), dyadic_cuda.runner(moduli, "cpu")
    out.append((f"dyadic_mul {DYADIC}", partial(run.run, x, y), partial(crun.run, cx, cy)))

    L, comp, B, n = KS_MAC
    q = int(nt.generate_primes(1, 52, n)[0])
    val = rng.integers(0, 1 << 64, size=(L, B, n), dtype=np.uint64)
    k = rng.integers(0, q, size=(L, comp, 1, n), dtype=np.uint64)
    (v, cv), (kd, ck), (pd, cp) = (_pair(a, device) for a in (val, k, w.precon64_np(k, q)))
    flat = torch.empty(v.numel() + 1, dtype=torch.int64, device=device)
    off = flat[1:].view_as(v)  # 8 bytes off a 16-byte boundary
    off.copy_(v)
    for what, x in (("", v), (" unaligned", off)):
        out.append((f"keyswitch_mac {KS_MAC}{what}",
                    partial(ntt_cuda.keyswitch_mac, x, kd, pd, q),
                    partial(ntt_cuda.keyswitch_mac_plain, cv, ck, cp, q)))
    return out


def check(device) -> dict:
    """Each case once on `device` (a card) against its plain version on the
    CPU: {case: "equal" or "DIFFERS"}."""
    results = {}
    for name, kernel, plain in cases(np.random.default_rng(SEED), device):
        got = kernel()
        torch.cuda.synchronize()  # a fault inside the kernel surfaces here
        results[name] = "equal" if torch.equal(got.cpu(), plain()) else "DIFFERS"
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    ntt_cuda.build_kernels()
    dyadic_cuda.build_kernels()
    results = check(device)
    ok = all(v == "equal" for v in results.values())
    print(json.dumps({"sanitize_kernels": {"device": torch.cuda.get_device_name(0),
                                           "cases": results, "ok": ok}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
