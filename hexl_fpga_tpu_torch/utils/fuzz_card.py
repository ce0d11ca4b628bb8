"""Fuzz the port over the envelope its API accepts, on the card: the
counterpart of `scripts/fuzz_hw.py`.

    python -m hexl_fpga_tpu_torch.utils.fuzz_card [--quick] [--device cpu] [--seed 0]

Every configuration is held bit for bit against an oracle that is not the
kernel's arithmetic, and prints one line; a JSON summary comes last.  Exit
code 0 only if every configuration matched.

  transforms  `ntt_cuda.ntt_fwd` / `ntt_inv` and `_NTT` / `_INTT` through the
              API with the caller's tables, at n = 1024 .. 32768 and moduli
              of every width in TRANSFORM_WIDTHS: the smallest prime of the
              width, and for the widths in TOP_WIDTHS also the largest (62
              bits: the kernels' limit q < 2^62, where 4q comes within 2^2 of
              2^64).  Rows: the reference's corners (a zero row, a row of
              q - 1, a delta), random canonical rows and random 64-bit rows.
              Against `golden.fwd_ntt` / `inv_ntt` of the rows mod q, and the
              round trip.
  keyswitch   the device context in the default schedule and with
              `fused_mac=True`, and `api.KeySwitch`, against the vector's
              `expected_output` (the golden model): fuzz_hw.py's six
              configurations, the envelope's edges (n = 1024 .. 16384 x
              (L, K) in KS_LK x the smallest width >= 17 bits that holds K
              primes, and the K largest primes below 2^52, the API's bound)
              and one BGV configuration.
  dyadic      `dyadic_cuda` at n = 1024 .. 32768, M in DYADIC_M, widths
              DYADIC_WIDTHS: canonical operands (corners first) and operands
              in [0, 4q), MultMod's exact domain, against the bignum
              `golden.dyadic_multiply`; random 64-bit operands, beyond it,
              against the plain version, which follows the reference's traced
              tier (tests/test_torch_fuzz.py holds it to the JAX package).

A width w names the primes q with q.bit_length() == w; scripts/fuzz_hw.py
passes w - 1 to nt.generate_primes.  On the card every launch of a kernel in
the run is also held against the kernel's plain version on the same inputs
(`kernels_vs_plain`); on the CPU (`--device cpu`) the wrappers are the plain
versions, so the run checks the grid and its oracles, not a kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import api, config as config_mod
from ..ops import dyadic_cuda, golden, keyswitch_cuda, nt, ntt_cuda, twiddles, word64 as w
from . import vectors

TRANSFORM_N = (1024, 2048, 4096, 8192, 16384, 32768)  # also api._NTT's n
TRANSFORM_WIDTHS = (20, 30, 40, 45, 48, 51, 52, 55, 61, 62)
TOP_WIDTHS = (52, 62)  # also the largest prime of the width
KS_N = (1024, 2048, 4096, 8192, 16384)  # api.KeySwitch's n
KS_LK = ((1, 2), (6, 7))
KS_MIN_WIDTH = 17  # moduli >= 2^16 (api.KeySwitch)
KS_MAX_WIDTH = 52  # moduli <= 2^52
# scripts/fuzz_hw.py:58-80, (n, L, K, bits) with bits nt.generate_primes'
FUZZ_HW_KEYSWITCH = ((1024, 2, 3, 30), (1024, 4, 5, 51), (2048, 3, 4, 40),
                     (4096, 2, 3, 45), (4096, 5, 6, 51), (8192, 3, 4, 48))
BGV_KEYSWITCH = (4096, 3, 4, 40, 65537)  # (n, L, K, bits, plain_modulus)
DYADIC_N = (1024, 2048, 4096, 8192, 16384, 32768)
DYADIC_M = (1, 7, 14)
DYADIC_WIDTHS = (17, 30, 50, 52, 60)
RANDOM_ROWS = 2  # random canonical rows, and as many random 64-bit ones

# the --quick subset: about a minute on the card, golden checks included,
# one host-side golden KeySwitch at n = 16384
QUICK_TRANSFORMS = ((1024, (20, 62)), (4096, (45,)), (16384, (52,)), (32768, (30, 62)))
QUICK_KEYSWITCH_EDGES = ((1024, (1, 2), "smallest"), (1024, (6, 7), "52"),
                         (4096, (6, 7), "smallest"), (16384, (6, 7), "52"))
QUICK_DYADIC = ((1024, (1, 14), (17, 52, 60)), (32768, (1, 14), (17, 60)))


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def width_exists(n: int, width: int) -> bool:
    """fuzz_hw.py's skip rule (`bits <= log2 n` skips), for widths: a width
    is tried only where nt.generate_primes takes w - 1 for n."""
    return width - 1 > nt.log2_exact(n)


@functools.lru_cache(maxsize=None)
def width_primes(k: int, width: int, n: int, top: bool = False):
    """k primes q = 1 mod 2n of `width` bits: the smallest (as
    nt.generate_primes finds them) or, top=True, the largest below 2^width,
    in ascending order; None where the width holds fewer."""
    if not width_exists(n, width):
        return None
    if not top:
        try:
            return tuple(nt.generate_primes(k, width - 1, n))
        except RuntimeError:
            return None
    found = []
    q = (1 << width) - 2 * n + 1
    while q >= 1 << (width - 1) and len(found) < k:
        if nt.is_prime(q):
            found.append(q)
        q -= 2 * n
    return tuple(sorted(found)) if len(found) == k else None


def smallest_width(k: int, n: int, lo: int = KS_MIN_WIDTH, hi: int = KS_MAX_WIDTH):
    """The smallest width in [lo, hi] that holds k primes q = 1 mod 2n."""
    for width in range(lo, hi + 1):
        if width_primes(k, width, n) is not None:
            return width
    return None


@dataclass(frozen=True)
class Transform:
    n: int
    width: int
    top: bool = False

    @property
    def q(self) -> int:
        return width_primes(1, self.width, self.n, self.top)[0]

    @property
    def name(self) -> str:
        edge = "largest" if self.top else "smallest"
        return f"ntt n={self.n} {self.width}b {edge} q={self.q}"


@dataclass(frozen=True)
class KeySwitch:
    label: str
    n: int
    L: int
    K: int
    moduli: tuple
    seed: int
    plain_modulus: int | None = None

    @property
    def name(self) -> str:
        lo, hi = (int(q).bit_length() for q in (min(self.moduli), max(self.moduli)))
        bgv = f" t={self.plain_modulus}" if self.plain_modulus else ""
        return f"keyswitch {self.n}_{self.L}_{self.K} {self.label} ({lo}-{hi}b){bgv}"


@dataclass(frozen=True)
class Dyadic:
    n: int
    M: int
    width: int

    @property
    def moduli(self) -> tuple:
        # any primes of the width (the product needs no root of unity)
        return tuple(nt.generate_primes(self.M, self.width - 1))

    @property
    def name(self) -> str:
        return f"dyadic n={self.n} M={self.M} {self.width}b"


def transform_grid(quick: bool = False, sizes=TRANSFORM_N, widths=TRANSFORM_WIDTHS):
    plan = QUICK_TRANSFORMS if quick else [(n, widths) for n in sizes]
    out = []
    for n, ws in plan:
        for width in ws:
            if width_primes(1, width, n) is None:
                continue
            out.append(Transform(n, width))
            if width in TOP_WIDTHS:
                out.append(Transform(n, width, top=True))
    return out


def keyswitch_edge(n: int, L: int, K: int, edge: str, seed: int) -> KeySwitch:
    """The envelope's edge: K primes of the smallest width that holds them,
    or the K largest below 2^52."""
    if edge == "smallest":
        moduli = width_primes(K, smallest_width(K, n), n)
    else:
        moduli = width_primes(K, KS_MAX_WIDTH, n, top=True)
    label = "smallest width" if edge == "smallest" else "largest below 2^52"
    return KeySwitch(label, n, L, K, moduli, seed)


def keyswitch_grid(quick: bool = False, sizes=KS_N, lk=KS_LK):
    if quick:
        edges = QUICK_KEYSWITCH_EDGES
        hw = ((1024, 2, 3, 45),)  # fuzz_hw.py --quick
    else:
        edges = [(n, c, e) for n in sizes for c in lk for e in ("smallest", "52")]
        hw = FUZZ_HW_KEYSWITCH
    out = [keyswitch_edge(n, L, K, e, seed=n + L + i)
           for i, (n, (L, K), e) in enumerate(edges)]
    for n, L, K, bits in hw:
        out.append(KeySwitch(f"fuzz_hw {bits}", n, L, K,
                             tuple(nt.generate_primes(K, bits, n)), seed=n + L))
    n, L, K, bits, t = BGV_KEYSWITCH
    out.append(KeySwitch(f"bgv {bits}", n, L, K, tuple(nt.generate_primes(K, bits, n)),
                         seed=n + t, plain_modulus=t))
    return out


def dyadic_grid(quick: bool = False, sizes=DYADIC_N, ms=DYADIC_M, widths=DYADIC_WIDTHS):
    plan = QUICK_DYADIC if quick else [(n, ms, widths) for n in sizes]
    return [Dyadic(n, M, width) for n, mm, ws in plan for M in mm for width in ws]


# ---------------------------------------------------------------------------
# every launch against its plain version
# ---------------------------------------------------------------------------

# wrapper -> (module, plain version, the plain version's positional arity)
_CHECKED = {
    "ntt_fwd": (ntt_cuda, ntt_cuda.ntt_fwd_plain, 3),
    "ntt_inv": (ntt_cuda, ntt_cuda.ntt_inv_plain, 3),
    "ntt_fwd_tail": (ntt_cuda, ntt_cuda.ntt_fwd_tail_plain, 8),
    "ntt_fwd_mac": (ntt_cuda, ntt_cuda.ntt_fwd_mac_plain, 7),
    "keyswitch_mac": (ntt_cuda, ntt_cuda.keyswitch_mac_plain, 4),
    "dyadic_multiply": (dyadic_cuda, dyadic_cuda.dyadic_multiply_plain, 3),
}


class KernelMismatch(AssertionError):
    pass


@contextlib.contextmanager
def kernels_vs_plain(counts: dict):
    """While open, every wrapper call on a CUDA tensor (any thread) is also
    run through the kernel's plain version on the same inputs, on the card,
    and the two must be equal bit for bit (else KernelMismatch);
    counts[wrapper] adds one a comparison.  The plain versions launch no
    kernel, so the launch counters are the run's own."""
    lock = threading.Lock()
    saved = {}

    def checked(name, kernel, plain, arity):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            if out.device.type == "cuda":
                kw.pop("cluster", None)  # the MAC's grouping: no counterpart
                want = plain(*args[:arity], **kw)
                if not torch.equal(out, want):
                    bad = int((out != want).sum())
                    raise KernelMismatch(f"{name} {tuple(args[0].shape)}: {bad} "
                                         "values differ from the plain version")
                with lock:
                    counts[name] = counts.get(name, 0) + 1
            return out
        return call

    for name, (mod, plain, arity) in _CHECKED.items():
        saved[name] = getattr(mod, name)
        setattr(mod, name, checked(name, saved[name], plain, arity))
    try:
        yield counts
    finally:
        for name, (mod, _, _) in _CHECKED.items():
            setattr(mod, name, saved[name])


# ---------------------------------------------------------------------------
# one configuration each
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def runtime(device, **env):
    """The API's runtime on `device` (RUN_CHOICE 2, or 1 for "cpu") under
    `env` (BATCH_SIZE_*, NUM_DEV), put back on the way out."""
    keep = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        with config_mod.run_choice_for(device):
            api.acquire_FPGA_resources()
            try:
                yield
            finally:
                api.release_FPGA_resources()
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config_mod.reset_config()


def transform_rows(rng, n: int, q: int) -> np.ndarray:
    """The reference's corner rows (`scripts/fuzz_hw.py:36-41`), random
    canonical rows, then random 64-bit rows."""
    corners = np.zeros((3, n), dtype=np.uint64)
    corners[1] = q - 1
    corners[2, 0] = 1
    canonical = rng.integers(0, q, size=(RANDOM_ROWS, n), dtype=np.uint64)
    wide = rng.integers(0, 1 << 64, size=(RANDOM_ROWS, n), dtype=np.uint64)
    return np.concatenate([corners, canonical, wide])


def api_transform(device, rows, t, q, n, inverse):
    """Every row through api._NTT (or _INTT) in one worksize and one batch,
    with the caller's tables; returns the transformed copies."""
    bufs = [r.copy() for r in rows]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with runtime(device, BATCH_SIZE_NTT=len(bufs), BATCH_SIZE_INTT=len(bufs)):
            if inverse:
                api._set_worksize_INTT(len(bufs))
                for b in bufs:
                    api._INTT(b, t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, n)
                assert api._INTTCompleted()
            else:
                api._set_worksize_NTT(len(bufs))
                for b in bufs:
                    api._NTT(b, t.fwd, t.fwd_precon, q, n)
                assert api._NTTCompleted()
    return np.stack(bufs)


def check_transform(case: Transform, device, rng) -> int:
    """Returns the number of comparisons made (each exact, else raises)."""
    n, q = case.n, case.q
    t = twiddles.ntt_tables(n, q)
    rows = transform_rows(rng, n, q)
    reduced = rows % np.uint64(q)
    want_fwd = golden.fwd_ntt(reduced, q, t)
    want_inv = golden.inv_ntt(reduced, q, t)
    tabs = ntt_cuda.modulus_tables(n, q, device=device)
    x = w.from_u64_np(rows, device)
    got_fwd = ntt_cuda.ntt_fwd(x, tabs)
    np.testing.assert_array_equal(w.to_u64_np(got_fwd), want_fwd, err_msg="ntt_fwd")
    np.testing.assert_array_equal(w.to_u64_np(ntt_cuda.ntt_inv(got_fwd, tabs)), reduced,
                                  err_msg="round trip")
    np.testing.assert_array_equal(w.to_u64_np(ntt_cuda.ntt_inv(x, tabs)), want_inv,
                                  err_msg="ntt_inv")
    made = 3
    if n in TRANSFORM_N:  # what the API accepts
        # the API's operands are canonical: the corners and the random rows
        canon = reduced[: 3 + RANDOM_ROWS]
        got = api_transform(device, canon, t, q, n, inverse=False)
        np.testing.assert_array_equal(got, want_fwd[: len(canon)], err_msg="_NTT")
        back = api_transform(device, got, t, q, n, inverse=True)
        np.testing.assert_array_equal(back, canon, err_msg="_INTT round trip")
        made += 2
    return made


def check_keyswitch(case: KeySwitch, device) -> int:
    vec = vectors.make_keyswitch_vector(
        case.n, case.L, case.K, seed=case.seed, moduli=list(case.moduli),
        plain_modulus=case.plain_modulus)
    want = vec.expected_output
    args = (vec.input, vec.t_target_iter_ptr, vec.key_vectors, vec.modswitch_factors)
    for fused in (False, True):
        ctx = keyswitch_cuda.KeySwitchContext(
            case.n, case.L, case.K, case.L + 1, 2, vec.moduli, vec.twiddle_factors,
            device=device, fused_mac=fused, plain_modulus=case.plain_modulus)
        np.testing.assert_array_equal(ctx.run(*args), want,
                                      err_msg=f"context fused_mac={fused}")
    res = vec.input.copy()
    with runtime(device):
        api.KeySwitch(res, vec.t_target_iter_ptr, case.n, case.L, case.K, case.L + 1, 2,
                      vec.moduli, vec.key_vectors, vec.modswitch_factors,
                      vec.twiddle_factors, plain_modulus=case.plain_modulus)
        assert api.KeySwitchCompleted()
    np.testing.assert_array_equal(res, want, err_msg="api.KeySwitch")
    return 3


def dyadic_operands(rng, moduli, n: int, factor: int) -> np.ndarray:
    """(1, 2, M, n) operands in [0, factor * q) per modulus, the corners of
    the range first; factor None: any 64-bit values."""
    M = len(moduli)
    if factor is None:
        return rng.integers(0, 1 << 64, size=(1, 2, M, n), dtype=np.uint64)
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, M, 1)
    a = rng.integers(0, 1 << 64, size=(1, 2, M, n), dtype=np.uint64) % (qcol * np.uint64(factor))
    top = qcol[0, 0, :, 0] * np.uint64(factor)
    a[0, :, :, 0], a[0, :, :, 1], a[0, :, :, 2] = 0, top - np.uint64(1), qcol[0, 0, :, 0] - np.uint64(1)
    return a


def check_dyadic(case: Dyadic, device, rng) -> int:
    moduli, n, M = case.moduli, case.n, case.M
    runner = dyadic_cuda.runner(moduli, device)
    made = 0
    for factor in (1, 4, None):
        a, b = (dyadic_operands(rng, moduli, n, factor) for _ in range(2))
        x, y = w.from_u64_np(a, device), w.from_u64_np(b, device)
        got = runner.run(x, y)
        if factor is None:  # beyond MultMod's exact domain: the plain version
            want = dyadic_cuda.dyadic_multiply_plain(x, y, runner.meta)
            assert torch.equal(got, want), "dyadic_mul vs plain on 64-bit operands"
        else:
            np.testing.assert_array_equal(
                w.to_u64_np(got).reshape(-1),
                golden.dyadic_multiply(a, b, n, moduli, M),
                err_msg=f"dyadic operands < {factor}q")
        made += 1
    return made


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@dataclass
class Summary:
    device: str
    seed: int
    configs: int = 0
    comparisons: int = 0
    failures: list = field(default_factory=list)
    by_kind: dict = field(default_factory=dict)
    kernels_vs_plain: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    edges: dict = field(default_factory=dict)
    s: float = 0.0


def edges_of(transforms, keyswitches) -> dict:
    """What the grid reaches: per n the smallest and largest transform
    widths, the 62-bit transform moduli, the KeySwitch moduli widths per
    (n, L)."""
    ntt = {}
    for c in transforms:
        lo, hi = ntt.get(c.n, (c.width, c.width))
        ntt[c.n] = (min(lo, c.width), max(hi, c.width))
    ks = {}
    for c in keyswitches:
        bits = sorted(int(q).bit_length() for q in c.moduli)
        key = f"{c.n}_{c.L}_{c.K}"
        lo, hi = ks.get(key, (bits[0], bits[-1]))
        ks[key] = (min(lo, bits[0]), max(hi, bits[-1]))
    return {
        "ntt_widths_by_n": {str(n): list(v) for n, v in sorted(ntt.items())},
        "ntt_62_bit_moduli": sorted({c.q for c in transforms if c.width == 62}),
        "keyswitch_widths_by_config": {k: list(v) for k, v in sorted(ks.items())},
    }


def run(device="cuda", transforms=None, keyswitches=None, dyadics=None, seed=0,
        echo=print) -> Summary:
    """Every configuration given (grids from transform_grid, keyswitch_grid,
    dyadic_grid), each checked; a failure is recorded and the run goes on."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (the kernels' plain versions)")
    out = Summary(device=name, seed=seed)
    transforms, keyswitches, dyadics = transforms or [], keyswitches or [], dyadics or []
    out.edges = edges_of(transforms, keyswitches)
    plan = ([("ntt", c, lambda c: check_transform(c, device, rng)) for c in transforms]
            + [("keyswitch", c, lambda c: check_keyswitch(c, device)) for c in keyswitches]
            + [("dyadic", c, lambda c: check_dyadic(c, device, rng)) for c in dyadics])
    ntt_cuda.reset_launch_counts()
    dyadic_cuda.reset_launch_counts()
    t_start = time.perf_counter()
    with kernels_vs_plain(out.kernels_vs_plain):
        for kind, case, check in plan:
            t0 = time.perf_counter()
            try:
                made = check(case)
                status = "OK"
            except Exception as exc:  # recorded; the run goes on and exits 1
                made, status = 0, f"FAIL {type(exc).__name__}: {exc}".splitlines()[0]
                out.failures.append({"config": case.name, "error": status})
            out.configs += 1
            out.comparisons += made
            k = out.by_kind.setdefault(kind, {"configs": 0, "s": 0.0})
            k["configs"] += 1
            k["s"] += time.perf_counter() - t0
            echo(f"{case.name}: {status} [{time.perf_counter() - t0:.2f}s]")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out.s = time.perf_counter() - t_start
    out.launches = {k: v for k, v in {**ntt_cuda.LAUNCHES, **dyadic_cuda.LAUNCHES}.items()
                    if v}
    return out


def grids(quick: bool):
    return transform_grid(quick), keyswitch_grid(quick), dyadic_grid(quick)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="the subset of about a minute")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="numpy seed of the operand rows")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("fuzz_card: no CUDA device is available; --device cpu runs the plain "
              "versions", file=sys.stderr)
        return 1
    summary = run(args.device, *grids(args.quick), seed=args.seed,
                  echo=lambda line: print(line, flush=True))
    print(json.dumps({"fuzz_card": {"quick": args.quick, **summary.__dict__}}))
    return 1 if summary.failures else 0


if __name__ == "__main__":
    sys.exit(main())
