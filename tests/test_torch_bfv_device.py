"""The port's device-resident BFV multiply (`integrations/bfv.py`,
`DeviceBfvEvaluator`) on the CPU, where every kernel runs its plain version:
against the host BehzTool through `BfvContext.multiply_rns`, against the
benchmark's plain reference (`hebench/reference/behz.py`, which shares no
code with the port), and that reference against the textbook product within
BEHZ's fast-floor bound.  Exact integer pipelines: zero tolerance.  Also the
multiply bodies' counter `rns_behz_cuda.GRAPHS`."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from hexl_fpga_tpu_torch.integrations import BfvContext, DeviceBfvEvaluator
from hexl_fpga_tpu_torch.integrations.ckks import Ciphertext
from hexl_fpga_tpu_torch.ops import nt, rns_behz_cuda, word64 as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hebench.reference.behz import M_TILDE, BehzMultiply  # noqa: E402

T = 65537


def context(n, k, bits, seed=0):
    """A BfvContext over k primes of `bits` bits and a special prime."""
    return BfvContext(n, [int(p) for p in nt.generate_primes(k + 1, bits, n)], T,
                      seed=seed)


def words(ctx, k, batch, seed):
    """Two (batch, 2, k, n) u64 batches of NTT words uniform below each
    limb's modulus."""
    rng = np.random.default_rng(seed)
    qcol = np.array(ctx.moduli[:k], dtype=np.uint64).reshape(1, 1, k, 1)
    return [rng.integers(0, 1 << 62, size=(batch, 2, k, ctx.n), dtype=np.uint64) % qcol
            for _ in range(2)]


@pytest.mark.parametrize("k,batch,bits", [(2, 1, 45), (2, 3, 45), (3, 1, 52),
                                          (3, 3, 52)])
def test_multiply_equals_multiply_rns(k, batch, bits):
    """Encrypted pairs at n = 128, staged, multiplied on the evaluator:
    row by row the bits of the host BehzTool."""
    ctx = context(128, k, bits, seed=k + batch)
    rng = np.random.default_rng(bits)
    cts = [[ctx.encrypt(rng.integers(0, T, size=ctx.n, dtype=np.uint64))
            for _ in range(batch)] for _ in range(2)]
    ev = DeviceBfvEvaluator(ctx, device="cpu")
    x1, x2 = ev.stage(cts[0]), ev.stage(cts[1])
    assert x1.shape == (batch, 2, k, ctx.n) and x1.dtype == torch.int64
    got = ev.to_host(ev.multiply(x1, x2))
    assert got.shape == (batch, 3, k, ctx.n) and got.dtype == np.uint64
    for b in range(batch):
        want, _ = ctx.multiply_rns(cts[0][b], cts[1][b], device=False)
        np.testing.assert_array_equal(got[b], want, err_msg=f"row {b}")


def test_multiply_below_the_top_level():
    """Ciphertexts one mod switch down (k = 2 of a 3-prime chain) multiply
    under that level's BEHZ, as multiply_rns does."""
    ctx = context(128, 3, 45, seed=6)
    rng = np.random.default_rng(6)
    cts = [ctx.mod_switch_to_next(ctx.encrypt(rng.integers(0, T, size=ctx.n,
                                                           dtype=np.uint64)))
           for _ in range(2)]
    ev = DeviceBfvEvaluator(ctx, device="cpu")
    x1, x2 = ev.stage(cts[:1]), ev.stage(cts[1:])
    assert x1.shape == (1, 2, 2, ctx.n)
    want, _ = ctx.multiply_rns(cts[0], cts[1], device=False)
    np.testing.assert_array_equal(ev.to_host(ev.multiply(x1, x2))[0], want)


def test_multiply_equals_the_plain_reference():
    ctx = context(128, 3, 52, seed=4)
    c1, c2 = words(ctx, 3, 3, seed=5)
    ev = DeviceBfvEvaluator(ctx, device="cpu")
    got = ev.to_host(ev.multiply(ev.stage(c1), ev.stage(c2)))
    ref = BehzMultiply(ctx.n, ctx.moduli[:3], ctx._behz(3).Bsk, T)
    want = ref(*(torch.from_numpy(c.view(np.int64)) for c in (c1, c2)))
    np.testing.assert_array_equal(got, want.numpy().view(np.uint64))


@pytest.mark.parametrize("k,bits", [(2, 45), (3, 52)])
def test_reference_is_the_textbook_product_within_the_fast_floor(k, bits):
    """The reference's product, taken back to coefficients, against the
    textbook round(t d / Q) of the centred lifts (`BfvContext.multiply`).

    The bound, per coefficient (Q the product of the k primes, m~ = 2^32):
      * SmMRq gives z = (c + Q r) / m~ with c = [x m~]_Q + a Q, 0 <= a < k,
        and r in [-m~/2, m~/2): so z = x mod Q and -Q/2 <= z < Q/2 + kQ/m~.
        z is the centred lift x_c unless x_c < -Q/2 + kQ/m~, which no input
        here meets (checked below; a share k/2^32 of uniform words would).
      * So the tensor under q and Bsk holds the integer products D of the
        centred lifts, the textbook's, and Bsk's range holds t D / Q.
      * The fast floor gives g = (t D - [t D]_Q - b Q) / Q = floor(t D / Q) - b,
        with 0 <= b < k the overflow of its fast conversion; Shenoy-Kumaresan
        carries g to q exactly.
      * The textbook gives round(t D / Q), floor(t D / Q) or one more.
    So BEHZ minus the textbook is -b or -b - 1: in [-k, 0] mod Q."""
    ctx = context(64, k, bits, seed=k)
    c1, c2 = words(ctx, k, 1, seed=bits)
    Q = math.prod(ctx.moduli[:k])
    for c in (c1, c2):
        for j in range(2):
            # x_c >= -Q/2 + kQ/m~, in integers
            assert all(2 * M_TILDE * x + Q * M_TILDE >= 2 * k * Q
                       for x in ctx._lift_centered(c[0, j], k))
    ref = BehzMultiply(ctx.n, ctx.moduli[:k], ctx._behz(k).Bsk, T)
    got = ref(*(torch.from_numpy(c.view(np.int64)) for c in (c1, c2)))[0]
    got = got.numpy().view(np.uint64)
    want, _ = ctx.multiply(*(Ciphertext(data=c[0], level=k - 1, scale=1.0)
                             for c in (c1, c2)))
    diffs = set()
    for j in range(3):
        a, b = ctx._lift_centered(got[j], k), ctx._lift_centered(want[j], k)
        diffs |= {(u - v + Q // 2) % Q - Q // 2 for u, v in zip(a, b)}
    assert diffs <= set(range(-k, 1)), sorted(diffs)


def _pair(batch=2):
    ctx = context(64, 2, 45, seed=9)
    ev = DeviceBfvEvaluator(ctx, device="cpu")
    return ctx, ev, [ev.stage(c) for c in words(ctx, 2, batch, seed=10)]


class _Captured:
    """A GraphProgram stand-in that holds a "graph" off the card: a call is
    the eager composition, as a replay gives its bits."""

    def __init__(self, run, *examples):
        self.eager, self.graph = run, object()

    def __call__(self, *xs):
        return self.eager(*xs)


def test_graphs_counts_eager_bodies_off_the_card():
    ctx, ev, (x1, x2) = _pair()
    behz = ctx._behz_cuda(2, "cpu")
    before = dict(rns_behz_cuda.GRAPHS)
    want = behz.multiply_tensors(x1, x2)
    assert torch.equal(ev.multiply(x1, x2), want)
    assert torch.equal(behz.program(2)(x1, x2), want)
    after = rns_behz_cuda.GRAPHS
    assert after["eager"] - before["eager"] == 3
    assert after["captures"] == before["captures"] and after["replays"] == before["replays"]


def test_graphs_counts_one_capture_then_replays(monkeypatch):
    monkeypatch.setattr(rns_behz_cuda, "GraphProgram", _Captured)
    ctx, ev, (x1, x2) = _pair()
    behz = ctx._behz_cuda(2, "cpu")
    before = dict(rns_behz_cuda.GRAPHS)
    want = behz._compose(x1, x2)  # uncounted
    assert rns_behz_cuda.GRAPHS == before
    for _ in range(3):
        assert torch.equal(ev.multiply(x1, x2), want)
    assert behz.program(2).graph is not None and behz.program(2) is behz.program(2)
    after = rns_behz_cuda.GRAPHS
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 3
    assert after["eager"] == before["eager"]


def test_stage_and_to_host():
    """stage takes ciphertexts of one level or u64 words, and refuses words
    at or above their modulus, another n, or more limbs than the chain's
    decomp moduli; to_host gives the words back."""
    ctx = context(64, 2, 45, seed=3)
    ev = DeviceBfvEvaluator(ctx, device="cpu")
    c1, _ = words(ctx, 2, 2, seed=4)
    np.testing.assert_array_equal(ev.to_host(ev.stage(c1)), c1)
    cts = [Ciphertext(data=c, level=1, scale=1.0) for c in c1]
    assert torch.equal(ev.stage(cts), w.from_u64_np(c1))
    one = Ciphertext(data=c1[0, :, :1], level=0, scale=1.0)
    assert ev.stage([one]).shape == (1, 2, 1, ctx.n)
    with pytest.raises(ValueError, match="one level"):
        ev.stage([cts[0], one])
    bad = c1.copy()
    bad[1, 0, 1, 7] = ctx.moduli[1]
    with pytest.raises(ValueError, match="canonical"):
        ev.stage(bad)
    with pytest.raises(ValueError, match="words"):
        ev.stage(c1[..., :32])
    wide = np.zeros((1, 2, 3, ctx.n), dtype=np.uint64)
    with pytest.raises(ValueError, match="limbs"):
        ev.stage(wide)
    x = ev.stage(c1)
    with pytest.raises(ValueError, match="one shape"):
        ev.multiply(x, x[:1])


def test_cuda_without_a_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBfvEvaluator(context(64, 2, 45), device="cuda")
