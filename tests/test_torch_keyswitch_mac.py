"""The KeySwitch engines' lazy key MAC (`ntt_cuda.keyswitch_mac`): one
hand-written kernel for the default schedule's `deferred` MAC.

On the CPU its plain version (the torch composition the kernel replaces) is
held bit for bit against the JAX package's approximate-quotient lazy MAC,
built from `hexl_fpga_tpu.ops.word64` (`mulhi64_approx`, `mullo64`, wrapping
sums, one `sub64` close, as `keyswitch_tpu._mac_term` / `_mac_close` compose
it), at every broadcast form its callers give it: one key row for the batch
(the engines), one key row per batch row (hoisted applies), one source row
for S key rows (`_apply_hoisted_many`) and a single limb (the fused route's
identity limb); at q just under 2^52 and near 2^16, on uniform 64-bit and
all-ones limbs, on keys at q - 1.  The sums are also held to their contract,
below 28q and equal to the exact sum mod q; and KeySwitchContext is held to
route every deferred MAC through the wrapper and no exact128 one.

The card tests hold the kernel to its plain version word for word at the
engines' shapes, with strided and unaligned operands, and a default
`dispatch_batch` at 16384_6_7_7_2 to 7 launches and the port's golden model.
They run with the hardware tier; the card has no JAX:

  HEXL_TORCH_HW_TESTS=1 python -m pytest --noconftest -p no:cacheprovider tests/test_torch_keyswitch_mac.py -q

Tolerance: zero."""

import glob
import os

import numpy as np
import pytest
import torch

from hexl_fpga_tpu_torch.ops import golden, keyswitch_cuda, nt, ntt_cuda, word64 as w
from hexl_fpga_tpu_torch.utils import vectors

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
Q52 = (1 << 52) - 47  # a prime just under 2^52
Q16 = 65537           # a prime near 2^16
ALL_ONES = (1 << 64) - 1

# (limbs, comp, Bv, Bk): the callers' broadcast forms
SHAPES = {
    "engine": (6, 2, 3, 1),          # default and sharded engines
    "engine_batch_1": (6, 2, 1, 1),  # batch 1 (seal_call)
    "identity_limb": (1, 2, 3, 1),   # fused route's identity limb
    "per_row_keys": (6, 2, 3, 3),    # _apply_hoisted: one key row per batch row
    "one_source_S_keys": (6, 2, 1, 4),  # _apply_hoisted_many: Bv = 1, Bk = S
    "seven_limbs": (7, 2, 2, 1),     # the contract's widest sum
}


def make_operands(shape, q, n, seed, val_kind="uniform", key_kind="uniform"):
    """u64 numpy val (L, Bv, n), key and precon (L, comp, Bk, n)."""
    L, comp, Bv, Bk = shape
    rng = np.random.default_rng(seed)
    if val_kind == "ones":
        val = np.full((L, Bv, n), ALL_ONES, dtype=np.uint64)
    else:
        val = rng.integers(0, 1 << 64, size=(L, Bv, n), dtype=np.uint64)
    if key_kind == "q-1":
        key = np.full((L, comp, Bk, n), q - 1, dtype=np.uint64)
    else:
        key = rng.integers(0, q, size=(L, comp, Bk, n), dtype=np.uint64)
    return val, key, w.precon64_np(key, q)


def jax_lazy_mac(val, key, kp, q):
    """The JAX package's deferred lazy MAC on (lo, hi) uint32 pairs:
    sum over limbs of mullo64(key, val) and of mulhi64_approx(val, kp), each
    wrapping, then sum_wx - sum_Q * q."""
    from hexl_fpga_tpu.ops import word64 as jw

    L, comp, Bk, n = key.shape
    B = max(val.shape[1], Bk)
    shape = (comp, B, n)
    acc_wx = acc_q = None
    for i in range(L):
        v = jw.to_pair_np(np.broadcast_to(val[i][None], shape))
        k = jw.to_pair_np(np.broadcast_to(key[i], shape))
        p = jw.to_pair_np(np.broadcast_to(kp[i], shape))
        wx, Q = jw.mullo64(k, v), jw.mulhi64_approx(v, p)
        acc_wx = wx if acc_wx is None else jw.add64(acc_wx, wx)
        acc_q = Q if acc_q is None else jw.add64(acc_q, Q)
    lo, hi = jw.sub64(acc_wx, jw.mullo64(acc_q, q))
    return jw.from_pair_np(np.asarray(lo), np.asarray(hi))


def exact_sum_mod_q(val, key, q):
    """sum_i val * key mod q, in Python integers."""
    v = val.astype(object)[:, None]
    return ((v * key.astype(object)).sum(0) % q).astype(np.uint64)


def check_contract(out, val, key, q):
    """out (comp, B, n) u64: a lazy sum below 28q of the exact sum mod q."""
    assert int(out.max()) < 28 * q, "lazy sum out of range"
    np.testing.assert_array_equal(out % np.uint64(q), exact_sum_mod_q(val, key, q))


# -- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("q", [Q52, Q16], ids=["q52", "q16"])
def test_plain_matches_jax_lazy_mac(name, q):
    shape = SHAPES[name]
    n = 64
    val, key, kp = make_operands(shape, q, n, seed=shape[0] * 10 + shape[3])
    got = w.to_u64_np(ntt_cuda.keyswitch_mac_plain(
        w.from_u64_np(val), w.from_u64_np(key), w.from_u64_np(kp), q))
    L, comp, Bv, Bk = shape
    assert got.shape == (comp, max(Bv, Bk), n)
    np.testing.assert_array_equal(got, jax_lazy_mac(val, key, kp, q))
    check_contract(got, val, key, q)


@pytest.mark.parametrize("val_kind,key_kind", [
    ("ones", "uniform"), ("uniform", "q-1"), ("ones", "q-1")])
@pytest.mark.parametrize("q", [Q52, Q16], ids=["q52", "q16"])
def test_plain_edges_match_jax_lazy_mac(val_kind, key_kind, q):
    """Limbs of 2^64 - 1 and keys at q - 1, where the approximate quotient
    falls furthest short."""
    val, key, kp = make_operands(SHAPES["seven_limbs"], q, 32, seed=5,
                                 val_kind=val_kind, key_kind=key_kind)
    got = w.to_u64_np(ntt_cuda.keyswitch_mac_plain(
        w.from_u64_np(val), w.from_u64_np(key), w.from_u64_np(kp), q))
    np.testing.assert_array_equal(got, jax_lazy_mac(val, key, kp, q))
    check_contract(got, val, key, q)


def test_wrapper_on_strided_views_is_the_plain_version():
    """The callers' views (a limb taken out of (B, L, n) targets, a column of
    the staged (L, comp, K, n) keys, the permuted column of a stacked
    (S, L, comp, K, n) key set) give what contiguous copies give."""
    rng = np.random.default_rng(9)
    n, L, K, B, S = 32, 3, 4, 2, 3
    moduli = [int(p) for p in nt.generate_primes(K, 50, n)]
    keys = np.stack([rng.integers(0, q, size=(L, 2, n), dtype=np.uint64)
                     for q in moduli], axis=2)
    kp = np.stack([w.precon64_np(keys[:, :, j], q) for j, q in enumerate(moduli)], axis=2)
    keys_t, kp_t = w.from_u64_np(keys), w.from_u64_np(kp)
    t = w.from_u64_np(rng.integers(0, 1 << 64, size=(B, L, n), dtype=np.uint64))
    j = 1
    col = lambda x: x[j:j + 1, :, j, None, :]
    views = [(t[:, j, :][None], col(keys_t), col(kp_t))]
    stacked_k = torch.stack([keys_t.roll(s, -1) for s in range(S)])
    stacked_p = torch.stack([kp_t.roll(s, -1) for s in range(S)])
    dec = w.from_u64_np(rng.integers(0, 1 << 64, size=(L, 1, n), dtype=np.uint64))
    views.append((dec, stacked_k[:, :, :, j, :].permute(1, 2, 0, 3),
                  stacked_p[:, :, :, j, :].permute(1, 2, 0, 3)))
    for val, key, p in views:
        got = ntt_cuda.keyswitch_mac(val, key, p, moduli[j])
        want = ntt_cuda.keyswitch_mac_plain(val.contiguous(), key.contiguous(),
                                            p.contiguous(), moduli[j])
        assert got.is_contiguous()
        assert torch.equal(got, want)


def test_wrapper_refuses_what_no_caller_gives():
    x = torch.zeros(2, 3, 16, dtype=torch.int64)
    k = torch.zeros(2, 2, 1, 16, dtype=torch.int64)
    for args in [(x, k[:1], k[:1]),                     # limbs disagree
                 (x, k, k[..., :8]),                    # shapes disagree
                 (x, torch.zeros(2, 2, 2, 16, dtype=torch.int64),
                  torch.zeros(2, 2, 2, 16, dtype=torch.int64)),  # 3 vs 2 rows
                 (x, torch.zeros(2, 3, 1, 16, dtype=torch.int64),
                  torch.zeros(2, 3, 1, 16, dtype=torch.int64)),  # 3 components
                 (x[..., ::2], k[..., ::2], k[..., ::2])]:       # n strided
        with pytest.raises(ValueError):
            ntt_cuda.keyswitch_mac(*args, Q16)
    with pytest.raises(TypeError):
        ntt_cuda.keyswitch_mac(x.int(), k, k, Q16)


@pytest.mark.parametrize("opts,calls", [
    ({}, 3),                          # L + 1 engines
    ({"plain_modulus": 17}, 3),       # the BGV tail: the same engines
    ({"fused_mac": True}, 2),         # the identity limb of each decomp engine
    ({"mac_impl": "exact128"}, 0),    # torch glue, no precons
])
def test_context_routes_deferred_mac_through_the_wrapper(monkeypatch, opts, calls):
    """A batch of the context on the CPU calls keyswitch_mac once an engine
    where the deferred MAC runs, and equals the golden model."""
    n, L, K = 256, 2, 3
    vec = vectors.make_keyswitch_vector(n, L, K, seed=3, modulus_bits=40)
    seen = []
    real = ntt_cuda.keyswitch_mac

    def counted(val, key, kp, q):
        seen.append((tuple(val.shape), tuple(key.shape), q))
        return real(val, key, kp, q)

    monkeypatch.setattr(ntt_cuda, "keyswitch_mac", counted)
    ctx = keyswitch_cuda.KeySwitchContext(n, L, K, L + 1, 2, vec.moduli,
                                          vec.twiddle_factors, device="cpu", **opts)
    got = ctx.run(vec.input, vec.t_target_iter_ptr, vec.key_vectors,
                  vec.modswitch_factors)
    assert len(seen) == calls, seen
    want = golden.keyswitch(vec.input, vec.t_target_iter_ptr, n, L, K, L + 1, 2,
                            vec.moduli, vec.key_vectors, vec.modswitch_factors,
                            vec.twiddle_factors,
                            plain_modulus=opts.get("plain_modulus"))
    np.testing.assert_array_equal(got, want)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    """Decided per test, never at import: runs only in the hardware tier
    with a card."""
    if os.environ.get("HEXL_TORCH_HW_TESTS") != "1":
        pytest.skip("hardware tier: set HEXL_TORCH_HW_TESTS=1 on a machine with a CUDA device")
    if not torch.cuda.is_available():
        pytest.skip("hardware tier: no CUDA device is available")
    return torch.device("cuda")


def kernel_vs_plain(val, key, kp, q):
    """The kernel's words against the plain version's on the same device
    tensors; returns the kernel's as u64 numpy."""
    got = ntt_cuda.keyswitch_mac(val, key, kp, q)
    want = ntt_cuda.keyswitch_mac_plain(val, key, kp, q)
    assert got.shape == want.shape and got.is_contiguous()
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {got.numel()} words differ from the plain version"
    return w.to_u64_np(got)


CARD_SHAPES = [
    (6, 2, 32, 1),   # an engine of a batch of 32
    (6, 2, 1, 1),    # batch 1
    (1, 2, 32, 1),   # the identity limb
    (6, 2, 32, 32),  # per-row keys
    (6, 2, 1, 8),    # one source row, S = 8 key rows
]


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("q", [Q52, Q16], ids=["q52", "q16"])
def test_card_kernel_equals_plain(card, shape, q):
    n = 16384
    val, key, kp = make_operands(shape, q, n, seed=sum(shape))
    got = kernel_vs_plain(*(w.from_u64_np(a, card) for a in (val, key, kp)), q)
    # the contract on a slice (Python integers are slow at full size)
    check_contract(got[..., :256], val[..., :256], key[..., :256], q)


@pytest.mark.card
@pytest.mark.parametrize("val_kind,key_kind", [
    ("ones", "uniform"), ("uniform", "q-1"), ("ones", "q-1")])
def test_card_edges_equal_plain(card, val_kind, key_kind):
    for q in (Q52, Q16):
        val, key, kp = make_operands((7, 2, 32, 1), q, 16384, seed=2,
                                     val_kind=val_kind, key_kind=key_kind)
        got = kernel_vs_plain(*(w.from_u64_np(a, card) for a in (val, key, kp)), q)
        check_contract(got[..., :256], val[..., :256], key[..., :256], q)


@pytest.mark.card
def test_card_strided_and_unaligned_operands(card):
    """The callers' views, and operands that start 8 bytes off a 16-byte
    boundary (the kernel's one-word accesses), against the plain version."""
    rng = np.random.default_rng(17)
    n, L, K, B, S = 16384, 6, 7, 32, 4
    q = Q52
    t = w.from_u64_np(rng.integers(0, 1 << 64, size=(B, L, n), dtype=np.uint64), card)
    keys = w.from_u64_np(rng.integers(0, q, size=(L, 2, K, n), dtype=np.uint64), card)
    kp = w.from_u64_np(w.precon64_np(w.to_u64_np(keys), q), card)
    j = 2
    kernel_vs_plain(t[:, j, :][None], keys[j:j + 1, :, j, None, :],
                    kp[j:j + 1, :, j, None, :], q)
    kernel_vs_plain(t.transpose(0, 1), keys[:, :, j, None, :], kp[:, :, j, None, :], q)
    sk, sp = torch.stack([keys] * S), torch.stack([kp] * S)
    kernel_vs_plain(t[:1].transpose(0, 1).contiguous(),
                    sk[:, :, :, j, :].permute(1, 2, 0, 3), sp[:, :, :, j, :].permute(1, 2, 0, 3), q)
    flat = torch.empty(L * B * n + 1, dtype=torch.int64, device=card)
    off = flat[1:].view(L, B, n)
    off.copy_(t.transpose(0, 1))
    kernel_vs_plain(off, keys[:, :, j, None, :], kp[:, :, j, None, :], q)


@pytest.mark.card
def test_card_dispatch_batch_launches_seven_and_equals_golden(card):
    """A default dispatch_batch at 16384_6_7_7_2, batch 4: 7 keyswitch_mac
    launches (6 decomp engines and the special one), every op against the
    frozen vector or the port's golden model."""
    files = sorted(glob.glob(os.path.join(TESTDATA, "16384_6_7_7_2_*.json*")))
    assert files, "frozen 16384_6_7_7_2 vector missing from tests/testdata/"
    vec = vectors.load_json(files[0])
    n, L, K = vec.coeff_count, vec.decomp_modulus_size, vec.key_modulus_size
    ctx = keyswitch_cuda.get_context(n, L, K, vec.rns_modulus_size, 2, vec.moduli,
                                     vec.twiddle_factors, device=card)
    rng = np.random.default_rng(4)
    rs = np.stack([vec.input] + [
        np.concatenate([rng.integers(0, vec.moduli[j % L], size=n, dtype=np.uint64)
                        for j in range(2 * L)]) for _ in range(3)])
    ts = np.stack([vec.t_target_iter_ptr] + [
        np.concatenate([rng.integers(0, vec.moduli[j], size=n, dtype=np.uint64)
                        for j in range(L)]) for _ in range(3)])
    keyed = (vec.key_vectors, vec.modswitch_factors)
    ctx.dispatch_batch(rs, ts, *keyed)  # stages the keys
    before = ntt_cuda.LAUNCHES["keyswitch_mac"]
    out = ctx.dispatch_batch(rs, ts, *keyed)
    assert ntt_cuda.LAUNCHES["keyswitch_mac"] - before == L + 1
    got = w.to_u64_np(out).reshape(len(rs), -1)
    np.testing.assert_array_equal(got[0], vec.expected_output)
    for i in (1, 3):
        np.testing.assert_array_equal(
            got[i], golden.keyswitch(rs[i], ts[i], n, L, K, vec.rns_modulus_size, 2,
                                     vec.moduli, *keyed, vec.twiddle_factors))
