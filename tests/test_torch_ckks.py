"""CKKS of the port (`hexl_fpga_tpu_torch/integrations/ckks.py`) on the CPU
against the reference's host context (`hexl_fpga_tpu/integrations/ckks.py`,
its API on the golden executor, RUN_CHOICE=0).  Keys, encodings,
ciphertexts and every operation that is not hoisted: bit for bit (the port's
host context through its own API on the plain kernels, RUN_CHOICE=1, and the
port's evaluator with device="cpu").  Hoisted rotations and the matrix-vector
product: fused against unfused bit for bit, and decrypted to noise as the
reference's tests hold them (1e-2 on values of order 1)."""

import math
import os

import numpy as np
import pytest
import torch

from hexl_fpga_tpu import api as japi, config as jconfig
from hexl_fpga_tpu.integrations import ckks as jckks
from hexl_fpga_tpu.ops import word64 as jw
from hexl_fpga_tpu.utils import vectors as jvectors
from hexl_fpga_tpu_torch import api, config, convert
from hexl_fpga_tpu_torch.integrations import ckks
from hexl_fpga_tpu_torch.ops import (
    dyadic_cuda, galois_cuda, golden, keyswitch_cuda, nt, twiddles,
)
from hexl_fpga_tpu_torch.utils import vectors

N = 1024
SCALE = 2.0 ** 45
MODULI = [int(q) for q in nt.generate_primes(4, 45, N)]  # 3 decomp + special
ROT_STEPS = (1, 2, 3, 4, 8, 12)  # the babies and giants of the matvecs below
NOISE = 1e-2


@pytest.fixture(scope="module")
def runtimes():
    """Both packages' runtimes: the reference on its golden executor, the
    port on its plain kernels."""
    saved = os.environ.get("RUN_CHOICE")
    os.environ["RUN_CHOICE"] = "0"
    jconfig.reset_config()
    japi.acquire_FPGA_resources()
    os.environ["RUN_CHOICE"] = "1"
    config.reset_config()
    api.acquire_FPGA_resources()
    yield
    api.release_FPGA_resources()
    japi.release_FPGA_resources()
    if saved is None:
        os.environ.pop("RUN_CHOICE", None)
    else:
        os.environ["RUN_CHOICE"] = saved
    config.reset_config()
    jconfig.reset_config()


@pytest.fixture(scope="module")
def pair(runtimes):
    """(reference context, port context on the SAME keys via convert): every
    rotation key the tests use is drawn by the reference first."""
    J = jckks.CkksContext(N, MODULI, SCALE, seed=1)
    for r in ROT_STEPS:
        J.galois_keys(r)
    J._galois_keys_for(2 * N - 1)
    P = convert.scheme_context_from_state(
        N, MODULI, J.s, J.relin_keys, J._rot_keys, scale=SCALE, seed=7)
    return J, P


@pytest.fixture(scope="module")
def ev(pair):
    return ckks.DeviceCkksEvaluator(pair[1], device="cpu")


def vec(seed, complex_=True, scale=0.5):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(N // 2) * scale
    return z + 1j * rng.standard_normal(N // 2) * scale if complex_ else z


@pytest.fixture(scope="module")
def cts(pair):
    """Two ciphertexts at the top level, encrypted by the port."""
    P = pair[1]
    return P.encrypt(vec(1)), P.encrypt(vec(2))


def test_keys_encoding_and_encryption_equal_reference(runtimes):
    """Fresh contexts from one seed: the secret, the relinearization and
    rotation keys, the embedding, encode, two encryptions and decrypt are
    the reference's, bit for bit (the same draws in the same order)."""
    J = jckks.CkksContext(N, MODULI, SCALE, seed=3)
    P = ckks.CkksContext(N, MODULI, SCALE, seed=3)
    assert P.s == J.s
    for a, b in zip(P.relin_keys, J.relin_keys):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.E, J.E)
    np.testing.assert_array_equal(P.twiddle_factors, J.twiddle_factors)
    assert P.modswitch_factors == J.modswitch_factors
    z = vec(4)
    assert P.encode(z) == J.encode(z)
    assert P.encode(z, scale=2.0 ** 30) == J.encode(z, scale=2.0 ** 30)
    for g in (pow(5, 1, 2 * N), 2 * N - 1):
        for a, b in zip(P._galois_keys_for(g), J._galois_keys_for(g)):
            np.testing.assert_array_equal(a, b)
    for seed in (5, 6):
        z = vec(seed)
        cp, cj = P.encrypt(z), J.encrypt(z)
        np.testing.assert_array_equal(cp.data, cj.data)
        assert (cp.level, cp.scale) == (cj.level, cj.scale)
        np.testing.assert_array_equal(P.decrypt(cp), J.decrypt(cj))
        assert np.max(np.abs(P.decrypt(cp) - z)) < 1e-4


@pytest.mark.parametrize("n", [8, 64, 256])
def test_exact_products_equal_schoolbook(n):
    """The vectorised negacyclic products and automorphism against the
    reference's loops (`vectors._negacyclic_mul`, the automorphism)."""
    rng = np.random.default_rng(n)
    s = [int(v) for v in rng.integers(-1, 2, size=n)]
    want = jvectors._negacyclic_mul(s, s, 1 << 127)
    assert ckks._negacyclic_square_small(s) == [
        v if v < (1 << 126) else v - (1 << 127) for v in want]
    moduli = [int(q) for q in nt.generate_primes(3, 45, n)]
    Q = math.prod(moduli)
    a = [(int(v) << 80) % Q for v in rng.integers(0, 1 << 62, size=n)]
    tabs = [twiddles.ntt_tables(n, q) for q in moduli]
    assert ckks._negacyclic_mul_crt(a, s, moduli, tabs) == vectors._negacyclic_mul(a, s, Q)
    q = moduli[0]
    c = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    c[:, :3] = 0
    for g in (3, 5, 2 * n - 1):
        got = ckks._automorphism_np(c, g, q)
        for k in range(2):
            assert [int(v) for v in got[k]] == jckks._negacyclic_automorphism(
                [int(v) for v in c[k]], g, n, q)


def _op(ctx, name, a, b):
    """One named operation on a host context or an evaluator (the same
    method names)."""
    if name == "multiply_relin":
        return ctx.multiply_relin(a, b)
    if name == "rescale":
        return ctx.rescale(ctx.multiply_relin(a, b))
    if name == "mod_switch_to_next":
        return ctx.mod_switch_to_next(a)
    if name in ("add", "sub"):
        return getattr(ctx, name)(a, b)
    if name in ("add_plain", "multiply_plain"):
        return getattr(ctx, name)(a, vec(9))
    if name == "conjugate":
        return ctx.conjugate(a)
    return ctx.rotate(a, int(name.split("_")[1]))


HOST_OPS = ["multiply_relin", "rescale", "mod_switch_to_next", "add", "sub",
            "add_plain", "multiply_plain", "conjugate", "rotate_1", "rotate_3"]


@pytest.mark.parametrize("name", HOST_OPS)
def test_host_ops_equal_reference(pair, cts, name):
    J, P = pair
    got = _op(P, name, *cts)
    want = _op(J, name, *cts)
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)


@pytest.mark.parametrize("name", HOST_OPS)
def test_evaluator_ops_equal_reference_host(pair, ev, cts, name):
    """Every non-hoisted evaluator op on the CPU equals the reference's host
    context bit for bit (the reference's own device evaluator is held to it
    the same way, `tests/test_ckks.py:126-190`)."""
    J, _ = pair
    got = ev.to_host(_op(ev, name, *(ev.stage(c) for c in cts)))
    want = _op(J, name, *cts)
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)


def test_evaluator_after_rescale_has_idle_moduli(pair, ev, cts):
    """After a rescale the keyswitch context has K > nl + 1 (a modulus
    between the active ones and the special prime is idle), and the
    scheme's key lists are longer than nl: rotate and multiply_relin there
    equal the reference's host context."""
    J, _ = pair
    low = J.rescale(J.multiply_relin(*cts))
    assert low.level + 1 < J.K - 1
    h = ev.stage(low)
    for got, want in ((ev.rotate(h, 1), J.rotate(low, 1)),
                      (ev.multiply_relin(h, h), J.multiply_relin(low, low))):
        np.testing.assert_array_equal(ev.to_host(got).data, want.data)


def test_keyswitch_takes_the_first_L_keys():
    """A key list longer than L contributes its first L (golden.keyswitch's
    semantics); before, the port's MAC broadcast L rows against L + 1."""
    v = vectors.make_keyswitch_vector(N, 3, 4, seed=1, modulus_bits=45)
    ctx = keyswitch_cuda.KeySwitchContext(N, 2, 4, 3, 2, v.moduli,
                                          v.twiddle_factors, device="cpu")
    r = v.input.reshape(2, 3, N)[:, :2].reshape(1, -1)
    t = v.t_target_iter_ptr[: 2 * N][None]
    want = golden.keyswitch(r[0], t[0], N, 2, 4, 3, 2, v.moduli, v.key_vectors,
                            v.modswitch_factors, v.twiddle_factors)
    got = ctx.run_batch(r, t, v.key_vectors, v.modswitch_factors)
    np.testing.assert_array_equal(got[0], want)


def test_rotate_many_fused_equals_unfused_and_decrypts(pair, ev, cts, monkeypatch):
    """The batched hoisted apply equals rotate_hoisted per step bit for bit,
    in one chunk and in chunks of one (HEXL_TPU_ROT_MANY_MAX_MB=0); every
    rotation decrypts to the rotated slots."""
    P = pair[1]
    h = ev.stage(cts[0])
    steps = [0, 1, 2, 3]
    unfused = ev.rotate_many(h, steps, fused=False)
    fused = ev.rotate_many(h, steps)
    monkeypatch.setenv("HEXL_TPU_ROT_MANY_MAX_MB", "0")
    chunked = ev.rotate_many(h, steps)
    assert fused[0] is h
    z = vec(1)
    for r, a, b, c in zip(steps, unfused, fused, chunked):
        assert torch.equal(a.data, b.data) and torch.equal(a.data, c.data), r
        err = np.max(np.abs(P.decrypt(ev.to_host(b)) - np.roll(z, -r)))
        assert err < NOISE, (r, err)


def test_hoisted_rotations_decrypt_to_noise(pair, ev, cts):
    """rotate_hoisted and conjugate_hoisted from one hoisted decomposition,
    at the top level and after a rescale (idle moduli): the rotated or
    conjugated slots, to noise."""
    P = pair[1]
    z = vec(1)
    hh = ev.hoist(ev.stage(cts[0]))
    for r in (1, 3):
        back = P.decrypt(ev.to_host(ev.rotate_hoisted(hh, r)))
        assert np.max(np.abs(back - np.roll(z, -r))) < NOISE
    back = P.decrypt(ev.to_host(ev.conjugate_hoisted(hh)))
    assert np.max(np.abs(back - np.conj(z))) < NOISE
    low = ev.rescale(ev.multiply_plain(ev.stage(cts[0]), np.full(N // 2, 0.5)))
    assert low.level + 1 < P.K - 1
    for r, o in zip((1, 2), ev.rotate_many(low, [1, 2])):
        back = P.decrypt(ev.to_host(o))
        assert np.max(np.abs(back - np.roll(0.5 * z, -r))) < NOISE


@pytest.mark.parametrize("diag_idx,n1", [
    (tuple(range(16)), 4),   # the benchmark's matvec shape
    ((0, 1, 5, 9, 14), 4),   # sparse groups, a group without its 0 diagonal
    ((0, 1, 3), 8),          # no giant step
    ((0,), 1),               # no rotation at all
])
def test_linear_transform_fused_equals_unfused(pair, ev, cts, diag_idx, n1):
    """linear_transform_fused, its program and linear_transform: the same
    bits; the result decrypts to the matrix-vector product."""
    P = pair[1]
    rng = np.random.default_rng(len(diag_idx) + n1)
    diags = {d: rng.standard_normal(N // 2) * 0.5 for d in diag_idx}
    h = ev.stage(cts[1])
    ref = ev.linear_transform(h, diags, bsgs_n1=n1)
    out, program = ev.linear_transform_fused(h, diags, bsgs_n1=n1,
                                             return_program=True)
    assert out.level == ref.level and out.scale == ref.scale == SCALE * SCALE
    assert torch.equal(out.data, ref.data)
    assert program.graph is None  # no graph off the card
    assert torch.equal(program(h.data), ref.data)
    assert torch.equal(ev.linear_transform_fused(h, diags, bsgs_n1=n1).data, ref.data)
    z = vec(2)
    want = sum(diags[d] * np.roll(z, -d) for d in diags)
    assert np.max(np.abs(P.decrypt(ev.to_host(out)) - want)) < NOISE


@pytest.mark.parametrize("form", ["u64", "tensor"])
@pytest.mark.parametrize("diag_idx,n1", [
    (tuple(range(16)), 4),   # the benchmark's matvec shape, cut to N
    ((0, 1, 5, 9, 14), 4),   # sparse groups, a group without its 0 diagonal
])
def test_encoded_diagonals_equal_slot_vectors(pair, ev, cts, diag_idx, n1, form):
    """A matrix staged from diagonals already encoded (the NTT planes of
    roll(u_d, j*n1) at the context's scale, as u64 words or int64 tensors)
    gives linear_transform_fused's bits on slot vectors, eager and through
    its program, and decrypts to M z."""
    P = pair[1]
    rng = np.random.default_rng(len(diag_idx) + n1)
    diags = {d: rng.standard_normal(N // 2) * 0.5 for d in diag_idx}
    h = ev.stage(cts[1])
    nl = h.level + 1
    planes = {d: P._to_ntt_limbs(P.encode(np.roll(u, d // n1 * n1)), nl)
              for d, u in diags.items()}
    if form == "tensor":
        planes = {d: torch.from_numpy(p.view(np.int64)) for d, p in planes.items()}
    want = ev.linear_transform_fused(h, diags, bsgs_n1=n1)
    lt = ev.stage_linear_transform(planes, h.level, n1, encoded=True)
    got = lt(h)
    assert torch.equal(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)
    program = lt.program(h.data)
    assert torch.equal(program(h.data), want.data)
    z = vec(2)
    want_z = sum(diags[d] * np.roll(z, -d) for d in diags)
    assert np.max(np.abs(P.decrypt(ev.to_host(got)) - want_z)) < NOISE


def test_counters_count_each_route(ev, cts):
    """ROTATIONS by route and LINEAR_TRANSFORMS by body; reset_counters
    zeroes both.  rotate and conjugate go through dispatch_batch's body
    cache, a giant step of the product is launched one by one; off the card
    every program call is an eager body."""
    def rotations(dispatched, eager, hoisted, rows):
        return {"dispatched": dispatched, "eager": eager, "hoisted": hoisted,
                "hoisted_rows": rows}

    ckks.reset_counters()
    assert ckks.ROTATIONS == rotations(0, 0, 0, 0)
    assert ckks.LINEAR_TRANSFORMS == {"captures": 0, "replays": 0, "eager": 0}
    h = ev.stage(cts[0])
    graphs = dict(keyswitch_cuda.GRAPHS)
    ev.rotate(h, 1)
    ev.conjugate(h)
    assert ckks.ROTATIONS == rotations(2, 0, 0, 0)
    assert keyswitch_cuda.GRAPHS["eager"] == graphs["eager"] + 2
    ev.rotate_hoisted(ev.hoist(h), 2)
    ev.rotate_many(h, [0, 1, 2, 3])
    assert ckks.ROTATIONS == rotations(2, 0, 1, 3)
    rng = np.random.default_rng(5)
    diags = {d: rng.standard_normal(N // 2) * 0.5 for d in range(16)}
    _, program = ev.linear_transform_fused(h, diags, bsgs_n1=4, return_program=True)
    assert ckks.LINEAR_TRANSFORMS == {"captures": 0, "replays": 0, "eager": 1}
    assert ckks.ROTATIONS == rotations(2, 3, 1, 6)
    program(h.data)
    program(h.data)
    assert ckks.LINEAR_TRANSFORMS == {"captures": 0, "replays": 0, "eager": 3}
    assert ckks.ROTATIONS == rotations(2, 9, 1, 12)
    assert keyswitch_cuda.GRAPHS["eager"] == graphs["eager"] + 2
    ckks.reset_counters()
    assert not any(ckks.ROTATIONS.values()) and not any(ckks.LINEAR_TRANSFORMS.values())


def test_context_builds_the_embedding_at_its_first_encode(runtimes):
    """A fresh context holds no E until an encode or decode needs it; then
    E and encode's integers are the reference's, and the draws are the
    same (E draws nothing)."""
    J = jckks.CkksContext(N, MODULI, SCALE, seed=8)
    P = ckks.CkksContext(N, MODULI, SCALE, seed=8)
    assert "E" not in vars(P)
    assert P._rng.bit_generator.state == J._rng.bit_generator.state
    for a, b in zip(P.galois_keys(1), J.galois_keys(1)):
        np.testing.assert_array_equal(a, b)
    assert "E" not in vars(P)
    z = vec(10)
    assert P.encode(z) == J.encode(z)
    assert "E" in vars(P)
    np.testing.assert_array_equal(P.E, J.E)
    Q = ckks.CkksContext(N, MODULI, SCALE, seed=8)
    np.testing.assert_array_equal(Q.decode(J.encode(z), SCALE), J.decode(J.encode(z), SCALE))
    with pytest.raises(AttributeError):
        Q.not_an_attribute


def test_linear_transform_program_reads_only_what_it_staged(ev, cts, monkeypatch):
    """A captured graph replays raw pointers, so once built the program must
    read no key, Galois index or constant from a cache that may evict and
    free it: it runs with every such lookup refused, to the same bits."""
    rng = np.random.default_rng(21)
    diags = {d: rng.standard_normal(N // 2) * 0.5 for d in range(16)}
    h = ev.stage(cts[1])
    out, program = ev.linear_transform_fused(h, diags, bsgs_n1=4,
                                             return_program=True)

    def refused(*args, **kwargs):
        raise AssertionError("the program looked a tensor up in a cache")

    monkeypatch.setattr(ev._ks_ctx(h.level + 1), "device_keys", refused)
    monkeypatch.setattr(galois_cuda, "galois_index", refused)
    monkeypatch.setattr(dyadic_cuda, "runner", refused)
    assert torch.equal(program(h.data), out.data)


def test_convert_round_trips(pair, ev, cts):
    """State and handles across the packages: the context built from the
    reference's state holds its keys; a reference `data32` (the layout its
    evaluator stages) becomes the port's handle and back."""
    J, P = pair
    assert P.s == J.s and P.n == J.n and P.moduli == J.moduli
    assert sorted(P._rot_keys) == sorted(J._rot_keys)
    for g in J._rot_keys:
        for a, b in zip(P._rot_keys[g], J._rot_keys[g]):
            np.testing.assert_array_equal(a, b)
    ct = cts[0]
    data32 = jw.to_interleaved_np(ct.data)
    h = convert.ckks_handle_from_data32(data32, ct.level, ct.scale, device="cpu")
    assert torch.equal(h.data, ev.stage(ct).data)
    assert (h.level, h.scale) == (ct.level, ct.scale)
    np.testing.assert_array_equal(convert.ckks_handle_to_data32(h), data32)
    np.testing.assert_array_equal(jw.from_interleaved_np(
        convert.ckks_handle_to_data32(h)).reshape(ct.data.shape), ct.data)


def test_evaluator_on_cuda_raises_without_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckks.DeviceCkksEvaluator(pair[1])
