"""BFV of the port (`hexl_fpga_tpu_torch/integrations/bfv.py`) on the CPU
against the reference's (`hexl_fpga_tpu/integrations/bfv.py`, RUN_CHOICE=0).
BFV is exact: keys, ciphertexts and every operation are compared bit for
bit, and every decryption equals the message mod t.  The host tier at
n = 64, t = 257 (the reference's `tests/test_bfv.py:14-24`), the BEHZ multiply
at n = 128 (`tests/test_rns_behz_tpu.py:72-90`) and the device evaluator's
rotations at n = 1024."""

import os

import numpy as np
import pytest
import torch

from hexl_fpga_tpu import config as jconfig
from hexl_fpga_tpu.integrations import bfv as jbfv
from hexl_fpga_tpu_torch import config, convert
from hexl_fpga_tpu_torch.integrations import BfvContext, bfv, ckks
from hexl_fpga_tpu_torch.ops import nt

N, T = 64, 257


def set_run_choice(value):
    """Set the port's RUN_CHOICE; returns the value to restore."""
    saved = os.environ.get("RUN_CHOICE")
    if value is None:
        os.environ.pop("RUN_CHOICE", None)
    else:
        os.environ["RUN_CHOICE"] = str(value)
    config.reset_config()
    return saved


@pytest.fixture
def run_choice():
    """A test sets the port's RUN_CHOICE through this; the old value comes
    back."""
    saved = os.environ.get("RUN_CHOICE")
    yield set_run_choice
    set_run_choice(saved)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """The reference's host contexts at RUN_CHOICE=0 (its golden executor),
    the port's at 1 (the kernels' plain versions)."""
    saved = set_run_choice(0)
    jconfig.reset_config()
    assert jconfig.get_config().run_choice == 0
    set_run_choice(1)
    yield
    set_run_choice(saved)
    jconfig.reset_config()


def msg(seed, n=N, t=T):
    return np.random.default_rng(seed).integers(0, t, size=n, dtype=np.uint64)


@pytest.fixture(scope="module")
def host():
    """Reference and port contexts from one seed, then the same draws on
    both (rotation keys, four encryptions)."""
    moduli = nt.generate_primes(4, 40, N)  # 3 decomp + special
    J = jbfv.BfvContext(N, moduli, t=T, seed=4)
    P = bfv.BfvContext(N, moduli, t=T, seed=4)
    for c in (J, P):
        c.galois_keys(3)
        c._galois_keys_for(2 * N - 1)
    zs = [msg(s) for s in range(4)]
    return J, P, zs, [J.encrypt(z) for z in zs], [P.encrypt(z) for z in zs]


def test_keys_and_ciphertexts_equal_reference(host):
    J, P, zs, cj, cp = host
    assert P.s == J.s and P._noise_scale == 1
    for ka, kb in ((P.relin_keys, J.relin_keys),
                   (P._rot_keys[pow(5, 3, 2 * N)], J._rot_keys[pow(5, 3, 2 * N)]),
                   (P._rot_keys[2 * N - 1], J._rot_keys[2 * N - 1])):
        for a, b in zip(ka, kb):
            np.testing.assert_array_equal(a, b)
    for z, a, b in zip(zs, cp, cj):
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.level, a.scale) == (b.level, b.scale)
        assert P.encode(z) == J.encode(z)
        np.testing.assert_array_equal(P.decrypt(a), z)
        assert P.noise_budget(a) == J.noise_budget(b)


def test_no_embedding_and_the_same_draws():
    """The port builds no complex embedding and skipping it draws nothing:
    a fresh context's generator stands where the reference's does."""
    moduli = nt.generate_primes(4, 40, N)
    J, P = jbfv.BfvContext(N, moduli, T, seed=12), BfvContext(N, moduli, T, seed=12)
    assert not hasattr(P, "E") and J.E.shape == (N // 2, N)
    assert P._rng.bit_generator.state == J._rng.bit_generator.state


def test_vectorised_products_equal_the_schoolbook(host):
    """a*s (inside encrypt, compared above), the lifts and [c0 + c1 s]_Q
    equal the reference's Python schoolbook computations."""
    J, P, _, cj, _ = host
    ct = J.multiply_relin(cj[0], cj[1])
    for c in (cj[0], ct, J.mod_switch_to_next(ct)):
        nl = c.level + 1
        assert P._raw_decrypt(c) == J._raw_decrypt(c)
        for k in range(2):
            assert P._lift_centered(c.data[k, :nl], nl) == J._lift_centered(c.data[k, :nl], nl)


def _op(ctx, name, cts, plain):
    """One named operation on a context; `plain` is the plaintext operand."""
    a, b, c, _ = cts
    if name == "multiply_relin":
        return ctx.multiply_relin(a, b)
    if name == "multiply_relinearize":
        d, sc = ctx.multiply(a, b)
        return ctx.relinearize(d, sc, a.level)
    if name == "mod_switch_to_next":
        return ctx.mod_switch_to_next(ctx.multiply_relin(a, b))
    if name == "depth2":
        p = ctx.mod_switch_to_next(ctx.multiply_relin(a, b))
        return ctx.multiply_relin(p, ctx.mod_switch_to_next(c))
    if name in ("add", "sub"):
        return getattr(ctx, name)(a, b)
    if name in ("add_plain", "multiply_plain"):
        return getattr(ctx, name)(a, plain)
    if name == "conjugate":
        return ctx.conjugate(a)
    return ctx.rotate(a, 3)


def _want(name, zs, t, n):
    a, b, c, _ = (z.astype(object) for z in zs)
    p = msg(9, n, t).astype(object)
    half = n // 2
    return {
        "multiply_relin": a * b % t, "multiply_relinearize": a * b % t,
        "mod_switch_to_next": a * b % t, "depth2": a * b % t * c % t,
        "add": (a + b) % t, "sub": (a - b) % t,
        "add_plain": (a + p) % t, "multiply_plain": a * p % t,
        "conjugate": a.reshape(2, half)[::-1].ravel(),
        "rotate": np.roll(a.reshape(2, half), -3, axis=1).ravel(),
    }[name].astype(np.uint64)


HOST_OPS = ["multiply_relin", "multiply_relinearize", "mod_switch_to_next",
            "depth2", "add", "sub", "add_plain", "multiply_plain", "conjugate",
            "rotate"]


@pytest.mark.parametrize("name", HOST_OPS)
def test_host_ops_equal_reference_and_decrypt_exactly(host, name):
    J, P, zs, cj, cp = host
    got, want = _op(P, name, cp, msg(9)), _op(J, name, cj, msg(9))
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)
    np.testing.assert_array_equal(P.decrypt(got), _want(name, zs, T, N))
    assert P.noise_budget(got) == J.noise_budget(want)


def test_noise_budget_tracks_operations(host):
    J, P, zs, _, cp = host
    fresh = P.noise_budget(cp[0])
    prod = P.multiply_relin(cp[0], cp[1])
    assert fresh > 20 and 0 < P.noise_budget(prod) < fresh


def test_rescale_rejected(host):
    with pytest.raises(TypeError, match="CKKS"):
        host[1].rescale(host[4][0])


# -- the BEHZ multiply -------------------------------------------------------

RN = 128


@pytest.fixture(scope="module")
def rns():
    """n = 128, three 45-bit moduli, t = 257: the reference's context and the
    port's for one seed, and two encryptions on each."""
    moduli = [int(p) for p in nt.generate_primes(3, 45, RN)]
    J, P = jbfv.BfvContext(RN, moduli, T, seed=4), BfvContext(RN, moduli, T, seed=4)
    zs = [msg(20 + s, RN) for s in range(2)]
    return J, P, zs, [J.encrypt(z) for z in zs], [P.encrypt(z) for z in zs]


def test_multiply_rns_routes_equal_reference(rns, run_choice):
    """device=False (the host BehzTool) and BehzCuda on the CPU (RUN_CHOICE=1)
    equal each other and the reference's multiply_rns(device=False); the
    relinearized product decrypts exactly.  RUN_CHOICE=0 takes the host
    tool and builds no device tool."""
    J, P, zs, cj, cp = rns
    want, _ = J.multiply_rns(cj[0], cj[1], device=False)
    run_choice(0)
    host, _ = P.multiply_rns(cp[0], cp[1])
    assert "_behz_cuda_tools" not in P.__dict__
    run_choice(1)
    dev, _ = P.multiply_rns(cp[0], cp[1])
    assert list(P._behz_cuda_tools) == [(2, "cpu")]
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(P.multiply_rns(cp[0], cp[1], device=False)[0], want)
    ct = P.relinearize(dev, 1.0, level=cp[0].level)
    np.testing.assert_array_equal(P.decrypt(ct), zs[0].astype(object) * zs[1] % T)
    assert P._behz(2).aux_bits == J._behz(2).aux_bits


def test_multiply_rns_on_the_card_raises_without_one(rns, run_choice):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, P, _, _, cp = rns
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.multiply_rns(cp[0], cp[1], device=True)
    run_choice(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.multiply_rns(cp[0], cp[1])


def test_multiply_rns_beyond_the_kernels_takes_the_host_tool(run_choice):
    """Moduli of 62 bits size the Bsk primes at 63 bits, beyond the port's
    kernels: device=None takes the host tool (by shape, before any build),
    device=True refuses."""
    moduli = [int(p) for p in nt.generate_primes(3, 61, N)]
    P = BfvContext(N, moduli, T, seed=5)
    ct = P.encrypt(msg(30))
    run_choice(1)
    got, _ = P.multiply_rns(ct, ct)
    assert P._behz_cuda_tools == {(2, "cpu"): None}
    np.testing.assert_array_equal(got, P.multiply_rns(ct, ct, device=False)[0])
    with pytest.raises(ValueError, match="device BEHZ unavailable"):
        P.multiply_rns(ct, ct, device=True)


def test_convert_builds_bfv_context(rns):
    """A port BfvContext from the reference's n, moduli, t, s and keys:
    the same BEHZ constants, multiply_rns, relinearization and rotation as
    the reference's context."""
    J, _, zs, cj, _ = rns
    J.galois_keys(1)
    P = convert.scheme_context_from_state(RN, J.moduli, J.s, J.relin_keys,
                                          J._rot_keys, t=T, scheme="bfv", seed=9)
    assert isinstance(P, BfvContext) and P._noise_scale == 1 and not hasattr(P, "E")
    PT, JT = P._behz(2), J._behz(2)
    for name in ("Bsk", "q_hat_mod_Bsk", "q_mod_Bsk", "b_hat_mod_q", "B_mod_q",
                 "inv_q_mod_Bsk", "neg_inv_q_mod_mtilde", "inv_B_mod_msk"):
        np.testing.assert_array_equal(getattr(PT, name), getattr(JT, name), err_msg=name)
    d, _ = P.multiply_rns(cj[0], cj[1])
    np.testing.assert_array_equal(d, J.multiply_rns(cj[0], cj[1], device=False)[0])
    got = P.relinearize(d, 1.0, cj[0].level)
    np.testing.assert_array_equal(got.data, J.relinearize(d, 1.0, cj[0].level).data)
    np.testing.assert_array_equal(P.rotate(cj[0], 1).data, J.rotate(cj[0], 1).data)
    np.testing.assert_array_equal(P.decrypt(got), zs[0].astype(object) * zs[1] % T)
    with pytest.raises(ValueError, match="take one"):
        convert.scheme_context_from_state(RN, J.moduli, J.s, J.relin_keys, scheme="bfv")


# -- rotations on the inherited device evaluator ------------------------------


def test_device_evaluator_rotates_bfv_ciphertexts():
    """DeviceCkksEvaluator works as-is on a BfvContext (the reference's
    `tests/test_bfv.py:113-131`): its plain keyswitch contexts are BFV's; the
    rotation equals the host context's bit for bit and decrypts exactly."""
    n, t = 1024, 65537
    ctx = BfvContext(n, nt.generate_primes(4, 45, n), t=t, seed=8)
    ev = ckks.DeviceCkksEvaluator(ctx, device="cpu")
    z = msg(9, n, t)
    ct = ctx.encrypt(z)
    for r in (4, 1):
        got = ev.to_host(ev.rotate(ev.stage(ct), r))
        want = ctx.rotate(ct, r)
        np.testing.assert_array_equal(got.data, want.data)
        assert (got.level, got.scale) == (want.level, want.scale)
        np.testing.assert_array_equal(ctx.decrypt(got).reshape(2, -1),
                                      np.roll(z.reshape(2, -1), -r, axis=1))
