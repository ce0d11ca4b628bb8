"""BGV of the port (`hexl_fpga_tpu_torch/integrations/bgv.py`) on the CPU
against the reference's (`hexl_fpga_tpu/integrations/bgv.py`, its API on the
golden executor, RUN_CHOICE=0).  BGV is exact: keys, ciphertexts and every
operation that is not hoisted are compared bit for bit, and every decryption
equals the message mod t.  Host tier at n = 64, t = 257 (the reference's
`tests/test_bgv.py:14-20`); the device evaluator at n = 1024, t = 65537."""

import os

import numpy as np
import pytest
import torch

from hexl_fpga_tpu import api as japi, config as jconfig
from hexl_fpga_tpu.integrations import bgv as jbgv
from hexl_fpga_tpu_torch import api, config, convert
from hexl_fpga_tpu_torch.integrations import bgv
from hexl_fpga_tpu_torch.ops import nt

N, T = 64, 257
DN, DT = 1024, 65537


@pytest.fixture(scope="module")
def runtimes():
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


def msg(seed, n=N, t=T):
    return np.random.default_rng(seed).integers(0, t, size=n, dtype=np.uint64)


@pytest.fixture(scope="module")
def host(runtimes):
    """Reference and port host contexts from one seed, then the same draws
    on both (rotation keys, four encryptions)."""
    moduli = nt.generate_primes(4, 40, N)  # 3 decomp + special
    J = jbgv.BgvContext(N, moduli, t=T, seed=3)
    P = bgv.BgvContext(N, moduli, t=T, seed=3)
    for c in (J, P):
        c.galois_keys(3)
        c._galois_keys_for(2 * N - 1)
    zs = [msg(s) for s in range(4)]
    return J, P, zs, [J.encrypt(z) for z in zs], [P.encrypt(z) for z in zs]


def test_keys_and_ciphertexts_equal_reference(host):
    J, P, zs, cj, cp = host
    assert P.s == J.s
    for ka, kb in ((P.relin_keys, J.relin_keys),
                   (P._rot_keys[pow(5, 3, 2 * N)], J._rot_keys[pow(5, 3, 2 * N)]),
                   (P._rot_keys[2 * N - 1], J._rot_keys[2 * N - 1])):
        for a, b in zip(ka, kb):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.encoder.slot_pos, J.encoder.slot_pos)
    for z, a, b in zip(zs, cp, cj):
        np.testing.assert_array_equal(a.data, b.data)
        assert P.encode(z) == J.encode(z)
        np.testing.assert_array_equal(P.decrypt(a), z)
        assert P.noise_budget(a) == J.noise_budget(b)


def _op(ctx, name, cts, plain):
    """One named operation on a host context or an evaluator; `plain` is the
    plaintext operand of add_plain / multiply_plain."""
    a, b, c, _ = cts
    if name == "multiply_relin":
        return ctx.multiply_relin(a, b)
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
        "multiply_relin": a * b % t, "mod_switch_to_next": a * b % t,
        "depth2": a * b % t * c % t, "add": (a + b) % t, "sub": (a - b) % t,
        "add_plain": (a + p) % t, "multiply_plain": a * p % t,
        "conjugate": a.reshape(2, half)[::-1].ravel(),
        "rotate": np.roll(a.reshape(2, half), -3, axis=1).ravel(),
    }[name].astype(np.uint64)


HOST_OPS = ["multiply_relin", "mod_switch_to_next", "depth2", "add", "sub",
            "add_plain", "multiply_plain", "conjugate", "rotate"]


@pytest.mark.parametrize("name", HOST_OPS)
def test_host_ops_equal_reference_and_decrypt_exactly(host, name):
    J, P, zs, cj, cp = host
    got, want = _op(P, name, cp, msg(9)), _op(J, name, cj, msg(9))
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)
    np.testing.assert_array_equal(P.decrypt(got), _want(name, zs, T, N))


def test_rescale_rejected(host):
    with pytest.raises(TypeError, match="CKKS"):
        host[1].rescale(host[4][0])


# -- the device evaluator at n = 1024 ---------------------------------------


@pytest.fixture(scope="module")
def dev(runtimes):
    """(reference host context, port evaluator on the same keys, messages,
    their ciphertexts)."""
    J = jbgv.BgvContext(DN, nt.generate_primes(4, 45, DN), t=DT, seed=9)
    for g in (pow(5, 3, 2 * DN), pow(5, 1, 2 * DN), 2 * DN - 1):
        J._galois_keys_for(g)
    P = convert.scheme_context_from_state(DN, J.moduli, J.s, J.relin_keys,
                                          J._rot_keys, t=DT, seed=4)
    zs = [msg(10 + s, DN, DT) for s in range(4)]
    return J, bgv.DeviceBgvEvaluator(P, device="cpu"), zs, [P.encrypt(z) for z in zs]


@pytest.mark.parametrize("name", HOST_OPS)
def test_evaluator_ops_equal_reference_host(dev, name):
    """Every non-hoisted device op (multiply_relin, the GHS mod switch on
    the card, rotations, add/sub, plaintext ops) equals the reference's host
    context bit for bit and decrypts exactly."""
    J, ev, zs, cts = dev
    p = msg(9, DN, DT)
    got = ev.to_host(_op(ev, name, [ev.stage(c) for c in cts], p))
    want = _op(J, name, cts, p)
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)
    np.testing.assert_array_equal(J.decrypt(got), _want(name, zs, DT, DN))


def test_evaluator_hoisted_rotations_decrypt_exactly(dev):
    """Hoisted BGV rotations fold the GHS digit in the hoisted tail: every
    rotation decrypts to the rotated rows exactly (fused = unfused bits)."""
    J, ev, zs, cts = dev
    h = ev.stage(cts[0])
    steps = [0, 1, 3]
    fused, unfused = ev.rotate_many(h, steps), ev.rotate_many(h, steps, fused=False)
    rows = zs[0].reshape(2, -1)
    for r, a, b in zip(steps, fused, unfused):
        assert torch.equal(a.data, b.data)
        np.testing.assert_array_equal(J.decrypt(ev.to_host(a)).reshape(2, -1),
                                      np.roll(rows, -r, axis=1))
    conj = ev.conjugate_hoisted(ev.hoist(h))
    np.testing.assert_array_equal(J.decrypt(ev.to_host(conj)).reshape(2, -1),
                                  rows[::-1])
    with pytest.raises(TypeError, match="CKKS"):
        ev.rescale(h)


def test_convert_builds_bgv_context(dev):
    J, ev, _, _ = dev
    P = ev.ctx
    assert isinstance(P, bgv.BgvContext) and P.t == J.t and P.s == J.s
    np.testing.assert_array_equal(P.encoder.slot_pos, J.encoder.slot_pos)
    assert ev._ks_ctx(3).plain_modulus == DT
