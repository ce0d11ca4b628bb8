"""52-bit wire packing of the port (`hexl_fpga_tpu_torch/ops/wirepack.py`) and
the packed KeySwitch route (HEXL_TPU_WIRE_PACK=1) on the CPU, against the
reference's codec (`hexl_fpga_tpu/ops/wirepack.py`, NumPy and jax.numpy) and
the unpacked path.  Tolerance: zero."""

import os

import numpy as np
import pytest
import torch

import hexl_fpga_tpu_torch as hexl
from hexl_fpga_tpu.ops import wirepack as jwirepack, word64 as jw
from hexl_fpga_tpu_torch import config as config_mod
from hexl_fpga_tpu_torch.ops import keyswitch_cuda, wirepack
from hexl_fpga_tpu_torch.utils import vectors

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
MASK52 = np.uint64((1 << 52) - 1)


def draw(seed, shape, bits=52):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("shape", [(8,), (3, 64), (2, 2, 1024)])
@pytest.mark.parametrize("bits", [52, 64])
def test_codec_matches_reference(shape, bits):
    """Host and device codecs against the reference's pack_np / unpack_np and
    pack_jnp / unpack_jnp; 64-bit draws exercise the masking."""
    x = draw(sum(shape) + bits, shape, bits)
    x32 = x.view(np.uint32)
    want = jwirepack.pack_np(x32)
    np.testing.assert_array_equal(wirepack.pack_np(x32), want)
    np.testing.assert_array_equal(wirepack.pack_u64_np(x), want)
    np.testing.assert_array_equal(np.asarray(jwirepack.pack_jnp(x32)), want)
    dev = wirepack.pack(torch.from_numpy(x.view(np.int64)))
    assert dev.dtype == torch.int32 and dev.shape[-1] == shape[-1] * 13 // 8
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), want)

    back = x & MASK52
    np.testing.assert_array_equal(wirepack.unpack_np(want), jwirepack.unpack_np(want))
    np.testing.assert_array_equal(wirepack.unpack_u64_np(want), back)
    np.testing.assert_array_equal(wirepack.unpack(dev).numpy().view(np.uint64), back)


def test_out_of_domain_value_corrupts_only_its_own_field():
    """The reference's contract (`wirepack.py:10-13`): a value >= 2^52 loses
    its high bits and leaves every neighbour intact, on both codecs."""
    x = draw(5, (2, 16))
    bad = x.copy()
    bad[0, 3] |= np.uint64(0xFFF) << np.uint64(52)
    bad[1, 7] = np.uint64((1 << 64) - 1)
    host = wirepack.unpack_u64_np(wirepack.pack_u64_np(bad))
    dev = wirepack.unpack(wirepack.pack(torch.from_numpy(bad.view(np.int64))))
    for got in (host, dev.numpy().view(np.uint64)):
        np.testing.assert_array_equal(got, bad & MASK52)
        keep = np.ones_like(x, dtype=bool)
        keep[0, 3] = keep[1, 7] = False
        np.testing.assert_array_equal(got[keep], x[keep])
    np.testing.assert_array_equal(wirepack.pack_u64_np(bad),
                                  jwirepack.pack_np(bad.view(np.uint32)))


def test_codec_rejects_bad_shapes():
    with pytest.raises(ValueError):
        wirepack.pack(torch.zeros(12, dtype=torch.int64))
    with pytest.raises(ValueError):
        wirepack.unpack(torch.zeros(12, dtype=torch.int32))
    with pytest.raises(TypeError):
        wirepack.unpack(torch.zeros(13, dtype=torch.int64))


@pytest.fixture(scope="module")
def vec():
    return vectors.load_json(os.path.join(TESTDATA, "1024_2_3_3_2_0.json"))


@pytest.fixture
def packed_env(monkeypatch):
    def start(pack, **env):
        if pack:
            monkeypatch.setenv("HEXL_TPU_WIRE_PACK", "1")
        else:
            monkeypatch.delenv("HEXL_TPU_WIRE_PACK", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        config_mod.reset_config()
        hexl.acquire_FPGA_resources()

    yield start
    hexl.release_FPGA_resources()
    config_mod.reset_config()


def api_keyswitch(vec, ops):
    """ops: (result, t_target) pairs, through set_worksize / KeySwitch /
    Completed; returns the results."""
    out = [r.copy() for r, _ in ops]
    hexl.set_worksize_KeySwitch(len(ops))
    for r, (_, t) in zip(out, ops):
        hexl.KeySwitch(r, t, vec.coeff_count, vec.decomp_modulus_size,
                       vec.key_modulus_size, vec.rns_modulus_size,
                       vec.key_component_count, vec.moduli, vec.key_vectors,
                       vec.modswitch_factors, vec.twiddle_factors)
    assert hexl.KeySwitchCompleted()
    return out


def seeded_ops(vec, count, seed):
    n, L = vec.coeff_count, vec.decomp_modulus_size
    rng = np.random.default_rng(seed)
    ops = [(vec.input.copy(), vec.t_target_iter_ptr.copy())]
    for _ in range(count - 1):
        t = np.concatenate([rng.integers(0, vec.moduli[j], n, dtype=np.uint64)
                            for j in range(L)])
        r = np.concatenate([rng.integers(0, vec.moduli[j % L], n, dtype=np.uint64)
                            for j in range(2 * L)])
        ops.append((r, t))
    return ops


@pytest.mark.parametrize("worksize", [1, 5])
def test_api_keyswitch_packed_equals_unpacked(vec, packed_env, worksize):
    """HEXL_TPU_WIRE_PACK=1 through the API (batches of 4): every op equals
    the unpacked path's, the first the frozen vector's expected output."""
    ops = seeded_ops(vec, worksize, seed=worksize)
    packed_env(False, RUN_CHOICE=1, BATCH_SIZE_KEYSWITCH=4)
    plain = api_keyswitch(vec, ops)
    hexl.release_FPGA_resources()
    packed_env(True, RUN_CHOICE=1, BATCH_SIZE_KEYSWITCH=4)
    packed = api_keyswitch(vec, ops)
    np.testing.assert_array_equal(packed[0], vec.expected_output)
    for a, b in zip(packed, plain):
        np.testing.assert_array_equal(a, b)


def test_packed_route_moves_the_reference_bytes(vec, monkeypatch):
    """The bytes that cross the link both ways are the reference's:
    pack_operands equals dispatch_batch32p's host packing, and the packed
    device result equals pack_jnp of the expected output, interleaved."""
    monkeypatch.setenv("HEXL_TPU_WIRE_PACK", "1")
    n, L = vec.coeff_count, vec.decomp_modulus_size
    ctx = keyswitch_cuda.KeySwitchContext(
        n, L, vec.key_modulus_size, vec.rns_modulus_size, 2, vec.moduli,
        vec.twiddle_factors, device="cpu")
    rs, ts = vec.input[None], vec.t_target_iter_ptr[None]
    rp, tp = ctx.pack_operands(rs, ts)
    np.testing.assert_array_equal(
        rp, jwirepack.pack_np(jw.to_interleaved_np(rs.reshape(1, 2, L, n))))
    np.testing.assert_array_equal(
        tp, jwirepack.pack_np(jw.to_interleaved_np(ts.reshape(1, L, n))))
    out = ctx.dispatch_batch(rs, ts, vec.key_vectors, vec.modswitch_factors)
    assert out.dtype == torch.int32 and out.shape == (1, 2, L, n * 13 // 8)
    want = np.asarray(jwirepack.pack_jnp(jw.to_interleaved_np(
        vec.expected_output.reshape(1, 2, L, n))))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        ctx.run_batch(rs, ts, vec.key_vectors, vec.modswitch_factors)[0],
        vec.expected_output)
    with pytest.raises(TypeError):
        ctx.dispatch_batch(ctx.stage_ciphertext(rs), ts, vec.key_vectors,
                           vec.modswitch_factors)
