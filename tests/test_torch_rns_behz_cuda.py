"""The port's device BEHZ multiply (`hexl_fpga_tpu_torch/ops/rns_behz_cuda.py`,
`BehzCuda`) on the CPU, where every kernel runs its plain version, against
the host BehzTool of both packages and the reference's device module
(`hexl_fpga_tpu/ops/rns_behz_tpu.py`, `BehzTpu(engine_impl="xla")`, as its own
tests run it on the CPU).  All exact integer pipelines: zero tolerance."""

import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import rns_behz as jbehz, rns_behz_tpu, twiddles as jtw
from hexl_fpga_tpu.ops import word64 as jw
from hexl_fpga_tpu_torch.ops import dyadic_cuda, nt, ntt_cuda, rns_behz, rns_behz_cuda
from hexl_fpga_tpu_torch.ops import twiddles, word64 as w
from hexl_fpga_tpu_torch.utils.graph import GraphProgram


def make(n, k, bits, t, seed, batch=1, aux_bits=None):
    """(port tool, its q tables, BehzCuda on the CPU, two (batch, 2, k, n)
    ciphertext batches of random canonical NTT limbs)."""
    q = [int(p) for p in nt.generate_primes(k, bits, n)]
    tool = rns_behz.BehzTool(n, q, t, aux_bits=aux_bits)
    tabs = [twiddles.ntt_tables(n, qi) for qi in q]
    rng = np.random.default_rng(seed)
    qcol = np.array(q, dtype=np.uint64).reshape(1, 1, k, 1)
    cts = [rng.integers(0, 1 << 62, size=(batch, 2, k, n), dtype=np.uint64) % qcol
           for _ in range(2)]
    return tool, tabs, rns_behz_cuda.BehzCuda(tool, tabs, device="cpu"), cts


def host_batch(tool, tabs, c1, c2):
    return np.stack([tool.multiply(a, b, tabs) for a, b in zip(c1, c2)])


@pytest.mark.parametrize("batch", (1, 2))
@pytest.mark.parametrize("n,k,bits,t", [(128, 2, 45, 65537), (128, 3, 51, 257)])
def test_multiply_equals_host_tools(n, k, bits, t, batch):
    """The reference's device test shapes (`tests/test_rns_behz_tpu.py:35-58`)
    against the port's and the reference's BehzTool."""
    tool, tabs, dev, (c1, c2) = make(n, k, bits, t, seed=k, batch=batch)
    got = dev.multiply_batch(c1, c2)
    assert got.shape == (batch, 3, k, n) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, host_batch(tool, tabs, c1, c2))
    jtool = jbehz.BehzTool(n, tool.q, t)
    jtabs = [jtw.ntt_tables(n, qi) for qi in tool.q]
    np.testing.assert_array_equal(got[0], jtool.multiply(c1[0], c2[0], jtabs))
    np.testing.assert_array_equal(dev.multiply(c1[0], c2[0]), got[0])


@pytest.fixture(scope="module")
def reference_device():
    """One multiply by the reference's device module on its XLA engines (about
    20 s on one CPU), and the port's inputs and result for the same pair."""
    tool, tabs, dev, (c1, c2) = make(128, 2, 45, 65537, seed=11)
    jtool = jbehz.BehzTool(128, tool.q, 65537)
    jtabs = [jtw.ntt_tables(128, qi) for qi in tool.q]
    want = rns_behz_tpu.BehzTpu(jtool, jtabs, engine_impl="xla").multiply(c1[0], c2[0])
    return dev.multiply(c1[0], c2[0]), want


def test_multiply_equals_reference_device_module(reference_device):
    got, want = reference_device
    np.testing.assert_array_equal(got, want)


def test_dyadic_tensor_product_equals_reference_lane_math():
    """The 2x2 -> 3 tensor product by dyadic_mul (B4) over q u Bsk equals the
    reference's `_tensor` lane math on canonical operands, every modulus."""
    tool, _, dev, _ = make(128, 3, 51, 257, seed=5)
    moduli = tool.q + tool.Bsk
    n, M = tool.n, len(moduli)
    rng = np.random.default_rng(6)
    qcol = np.array(moduli, dtype=np.uint64).reshape(1, 1, M, 1)
    a, b = (rng.integers(0, 1 << 62, size=(2, 2, M, n), dtype=np.uint64) % qcol
            for _ in range(2))
    got = w.to_u64_np(dev._runner.run(w.from_u64_np(a), w.from_u64_np(b)))
    for i, m in enumerate(moduli):
        for j in range(2):
            pairs = [jw.to_pair_np(x[j, c, i]) for x in (a, b) for c in range(2)]
            want = rns_behz_tpu.BehzTpu._tensor(*pairs, m)
            for c in range(3):
                np.testing.assert_array_equal(
                    got[j, c, i], jw.from_pair_np(*(np.asarray(p) for p in want[c])))


@pytest.mark.parametrize("n,k,bits,t,aux_bits", [
    (64, 2, 51, (1 << 57) + 1, None),  # auto-sized Bsk of 59 bits: a large t
    (64, 4, 45, 257, 61),              # 62-bit Bsk: 2k lazy terms pass 2^64
])
def test_bsk_beyond_the_reference_device_ceiling(n, k, bits, t, aux_bits):
    """Bsk primes wider than the reference's 2^55 device ceiling: the lazy
    conversion sums are reduced in groups before they reach 2^64."""
    tool, tabs, dev, (c1, c2) = make(n, k, bits, t, seed=3, batch=2, aux_bits=aux_bits)
    assert max(tool.Bsk) > 1 << 55
    if aux_bits == 61:
        assert dev._q_to_bsk.group < k
    np.testing.assert_array_equal(dev.multiply_batch(c1, c2),
                                  host_batch(tool, tabs, c1, c2))


def test_transforms_and_tensor_launches_per_multiply(monkeypatch):
    """A multiply calls ntt_inv 3k + 1 times (k over 4B rows and k over 3B
    rows under q, k + 1 over 3B rows under Bsk), ntt_fwd 2k + 1 times (k + 1
    over 4B rows under Bsk, k over 3B rows under q) and dyadic_multiply once
    over (B, 2, 2k + 1, n)."""
    B, k = 2, 3
    tool, _, dev, (c1, c2) = make(64, k, 45, 257, seed=8, batch=B)
    calls = {"ntt_inv": [], "ntt_fwd": [], "dyadic_multiply": []}

    def spy(mod, name):
        real = getattr(mod, name)

        def call(x, *args):
            calls[name].append(tuple(x.shape))
            return real(x, *args)
        monkeypatch.setattr(mod, name, call)

    spy(ntt_cuda, "ntt_inv")
    spy(ntt_cuda, "ntt_fwd")
    spy(dyadic_cuda, "dyadic_multiply")
    dev.multiply_tensors(w.from_u64_np(c1), w.from_u64_np(c2))
    rows = lambda r: (r * B, tool.n)
    assert sorted(calls["ntt_inv"]) == sorted([rows(4)] * k + [rows(3)] * (2 * k + 1))
    assert sorted(calls["ntt_fwd"]) == sorted([rows(4)] * (k + 1) + [rows(3)] * k)
    assert calls["dyadic_multiply"] == [(B, 2, 2 * k + 1, tool.n)]


def test_program_on_the_cpu_is_the_eager_composition():
    tool, _, dev, (c1, c2) = make(64, 2, 45, 257, seed=9, batch=2)
    x1, x2 = w.from_u64_np(c1), w.from_u64_np(c2)
    prog = dev.program(2)
    assert prog.graph is None and dev.program(2) is prog
    assert torch.equal(prog(x1, x2), dev.multiply_tensors(x1, x2))
    calls = []
    g = GraphProgram(lambda a, b: calls.append(1) or a + b, x1, x2)
    assert g.graph is None and not calls  # nothing runs or is captured off the card
    assert torch.equal(g(x1, x2), x1 + x2) and calls == [1]


def test_shape_gates():
    """The port's kernels take n a power of two in [4, 32768] and moduli
    below 2^62; the gate is decided from the shape before anything is built,
    and inputs of another shape, dtype or device are refused."""
    q = [int(p) for p in nt.generate_primes(2, 45, 64)]
    wide = rns_behz.BehzTool(64, q, 257, aux_bits=62)  # Bsk primes of 63 bits
    small = rns_behz.BehzTool(2, [int(p) for p in nt.generate_primes(2, 45, 2)], 257)
    tabs = [twiddles.ntt_tables(64, qi) for qi in q]
    assert rns_behz_cuda.fits(rns_behz.BehzTool(64, q, 257))
    for tool in (wide, small):
        assert not rns_behz_cuda.fits(tool)
        with pytest.raises(ValueError, match="host BehzTool"):
            rns_behz_cuda.BehzCuda(tool, tabs[: tool.k], device="cpu")
    _, _, dev, (c1, c2) = make(64, 2, 45, 257, seed=1)
    x = w.from_u64_np(c1)
    with pytest.raises(ValueError, match="ciphertext"):
        dev.multiply_tensors(x[:, :, :1].contiguous(), x[:, :, :1].contiguous())
    with pytest.raises(TypeError, match="int64"):
        dev.multiply_tensors(x.to(torch.int32), x.to(torch.int32))
    with pytest.raises(ValueError, match="q tables"):
        rns_behz_cuda.BehzCuda(dev.tool, tabs[:1], device="cpu")


def test_cuda_without_a_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tool, tabs, _, _ = make(64, 2, 45, 257, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rns_behz_cuda.BehzCuda(tool, tabs)
