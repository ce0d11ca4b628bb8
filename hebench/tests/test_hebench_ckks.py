"""The CKKS cells: the configuration held to the port's SEAL chain, the plain
reference (reference/ckks.py) held to the port's evaluator bit for bit at the
tiny configuration, both cells rehearsed, and the check seen to fail under
each fault planted in the evaluator, rehearsed on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from hebench import run
from hebench.reference import ckks as ref_ckks
from hebench.reference import ntt, primes

ROTATE, MATVEC = "ckks16384.seal_rotate", "ckks16384.bsgs_matvec"
CONFIGS = ["hebench/configs/ckks16384_seal.json", "hebench/tests/configs/tiny_ckks.json"]


def _cfg(path):
    with open(os.path.join(run.ROOT, path)) as f:
        return json.load(f)


@pytest.mark.parametrize("path", CONFIGS)
def test_the_configuration_is_the_seal_chain(path):
    """The moduli are the port's seal_moduli(n): {52, 40 x 5, 52} bits, the
    special prime last, each 1 mod 2n; the ciphertexts at the top level."""
    from hexl_fpga_tpu_torch.integrations.ckks import SEAL_BITS, seal_moduli

    cfg = _cfg(path)
    n, q = cfg["n"], cfg["moduli"]
    assert q == seal_moduli(n)
    assert [v.bit_length() for v in q] == list(SEAL_BITS)
    assert all(v % (2 * n) == 1 for v in q)
    assert cfg["level"] == len(q) - 2 and cfg["scale_bits"] == 40


@pytest.mark.parametrize("g", [3, 5, 25, 127, 2 * 64 - 1])
def test_the_galois_index_is_the_automorphism(g):
    """The NTT-domain index against c(X) -> c(X^g) in the coefficient domain,
    through the reference's own transforms, and against the port's sigma."""
    from hexl_fpga_tpu_torch.ops import galois_cuda

    n, q = 64, primes.ntt_primes(1, 40, 64)[0]
    tab = ntt.Tables(n, q, primes.minimal_root(n, q))
    coeff = torch.randint(0, q, (2, n), generator=torch.Generator().manual_seed(g))
    auto = torch.zeros_like(coeff)
    for k in range(n):
        e = g * k % (2 * n)
        v = coeff[:, k] if e < n else (q - coeff[:, k]) % q
        auto[:, e % n] = v
    index = ref_ckks.galois_index(n, g)
    assert torch.equal(ntt.forward(coeff, tab)[:, index], ntt.forward(auto, tab))
    assert index.tolist() == galois_cuda.ntt_galois_sigma(n, g).tolist()


@pytest.fixture(scope="module")
def tiny():
    """The port's evaluator on the plain kernels and the reference, on one
    seeded tiny workload's keys and inputs (the keys the op draws)."""
    from hexl_fpga_tpu_torch.integrations.ckks import Ciphertext, DeviceCkksEvaluator

    op = run.load("ops", "ckks")
    cfg = _cfg(CONFIGS[1])
    saved = os.environ.get(op.OP_ENV)
    os.environ[op.OP_ENV] = "matvec"
    try:
        w = op.Workload(cfg, 2, 3_100_000_007, torch.device("cpu"))
    finally:
        os.environ.pop(op.OP_ENV)
        if saved is not None:
            os.environ[op.OP_ENV] = saved
    ev = DeviceCkksEvaluator(w.ctx, "cpu")
    hs = [ev.stage(Ciphertext(w.c[r], w.level, w.scale)) for r in range(2)]
    ref = w.reference("exact", "cpu")  # the op's own reference entry
    n, K = w.n, len(w.moduli)
    keys = {ref_ckks.galois_element(n, r): torch.from_numpy(
                np.stack(w.keys[r]).view(np.int64)).view(-1, 2, K, n) for r in w.steps}
    r = ref_ckks.Ckks(n, w.moduli, w.L, keys)
    return w, ev, hs, r, ref


def _c(w, row):
    return torch.from_numpy(w.c[row].view(np.int64))[None]


def test_the_ports_rotate_is_the_reference(tiny):
    w, ev, hs, r, _ = tiny
    for row, h in enumerate(hs):
        for step in (1, 4, 8):
            got = ev.rotate(h, step).data
            want = r.rotate(_c(w, row), ref_ckks.galois_element(w.n, step))[0]
            assert torch.equal(got, want), (row, step)


def test_the_ports_hoisted_rotations_are_the_reference(tiny):
    """rotate_many's one batched hoisted apply, and rotate_hoisted, row by
    row: sigma(KeySwitch(c1; sigma^-1 keys) + [c0, 0])."""
    w, ev, hs, r, _ = tiny
    h = hs[0]
    outs = ev.rotate_many(h, [1, 2, 3])
    for step, out in zip((1, 2, 3), outs):
        want = r.rotate_hoisted(_c(w, 0), ref_ckks.galois_element(w.n, step))[0]
        assert torch.equal(out.data, want), step
    assert torch.equal(ev.rotate_hoisted(ev.hoist(h), 1).data, outs[0].data)
    assert not torch.equal(outs[0].data, ev.rotate(h, 1).data)  # not rotate's bits


def test_the_encoded_matvec_program_is_the_reference(tiny):
    """The staged matrix of encoded planes, its program on either staged
    ciphertext, and the op's own reference entry: bit for bit."""
    w, ev, hs, r, ref = tiny
    n1 = w.cfg["matvec_n1"]
    lt = ev.stage_linear_transform(dict(enumerate(w.planes)), w.level, n1,
                                   encoded=True)
    program = lt.program(hs[0].data)
    planes = torch.from_numpy(w.planes.view(np.int64))
    for row, h in enumerate(hs):
        want = r.matvec(_c(w, row), planes, n1)[0]
        assert torch.equal(program(h.data), want), row
        assert torch.equal(lt(h).data, want), row
    np.testing.assert_array_equal(ref([0, 1]), np.stack(
        [program(h.data).numpy().view(np.uint64).reshape(-1) for h in hs]))


@pytest.mark.parametrize("cell", [ROTATE, MATVEC])
def test_the_cell_rehearses_correct(rehearse, monkeypatch, cell):
    monkeypatch.delenv("HEBENCH_CKKS_OP", raising=False)
    rc, line, err = rehearse(cell, seconds=0.5, check_every=1)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["compared"]["ops_checked"]["value"] == line["attempted"] >= 1
    assert set(line["metrics"]) == {"device_ops_per_s", "setup_s"}
    rc, line, err = rehearse(cell, trace=1, seconds=0.3)
    assert rc == 0 and line["correct"] is True, err
    assert {"ckks.glue_share_of_busy", "ckks.device_ops_per_op"} <= set(line["metrics"])


def _plant(monkeypatch, fault):
    from hexl_fpga_tpu_torch.integrations import ckks
    from hexl_fpga_tpu_torch.ops import galois_cuda, keyswitch_cuda

    E = ckks.DeviceCkksEvaluator
    if fault == "wrong_key":  # each full rotation switches under the next step's keys
        def staged(self, ks, g):
            gs = sorted(self.ctx._rot_keys)
            keys, kp = ks.device_keys(self.ctx._rot_keys[gs[(gs.index(g) + 1) % len(gs)]])
            return keys, kp, galois_cuda.galois_index(self.ctx.n, g, self.device)

        monkeypatch.setattr(E, "_galois_staged", staged)
    elif fault == "baby_unhoisted":  # baby step 1 as a full rotation
        targets = []
        decompose = keyswitch_cuda.KeySwitchContext._decompose
        many = E._hoisted_many_data

        def record(self, t):
            targets.append(t)
            return decompose(self, t)

        def unhoisted(self, dec, c0, ks, staged):
            out = many(self, dec, c0, ks, staged)
            x = torch.stack([c0, targets[-1][0]])
            out[0] = self._galois_data(x, self._galois_staged(ks, pow(5, 1, 2 * self.ctx.n)))
            return out

        monkeypatch.setattr(keyswitch_cuda.KeySwitchContext, "_decompose", record)
        monkeypatch.setattr(E, "_hoisted_many_data", unhoisted)
    elif fault == "giant_skipped":  # a full rotation that returns its input
        monkeypatch.setattr(E, "_galois_data", lambda self, x, staged, **_: x)
    else:  # a result left as allocated
        monkeypatch.setattr(E, "rotate", lambda self, h, r: ckks.DeviceCkksCiphertext(
            torch.zeros_like(h.data), h.level, h.scale))
        monkeypatch.setattr(ckks.DeviceLinearTransform, "program",
                            lambda self, example: torch.zeros_like)


@pytest.mark.parametrize("cell,fault", [
    (ROTATE, "wrong_key"), (ROTATE, "unwritten"),
    (MATVEC, "wrong_key"), (MATVEC, "baby_unhoisted"), (MATVEC, "giant_skipped"),
    (MATVEC, "unwritten"),
])
def test_a_fault_in_the_evaluator_is_not_correct(rehearse, monkeypatch, cell, fault):
    """Each fault planted in the port: a rotation under another step's keys, a
    baby step rotated unhoisted, a giant step left out, a result left as
    allocated."""
    monkeypatch.delenv("HEBENCH_CKKS_OP", raising=False)
    _plant(monkeypatch, fault)
    rc, line, err = rehearse(cell, seconds=0.5, check_every=1)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["compared"]["mismatched_words"]["value"] > 0


def test_the_ckks_reference_loads_nothing_of_the_port():
    import subprocess
    import sys

    code = (f"import sys; sys.path.insert(0, {run.ROOT!r}); import json; "
            "from hebench.reference import ckks; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=run.ROOT, timeout=300)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "hexl_fpga_tpu", "hexl_fpga_tpu_torch"}
