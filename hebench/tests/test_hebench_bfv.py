"""The BFV multiply cell: its configuration held to the port's choice of Bsk
and to the transforms' primes, and the check seen to fail under each fault
planted in `DeviceBfvEvaluator.multiply`, rehearsed on the CPU."""

import json
import os

import pytest

from hebench import run

CELL = "bfv16384.behz_multiply"
CONFIGS = ["hebench/configs/bfv16384_6_65537.json",
           "hebench/tests/configs/tiny_bfv_multiply.json"]


@pytest.mark.parametrize("path", CONFIGS)
def test_the_configuration_is_the_ports_level(path):
    """Every prime of q and Bsk is 1 mod 2n (each carries a length-n
    negacyclic transform), and Bsk is what the port's BehzTool picks for q
    and t."""
    from hexl_fpga_tpu_torch.ops import rns_behz

    with open(os.path.join(run.ROOT, path)) as f:
        cfg = json.load(f)
    n, q, bsk = cfg["n"], cfg["moduli"], cfg["bsk_moduli"]
    assert all(p % (2 * n) == 1 for p in q + bsk + [cfg["special_modulus"]])
    tool = rns_behz.BehzTool(n, q, cfg["t"])
    assert tool.Bsk == bsk and tool.m_tilde == cfg["m_tilde"]


def _multiply_fault(monkeypatch, fault):
    from hexl_fpga_tpu_torch.integrations import DeviceBfvEvaluator

    orig = DeviceBfvEvaluator.multiply

    def multiply(self, c1, c2):
        B, _, k, n = c1.shape
        if fault == "unchanged":  # a step that writes nothing into its result
            return c1.new_zeros((B, 3, k, n))
        out = orig(self, c1, c2)
        if fault == "half_batch":
            out[B // 2:] = 0
        else:
            out.view(-1)[5] ^= 1
        return out

    monkeypatch.setattr(DeviceBfvEvaluator, "multiply", multiply)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_fault_in_the_multiply_is_not_correct(rehearse, monkeypatch, fault):
    """Each fault planted in the port: a result left as allocated, half of
    the batch left out, one word altered where it is produced."""
    _multiply_fault(monkeypatch, fault)
    rc, line, err = rehearse(CELL, seconds=0.5, check_every=1)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["compared"]["mismatched_words"]["value"] > 0


def test_the_bfv_reference_loads_nothing_of_the_port():
    import subprocess
    import sys

    code = (f"import sys; sys.path.insert(0, {run.ROOT!r}); import json; "
            "from hebench.reference import behz; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=run.ROOT, timeout=300)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "hexl_fpga_tpu", "hexl_fpga_tpu_torch"}
