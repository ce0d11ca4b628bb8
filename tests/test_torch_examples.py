"""The port's examples (examples_torch/) on the CPU: each script's main() at
the reference script's configuration and seed, with the kernels' plain
versions (device "cpu"), its own checks passing.  The dyadic and C++-API
examples are also held to the JAX package's golden model on the same
seeded inputs; the multichip example runs over two spawned CPU ranks.
Tolerance: zero, but CKKS decryptions, to noise (1e-2, the reference's)."""

import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import golden as ref_golden, nt as ref_nt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SCRIPTS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples_torch"))
                 if f.endswith(".py"))


def example(name):
    return importlib.import_module(f"examples_torch.{name}")


def test_every_reference_example_has_a_counterpart():
    ref = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py")}
    assert ref | {"example_cpp_api"} == set(SCRIPTS)


@pytest.mark.parametrize("name", ["example_dyadic_multiply", "example_cpp_api"])
def test_dyadic_examples_equal_the_reference_golden(name, capsys):
    moduli, jobs = example(name).main(CPU)
    assert len(jobs) == 4
    if name == "example_dyadic_multiply":  # the reference's own primes
        np.testing.assert_array_equal(moduli, ref_nt.generate_primes(3, 48, 4096))
    for op1, op2, out in jobs:
        np.testing.assert_array_equal(out, ref_golden.dyadic_multiply(op1, op2, 4096, moduli, 3))
    printed = capsys.readouterr().out
    assert printed.count("verified OK") == 4 and "all results validated" in printed


@pytest.mark.parametrize("name", ["example_ckks", "example_rotate_chain", "example_matvec"])
def test_ckks_examples_decrypt_to_noise(name, capsys):
    errs = np.atleast_1d(example(name).main(CPU))
    assert np.all(errs < 1e-2)
    assert "cpu (the kernels' plain versions)" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["example_bgv", "example_bfv"])
def test_exact_scheme_examples(name, capsys):
    example(name).main(CPU)
    printed = capsys.readouterr().out
    assert printed.count("EXACT") == (2 if name == "example_bgv" else 4)
    assert printed.rstrip().endswith("done")


def test_multichip_example_over_two_spawned_cpu_ranks(capsys):
    got = example("example_multichip").main(CPU)
    assert got == {"ranks": 2, "launches": {}}  # the plain versions launch nothing
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["2 ranks on cpu (the kernels' plain versions)",
                       "batch-sharded NTT over dp=2: bit-exact",
                       "limb-sharded KeySwitch over mp=2: bit-exact",
                       "coefficient-sharded NTT over sp=2: bit-exact"]


def test_an_example_run_as_a_script_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "examples_torch/example_dyadic_multiply.py"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "verified" not in res.stdout


def test_examples_and_the_new_modules_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|hexl_fpga_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "examples_torch", f + ".py") for f in SCRIPTS]
    files += [os.path.join(ROOT, "hexl_fpga_tpu_torch", "parallel", f)
              for f in ("mesh.py", "rank_ops.py")]
    assert len(files) == 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
