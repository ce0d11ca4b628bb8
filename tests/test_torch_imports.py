"""The port stands alone: importing it (and everything chip_smoke.py imports
at module level) pulls in neither jax nor the JAX package, and a CUDA request
without a CUDA device raises instead of falling back."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "hexl_fpga_tpu_torch", "hexl_fpga_tpu_torch.api", "hexl_fpga_tpu_torch.config",
    "hexl_fpga_tpu_torch.convert", "hexl_fpga_tpu_torch.ops._build",
    "hexl_fpga_tpu_torch.ops._native",
    "hexl_fpga_tpu_torch.ops.dyadic_cuda", "hexl_fpga_tpu_torch.ops.galois_cuda",
    "hexl_fpga_tpu_torch.ops.golden", "hexl_fpga_tpu_torch.ops.keyswitch_cuda",
    "hexl_fpga_tpu_torch.ops.nt", "hexl_fpga_tpu_torch.ops.ntt_cuda",
    "hexl_fpga_tpu_torch.ops.twiddles", "hexl_fpga_tpu_torch.ops.word64",
    "hexl_fpga_tpu_torch.runtime.executors", "hexl_fpga_tpu_torch.runtime.scheduler",
    "hexl_fpga_tpu_torch.utils.debug", "hexl_fpga_tpu_torch.utils.keycache",
    "hexl_fpga_tpu_torch.utils.vectors",
    "hexl_fpga_tpu_torch.utils.cuda_timing",
    "hexl_fpga_tpu_torch.utils.sass_count",
    "hexl_fpga_tpu_torch.utils.cpp_rates",
    "hexl_fpga_tpu_torch.utils.ablate_kernels",
    "hexl_fpga_tpu_torch.ops.wirepack",
    "hexl_fpga_tpu_torch.integrations.ckks",
    "hexl_fpga_tpu_torch.integrations.bgv",
    "hexl_fpga_tpu_torch.utils.profile_ckks", "hexl_fpga_tpu_torch.utils.profile_bfv",
    "hexl_fpga_tpu_torch.utils.graph",
    "hexl_fpga_tpu_torch.ops.rns_behz",
    "hexl_fpga_tpu_torch.ops.rns_behz_cuda",
    "hexl_fpga_tpu_torch.integrations.bfv",
    "hexl_fpga_tpu_torch.cpp_bridge",
    "hexl_fpga_tpu_torch.parallel.mesh",
    "hexl_fpga_tpu_torch.parallel.projection",
    "hexl_fpga_tpu_torch.parallel.sharded",
    "hexl_fpga_tpu_torch.parallel.rank_ops",
    "hexl_fpga_tpu_torch.utils.fuzz_card",
    "hexl_fpga_tpu_torch.utils.sanitize_kernels",
]


def run_py(code, **env):
    e = {k: v for k, v in os.environ.items() if k != "RUN_CHOICE"}
    e.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'hexl_fpga_tpu'\n"
        "       or m.startswith('hexl_fpga_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n"
    )
    res = run_py(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_no_import_statement_names_jax_or_the_jax_package():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|hexl_fpga_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "hexl_fpga_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_cuda_launch_path_raises_without_cuda():
    """No silent fallback: a CUDA request with no device raises at every
    level (tables, numpy conveniences, context, runtime)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = (
        "import numpy as np\n"
        "from hexl_fpga_tpu_torch.ops import dyadic_cuda, ntt_cuda, keyswitch_cuda\n"
        "import hexl_fpga_tpu_torch as hexl\n"
        "def raises(fn):\n"
        "    try: fn()\n"
        "    except (RuntimeError, AssertionError) as e: return True\n"
        "    return False\n"
        "a = np.zeros((1, 1024), dtype=np.uint64)\n"
        "assert raises(lambda: ntt_cuda.fwd_ntt(a, 1073750017))\n"
        "assert raises(lambda: ntt_cuda.modulus_tables(1024, 1073750017, device='cuda'))\n"
        "assert raises(lambda: keyswitch_cuda.get_context(1024, 1, 2, 2, 2,\n"
        "              [1073750017, 1073872897]))\n"
        "assert raises(lambda: ntt_cuda.modulus_tables(32768, 1152921504606584833,\n"
        "              device='cuda'))\n"
        "t = ntt_cuda.modulus_tables(1024, 1073750017, device='cpu')\n"
        "assert raises(lambda: ntt_cuda.caller_fwd_tables(1024, t.q, t.tab[0].numpy(),\n"
        "              t.tab[1].numpy(), device='cuda'))\n"
        "assert raises(lambda: dyadic_cuda.runner([17], device='cuda'))\n"
        "assert raises(lambda: keyswitch_cuda.KeySwitchContext(1024, 1, 2, 2, 2,\n"
        "              [1073750017, 1073872897], fused_mac=True))\n"
        "assert raises(lambda: dyadic_cuda.dyadic_multiply_np(a[0], a[0], 512, [17], 1))\n"
        "assert raises(hexl.acquire_FPGA_resources)\n"
        "assert set(ntt_cuda.LAUNCHES.values()) == {0} and len(ntt_cuda.LAUNCHES) == 5\n"
        "assert dyadic_cuda.LAUNCHES == {'dyadic_mul': 0}\n"
        "print('raised')\n"
    )
    res = run_py(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"


def test_op_constructors_default_to_the_card():
    """The op-level constructors (the caller-table ones too), the mesh of
    the multi-device layer, and the converters that carry the reference's
    device state across (its staged keys, a CKKS `data32`), build for the
    card unless asked for the CPU, as the reference's build for the default
    device: without a CUDA device the default raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = (
        "import numpy as np\n"
        "from hexl_fpga_tpu_torch import convert\n"
        "from hexl_fpga_tpu_torch.ops import dyadic_cuda, galois_cuda, ntt_cuda\n"
        "def raises(fn):\n"
        "    try: fn()\n"
        "    except (RuntimeError, AssertionError) as e: return True\n"
        "    return False\n"
        "assert raises(lambda: ntt_cuda.modulus_tables(1024, 1073750017))\n"
        "assert raises(lambda: dyadic_cuda.runner([17]))\n"
        "assert raises(lambda: galois_cuda.galois_index(1024, 5))\n"
        "t = ntt_cuda.modulus_tables(1024, 1073750017, device='cpu')\n"
        "fwd = (1024, t.q, t.tab[0].numpy(), t.tab[1].numpy())\n"
        "inv = (1024, t.q, t.tab[2].numpy(), t.tab[3].numpy(), t.inv_n, t.inv_n_w)\n"
        "assert raises(lambda: ntt_cuda.caller_fwd_tables(*fwd))\n"
        "assert raises(lambda: ntt_cuda.caller_inv_tables(*inv))\n"
        "assert ntt_cuda.caller_fwd_tables(*fwd, device='cpu').tab.is_cpu\n"
        "assert ntt_cuda.caller_inv_tables(*inv, device='cpu').tab.is_cpu\n"
        "import torch.distributed as dist\n"
        "from hexl_fpga_tpu_torch.parallel import mesh\n"
        "assert raises(lambda: mesh.Mesh(dist.HashStore(), 0, {'mp': 1}))\n"
        "assert mesh.default_device(0, 'cpu').type == 'cpu'\n"
        "p = np.ones((1, 2, 3, 8), dtype=np.uint32)\n"
        "d32 = np.ones((2, 2, 16), dtype=np.uint32)\n"
        "assert raises(lambda: convert.staged_keys_from_pairs(p, p, p, p))\n"
        "assert raises(lambda: convert.ckks_handle_from_data32(d32, 1, 2.0 ** 40))\n"
        "assert ntt_cuda.modulus_tables(1024, 1073750017, device='cpu').tab.is_cpu\n"
        "assert dyadic_cuda.runner([17], device='cpu').meta.is_cpu\n"
        "assert galois_cuda.galois_index(1024, 5, device='cpu').is_cpu\n"
        "k, kp = convert.staged_keys_from_pairs(p, p, p, p, device='cpu')\n"
        "assert k.is_cpu and kp.is_cpu and k.shape == (1, 2, 3, 8)\n"
        "h = convert.ckks_handle_from_data32(d32, 1, 2.0 ** 40, device='cpu')\n"
        "assert h.data.is_cpu and h.data.shape == (2, 2, 8)\n"
        "print('card')\n"
    )
    res = run_py(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "card"
