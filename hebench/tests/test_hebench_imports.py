"""Nothing a run loads is JAX or the JAX package, compared by whole top-level
module name (the port's name begins with the JAX package's); the plain
reference loads nothing of the port either."""

import ast
import glob
import json
import os
import subprocess
import sys

from hebench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "hexl_fpga_tpu"}
PORT = "hexl_fpga_tpu_torch"

# a rehearsal of every cell in a fresh interpreter, then its modules' names
PROBE = """
import io, json, sys
sys.path.insert(0, {root!r})
from hebench import run
spec = json.loads({spec!r})
for cell in [c["name"] for c in spec["workloads"]]:
    for trace in ("0", "1"):
        assert run.main(["--workload", cell, "--seed", "11", "--seconds", "0.3",
                         "--trace", trace], spec=spec, rehearse=True,
                        out=io.StringIO(), err=io.StringIO()) == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=run.ROOT, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_spec):
    names = _top_names(PROBE.format(root=run.ROOT, spec=json.dumps(tiny_spec)))
    assert PORT in names and "hebench" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = _top_names(f"import sys; sys.path.insert(0, {run.ROOT!r}); "
                       "import json; "
                       "from hebench.reference import arith, dyadic, keyswitch, ntt, primes; "
                       "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & (FORBIDDEN | {PORT})


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(run.HERE, "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            tops = {m.split(".")[0] for m in mods}
            assert not tops & FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert PORT not in tops, path
