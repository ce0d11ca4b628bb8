"""The benchmark's tests: on the CPU, except those marked `card`, which skip
without a CUDA device (decided inside the `card` fixture, never at import).

    python -m pytest hebench/tests -q                      # the CPU
    python -m pytest hebench/tests -q -m card              # on the H100
"""

import copy
import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the H100")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny_spec(spec):
    """BENCHMARK.json with each configuration swapped for the test-only one
    of its op (tests/configs/tiny_<op>.json): the rehearsals' size."""
    tiny = copy.deepcopy(spec)
    for c in tiny["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            op = json.load(f)["op"]
        c["file"] = f"hebench/tests/configs/tiny_{op}.json"
    return tiny


@pytest.fixture
def rehearse(tiny_spec, monkeypatch):
    """rehearse(cell, trace=0, seed=..., **overrides) -> (rc, result line as
    a dict or None, stderr text): one run of the cell on the CPU at the tiny
    configurations, with the environment put back afterwards."""
    from hebench import run

    for k in (*run.PORT_KNOBS, "USE_FLAX"):
        monkeypatch.delenv(k, raising=False)  # put back at teardown

    def go(cell, trace=0, seed=3_000_000_019, seconds=1.0, **overrides):
        out, err = io.StringIO(), io.StringIO()
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], spec=tiny_spec,
                      rehearse=True, out=out, err=err, overrides=overrides)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

    return go
