"""The root conftest.py's `slow` marker: each entry names a real test, the
tier-1 command's `-m 'not slow'` leaves out exactly the marked tests of a
file and `-m slow` selects exactly them, and the file loads nothing but
pytest and the standard library."""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
CONFTEST = os.path.join(ROOT, "conftest.py")
HELD_FILE = "test_keyswitch_bgv.py"


def root_slow():
    spec = importlib.util.spec_from_file_location("root_conftest", CONFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SLOW


def collect(*args):
    """Node ids that pytest collects from HELD_FILE, from the repo root."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", f"tests/{HELD_FILE}", "--collect-only",
         "-q", "-p", "no:cacheprovider", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return {line.strip() for line in res.stdout.splitlines()
            if line.startswith(f"tests/{HELD_FILE}::")}


def test_every_slow_entry_names_a_test_in_its_file():
    slow = root_slow()
    assert slow
    for fname, func in slow:
        path = os.path.join(TESTS, fname)
        assert os.path.isfile(path), fname
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names = {node.name for node in tree.body if isinstance(node, ast.FunctionDef)}
        assert func in names, (fname, func)


def test_root_conftest_imports_only_pytest_and_the_standard_library():
    with open(CONFTEST) as fh:
        tree = ast.parse(fh.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert "pytest" in tops
    assert tops <= {"pytest"} | set(sys.stdlib_module_names), tops


@pytest.fixture(scope="module")
def every_test():
    return collect()


@pytest.mark.parametrize("expr", ["not slow", "slow"])
def test_slow_mark_splits_the_file(expr, every_test):
    held = {f"tests/{HELD_FILE}::{func}" for fname, func in root_slow()
            if fname == HELD_FILE}
    assert held and held <= every_test  # with no -m, every test is collected
    want = every_test - held if expr == "not slow" else held
    assert collect("-m", expr) == want
