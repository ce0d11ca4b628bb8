"""Root test configuration: the `slow` marker and the one test it names.

The tier-1 command runs `pytest tests/ -m 'not slow'` under a limit of
1,470 s for the whole suite.  One test runs far past that on the CPU:
`tests/test_keyswitch_bgv.py::test_device_bgv_matches_golden_fused`, the
JAX package's fused BGV KeySwitch at n = 1024, t = 65537, in interpret mode.
Run alone from an empty compile cache it was cut at 2,400 s; its CKKS twin
takes 32 s.  Under `--dist loadfile` it also holds back the tests after it in
its file.  So it is marked `slow` here, and the tier-1 command's own
`-m 'not slow'` leaves it out.  Nothing is skipped: with no `-m` the test
runs, and by node id it runs alone:

    python -m pytest -p no:cacheprovider \\
        tests/test_keyswitch_bgv.py::test_device_bgv_matches_golden_fused

This file imports only pytest and the standard library, so every test
directory loads it at no cost.  Mark a test here only if it takes hundreds
of seconds alone.
"""

import pytest

# (file name, test function name); matched on names, not node ids, so that
# any rootdir gives the same result
SLOW = {
    ("test_keyswitch_bgv.py", "test_device_bgv_matches_golden_fused"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: truly slow on the CPU; deselected by the tier-1 command's "
        "-m 'not slow'; run it by node id",
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.path.name, getattr(item, "originalname", None)) in SLOW:
            item.add_marker(pytest.mark.slow)
