"""The check's control (the reference in float64 in the program's place)
comes out as not correct: at the rehearsals' size here, and at the cells'
own size on three seeds on the card."""

import pytest

from hebench import control

SEEDS = "3100000001,3100000002,3100000003"


def _cells(spec):
    return [c["name"] for c in spec["workloads"]]


def test_the_control_is_not_correct(tiny_spec):
    for cell in _cells(tiny_spec):
        for line in control.main(["--workload", cell, "--seeds", "5,6,7",
                                  "--ops", "4"], spec=tiny_spec, device="cpu"):
            assert not line["correct"] and line["mismatched_words"] > 0


@pytest.mark.card
def test_the_control_is_not_correct_on_the_card(card, spec):
    for cell in _cells(spec):
        for line in control.main(["--workload", cell, "--seeds", SEEDS,
                                  "--ops", "48"], spec=spec, device=card):
            assert not line["correct"] and line["mismatched_words"] > 0
