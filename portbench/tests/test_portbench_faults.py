"""A run with the timed path broken underneath comes out not correct.

The harness's run (`bench.run_cell`: set-up, window, comparison) is driven
on the CPU at the small width, past run.py's look for a card, with one
fault of `portbench/faults.py` planted in the program for each fault these
cells can have.
"""

import pytest

from portbench import bench
from portbench.conftest import make_small_root
from portbench.faults import FAULTS
from portbench.tests.test_portbench_reference import SMALL_LIMITS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("faults"), limits=SMALL_LIMITS)


@pytest.mark.parametrize("cell", ["small.small_long", "small.small_many"])
def test_a_sound_run_is_correct(root, cell):
    assert bench.run_cell(root, cell, 11, 0.0, trace=False, device="cpu")["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["small.small_long", "small.small_many"])
def test_a_fault_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = bench.run_cell(root, cell, 11, 0.0, trace=False, device="cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
