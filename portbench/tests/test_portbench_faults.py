"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU (its look for a card skipped) at a tiny size in
float64, with each fault a training cell on one card can have planted
in the program, judged by the cell's own limits. The exchange between
cards is no fault of a one-card cell."""

import time

import pytest
import torch

from portbench import harness, readings
from portbench.tests.tiny import tiny_cell


def judged_run(cell, fault):
    bench, entry, traffic, config = tiny_cell(cell)
    args = harness.parse_args(["--workload", cell, "--seed", "77", "--seconds", "0.01",
                               "--trace", "0"])
    with readings.planted(fault):
        return harness.run_cell(args, torch.device("cpu"), time.perf_counter(), bench, entry,
                                traffic, config)


@pytest.mark.parametrize("cell", ["rodent.flat", "pair.flat"])
@pytest.mark.parametrize("fault", [None, *readings.FAULTS])
def test_fault_is_not_correct(cell, fault):
    result = judged_run(cell, fault)
    assert result["correct"] is (fault is None), result["check"]
