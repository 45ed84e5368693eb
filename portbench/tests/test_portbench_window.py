"""A whole run of a cell, cut to a tiny float64 CPU size: the result line's
keys and what the command does without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_cell

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


# per-env models: the scaled draws of the body and contact leaves
RANDOMIZED = {"leaves": ["body_mass", "body_inertia", "dof_armature", "jnt_stiffness",
                         "geom_size", "actuator_gainprm", "actuator_biasprm", "opt.gravity",
                         "pairs.solref"], "spread": 0.1}


@pytest.mark.parametrize("cell,randomization", [("rodent.flat", None),
                                                ("rodent.flat", RANDOMIZED),
                                                ("pair.flat", None)])
def test_tiny_cpu_window_result_line(cell, randomization):
    bench, entry, traffic, config = tiny_cell(cell, randomization=randomization)
    args = harness.parse_args(["--workload", cell, "--seed", str(2**31 + 12345), "--seconds",
                               "0.01", "--trace", "0"])
    result = harness.run_cell(args, torch.device("cpu"), time.perf_counter(), bench, entry,
                              traffic, config)
    line = json.loads(json.dumps(result))
    assert set(line) == CONTRACT_KEYS | {"check"}
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # float64 on both sides: the program's plain paths agree with the frozen copy
    assert all(c["value"] <= 1e-12 for c in line["check"].values())
    assert line["correct"] is True


def _command(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "rodent.flat",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_command_without_a_card_prints_no_result():
    out = _command(harness.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_command_without_the_port_prints_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = _command(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
