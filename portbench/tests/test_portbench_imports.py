"""The check that no run holds JAX, the JAX package or the repository's
scripts once its window has closed: top-level names compared whole."""

import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.parametrize("name,bad", [
    ("brax_tracking_tpu_torch", False),
    ("brax_tracking_tpu_torch.physics.step", False),
    ("brax_tracking_tpu", True),
    ("brax_tracking_tpu.physics", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("jaxtyping", False), ("flax", True), ("optax", True), ("orbax.checkpoint", True),
    ("chip_smoke", True), ("scripts.profile_torch_rollout", True), ("scripts_x", False),
    ("portbench.harness", False), ("torch", False),
])
def test_top_level_names_compared_whole(name, bad):
    assert bool(harness.forbidden_modules([name])) == bad


def test_a_run_loads_none_of_them():
    """A tiny CPU run in a fresh interpreter leaves no forbidden module."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from portbench import harness\n"
        "from tiny import tiny_cell\n"
        "args = harness.parse_args(['--workload', 'rodent.flat', '--seed', '3', '--seconds', "
        "'0.01', '--trace', '0'])\n"
        "harness.run_cell(args, torch.device('cpu'), time.perf_counter(), "
        "*tiny_cell('rodent.flat'))\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code, harness.HERE + "/tests"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
