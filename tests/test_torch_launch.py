"""The port's launcher (harness/launch.py), its driver on two ranks and the
kernel build's lock guard (ops/library.py::build_lock), on the CPU.

- Dry runs of the three modes, as tests/test_launch.py runs
  scripts/launch.py's: the sbatch script's torchrun line, one torchrun
  command per host with its node rank, torchrun on this machine.
- ``driver.main(['train=smoke', 'dataset=minirat', ...], device='cpu')`` on
  two gloo ranks with torchrun's environment (tests/_torch_dist_worker.py):
  rank 0 alone writes the config, ``metrics.jsonl``, the clip cache, the
  checkpoint and ``final`` (the files each rank opened for writing, from
  the interpreter's audit events), and both ranks end with the same params
  bitwise.
- The build's guard without ``nvcc``: a ``_build/lock`` left by a dead build
  is logged and removed before ``load`` runs, and the guard waits while
  another process holds the ``flock``, until it lets go or is killed.
"""

import json
import logging
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from brax_tracking_tpu_torch.harness import launch
from brax_tracking_tpu_torch.ops import library
from _torch_dist_worker import free_ports, spawn_ranks, wait_ranks

DRIVER = "-m brax_tracking_tpu_torch.harness.driver"
# tests/test_torch_harness.py's cuts of the smoke run: one training step of
# 64 env steps (8 envs, 4 per rank), a 16-frame clip
CUTS = ["train=smoke", "dataset=minirat", "train.num_timesteps=64", "train.eval_every=64",
        "train.episode_length=4", "dataset.clip_length=16"]


def _launch(argv, capsys):
    launch.main(argv)
    return capsys.readouterr().out


def test_slurm_dry_run(tmp_path, capsys):
    log_dir = str(tmp_path / "slurm")
    out = _launch(["slurm", "--dry-run", "--gpus", "4", "--hours", "12", "--partition",
                   "gpu_requeue", "--log-dir", log_dir, "--", "train=train_rodent",
                   "dataset=rodent"], capsys)
    assert "#SBATCH --partition=gpu_requeue" in out and "#SBATCH --gres=gpu:4" in out
    assert "#SBATCH --time=12:00:00" in out
    assert f"torchrun --standalone --nproc-per-node 4 {DRIVER} train=train_rodent " \
           "dataset=rodent" in out
    with open(os.path.join(log_dir, "job.sbatch")) as f:
        assert f.read() in out


def test_hosts_dry_run(capsys):
    out = _launch(["hosts", "--dry-run", "--hosts", "gpu-host-0:9999,gpu-host-1",
                   "--nproc-per-node", "8", "--", "train=train_rodent"], capsys)
    lines = [line for line in out.splitlines() if line.startswith("ssh ")]
    assert len(lines) == 2
    for i, line in enumerate(lines):
        assert line.startswith(f"ssh gpu-host-{i} ")
        assert (f"torchrun --nnodes 2 --node-rank {i} --nproc-per-node 8 --master-addr "
                f"gpu-host-0 --master-port 9999 {DRIVER} train=train_rodent") in line
    # the rendezvous port defaults to torchrun's
    out = _launch(["hosts", "--dry-run", "--hosts", "a,b,c", "--", "train=smoke"], capsys)
    assert out.count("--master-addr a --master-port 29500") == 3


def test_local_dry_run(capsys):
    out = _launch(["local", "--dry-run", "--nproc-per-node", "2", "--", "train=smoke"], capsys)
    assert f"-m torch.distributed.run --standalone --nproc-per-node 2 {DRIVER} train=smoke" \
           in out
    assert out.startswith(sys.executable)


# --- the driver on two ranks ---------------------------------------------------


@pytest.fixture(scope="module")
def driver_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver")
    (port,) = free_ports(1)
    argv = json.dumps(CUTS + [f"paths.base_dir={tmp}/run", f"paths.data_dir={tmp}/data"])
    procs = spawn_ranks("driver", lambda r: [argv, str(tmp / f"rank{r}.p")], 2, port,
                        str(tmp))
    wait_ranks(procs, str(tmp))
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.p", "rb") as f:
            out.append(pickle.load(f))
    return out, tmp


def test_driver_writes_on_rank_zero_only(driver_ranks):
    out, tmp = driver_ranks
    run = "run/ckpt/single_clip_tracking_track_smoke"
    written = set(out[0]["written"])
    for rel in ("run/run_config.yaml", "run/logs/metrics.jsonl", "data/clips/0.npz",
                "run/ckpt/64", f"{run}/64", f"{run}/final", f"{run}/rollout_64.p"):
        assert rel in written, rel
    assert out[1]["written"] == []
    records = [json.loads(line) for line in open(tmp / "run" / "logs" / "metrics.jsonl")]
    assert sum("_config" in r for r in records) == 1
    assert "eval/episode_reward" in out[0]["metrics"]
    assert "training/sps" in out[1]["metrics"] and not any(
        k.startswith("eval/") for k in out[1]["metrics"])


def test_driver_ranks_end_with_equal_params(driver_ranks):
    out, tmp = driver_ranks
    a, b = out
    assert a["policy"].keys() == b["policy"].keys() and len(a["policy"]) == 6
    for k in a["policy"]:
        np.testing.assert_array_equal(a["policy"][k], b["policy"][k], err_msg=k)
    for k in a["normalizer"]:
        np.testing.assert_array_equal(a["normalizer"][k], b["normalizer"][k], err_msg=k)
    # the normalizer counted both ranks' envs: the run's 64 env steps
    assert float(a["normalizer"]["count"]) == 64


# --- the kernel build's lock guard -------------------------------------------


def test_build_lock_removes_a_stale_baton(tmp_path, caplog):
    stale = tmp_path / "lock"
    stale.write_text("")
    with caplog.at_level(logging.WARNING, logger=library.__name__):
        with library.build_lock(str(tmp_path)):
            assert not stale.exists()
    assert any("left by a build that did not finish" in r.getMessage()
               for r in caplog.records)
    assert (tmp_path / "build.flock").exists()


def test_build_removes_a_stale_baton_before_load(tmp_path, monkeypatch):
    """build() reaches load() with the dead build's baton gone (load would
    wait on it forever); load itself needs nvcc, absent here."""
    import torch.utils.cpp_extension as cpp

    (tmp_path / "lock").write_text("")
    seen = []

    def fake_load(**kwargs):
        seen.append((kwargs["build_directory"], os.path.exists(tmp_path / "lock")))
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(library, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(library, "_LIB", None)
    monkeypatch.setattr(cpp, "load", fake_load)
    with pytest.raises(RuntimeError, match="no nvcc"):
        library.build()
    assert seen == [(str(tmp_path), False)]


_HOLDER = """
import fcntl, sys, time
f = open(sys.argv[1], "a")
fcntl.flock(f, fcntl.LOCK_EX)
print("held", flush=True)
time.sleep(float(sys.argv[2]))
"""


@pytest.mark.parametrize("ending", ["exits", "killed"])
def test_build_lock_waits_for_a_holder(tmp_path, ending):
    """Another process holds the flock: the guard waits until it exits, or
    until it is killed (the kernel drops a dead holder's lock)."""
    hold = 1.5 if ending == "exits" else 600.0
    holder = subprocess.Popen([sys.executable, "-c", _HOLDER, str(tmp_path / "build.flock"),
                               str(hold)], stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        if ending == "killed":
            threading.Timer(1.0, holder.kill).start()
        t0 = time.perf_counter()
        with library.build_lock(str(tmp_path)):
            waited = time.perf_counter() - t0
            assert holder.wait(timeout=5) == (0 if ending == "exits" else -9)
        assert 0.5 < waited < 30.0, waited
    finally:
        holder.kill()
        holder.wait()
