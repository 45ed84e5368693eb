"""Launcher of the port's driver on several GPUs: a SLURM job, a command per
host, or torchrun on this machine.

Counterpart of ``scripts/launch.py``, which starts the JAX package's
driver. Every mode starts one driver process per GPU through ``torchrun``,
whose environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) the driver reads
(``distributed/mesh.py::make_train_mesh``). ``--nproc-per-node`` is the
JAX ``max_devices_per_host``: the ranks on each node, one per GPU.

    python -m brax_tracking_tpu_torch.harness.launch slurm --gpus 4 -- train=train_rodent
    python -m brax_tracking_tpu_torch.harness.launch hosts --hosts node0:29500,node1 \\
        --nproc-per-node 8 -- train=train_rodent
    python -m brax_tracking_tpu_torch.harness.launch local --nproc-per-node 2 -- \\
        train=smoke dataset=minirat

``--dry-run`` prints (and for ``slurm`` writes) what it would run without
running it.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

DRIVER = "brax_tracking_tpu_torch.harness.driver"
DEFAULT_PORT = 29500

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --partition={partition}
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --gres=gpu:{gpus}
#SBATCH --cpus-per-task={cpus}
#SBATCH --mem={mem}
#SBATCH --time={hours}:00:00
#SBATCH --output={log_dir}/%j.out
#SBATCH --requeue

{env_setup}
torchrun --standalone --nproc-per-node {gpus} -m {driver} {overrides}
"""


def _join(argv) -> str:
    return " ".join(shlex.quote(a) for a in argv)


def launch_slurm(args, overrides) -> None:
    """Writes ``<log-dir>/job.sbatch`` (one node, torchrun with one rank per
    GPU) and submits it with sbatch."""
    script = SBATCH_TEMPLATE.format(
        job_name=args.job_name, partition=args.partition, gpus=args.gpus, cpus=args.cpus,
        mem=args.mem, hours=args.hours, log_dir=args.log_dir, env_setup=args.env_setup,
        driver=DRIVER, overrides=_join(overrides))
    os.makedirs(args.log_dir, exist_ok=True)
    path = os.path.join(args.log_dir, "job.sbatch")
    with open(path, "w") as f:
        f.write(script)
    print(script)
    if not args.dry_run:
        subprocess.run(["sbatch", path], check=True)


def host_commands(hosts: str, nproc_per_node: int, overrides) -> list:
    """One ``ssh host 'torchrun ...'`` command per host of ``hosts``
    (``host0[:port],host1,...``): node rank i of N, rank 0's node the
    rendezvous (port 29500 unless given)."""
    names = [h.split(":")[0] for h in hosts.split(",")]
    head = hosts.split(",")[0]
    port = int(head.split(":")[1]) if ":" in head else DEFAULT_PORT
    out = []
    for i, host in enumerate(names):
        cmd = ["torchrun", "--nnodes", str(len(names)), "--node-rank", str(i),
               "--nproc-per-node", str(nproc_per_node), "--master-addr", names[0],
               "--master-port", str(port), "-m", DRIVER, *overrides]
        out.append(f"ssh {host} {shlex.quote(_join(cmd))}")
    return out


def launch_hosts(args, overrides) -> None:
    """Prints the command of each host and, unless a dry run, starts them
    (ssh fan-out) and waits for all; a failed host fails the launch."""
    cmds = host_commands(args.hosts, args.nproc_per_node, overrides)
    for cmd in cmds:
        print(cmd)
    if args.dry_run:
        return
    procs = [subprocess.Popen(cmd, shell=True) for cmd in cmds]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"host commands exited with {codes}")


def local_command(nproc_per_node: int, overrides) -> list:
    """torchrun (as ``python -m torch.distributed.run``) on this machine."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            str(nproc_per_node), "-m", DRIVER, *overrides]


def launch_local(args, overrides) -> None:
    cmd = local_command(args.nproc_per_node, overrides)
    print(_join(cmd))
    if not args.dry_run:
        subprocess.run(cmd, check=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)

    s = sub.add_parser("slurm")
    s.add_argument("--job-name", default="brax_tracking_tpu_torch")
    s.add_argument("--partition", default="gpu_requeue")
    s.add_argument("--gpus", type=int, default=4, help="GPUs of the node, one rank each")
    s.add_argument("--cpus", type=int, default=16)
    s.add_argument("--mem", default="128G")
    s.add_argument("--hours", type=int, default=12)
    s.add_argument("--log-dir", default="./slurm_logs")
    s.add_argument("--env-setup", default="")
    s.add_argument("--dry-run", action="store_true")

    h = sub.add_parser("hosts")
    h.add_argument("--hosts", required=True, help="host0[:port],host1,...")
    h.add_argument("--nproc-per-node", type=int, default=1, help="ranks (GPUs) per host")
    h.add_argument("--dry-run", action="store_true")

    lo = sub.add_parser("local")
    lo.add_argument("--nproc-per-node", type=int, default=1, help="ranks (GPUs) to start")
    lo.add_argument("--dry-run", action="store_true")

    args, overrides = p.parse_known_args(argv)
    overrides = [o for o in overrides if o != "--"]
    {"slurm": launch_slurm, "hosts": launch_hosts, "local": launch_local}[args.mode](
        args, overrides)


if __name__ == "__main__":
    main()
