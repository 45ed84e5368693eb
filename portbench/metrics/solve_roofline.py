"""The solve kernel's share of its roofline: its least time at the cell's
sizes (``counts/solve.py``: bytes over the HBM rate or FP32 operations over
the peak, whichever is larger; at the 4 CG iterations and 4 line-search
steps the configuration caps, since the kernel does not report the
iterations each env needed) over its profiled device time per launch, in
percent."""

from portbench.counts import solve


def read(run):
    n, seconds = run.kernels("cg_fused_kernel")
    if not n:
        return None
    args = run.config["env_args"]
    rand = run.traffic.get("randomization") or {}
    s = solve.sizes(run.model_file)
    _, _, least, _ = solve.launch(s, run.geometry.envs, args["iterations"],
                                  args["ls_iterations"],
                                  per_env_armature="dof_armature" in rand.get("leaves", ()))
    return 100.0 * least / (seconds / n)
