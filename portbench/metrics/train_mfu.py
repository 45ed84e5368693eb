"""The whole training step's share of the card's FP32 peak, in percent:
the counted FLOPs of the profiled steps (the policy MLP per env and control
step, the learner's forward and backward per row and pass,
``counts/mlp.py``; the solve kernel's counted operations per launch,
``counts/solve.py``) over their wall time times 67 TFLOP/s. The eager
engine's ops are not counted, so it is a lower bound."""

from portbench.counts import H100_FP32_FLOPS, mlp, solve


def read(run):
    if not run.events.device:
        return None
    g, args = run.geometry, run.config["env_args"]
    rand = run.traffic.get("randomization") or {}
    _, solve_flops, _, _ = solve.launch(
        solve.sizes(run.model_file), g.envs, args["iterations"], args["ls_iterations"],
        per_env_armature="dof_armature" in rand.get("leaves", ()))
    flops = run.training_steps * mlp.training_step(run.obs_size, run.action_size,
                                                   run.config, g) + run.substeps * solve_flops
    return 100.0 * flops / (run.wall_s * H100_FP32_FLOPS)
