"""PPO trainer: one card, or data-parallel over ``torch.distributed`` ranks.

Counterpart of ``brax_tracking_tpu/agents/ppo/train.py`` with the same
semantics: step accounting (``steps_per_train_step = num_minibatches *
batch_size * unroll_length * action_repeat``), ``n_unrolls = batch_size *
num_minibatches // num_envs`` unrolls per training step laid out rows x
time, the normalizer updated after the unroll and used by the loss, a
fresh row permutation per SGD pass cut into ``num_minibatches``, resets
between epochs when ``num_resets_per_eval > 0``, and the same evals,
checkpoints and final step check.

The JAX closures ``rollout_step`` and ``learn_step`` are module functions
here that take their random draws as tensors; ``train`` makes every draw
(reset, network init, action noise, permutations, entropy noise, eval)
from one generator seeded by ``seed``. The modules' parameters and the
optimizer's moments are updated in place.

Several cards (``mesh``, ``distributed/mesh.py``; by default the ranks
torchrun started, else one) are the JAX package's mesh shards: each rank
steps ``num_envs / world_size`` envs and holds the whole learner. The
unrolls per training step stay ``batch_size * num_minibatches // num_envs``
of the global ``num_envs``, so each rank learns from ``1 / world_size`` of
the rows, permuted and cut into ``num_minibatches`` on the rank; the
gradients are averaged across ranks before each Adam step, the normalizer
takes every rank's batch, the loss metrics are averaged. The network
init is rank 0's, broadcast; every other draw comes from the rank's own
generator (``fold_process_key``: rank 0's is the undistributed run's, so a
world of one through a process group is that run bitwise). Evals,
``progress_fn`` and ``policy_params_fn`` run on rank 0 only, checkpoints are
written by rank 0; at the end the training state is checked bitwise
replicated and the ranks meet at a barrier. ``training/sps`` counts the
env steps of all ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import time
from typing import Callable, Optional, Tuple

import torch

from brax_tracking_tpu_torch.agents.ppo import losses as losses_lib
from brax_tracking_tpu_torch.agents.ppo import networks as networks_lib
from brax_tracking_tpu_torch.device import resolve_device, same_device, synchronize
from brax_tracking_tpu_torch.distributed import mesh as dmesh
from brax_tracking_tpu_torch.envs import wrappers
from brax_tracking_tpu_torch.envs.base import Env, State
from brax_tracking_tpu_torch.training import (acting, checkpoint, debug_nans, gradients,
                                             running_statistics)
from brax_tracking_tpu_torch.training.types import Metrics, Transition

_logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainingState:
    """Learner state: the networks (policy and value parameters), their
    Adam optimizer, the normalizer and the env steps taken."""

    params: networks_lib.PPONetworks
    optimizer: torch.optim.Optimizer
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: int


def eval_params(ts: TrainingState) -> Tuple:
    """(normalizer, policy): the inference-side parameter view."""
    return (ts.normalizer_params, ts.params.policy)


def _to_rows(x: torch.Tensor) -> torch.Tensor:
    """[n_unrolls, T, envs, ...] -> [n_unrolls * envs, T, ...]."""
    x = x.transpose(1, 2)
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


@torch.no_grad()
def rollout_step(
    env: Env,
    make_policy: Callable,
    training_state: TrainingState,
    env_state: State,
    action_eps: torch.Tensor,
    group=None,
) -> Tuple[State, Transition, running_statistics.RunningStatisticsState]:
    """The acting half of a training step: ``action_eps.shape[0]`` unrolls
    of ``action_eps.shape[1]`` steps (``action_eps`` is ``(n_unrolls, T,
    envs, action_size)``), laid out rows x time with each unroll's final
    observation re-attached as ``next_observation[:, None]`` (the loss's
    bootstrap), then the normalizer updated on the observations (every
    rank's, under ``group``). Returns (env state, data, normalizer)."""
    policy = make_policy(eval_params(training_state))
    segments, boot_obs = [], []
    for eps in action_eps:
        env_state, segment = acting.generate_unroll(
            env, env_state, policy, eps, eps.shape[0], extra_fields=("truncation",), compact=True
        )
        segments.append(segment)
        boot_obs.append(env_state.obs)
    data = Transition.stack(segments).map(_to_rows)
    boot = torch.stack(boot_obs)
    data = data.replace(next_observation=boot.reshape((-1,) + boot.shape[2:])[:, None])
    normalizer_params = running_statistics.update(training_state.normalizer_params,
                                                  data.observation, group)
    return env_state, data, normalizer_params


def learn_step(
    training_state: TrainingState,
    data: Transition,
    normalizer_params: running_statistics.RunningStatisticsState,
    perms: torch.Tensor,
    entropy_eps: torch.Tensor,
    loss_fn: Callable,
    steps_per_train_step: int,
    group=None,
) -> Tuple[TrainingState, Metrics]:
    """The learner half: one SGD pass per row of ``perms`` (``(updates,
    rows)``), each cut into ``entropy_eps.shape[1]`` minibatches
    (``entropy_eps`` is ``(updates, minibatches, rows / minibatches, T,
    action_size)``), one Adam step per minibatch on the gradients averaged
    across the ranks of ``group``. Returns the state and this rank's loss
    metrics stacked ``(updates, minibatches)``."""
    update = gradients.gradient_update_fn(loss_fn, training_state.optimizer, group)
    num_updates, num_minibatches = entropy_eps.shape[:2]
    step_metrics = []
    for perm, eps_pass in zip(perms, entropy_eps):
        for rows, eps in zip(perm.reshape(num_minibatches, -1), eps_pass):
            mb = data.map(lambda x: x[rows])
            _, metrics = update(training_state.params, normalizer_params, mb, eps)
            step_metrics.append(metrics)
    stacked = {
        k: torch.stack([m[k] for m in step_metrics]).reshape(num_updates, num_minibatches)
        for k in step_metrics[0]
    }
    return dataclasses.replace(
        training_state,
        normalizer_params=normalizer_params,
        env_steps=training_state.env_steps + steps_per_train_step,
    ), stacked


def rollout_draws(generator: torch.Generator, n_unrolls: int, unroll_length: int,
                  num_envs: int, action_size: int, dtype: torch.dtype) -> torch.Tensor:
    """The action noise of one training step, ``(n_unrolls, T, envs, A)``."""
    return torch.randn((n_unrolls, unroll_length, num_envs, action_size), generator=generator,
                       dtype=dtype, device=generator.device)


def learn_draws(generator: torch.Generator, num_updates: int, num_minibatches: int, rows: int,
                unroll_length: int, action_size: int, dtype: torch.dtype):
    """The row permutations ``(updates, rows)`` and entropy noise
    ``(updates, minibatches, rows / minibatches, T, A)`` of one learn step."""
    dev = generator.device
    perms = torch.stack([
        torch.randperm(rows, generator=generator, device=dev) for _ in range(num_updates)
    ])
    eps = torch.randn((num_updates, num_minibatches, rows // num_minibatches, unroll_length,
                       action_size), generator=generator, dtype=dtype, device=dev)
    return perms, eps


def mean_across_ranks(metrics: Metrics, group) -> Metrics:
    """Each metric (tensors of one shape) averaged across the ranks of
    ``group`` in one all-reduce; the metrics as they are without one."""
    if group is None:
        return metrics
    return dict(zip(metrics, dmesh.all_reduce_mean(list(metrics.values()), group)))


def train(
    environment: Env,
    num_timesteps: int,
    episode_length: int,
    # --- rollout geometry -------------------------------------------------
    num_envs: int = 1,
    unroll_length: int = 10,
    action_repeat: int = 1,
    # --- optimization -----------------------------------------------------
    learning_rate: float = 1e-4,
    batch_size: int = 32,
    num_minibatches: int = 16,
    num_updates_per_batch: int = 2,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    normalize_advantage: bool = True,
    normalize_observations: bool = False,
    # --- evaluation -------------------------------------------------------
    num_evals: int = 1,
    num_eval_envs: int = 128,
    num_resets_per_eval: int = 0,
    deterministic_eval: bool = False,
    eval_env: Optional[Env] = None,
    # --- plumbing ---------------------------------------------------------
    seed: int = 0,
    network_factory: Callable = networks_lib.make_ppo_networks,
    progress_fn: Callable[[int, Metrics], None] = lambda *args: None,
    policy_params_fn: Callable[..., None] = lambda *args: None,
    randomization_fn: Optional[Callable] = None,
    restore_checkpoint_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
    mesh: Optional[dmesh.TrainMesh] = None,
):
    """PPO training on ``device``. Returns (make_policy, (normalizer,
    policy), metrics). ``environment`` is the unwrapped env, on ``device``;
    it is wrapped here for training and for the evals (``eval_env`` if
    given). ``network_factory`` is called as ``make_ppo_networks`` is, with
    ``generator``, ``device`` and ``dtype`` (the observations') keywords.
    ``randomization_fn(model, num_envs=..., generator=...)`` gives the
    training envs and the eval envs per-env models, one draw per env
    (envs/wrappers.py ``DomainRandomizationVmapWrapper``), from a generator
    of their own seeded by ``seed``, so every other draw is the one an
    unrandomized run makes. ``mesh`` (default ``make_train_mesh(device)``)
    names the ranks; its device is ``device``'s. On ranks other than 0 the
    returned metrics are the last epoch's training metrics."""
    if (batch_size * num_minibatches) % num_envs != 0:
        raise ValueError("batch_size * num_minibatches must divide by num_envs")
    dev = resolve_device(device)
    if mesh is None:
        mesh = dmesh.make_train_mesh(device)
    if not same_device(mesh.device, dev):
        raise ValueError(f"the mesh's device {mesh.device} is not {dev}")
    if num_envs % mesh.world_size != 0:
        raise ValueError(f"num_envs={num_envs} not divisible by {mesh.world_size} ranks")
    group, lead = mesh.group, mesh.rank == 0
    local_envs = num_envs // mesh.world_size
    t_start = time.perf_counter()

    # step accounting: one training step consumes num_minibatches * batch_size
    # rows of unroll_length transitions each
    steps_per_train_step = num_minibatches * batch_size * unroll_length * action_repeat
    epochs = max(num_evals - 1, 1)
    resets_per_epoch = max(num_resets_per_eval, 1)
    # ceil-divide so the requested step budget is always reached
    train_steps_per_epoch = -(-num_timesteps // (epochs * steps_per_train_step * resets_per_epoch))
    n_unrolls = (batch_size * num_minibatches) // num_envs
    # this rank's rows of the training step
    rows = n_unrolls * local_envs

    generator = dmesh.fold_process_key(seed, mesh.rank, dev)
    wrap_for_training = functools.partial(
        wrappers.wrap, episode_length=episode_length, action_repeat=action_repeat,
    )
    randomization_generator = torch.Generator(device=dev).manual_seed(seed)

    def randomized(n):
        """randomization_fn bound to n envs, or None."""
        if randomization_fn is None:
            return None
        return functools.partial(randomization_fn, num_envs=n,
                                 generator=randomization_generator)

    env = wrap_for_training(environment, randomization_fn=randomized(local_envs))
    env_state = debug_nans.call("the env reset", env.reset, generator, local_envs)
    obs_size, dtype = env_state.obs.shape[-1], env_state.obs.dtype
    action_size = env.action_size

    preprocess = (networks_lib.normalize_preprocessor if normalize_observations
                  else networks_lib.identity_preprocessor)
    ppo_network = network_factory(obs_size, action_size, preprocess_observations_fn=preprocess,
                                  generator=generator, device=dev, dtype=dtype)
    dmesh.broadcast_parameters(ppo_network, mesh)
    make_policy = networks_lib.make_inference_fn(ppo_network)
    loss_fn = functools.partial(
        losses_lib.compute_ppo_loss,
        entropy_cost=entropy_cost,
        discounting=discounting,
        reward_scaling=reward_scaling,
        gae_lambda=gae_lambda,
        clipping_epsilon=clipping_epsilon,
        normalize_advantage=normalize_advantage,
    )
    training_state = TrainingState(
        params=ppo_network,
        optimizer=gradients.make_optimizer(ppo_network.parameters(), learning_rate),
        normalizer_params=running_statistics.init_state(
            torch.zeros(obs_size, dtype=dtype, device=dev)),
        env_steps=0,
    )

    if num_timesteps == 0:
        return make_policy, eval_params(training_state), {}

    if restore_checkpoint_path is not None and os.path.exists(restore_checkpoint_path):
        # probe the layout first, so a partial checkpoint fails with its own error
        layout = checkpoint.checkpoint_layout(restore_checkpoint_path)
        _logger.info("restoring from checkpoint %s (layout: %s)", restore_checkpoint_path, layout)
        # a "reference" layout, (normalizer, params), restores those two only:
        # the optimizer and env_steps restart, as the reference resumes
        training_state = checkpoint.restore_checkpoint(restore_checkpoint_path, training_state)

    evaluator = acting.Evaluator(
        wrap_for_training(eval_env if eval_env else environment,
                          randomization_fn=randomized(num_eval_envs)),
        functools.partial(make_policy, deterministic=deterministic_eval),
        num_eval_envs=num_eval_envs,
        episode_length=episode_length,
        action_repeat=action_repeat,
        generator=generator,
    ) if lead else None

    training_walltime = 0.0

    def run_one_epoch(training_state, env_state):
        """train_steps_per_epoch training steps, timed from a barrier (rank 0
        may still be evaluating) to their end."""
        nonlocal training_walltime
        dmesh.synchronize_hosts(mesh)
        t0 = time.perf_counter()
        step_metrics = []
        for _ in range(train_steps_per_epoch):
            eps = rollout_draws(generator, n_unrolls, unroll_length, local_envs, action_size,
                                dtype)
            env_state, data, normalizer_params = debug_nans.call(
                "rollout_step", rollout_step, env, make_policy, training_state, env_state, eps,
                group)
            perms, entropy_eps = learn_draws(generator, num_updates_per_batch, num_minibatches,
                                             rows, unroll_length, action_size, dtype)
            training_state, metrics = debug_nans.call(
                "learn_step", learn_step, training_state, data, normalizer_params, perms,
                entropy_eps, loss_fn, steps_per_train_step, group)
            step_metrics.append(metrics)
        loss_metrics = mean_across_ranks(
            {k: torch.stack([m[k] for m in step_metrics]).mean() for k in step_metrics[0]}, group)
        loss_metrics = {k: float(v) for k, v in loss_metrics.items()}
        synchronize(dev)
        dt = time.perf_counter() - t0
        training_walltime += dt
        # the steps this call took on every rank: the JAX package multiplies
        # them by resets_per_epoch too, though this runs once per reset
        # (ROADMAP C)
        metrics = {
            "training/sps": train_steps_per_epoch * steps_per_train_step / dt,
            "training/walltime": training_walltime,
        }
        metrics.update({f"training/{k}": v for k, v in loss_metrics.items()})
        return training_state, env_state, metrics

    metrics = {}
    if lead and num_evals > 1:
        metrics = evaluator.run_evaluation(eval_params(training_state), training_metrics={})
        _logger.info("initial eval: %s", metrics)
        # keyed by the restored step count, 0 on a fresh run
        progress_fn(training_state.env_steps, metrics)

    training_metrics = {}
    current_step = 0
    for it in range(epochs):
        _logger.info("starting iteration %s %.1fs", it, time.perf_counter() - t_start)
        for _ in range(resets_per_epoch):
            training_state, env_state, training_metrics = run_one_epoch(training_state, env_state)
            current_step = training_state.env_steps
            if num_resets_per_eval > 0:
                env_state = debug_nans.call("the env reset", env.reset, generator, local_envs)

        if lead:
            metrics = evaluator.run_evaluation(eval_params(training_state), training_metrics)
            _logger.info("eval @%d: %s", current_step, metrics)
            progress_fn(current_step, metrics)
            policy_params_fn(current_step, make_policy, eval_params(training_state))
        else:
            metrics = training_metrics
        if checkpoint_dir is not None:
            checkpoint.save_checkpoint(f"{checkpoint_dir}/{current_step}", training_state, group)

    if current_step < num_timesteps:
        raise AssertionError(f"trained {current_step} < requested {num_timesteps} steps")
    dmesh.assert_is_replicated(dmesh.training_state_tensors(training_state), mesh)
    _logger.info("total steps: %s", current_step)
    dmesh.synchronize_hosts(mesh)
    return make_policy, eval_params(training_state), metrics
