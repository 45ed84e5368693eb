"""Rollout collection and evaluation over a batched env.

Counterpart of ``brax_tracking_tpu/training/acting.py``:
- ``actor_step``: one policy action and env step, as a ``Transition``;
- ``generate_unroll``: ``unroll_length`` actor steps stacked time-major
  ``[T, B, ...]`` (the JAX ``lax.scan`` is a Python loop: every env step
  is a batch of eager ops and kernel launches);
- ``EvalWrapper`` and ``Evaluator``: full-episode metrics under the JAX
  package's names.

The policy's noise is a tensor ``eps`` of standard-normal draws, one
``(B, action_size)`` slice per step, made by the caller from its
generator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from brax_tracking_tpu_torch.device import synchronize
from brax_tracking_tpu_torch.envs.base import Env, State, Wrapper
from brax_tracking_tpu_torch.training import debug_nans
from brax_tracking_tpu_torch.training.types import Metrics, Policy, Transition


def actor_step(
    env: Env,
    env_state: State,
    policy: Policy,
    eps: Optional[torch.Tensor],
    extra_fields: Sequence[str] = (),
) -> Tuple[State, Transition]:
    """One policy action and env step; records the requested info fields."""
    actions, policy_extras = policy(env_state.obs, eps)
    nstate = env.step(env_state, actions)
    state_extras = {f: nstate.info[f] for f in extra_fields}
    return nstate, Transition(
        observation=env_state.obs,
        action=actions,
        reward=nstate.reward,
        discount=1 - nstate.done,
        next_observation=nstate.obs,
        extras={"policy_extras": policy_extras, "state_extras": state_extras},
    )


def generate_unroll(
    env: Env,
    env_state: State,
    policy: Policy,
    eps: Optional[torch.Tensor],
    unroll_length: int,
    extra_fields: Sequence[str] = (),
    compact: bool = False,
) -> Tuple[State, Transition]:
    """``unroll_length`` actor steps; ``eps`` is ``(unroll_length, B,
    action_size)`` (None for a deterministic policy). Returns the final
    state and the transitions stacked ``[T, B, ...]``.

    ``compact=True`` keeps neither ``next_observation`` (the loss reads
    only its last step, which is the final state's obs) nor the squashed
    ``action`` (the loss works from ``raw_action``): both come back None.
    """
    steps = []
    for t in range(unroll_length):
        env_state, transition = actor_step(
            env, env_state, policy, None if eps is None else eps[t], extra_fields
        )
        if compact:
            transition = transition.replace(next_observation=None, action=None)
        steps.append(transition)
    return env_state, Transition.stack(steps)


@dataclasses.dataclass
class EvalMetrics:
    """Per-env episode metric sums, active-episode mask, episode lengths."""

    episode_metrics: Dict[str, torch.Tensor]
    active_episodes: torch.Tensor
    episode_steps: torch.Tensor


class EvalWrapper(Wrapper):
    """Accumulates per-episode metric sums in ``state.info["eval_metrics"]``."""

    def _after_reset(self, state: State) -> State:
        metrics = dict(state.metrics, reward=state.reward)
        info = dict(state.info)
        info["eval_metrics"] = EvalMetrics(
            episode_metrics={k: torch.zeros_like(v) for k, v in metrics.items()},
            active_episodes=torch.ones_like(state.reward),
            episode_steps=torch.zeros_like(state.reward),
        )
        return state.replace(metrics=metrics, info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        info = dict(state.info)
        state_metrics = info.pop("eval_metrics")
        if not isinstance(state_metrics, EvalMetrics):
            raise ValueError(f"Incorrect type for state_metrics: {type(state_metrics)}")
        nstate = self.env.step(state.replace(info=info), action)
        metrics = dict(nstate.metrics, reward=nstate.reward)
        active = state_metrics.active_episodes
        episode_steps = torch.where(
            active.bool(),
            nstate.info.get("steps", state_metrics.episode_steps + 1),
            state_metrics.episode_steps,
        ).to(state_metrics.episode_steps.dtype)
        info = dict(nstate.info)
        info["eval_metrics"] = EvalMetrics(
            episode_metrics={
                k: v + metrics[k] * active for k, v in state_metrics.episode_metrics.items()
            },
            active_episodes=active * (1 - nstate.done),
            episode_steps=episode_steps,
        )
        return nstate.replace(metrics=metrics, info=info)


class Evaluator:
    """Runs full-episode evaluations of ``num_eval_envs`` envs; resets and
    policy noise are drawn from ``generator``."""

    def __init__(
        self,
        eval_env: Env,
        eval_policy_fn: Callable[..., Policy],
        num_eval_envs: int,
        episode_length: int,
        action_repeat: int,
        generator: torch.Generator,
    ):
        self._env = EvalWrapper(eval_env)
        self._eval_policy_fn = eval_policy_fn
        self._num_eval_envs = num_eval_envs
        self._unroll_length = episode_length // action_repeat
        self._generator = generator
        self._eval_walltime = 0.0
        self._steps_per_unroll = episode_length * num_eval_envs

    @torch.no_grad()
    def _unroll(self, policy_params, generator: torch.Generator) -> State:
        """One evaluation episode of every env: the final state (the JAX
        ``generate_eval_unroll``)."""
        state = self._env.reset(generator, self._num_eval_envs)
        eps = torch.randn(
            (self._unroll_length, self._num_eval_envs, self._env.action_size),
            generator=generator, dtype=state.obs.dtype, device=generator.device,
        )
        state, _ = generate_unroll(
            self._env, state, self._eval_policy_fn(policy_params), eps, self._unroll_length
        )
        return state

    def run_evaluation(self, policy_params, training_metrics: Metrics) -> Metrics:
        device = self._generator.device
        t = time.perf_counter()
        state = debug_nans.call("the evaluator's unroll", self._unroll, policy_params,
                                self._generator)
        eval_metrics = state.info["eval_metrics"]
        synchronize(device)
        epoch_eval_time = time.perf_counter() - t
        metrics = {}
        for suffix, fn in (("", torch.mean), ("_std", lambda v: torch.std(v, correction=0))):
            metrics.update({
                f"eval/episode_{name}{suffix}": float(fn(value))
                for name, value in eval_metrics.episode_metrics.items()
            })
        metrics["eval/avg_episode_length"] = float(torch.mean(eval_metrics.episode_steps))
        metrics["eval/epoch_eval_time"] = epoch_eval_time
        metrics["eval/sps"] = self._steps_per_unroll / epoch_eval_time
        self._eval_walltime += epoch_eval_time
        return {"eval/walltime": self._eval_walltime, **training_metrics, **metrics}
