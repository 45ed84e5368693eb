"""Training wrapper stack, batch-first.

Counterpart of ``brax_tracking_tpu/envs/wrappers.py``: ``EpisodeWrapper``
(step counting + truncation), ``AutoResetWrapperTracking`` (roll done
envs back to their reset-time state, tracking clock included) and
``RenderRolloutWrapperTracking`` (deterministic resets at frame 0). The envs
are already batched, so the JAX package's ``VmapWrapper`` has no
counterpart; per-env randomized models are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from brax_tracking_tpu_torch.envs.base import Env, State, Wrapper
from brax_tracking_tpu_torch.physics import model as M


def wrap(
    env: Env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
) -> Wrapper:
    """Episode bookkeeping + tracking-aware auto-reset."""
    if randomization_fn is not None:
        M.unported("per-env randomized models", "§A.12")
    return AutoResetWrapperTracking(EpisodeWrapper(env, episode_length, action_repeat))


class EpisodeWrapper(Wrapper):
    """Truncates episodes at episode_length steps (with action_repeat)."""

    def __init__(self, env: Env, episode_length: int, action_repeat: int):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def _after_reset(self, state: State) -> State:
        info = dict(state.info)
        info["steps"] = torch.zeros(state.reward.shape, dtype=torch.int32, device=state.reward.device)
        info["truncation"] = torch.zeros_like(state.reward)
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        reward = 0.0
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
            reward = reward + state.reward
        info = dict(state.info)
        steps = info["steps"] + self.action_repeat
        over = steps >= self.episode_length
        info["truncation"] = torch.where(over, 1 - state.done, torch.zeros_like(state.done))
        info["steps"] = steps
        done = torch.where(over, torch.ones_like(state.done), state.done)
        return state.replace(reward=reward, done=done, info=info)


class AutoResetWrapperTracking(Wrapper):
    """Restores the reset-time snapshot where done (cheap pseudo-reset):
    physics state, observation and the tracking clock roll back to their
    values at reset, rather than being re-sampled."""

    # tracking-clock info fields snapshotted when the env provides them
    _CLOCK_KEYS = ("cur_frame", "steps_taken_cur_frame")

    def _after_reset(self, state: State) -> State:
        snap = {"pipeline_state": state.pipeline_state, "obs": state.obs}
        for k in self._CLOCK_KEYS:
            if k in state.info:
                snap[k] = state.info[k]
        info = dict(state.info)
        info["autoreset_snapshot"] = snap
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        # a finished env re-enters the pool: zero its episode clock and
        # clear the flag before stepping
        info = dict(state.info)
        if "steps" in info:
            info["steps"] = torch.where(
                state.done.bool(), torch.zeros_like(info["steps"]), info["steps"]
            )
        state = self.env.step(
            state.replace(done=torch.zeros_like(state.done), info=info), action
        )

        snap = state.info["autoreset_snapshot"]
        rollback = state.done.bool()

        def merge(initial, current):
            mask = rollback.reshape(rollback.shape + (1,) * (current.dim() - 1))
            return torch.where(mask, initial, current)

        current = state.pipeline_state.tensors()
        initial = snap["pipeline_state"].tensors()
        if initial.keys() != current.keys():
            raise ValueError("reset and step produced different physics fields")
        data = state.pipeline_state.replace(
            **{k: merge(initial[k], v) for k, v in current.items()}
        )
        info = dict(state.info)
        for k in self._CLOCK_KEYS:
            if k in snap:
                info[k] = merge(snap[k], info[k])
        return state.replace(
            pipeline_state=data, obs=merge(snap["obs"], state.obs), info=info
        )


class RenderRolloutWrapperTracking(Wrapper):
    """Deterministic eval resets: every env starts at frame 0 (and clip 0 in
    a multi-clip env), with the reset noise drawn from ``generator``."""

    def reset(self, generator: torch.Generator, batch_size: int) -> State:
        env = self.unwrapped
        start_frame = torch.zeros(batch_size, dtype=torch.int32, device=env.device)
        return env.reset_to_frame(start_frame, generator)
