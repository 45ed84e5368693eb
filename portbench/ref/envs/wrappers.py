"""Training wrapper stack, batch-first.

Counterpart of ``brax_tracking_tpu/envs/wrappers.py``: ``EpisodeWrapper``
(step counting + truncation), ``DomainRandomizationVmapWrapper`` (per-env
randomized physics parameters), ``AutoResetWrapperTracking`` (roll done
envs back to their reset-time state, tracking clock included) and
``RenderRolloutWrapperTracking`` (deterministic resets at frame 0). The envs
are already batched, so the JAX package's ``VmapWrapper`` has no
counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.ref.envs.base import Env, State, Wrapper
from portbench.ref.physics import model as M
from portbench.ref.physics import solver as S


def wrap(
    env: Env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
) -> Wrapper:
    """Episode bookkeeping, per-env models with a ``randomization_fn``,
    tracking-aware auto-reset (the JAX package's order)."""
    env = EpisodeWrapper(env, episode_length, action_repeat)
    if randomization_fn is not None:
        env = DomainRandomizationVmapWrapper(env, randomization_fn)
    return AutoResetWrapperTracking(env)


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


class DomainRandomizationVmapWrapper(Wrapper):
    """Per-env randomized physics parameters.

    ``randomization_fn(model) -> (batched_model, env_leaves)`` returns a
    Model whose leaves named in ``env_leaves`` ("body_mass", "opt.gravity",
    "pairs.solref") carry a leading axis of one value per env, the JAX
    package's contract with the leaf names in place of its vmap in_axes
    (the trainer binds the env count and a ``torch.Generator``:
    ``randomization_fn(model, num_envs=..., generator=...)``). A leaf the
    engine reads as a per-model constant raises by name
    (``physics/model.py::env_model``). Every reset and step runs with the
    batched model swapped into the unwrapped env and the shared one put
    back after, so the train and eval wrappers can share one env at their
    own batch sizes, as the JAX wrapper's ``_with_model`` does."""

    def __init__(self, env: Env, randomization_fn: Callable):
        super().__init__(env)
        base = getattr(self.env.unwrapped, "model", None)
        if not isinstance(base, M.Model):
            raise TypeError("per-env randomization needs an env over a physics model")
        out = randomization_fn(base)
        if not (isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], M.Model)):
            raise TypeError("randomization_fn must return (batched model, per-env leaf names)")
        self._model_v = M.env_model(base, out[0], out[1], S.static_leaves(base))

    def _with_model(self, batch_size: int, fn):
        """fn() with the env's model swapped for the batched one."""
        if batch_size != self._model_v.nenv:
            raise ValueError(f"the randomized model holds {self._model_v.nenv} envs, not "
                             f"{batch_size}")
        unwrapped = self.env.unwrapped
        old = unwrapped._model
        unwrapped._model = self._model_v
        try:
            return fn()
        finally:
            unwrapped._model = old

    def reset(self, generator: torch.Generator, batch_size: int) -> State:
        return self._with_model(batch_size, lambda: self.env.reset(generator, batch_size))

    def init_state(self, start_frame: torch.Tensor, *args, **kwargs) -> State:
        return self._with_model(start_frame.shape[0],
                                lambda: self.env.init_state(start_frame, *args, **kwargs))

    def step(self, state: State, action: torch.Tensor) -> State:
        return self._with_model(action.shape[0], lambda: self.env.step(state, action))


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
