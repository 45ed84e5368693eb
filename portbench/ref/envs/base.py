"""Env base: State, the Env/Wrapper protocol, the physics substep loop.

Counterpart of ``brax_tracking_tpu/envs/base.py``. Envs here are batched
objects: ``reset`` returns the state of a whole batch of envs and ``step``
advances all of them; every tensor is batch-first. There is no vmap
wrapper.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict

import torch

from portbench.ref.physics import model as M
from portbench.ref.physics import step as pstep


@dataclasses.dataclass
class State:
    """Batched env state, the brax State field contract."""

    pipeline_state: M.Data
    obs: torch.Tensor  # (B, obs)
    reward: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) 0/1 float
    metrics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kwargs) -> "State":
        return dataclasses.replace(self, **kwargs)


class Env(abc.ABC):
    """Abstract batched env over the physics engine."""

    @abc.abstractmethod
    def reset(self, generator: torch.Generator, batch_size: int) -> State:
        ...

    @abc.abstractmethod
    def step(self, state: State, action: torch.Tensor) -> State:
        ...

    @property
    @abc.abstractmethod
    def observation_size(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def action_size(self) -> int:
        ...

    @property
    def unwrapped(self) -> "Env":
        return self


class PipelineEnv(Env):
    """Env owning a physics Model; ``pipeline_step`` runs ``n_frames``
    physics substeps per control step."""

    def __init__(self, model: M.Model, n_frames: int = 1):
        self._model = model
        self._n_frames = n_frames

    @property
    def model(self) -> M.Model:
        return self._model

    @property
    def device(self) -> torch.device:
        return self._model.device

    @property
    def dt(self) -> torch.Tensor:
        """Control timestep (physics dt * substeps)."""
        return self._model.opt.timestep * self._n_frames

    @property
    def action_size(self) -> int:
        return self._model.nu

    def pipeline_init(self, qpos: torch.Tensor, qvel: torch.Tensor) -> M.Data:
        d = pstep.make_data(self._model, qpos.shape[0], device=self.device)
        return pstep.forward(self._model, d.replace(qpos=qpos, qvel=qvel))

    def pipeline_step(self, data: M.Data, action: torch.Tensor) -> M.Data:
        data = data.replace(ctrl=action.to(data.qpos.dtype))
        for _ in range(self._n_frames):
            data = pstep.step(self._model, data, device=self.device)
        return data


class Wrapper(Env):
    """Delegating wrapper. Both reset entries (``reset`` and
    ``init_state``) pass through ``_after_reset``."""

    def __init__(self, env: Env):
        self.env = env

    def _after_reset(self, state: State) -> State:
        return state

    def reset(self, *args, **kwargs) -> State:
        return self._after_reset(self.env.reset(*args, **kwargs))

    def init_state(self, *args, **kwargs) -> State:
        return self._after_reset(self.env.init_state(*args, **kwargs))

    def step(self, state: State, action: torch.Tensor) -> State:
        return self.env.step(state, action)

    @property
    def observation_size(self) -> int:
        return self.env.observation_size

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def __getattr__(self, name):
        if name == "env":
            raise AttributeError("env")
        return getattr(self.env, name)
