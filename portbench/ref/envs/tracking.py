"""Core motion-tracking MDP over a batch of envs.

Counterpart of ``brax_tracking_tpu/envs/tracking.py`` (``TrackingEnv``,
``GenericSingleClip``): the same
frame clock, six tracking reward terms, termination (with the NaN guard)
and reference-window observation, with the same reference quirks
(exp(-k * (sum diff)^2); free-root envs track qpos[7:]). Indices into the
clip clamp to its range, as the JAX package's gathers do.

Every reference read goes through ``_ref_rows``, which indexes the clip's
frames.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.data.clips import ReferenceClip
from portbench.ref.device import resolve_device, same_device
from portbench.ref.envs.base import PipelineEnv, State
from portbench.ref.physics import model as M
from portbench.ref.physics import spec as bspec

_METRICS = (
    "pos_reward", "quat_reward", "joint_reward", "angvel_reward",
    "bodypos_reward", "endeff_reward", "reward_quadctrl", "reward_alive",
    "too_far", "bad_pose", "bad_quat", "fall",
)


def _lookup(model: M.Model, objtype: str, names: Sequence[str], strict: bool):
    idxs = [bspec.name2id(model, objtype, n) for n in names]
    if strict:
        missing = [n for n, i in zip(names, idxs) if i < 0]
        if missing:
            raise ValueError(f"unknown {objtype} names: {missing}")
    return np.array(idxs, np.int64)


class TrackingEnv(PipelineEnv):
    """Single-clip tracking MDP over a model on one device.

    ``appendage_names`` and ``free_jnt`` are accepted for config parity and
    unused, as in the JAX package (the model decides whether the root is
    free).
    """

    def __init__(
        self,
        model: M.Model,
        reference_clip: ReferenceClip,
        center_of_mass: str,
        end_eff_names: List[str],
        body_names: List[str],
        joint_names: List[str],
        appendage_names: Optional[List[str]] = None,
        mocap_hz: int = 50,
        ref_len: int = 5,
        too_far_dist: float = 0.1,
        bad_pose_dist: float = math.inf,
        bad_quat_dist: float = math.inf,
        ctrl_cost_weight: float = 0.01,
        pos_reward_weight: float = 0.0,
        quat_reward_weight: float = 1.0,
        joint_reward_weight: float = 10.0,
        angvel_reward_weight: float = 1.0,
        bodypos_reward_weight: float = 1.0,
        endeff_reward_weight: float = 1.0,
        healthy_reward: float = 0.25,
        healthy_z_range: Tuple[float, float] = (0.03, 0.5),
        physics_steps_per_control_step: int = 10,
        reset_noise_scale: float = 1e-3,
        terminate_when_unhealthy: bool = True,
        free_jnt: bool = True,
        joint_obs_over_full_qpos: Optional[bool] = None,
        include_root_obs: Optional[bool] = None,
        start_frame_range: Tuple[int, int] = (0, 44),
        strict_name_lookup: bool = False,
        device="cuda",
        **kwargs,
    ):
        dev = resolve_device(device)
        if not same_device(model.device, dev):
            raise ValueError(f"the model lives on {model.device}, not {dev}")
        super().__init__(model, n_frames=physics_steps_per_control_step)

        # physics substeps per mocap frame; round, not truncate (a float32
        # 0.002 timestep would floor 10.0 down to 9)
        max_steps = round(1.0 / (mocap_hz * float(model.opt.timestep)))
        if max_steps % physics_steps_per_control_step != 0:
            raise ValueError(
                f"physics_steps_per_control_step ({physics_steps_per_control_step})"
                f" must be a factor of ({max_steps})"
            )
        self._steps_for_cur_frame = max_steps // physics_steps_per_control_step

        self._thorax_idx = bspec.name2id(model, "body", center_of_mass)
        self._joint_idxs = _lookup(model, "joint", joint_names, strict_name_lookup)
        self._body_idxs = _lookup(model, "body", body_names, strict_name_lookup)
        self._endeff_idxs = _lookup(model, "body", end_eff_names, strict_name_lookup)

        self._has_free_root = model.njnt > 0 and int(model.jnt_type[0]) == M.JNT_FREE
        self._ref_traj = reference_clip.to(model.device, model.dtype)
        self._n_frames_clip = int(self._ref_traj.joints.shape[-2])
        self._ref_len = ref_len
        self._too_far_dist = too_far_dist
        self._bad_pose_dist = bad_pose_dist
        self._bad_quat_dist = bad_quat_dist
        self._ctrl_cost_weight = ctrl_cost_weight
        self._pos_reward_weight = pos_reward_weight
        self._quat_reward_weight = quat_reward_weight
        self._joint_reward_weight = joint_reward_weight
        self._angvel_reward_weight = angvel_reward_weight
        self._bodypos_reward_weight = bodypos_reward_weight
        self._endeff_reward_weight = endeff_reward_weight
        self._healthy_reward = healthy_reward
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._start_frame_range = start_frame_range
        if joint_obs_over_full_qpos is None:
            joint_obs_over_full_qpos = not self._has_free_root
        self._joint_full_qpos = joint_obs_over_full_qpos
        if include_root_obs is None:
            include_root_obs = self._has_free_root
        self._include_root_obs = include_root_obs
        # joint ids index the tracked-joint columns (the reference's quirk);
        # ids past the last column clamp to it, as the JAX gather does
        ncols = model.nq if self._joint_full_qpos else model.nq - 7
        self._joint_cols = np.minimum(self._joint_idxs, ncols - 1)

    # ------------------------------------------------------------------
    @property
    def observation_size(self) -> int:
        L = self._ref_len
        size = self.model.nq + self.model.nv
        if self._include_root_obs and self._ref_traj.position is not None:
            size += L * 3 + L * 4
        return size + L * len(self._joint_idxs) + L * 3 * len(self._body_idxs)

    def _frame(self, cur_frame: torch.Tensor) -> torch.Tensor:
        return torch.clamp(cur_frame.long(), 0, self._n_frames_clip - 1)

    def _ref_rows(self, x: torch.Tensor, info: dict, frames: torch.Tensor) -> torch.Tensor:
        """The reference field ``x`` at each env's ``frames`` ((B,) or (B, L))."""
        return x[frames]

    def _start_frames(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        lo_f, hi_f = self._start_frame_range
        return torch.randint(
            lo_f, hi_f, (batch_size,), generator=generator, device=self.device
        ).to(torch.int32)

    def _reset_noise(self, generator: torch.Generator, batch_size: int):
        """qpos0 and zero qvel, each plus uniform noise."""
        m = self.model
        low, hi = -self._reset_noise_scale, self._reset_noise_scale
        u = lambda n: low + (hi - low) * torch.rand(
            batch_size, n, generator=generator, dtype=m.dtype, device=self.device
        )
        return m.qpos0 + u(m.nq), u(m.nv)

    def reset(self, generator: torch.Generator, batch_size: int) -> State:
        return self.reset_to_frame(self._start_frames(generator, batch_size), generator)

    def reset_to_frame(self, start_frame: torch.Tensor, generator: torch.Generator) -> State:
        return self.init_state(start_frame, *self._reset_noise(generator, start_frame.shape[0]))

    def init_state(self, start_frame: torch.Tensor, qpos: torch.Tensor, qvel: torch.Tensor) -> State:
        """Batched state at ``start_frame`` from given (noisy) qpos and qvel."""
        return self._init_state(start_frame, qpos, qvel, {})

    def _init_state(self, start_frame, qpos, qvel, extra_info: dict) -> State:
        dtype = self.model.dtype
        B = qpos.shape[0]
        data = self.pipeline_init(qpos, qvel)
        start_frame = start_frame.to(device=self.device, dtype=torch.int32)
        zero = torch.zeros(B, dtype=dtype, device=self.device)
        info = {
            "cur_frame": start_frame,
            "steps_taken_cur_frame": torch.zeros_like(start_frame),
            "summed_pos_distance": zero,
            "quat_distance": zero,
            "joint_distance": zero,
            **extra_info,
        }
        return State(
            pipeline_state=data,
            obs=self._get_obs(data, info),
            reward=zero,
            done=zero,
            metrics={k: zero for k in _METRICS},
            info=info,
        )

    # ------------------------------------------------------------------
    def step(self, state: State, action: torch.Tensor) -> State:
        dtype = state.obs.dtype
        action = action.to(dtype)
        data = self.pipeline_step(state.pipeline_state, action)

        info = dict(state.info)
        steps_taken = info["steps_taken_cur_frame"] + 1
        rolled = steps_taken == self._steps_for_cur_frame
        info["cur_frame"] = info["cur_frame"] + rolled.to(torch.int32)
        info["steps_taken_cur_frame"] = torch.where(
            rolled, torch.zeros_like(steps_taken), steps_taken
        )
        cur = self._frame(info["cur_frame"])
        qpos, qvel, xpos = data.qpos, data.qvel, data.xpos
        one = torch.ones_like(state.reward)
        zero = torch.zeros_like(state.reward)

        ref = self._ref_traj
        if ref.position is not None:
            pos_distance = qpos[:, :3] - self._ref_rows(ref.position, info, cur)
            pos_reward = self._pos_reward_weight * torch.exp(
                -400.0 * torch.sum(pos_distance, -1) ** 2
            )
            quat_distance = torch.sum(
                btm.bounded_quat_dist(qpos[:, 3:7], self._ref_rows(ref.quaternion, info, cur))
                ** 2, -1
            )
            quat_reward = self._quat_reward_weight * torch.exp(-4.0 * quat_distance)
        else:
            pos_distance = torch.zeros_like(qpos[:, :3])
            quat_distance = pos_reward = quat_reward = zero

        qpos_joints = qpos if self._joint_full_qpos else qpos[:, 7:]
        joint_distance = torch.sum(qpos_joints - self._ref_rows(ref.joints, info, cur), -1) ** 2
        joint_reward = self._joint_reward_weight * torch.exp(-0.5 * joint_distance)
        info["joint_distance"] = joint_distance

        angvel_reward = self._angvel_reward_weight * torch.exp(
            -0.5 * torch.sum(qvel[:, 3:6] - self._ref_rows(ref.angular_velocity, info, cur), -1)
            ** 2
        )
        track_bodypos = self._ref_rows(ref.body_positions, info, cur)
        bi = self.model.idx(self._body_idxs)
        ei = self.model.idx(self._endeff_idxs)
        bodypos_reward = self._bodypos_reward_weight * torch.exp(
            -6.0 * torch.sum((xpos[:, bi] - track_bodypos[:, bi]).flatten(1), -1) ** 2
        )
        endeff_reward = self._endeff_reward_weight * torch.exp(
            -0.75 * torch.sum((xpos[:, ei] - track_bodypos[:, ei]).flatten(1), -1) ** 2
        )

        min_z, max_z = self._healthy_z_range
        thorax_z = xpos[:, self._thorax_idx, 2]
        is_healthy = torch.where(thorax_z < min_z, zero, one)
        is_healthy = torch.where(thorax_z > max_z, zero, is_healthy)
        if self._terminate_when_unhealthy:
            healthy_reward = self._healthy_reward * one
        else:
            healthy_reward = self._healthy_reward * is_healthy

        weights = torch.tensor([1.0, 1.0, 0.2], dtype=dtype, device=self.device)
        summed_pos_distance = torch.sum((pos_distance * weights) ** 2, -1)
        too_far = torch.where(summed_pos_distance > self._too_far_dist, one, zero)
        info["summed_pos_distance"] = summed_pos_distance
        info["quat_distance"] = quat_distance
        bad_pose = torch.where(joint_distance > self._bad_pose_dist, one, zero)
        bad_quat = torch.where(quat_distance > self._bad_quat_dist, one, zero)
        ctrl_cost = self._ctrl_cost_weight * torch.sum(action**2, -1)

        obs = self._get_obs(data, info)
        reward = (
            joint_reward + pos_reward + quat_reward + angvel_reward
            + bodypos_reward + endeff_reward + healthy_reward - ctrl_cost
        )
        done = one - is_healthy if self._terminate_when_unhealthy else zero
        done = torch.stack([done, too_far, bad_pose, bad_quat]).amax(0)

        # NaN guard: an env with a NaN anywhere in its physics state is done
        reward = torch.nan_to_num(reward)
        obs = torch.nan_to_num(obs)
        any_nan = torch.stack([
            torch.isnan(t).reshape(t.shape[0], -1).any(-1)
            for t in data.tensors().values()
            if t.is_floating_point()
        ]).any(0)
        done = torch.maximum(torch.where(any_nan, one, zero), done)

        metrics = dict(state.metrics)
        metrics.update(
            pos_reward=pos_reward,
            quat_reward=quat_reward,
            joint_reward=joint_reward,
            angvel_reward=angvel_reward,
            bodypos_reward=bodypos_reward,
            endeff_reward=endeff_reward,
            reward_quadctrl=-ctrl_cost,
            reward_alive=healthy_reward,
            too_far=too_far,
            bad_pose=bad_pose,
            bad_quat=bad_quat,
            fall=1.0 - is_healthy,
        )
        return state.replace(
            pipeline_state=data, obs=obs, reward=reward, done=done,
            metrics=metrics, info=info,
        )

    # ------------------------------------------------------------------
    def _get_obs(self, data: M.Data, info: dict) -> torch.Tensor:
        ref = self._ref_traj
        L = self._ref_len
        start = torch.clamp(info["cur_frame"].long() + 1, 0, self._n_frames_clip - L)
        idx = start[:, None] + torch.arange(L, device=self.device)  # (B, L)
        qpos = data.qpos
        quat = qpos[:, None, 3:7]

        parts = [qpos, data.qvel]
        if self._include_root_obs and ref.position is not None:
            track_pos_local = btm.rotate(
                self._ref_rows(ref.position, info, idx) - qpos[:, None, :3], quat)
            quat_dist = btm.relative_quat(
                quat.expand(-1, L, -1), self._ref_rows(ref.quaternion, info, idx))
            parts += [track_pos_local.flatten(1), quat_dist.flatten(1)]
        qpos_joints = qpos if self._joint_full_qpos else qpos[:, 7:]
        joint_dist = (self._ref_rows(ref.joints, info, idx) - qpos_joints[:, None, :])[
            :, :, self.model.idx(self._joint_cols)
        ]
        parts.append(joint_dist.flatten(1))
        bi = self.model.idx(self._body_idxs)
        body_pos_dist_local = btm.rotate(
            (self._ref_rows(ref.body_positions, info, idx) - data.xpos[:, None])[:, :, bi],
            quat[:, :, None, :],
        )
        parts.append(body_pos_dist_local.flatten(1))
        return torch.cat(parts, dim=-1)


class GenericSingleClip(TrackingEnv):
    """Tracking env whose model comes from a frozen model file.

    Takes the dataset config's ``env_args`` like the JAX class:
    ``mjcf_path`` names the MJCF (``builtin:minirat.xml``) and the port
    loads its frozen ``.npz`` (``spec.frozen_path``); the solver and build
    options must match the frozen ones, or the loader raises.
    """

    def __init__(
        self,
        reference_clip: ReferenceClip,
        mjcf_path: str,
        scale_factor: float = 1.0,
        torque_actuators: bool = False,
        solver: str = "cg",
        iterations: int = 4,
        ls_iterations: int = 4,
        free_jnt: bool = True,
        dtype=None,
        device="cuda",
        **kwargs,
    ):
        model = bspec.load_model(
            bspec.frozen_path(mjcf_path, free_jnt),
            device=device,
            dtype=dtype,
            scale_factor=scale_factor,
            torque_actuators=torque_actuators,
            solver=solver,
            iterations=iterations,
            ls_iterations=ls_iterations,
            free_jnt=free_jnt,
        )
        super().__init__(
            model=model, reference_clip=reference_clip, free_jnt=free_jnt,
            device=device, **kwargs,
        )


