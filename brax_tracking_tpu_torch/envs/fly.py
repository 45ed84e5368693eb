"""Fruit-fly tracking envs.

Counterpart of ``brax_tracking_tpu/envs/fly.py``:

- ``FlyTethered``: the free joint stripped, joint tracking over the full
  qpos, no root terms in the observation;
- ``FlyFreeJoint``: the free joint kept, root position and orientation
  tracked, root terms in the observation, joint observations over
  qpos[7:].

Both with the JAX package's defaults (CG 6/6, 10 physics steps per control
step unless given; ``scale_factor`` accepted and ignored, as the JAX
``_build`` ignores it). The model is the frozen file of ``mjcf_path`` with
the env's ``free_jnt`` (``spec.frozen_path``: ``<name>.npz`` with the free
root, ``<name>_tethered.npz`` without); the loader checks the frozen options
against the ones given here. The fly's MJCF is not in this repository:
``builtin:fly_standin.xml`` (assets/make_fly_standin.py) stands in for it
and is the default.
"""

from __future__ import annotations

from typing import List, Optional

from brax_tracking_tpu_torch.data.clips import ReferenceClip
from brax_tracking_tpu_torch.envs.tracking import TrackingEnv
from brax_tracking_tpu_torch.physics import spec as bspec

_DEF_FLY_XML = "builtin:fly_standin.xml"


def _load(mjcf_path, free_jnt, torque_actuators, solver, iterations, ls_iterations, dtype,
          device):
    return bspec.load_model(
        bspec.frozen_path(mjcf_path, free_jnt),
        device=device,
        dtype=dtype,
        free_jnt=free_jnt,
        torque_actuators=torque_actuators,
        solver=solver,
        iterations=iterations,
        ls_iterations=ls_iterations,
    )


class FlyTethered(TrackingEnv):
    """Tethered fly single-clip tracking (``fly_single_clip``)."""

    def __init__(
        self,
        reference_clip: ReferenceClip,
        center_of_mass: str,
        end_eff_names: List[str],
        body_names: List[str],
        joint_names: List[str],
        appendage_names: Optional[List[str]] = None,
        mjcf_path: str = _DEF_FLY_XML,
        scale_factor: float = 1.0,
        torque_actuators: bool = False,
        solver: str = "cg",
        iterations: int = 6,
        ls_iterations: int = 6,
        free_jnt: bool = False,
        dtype=None,
        device="cuda",
        **kwargs,
    ):
        model = _load(mjcf_path, free_jnt, torque_actuators, solver, iterations, ls_iterations,
                      dtype, device)
        kwargs.setdefault("physics_steps_per_control_step", 10)
        super().__init__(
            model=model,
            reference_clip=reference_clip,
            center_of_mass=center_of_mass,
            end_eff_names=end_eff_names,
            body_names=body_names,
            joint_names=joint_names,
            appendage_names=appendage_names,
            free_jnt=free_jnt,
            joint_obs_over_full_qpos=True,
            include_root_obs=False,
            device=device,
            **kwargs,
        )


class FlyFreeJoint(TrackingEnv):
    """Free-joint fly single-clip tracking (``fly_single_clip_freejnt``)."""

    def __init__(
        self,
        reference_clip: ReferenceClip,
        center_of_mass: str,
        end_eff_names: List[str],
        body_names: List[str],
        joint_names: List[str],
        appendage_names: Optional[List[str]] = None,
        mjcf_path: str = _DEF_FLY_XML,
        scale_factor: float = 1.0,
        torque_actuators: bool = False,
        solver: str = "cg",
        iterations: int = 6,
        ls_iterations: int = 6,
        free_jnt: bool = True,
        dtype=None,
        device="cuda",
        **kwargs,
    ):
        model = _load(mjcf_path, free_jnt, torque_actuators, solver, iterations, ls_iterations,
                      dtype, device)
        kwargs.setdefault("physics_steps_per_control_step", 10)
        super().__init__(
            model=model,
            reference_clip=reference_clip,
            center_of_mass=center_of_mass,
            end_eff_names=end_eff_names,
            body_names=body_names,
            joint_names=joint_names,
            appendage_names=appendage_names,
            free_jnt=free_jnt,
            joint_obs_over_full_qpos=False,
            include_root_obs=True,
            device=device,
            **kwargs,
        )
