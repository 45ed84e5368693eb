"""Rodent tracking envs.

Counterpart of ``brax_tracking_tpu/envs/rodent.py``: ``RodentSingleClip``
over ``TrackingEnv``, with the JAX package's defaults (end effectors, bodies
and joints, 5 physics steps per control step, the root in the
observation, joint observations over qpos[7:], always a free root). The
model is the frozen file ``mjcf_path`` names (the benchmark's own copy of
the rodent stand-in), frozen with the subtree under the torso rescaled by
``scale_factor``; the loader checks the frozen options against the ones
given here.
"""

from __future__ import annotations

from typing import List, Optional

from portbench.ref.data.clips import ReferenceClip
from portbench.ref.envs.tracking import TrackingEnv
from portbench.ref.physics import spec as bspec

_DEF_RODENT_XML = ""  # the frozen copy: every caller passes its model file


class RodentSingleClip(TrackingEnv):
    def __init__(
        self,
        reference_clip: ReferenceClip,
        center_of_mass: str = "torso",
        end_eff_names: Optional[List[str]] = None,
        body_names: Optional[List[str]] = None,
        joint_names: Optional[List[str]] = None,
        appendage_names: Optional[List[str]] = None,
        mjcf_path: str = _DEF_RODENT_XML,
        scale_factor: float = 0.9,
        torque_actuators: bool = False,
        solver: str = "cg",
        iterations: int = 6,
        ls_iterations: int = 6,
        healthy_z_range=(0.0325, 0.5),
        dtype=None,
        device="cuda",
        **kwargs,
    ):
        model = bspec.load_model(
            bspec.frozen_path(mjcf_path),
            device=device,
            dtype=dtype,
            free_jnt=True,
            torque_actuators=torque_actuators,
            scale_factor=scale_factor,
            rescale_root="torso",
            solver=solver,
            iterations=iterations,
            ls_iterations=ls_iterations,
        )
        end_eff_names = end_eff_names or ["foot_L", "foot_R", "hand_L", "hand_R"]
        body_names = body_names or ["torso", "pelvis", "skull"]
        joint_names = joint_names or [n for n in model.names["joint"] if n and n != "free"]
        kwargs.setdefault("physics_steps_per_control_step", 5)
        kwargs.setdefault("pos_reward_weight", 1.0)
        kwargs.setdefault("joint_reward_weight", 1.0)
        kwargs.setdefault("too_far_dist", 0.01)
        kwargs.pop("free_jnt", None)  # the rodent's root is always free
        super().__init__(
            model=model,
            reference_clip=reference_clip,
            center_of_mass=center_of_mass,
            end_eff_names=end_eff_names,
            body_names=body_names,
            joint_names=joint_names,
            appendage_names=appendage_names,
            healthy_z_range=healthy_z_range,
            free_jnt=True,
            joint_obs_over_full_qpos=False,
            include_root_obs=True,
            device=device,
            **kwargs,
        )


