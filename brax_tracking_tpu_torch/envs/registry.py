"""Env registry: names to env constructors.

Counterpart of ``brax_tracking_tpu/envs/registry.py`` (brax's
``register_environment`` / ``get_environment``). ``single_clip_tracking``
and ``multi_clip_tracking`` build the port's generic tracking envs,
``rodent_single_clip`` and ``rodent_multi_clip`` its rodent envs,
``fly_single_clip`` and ``fly_single_clip_freejnt`` its fly envs.
Constructors take ``device`` and ``dtype`` keywords.
"""

from __future__ import annotations

from typing import Callable, Dict

from brax_tracking_tpu_torch.envs.base import Env
from brax_tracking_tpu_torch.envs.fly import FlyFreeJoint, FlyTethered
from brax_tracking_tpu_torch.envs.rodent import RodentMultiClip, RodentSingleClip
from brax_tracking_tpu_torch.envs.tracking import GenericMultiClip, GenericSingleClip

_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register_environment(name: str, cls: Callable[..., Env]) -> None:
    _REGISTRY[name] = cls


def lookup(name: str) -> Callable[..., Env]:
    """The constructor registered as ``name``; raises for an unknown name."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown environment {name!r}; known: {sorted(_REGISTRY)}")


def get_environment(name: str, **kwargs) -> Env:
    return lookup(name)(**kwargs)


register_environment("single_clip_tracking", GenericSingleClip)
register_environment("multi_clip_tracking", GenericMultiClip)
register_environment("rodent_single_clip", RodentSingleClip)
register_environment("rodent_multi_clip", RodentMultiClip)
register_environment("fly_single_clip", FlyTethered)
register_environment("fly_single_clip_freejnt", FlyFreeJoint)
