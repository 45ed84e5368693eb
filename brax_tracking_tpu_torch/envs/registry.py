"""Env registry: names to env constructors.

Counterpart of ``brax_tracking_tpu/envs/registry.py`` (brax's
``register_environment`` / ``get_environment``). ``single_clip_tracking``
and ``multi_clip_tracking`` build the port's generic tracking envs,
``rodent_single_clip`` and ``rodent_multi_clip`` its rodent envs; the fly
envs are registered names that raise until their ROADMAP item lands.
Constructors take ``device`` and ``dtype`` keywords.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from brax_tracking_tpu_torch.envs.base import Env
from brax_tracking_tpu_torch.envs.rodent import RodentMultiClip, RodentSingleClip
from brax_tracking_tpu_torch.envs.tracking import GenericMultiClip, GenericSingleClip
from brax_tracking_tpu_torch.physics import model as M

_REGISTRY: Dict[str, Callable[..., Env]] = {}
# registered names without a port yet: (what, ROADMAP item)
_UNPORTED: Dict[str, Tuple[str, str]] = {
    "fly_single_clip": ("envs/fly.py::FlyTethered", "§A.9"),
    "fly_single_clip_freejnt": ("envs/fly.py::FlyFreeJoint", "§A.9"),
}


def register_environment(name: str, cls: Callable[..., Env]) -> None:
    _REGISTRY[name] = cls


def lookup(name: str) -> Callable[..., Env]:
    """The constructor registered as ``name``; raises for an unknown name
    and for a registered one that is not ported yet."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _UNPORTED:
        what, item = _UNPORTED[name]
        M.unported(f"the {name!r} environment ({what})", item)
    raise KeyError(f"unknown environment {name!r}; known: {sorted({**_REGISTRY, **_UNPORTED})}")


def get_environment(name: str, **kwargs) -> Env:
    return lookup(name)(**kwargs)


register_environment("single_clip_tracking", GenericSingleClip)
register_environment("multi_clip_tracking", GenericMultiClip)
register_environment("rodent_single_clip", RodentSingleClip)
register_environment("rodent_multi_clip", RodentMultiClip)
