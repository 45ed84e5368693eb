"""Env registry: names to env constructors.

Counterpart of ``brax_tracking_tpu/envs/registry.py`` (brax's
``register_environment`` / ``get_environment``). ``single_clip_tracking``
builds the generic tracking env, ``rodent_single_clip`` the rodent's.
Constructors take ``device`` and ``dtype`` keywords.
"""

from __future__ import annotations

from typing import Callable, Dict

from portbench.ref.envs.base import Env
from portbench.ref.envs.rodent import RodentSingleClip
from portbench.ref.envs.tracking import GenericSingleClip

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
register_environment("rodent_single_clip", RodentSingleClip)
