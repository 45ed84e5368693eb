"""``debug_nans``: fail at the op that made the first NaN of a run.

Counterpart of the JAX package's ``jax_debug_nans`` (the driver's
``debug_nans=true`` or ``BTT_DEBUG_NANS=1``). That flag checks the
outputs of each jitted call; on a NaN it re-runs the call de-optimized,
op by op, and raises ``FloatingPointError`` at the first primitive whose
output holds a NaN. A NaN that a later ``where`` masks inside one call
(one env's state after the NaN guard and the auto-reset) reaches no output
and raises nothing.

The port's calls are eager, so the boundaries are the counterparts of the
JAX package's jitted calls: the env reset, ``rollout_step`` and
``learn_step`` of ``agents/ppo/train.py`` and the evaluator's unroll
(``training/acting.py``), each run through ``call``. With the mode on,
``call`` clones the call's inputs (tensors; the state of the modules,
optimizers and generators it is handed, which the call updates in place),
runs it, and checks every floating tensor of its outputs with
``torch.isnan`` (``jax_debug_infs`` is a separate flag: an inf passes).
On a NaN it restores the inputs and replays the call under a
``TorchDispatchMode`` that checks each op's floating outputs, and raises
``FloatingPointError`` naming the aten op and the line of the port that
issued it. The CUDA kernels are launched through ctypes and bypass
dispatch, so during a replay their launch wrappers check their outputs
(``check_kernel``) and name the kernel.

With the mode off ``call`` is the plain call: no clone, no host read.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import sys
from typing import Any, Callable, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.abspath(__file__)


class _State:
    enabled = False  # the mode is on for the run
    replaying = False  # a replay is checking each op and each kernel


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """The mode on (or off) inside the block."""
    before = _STATE.enabled
    _STATE.enabled = bool(on)
    try:
        yield
    finally:
        _STATE.enabled = before


# --- inputs: clone and restore -------------------------------------------------------


class _Snapshot:
    """A copy of a call's arguments made before the call: tensors cloned,
    dataclasses and containers rebuilt around the clones; modules,
    optimizers and generators are kept (the call updates them in place)
    and their state saved, to be put back before a replay."""

    def __init__(self, args: Any):
        self._live: List = []
        self._seen = {}
        self.args = self._copy(args)

    def _copy(self, x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, (torch.nn.Module, torch.optim.Optimizer, torch.Generator)):
            if id(x) not in self._seen:
                self._seen[id(x)] = x
                if isinstance(x, torch.nn.Module):
                    saved = {k: v.detach().clone() for k, v in x.state_dict().items()}
                elif isinstance(x, torch.optim.Optimizer):
                    saved = copy.deepcopy(x.state_dict())
                else:
                    saved = x.get_state()
                self._live.append((x, saved))
            return x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: self._copy(getattr(x, f.name)) for f in dataclasses.fields(x) if f.init
            })
        if isinstance(x, dict):
            return type(x)((k, self._copy(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(self._copy(v) for v in x)
        return x

    def restore(self) -> None:
        with torch.no_grad():
            for obj, saved in self._live:
                if isinstance(obj, torch.nn.Module):
                    obj.load_state_dict(saved)
                elif isinstance(obj, torch.optim.Optimizer):
                    obj.load_state_dict(copy.deepcopy(saved))
                else:
                    obj.set_state(saved)


# --- outputs: the floating tensors ----------------------------------------------------


def _floating(x: Any, out: List[torch.Tensor], seen: set) -> List[torch.Tensor]:
    """Every floating tensor reachable from ``x``: containers, dataclasses,
    a module's parameters and buffers, an optimizer's state."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            out.append(x.detach())
    elif id(x) in seen:
        pass
    elif isinstance(x, torch.nn.Module):
        seen.add(id(x))
        _floating(list(x.state_dict().values()), out, seen)
    elif isinstance(x, torch.optim.Optimizer):
        seen.add(id(x))
        _floating([v for s in x.state.values() for v in s.values()], out, seen)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _floating(getattr(x, f.name), out, seen)
    elif isinstance(x, dict):
        for v in x.values():
            _floating(v, out, seen)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _floating(v, out, seen)
    return out


def has_nan(x: Any) -> bool:
    """Whether a floating tensor reachable from ``x`` holds a NaN: one host
    read per device."""
    by_device = {}
    for t in _floating(x, [], set()):
        if t.numel():
            by_device.setdefault(t.device, []).append(torch.isnan(t).any())
    return any(bool(torch.stack(flags).any()) for flags in by_device.values())


# --- the replay ---------------------------------------------------------------------------


def _port_line() -> str:
    """The innermost frame of the port's own code below this module."""
    f = sys._getframe(1)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if name.startswith(_PACKAGE) and name != _THIS:
            return f"{os.path.relpath(name, os.path.dirname(_PACKAGE))}:{f.f_lineno} " \
                   f"in {f.f_code.co_name}"
        f = f.f_back
    return "outside the port's code"


class _CheckEachOp(TorchDispatchMode):
    """Raises at the first op whose floating output holds a NaN."""

    def __init__(self, call: str):
        super().__init__()
        self.call = call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {func} ({_port_line()}), found replaying "
                    f"{self.call} under debug_nans")
        return out


@contextlib.contextmanager
def checking(call: str = "a call", ops: bool = True):
    """Each kernel launch inside the block checked for NaN outputs, and with
    ``ops`` each op too, as a replay checks them."""
    before = _STATE.replaying
    _STATE.replaying = True
    try:
        with _CheckEachOp(call) if ops else contextlib.nullcontext():
            yield
    finally:
        _STATE.replaying = before


def check_kernel(name: str, outputs: Iterable[torch.Tensor]) -> None:
    """Called by each kernel's launch wrapper after its launch: during a
    replay, raises naming the kernel if one of its floating outputs holds a
    NaN; otherwise does nothing."""
    if not _STATE.replaying:
        return
    for t in outputs:
        if t.is_floating_point() and t.numel() and bool(torch.isnan(t).any()):
            raise FloatingPointError(
                f"NaN in the output of the kernel {name} ({_port_line()}), found under "
                "debug_nans")


def call(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``; with the mode on, its outputs are checked
    for NaN and a NaN replays it op by op to name the op that made it."""
    if not _STATE.enabled or _STATE.replaying:
        return fn(*args, **kwargs)
    snapshot = _Snapshot((args, kwargs))
    out = fn(*args, **kwargs)
    if not has_nan(out):
        return out
    snapshot.restore()
    replay_args, replay_kwargs = snapshot.args
    with checking(name):
        fn(*replay_args, **replay_kwargs)
    raise FloatingPointError(
        f"NaN in the outputs of {name} under debug_nans; no op of its replay made one (it "
        "came in with the inputs)")
