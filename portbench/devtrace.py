"""The reduction of a torch.profiler trace of whole training steps to what
the per-layer metric readers (``metrics/<name>.py``) read.

The arithmetic follows the port's rollout profiler script: the device
events are the CUDA kernels, copies and memsets the profiler saw, every
one counted as a device op, and the device busy time is their time on the
card. The eager port issues all of them on one stream, so they do not
overlap; busy time here is the union of their intervals all the same. The
idle share divides by the wall time of the same profiled steps.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the benchmark's own spans (record_function names)
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Events:
    # (name, start s, duration s, host time of its launch or None), by start
    device: List[Tuple[str, float, float, Optional[float]]]
    spans: List[Tuple[str, float, float]]  # the benchmark's spans, the same clock
    host: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)
    # the host's ops (start s, end s, name), by start


def collect(prof) -> Events:
    """The device events, the benchmark's spans and the host's ops of a
    finished profile, read from the profiler's raw results (no event tree
    is built). The device events are kernels, copies and memsets; each
    carries the host time of the runtime call that launched it (the one
    with its correlation id)."""
    from torch.autograd import DeviceType

    device, spans, launched, host = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            # the annotations the profiler mirrors onto the device timeline
            # (the spans, the optimizer's) are no device work
            if not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                device.append((name, start, e.duration_ns() * 1e-9, e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, e.duration_ns() * 1e-9))
        else:
            if e.correlation_id():
                launched[e.correlation_id()] = start
            host.append((start, e.end_ns() * 1e-9, name))
    device = sorted(((n, t, d, launched.get(c)) for n, t, d, c in device), key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    host.sort()
    return Events(device=device, spans=spans, host=host)


def busy_intervals(device) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, as (start, end)."""
    out: List[Tuple[float, float]] = []
    for _, t, d, _ in device:
        if out and t <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t + d))
        else:
            out.append((t, t + d))
    return out


@dataclasses.dataclass
class Run:
    """What one traced run hands each per-layer metric reader."""

    events: Events
    wall_s: float  # wall time of the profiled training steps
    training_steps: int  # profiled
    control_steps: int  # profiled
    substeps: int  # profiled
    env_steps: int  # profiled
    geometry: object
    config: dict
    traffic: dict
    model_file: str
    obs_size: int
    action_size: int
    host_spans: Dict[str, List[float]]  # seconds per unprofiled training step
    unprofiled_step_s: List[float]
    parse_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in busy_intervals(self.events.device))

    def kernels(self, tag: str):
        """(count, device seconds) of the device events whose name holds ``tag``."""
        hits = [d for n, _, d, _ in self.events.device if tag in n]
        return len(hits), sum(hits)

    def launched_in(self, span: str) -> int:
        """Device events launched from the host while ``span`` was open."""
        return sum(1 for *_, t in self.events.device
                   if t is not None and self.span_at(t) == span)

    def span_at(self, t: float) -> str:
        """The benchmark's span open at time ``t``, or ``outside``."""
        for name, s, d in self.events.spans:
            if s <= t < s + d:
                return name
        return "outside"

    def host_op_at(self, t: float, lookback: int = 5000) -> str:
        """The innermost host op open at time ``t`` (the latest started of
        those that cover it), or ``-``."""
        ops = self.events.host
        i = bisect.bisect_right(ops, (t, float("inf"), ""))
        for start, end, name in reversed(ops[max(0, i - lookback):i]):
            if end >= t:
                return name
        return "-"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device ops that took most time, and the longest idle gaps of
        the card, each named by the benchmark's span open when it began and
        the innermost host op then, in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, d, _ in self.events.device:
            by_name[name[:120]] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = busy_intervals(self.events.device)
        gaps = sorted(((a[1], b[0] - a[1]) for a, b in zip(busy[:-1], busy[1:])),
                      key=lambda g: -g[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[f"{self.span_at(t)}: {self.host_op_at(t)}"[:120], d]
                              for t, d in gaps]}

