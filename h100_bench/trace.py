"""The traced window, in two halves read from the profiler's raw events
without building its tables.

The first half records the card alone (`use_cpu=False`: kernel, copy and
set intervals with names); the host runs at about its untraced pace, so
the device's busy and idle time, kernel times and counts, and utilisation
come from it. The second half also records the host (its ops, the CUDA
calls that launch kernels, and the benchmark's own spans: `record_function`
ranges that the drivers put around a step and a chain's end), so that an
idle gap can be given to what the host was doing; recording
every host op slows the host, so only device time per step comes from it,
and the idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
import time

import torch

__all__ = ["Tracer", "Window", "union_ns"]

_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")
_COPY = re.compile(r"^(Memcpy|Memset)")


def union_ns(intervals) -> int:
    """Total length covered by [start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclasses.dataclass
class Window:
    """A traced window. `kernels` (name, start_ns, end_ns) and `copies` are
    the first half's device operations over its `window_s` and `steps`;
    `gaps` the second half's idle stretches by label. The driver fills
    `step_ms` and `shape` (the cell's sizes the readers use)."""

    kernels: list
    copies: list
    window_s: float = 0.0
    steps: int = 0
    step_ms: list = dataclasses.field(default_factory=list)
    shape: dict = dataclasses.field(default_factory=dict)
    gaps: list = dataclasses.field(default_factory=list)
    unlinked: int = 0  # second-half kernels whose launching host call the trace lacks

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.kernels + self.copies]) / 1e9

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the first half's kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) / 1e9

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.kernels if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, s, e in self.kernels + self.copies:
            by[name] += e - s
        return [[name[:160], ns / 1e9] for name, ns in by.most_common(n)]


class _Intervals:
    """Sorted, possibly nested, host intervals; which contain a time."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def containing(self, t):
        i = bisect.bisect_right(self.starts, t)
        return [name for s, e, name in self.items[max(0, i - 64):i] if s <= t <= e]


def _session(cpu: bool):
    cuda = torch.cuda.is_available()
    prof = torch.autograd.profiler.profile(use_device="cuda" if cuda else None, use_kineto=True,
                                           use_cpu=cpu or not cuda, record_shapes=False)
    prof.__enter__()
    return prof


class Tracer:
    """Traces a window when `enabled`. The driver calls `start(seconds)` as
    the window opens, `tick(steps)` after every step (the halves switch at
    the first step past half the window) and `stop(steps)` after the
    window's closing synchronize. `span(name)` is a `record_function` range
    in the second half and nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.phase, self.prof = None, None

    def start(self, seconds: float) -> None:
        if not self.enabled:
            return
        self.prof = _session(cpu=False)
        self.t0 = time.perf_counter()
        self.switch_at = self.t0 + seconds / 2
        self.phase = "device"

    def tick(self, steps: int) -> None:
        if self.phase == "device" and time.perf_counter() >= self.switch_at:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window_s = time.perf_counter() - self.t0  # before the profiler's own stop
            self.prof.__exit__(None, None, None)
            self.first = (self.prof.kineto_results, window_s, steps)
            self.prof, self.phase = _session(cpu=True), "spans"

    def stop(self, steps: int) -> None:
        """After the window's closing synchronize."""
        if self.phase is None:
            return
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        if self.phase == "device":  # the window closed before the switch
            self.first = (self.prof.kineto_results, window_s, steps)
            self.second = None
        else:
            self.second = self.prof.kineto_results
        self.phase = "done"

    def span(self, name: str):
        if self.phase != "spans":
            return contextlib.nullcontext()
        return torch.autograd.profiler.record_function(name)

    def window(self, span_names=()) -> Window:
        results, window_s, steps = self.first
        kernels, copies = [], []
        for ev in results.events():
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                (copies if _COPY.match(ev.name()) else kernels).append(
                    (ev.name(), ev.start_ns(), ev.end_ns()))
        w = Window(kernels=kernels, copies=copies, window_s=window_s, steps=steps)
        if self.second is not None:
            w.gaps, w.unlinked = _attribute(self.second, set(span_names))
        return w


def _attribute(results, span_names):
    """The second half's idle gaps, labelled by the benchmark's span open at
    the launch of the operation ending each and the host op that launched
    it, and the count of device operations whose launch is not in the
    trace."""
    launch_at, op_at, spans, device = {}, {}, [], []
    for ev in results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if name in span_names:
                spans.append((ev.start_ns(), ev.end_ns(), name))
            elif _RUNTIME.match(name):
                launch_at[ev.correlation_id()] = ev.start_ns()
            else:
                op_at[ev.correlation_id()] = (ev.start_ns(), name)
        elif name not in span_names:  # a span's own range on the device is no operation
            device.append((name, ev.start_ns(), ev.end_ns(), ev.correlation_id(),
                           ev.linked_correlation_id()))
    host = _Intervals(spans)
    labelled, unlinked = [], 0
    for name, s, e, corr, linked in device:
        op = op_at.get(linked)
        at = launch_at.get(corr, op[0] if op else None)
        unlinked += at is None
        inside = tuple(host.containing(at)) if at is not None else ()
        labelled.append((s, e, "/".join(inside[-1:] + ((op[1],) if op else ("?",)))))
    return _gaps(labelled), unlinked


def _gaps(device_ops) -> list:
    """Idle stretches between device operations, each labelled by what the
    host was doing: the benchmark's innermost span and the host op that
    launched the operation ending the stretch, summed by label."""
    by = collections.Counter()
    end = None
    for s, e, label in sorted(device_ops):
        if end is not None and s > end:
            by[label] += s - end
        end = e if end is None else max(end, e)
    return [[label[:160], ns / 1e9] for label, ns in by.most_common(10)]
