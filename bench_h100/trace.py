"""Reading a ``torch.profiler`` trace of a stretch of the window.

``Trace`` parses the profile once:

- device activity: every event that ran on the card (kernels, copies,
  fills; the profiler's mirrors of named spans left out), as intervals;
- launches: each device event's launch call on the host (a ``cu*`` CUDA API
  call with the same correlation id), so that a span's device time counts
  the work launched inside it, the port's ctypes kernels included, which the
  profiler links to no op. This is a copy of the logic of
  ``epcnet_torch/utils/profiling.py::region_ms`` and ``top_device_ops``; it
  assumes one thread launches work while the profile records, as in every
  traced stretch here;
- the host's spans and ops, to say what the host was doing in each gap.

Busy time is the union of the device intervals within the stretch, never
their sum: overlapping kernels count once.

The profiler slows the host inside the stretch, so the stretch's length
over its units overstates the time a unit takes. The window therefore sets
``Trace.unit_s``, the time a unit takes outside the stretch on the host's
clock, and the shares of a unit's time (the device's idle share, ``mfu``)
divide by that.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import DeviceType


MARK = "bench/stretch"
TOP = 10  # entries of each list of the breakdown
LONGEST = 400  # idle gaps named in the breakdown


class Trace:
    def __init__(self, prof, units: int):
        """``prof``: a stopped ``torch.profiler.profile`` whose stretch is the
        span ``MARK`` (opened right after the profiler started, closed right
        before it stopped, the card synchronised at both ends); ``units``:
        the dispatches, batches or steps completed in it. Times are kept in
        us from the stretch's start."""
        self.units = units
        # seconds a unit takes outside the stretch, set by the window
        self.unit_s: float | None = None
        events = list(prof.events())
        marks = [e for e in events if e.name == MARK and e.device_type == DeviceType.CPU]
        if marks:
            t0, t1 = marks[0].time_range.start, marks[0].time_range.end
        else:
            t0 = min((e.time_range.start for e in events), default=0.0)
            t1 = max((e.time_range.end for e in events), default=0.0)
        self.stretch_s = (t1 - t0) / 1e6
        launched_at = {e.id: e.time_range.start - t0 for e in events
                       if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
        self.device = []  # (start us, end us, name, launch us or None)
        self.host = []  # (start us, end us, name, is span)
        for e in events:
            if e.name == MARK:
                continue
            annotation = getattr(e, "is_user_annotation", False)
            s, t = e.time_range.start - t0, e.time_range.end - t0
            if e.device_type == DeviceType.CPU:
                self.host.append((s, t, e.name, annotation))
            elif not annotation:
                self.device.append((s, t, e.name, launched_at.get(e.id)))
        self.spans = [(s, t, name) for s, t, name, ann in self.host if ann]

    @property
    def has_device(self) -> bool:
        return bool(self.device)

    def span_device_us(self, names) -> float:
        """Device time (us) of the work launched inside any span whose name
        is in ``names``; an event launched inside two of them counts once."""
        ranges = sorted((s, t) for s, t, name in self.spans if name in set(names))
        if not ranges:
            return 0.0
        starts = np.array([r[0] for r in ranges])
        ends = np.maximum.accumulate(np.array([r[1] for r in ranges]))
        total = 0.0
        for s, t, _, launch in self.device:
            if launch is None:
                continue
            i = int(np.searchsorted(starts, launch, side="right")) - 1
            if i >= 0 and launch <= ends[i]:
                total += t - s
        return total

    def kernel_us(self, patterns) -> tuple[float, int]:
        """(device time us, launches) of the device events whose name holds
        any of ``patterns``."""
        hits = [t - s for s, t, name, _ in self.device if any(p in name for p in patterns)]
        return float(sum(hits)), len(hits)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device intervals, clipped to the stretch."""
        end = self.stretch_s * 1e6
        merged: list = []
        for s, t in sorted((max(s, 0.0), min(t, end)) for s, t, _, _ in self.device):
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def idle_share(self) -> float | None:
        """The device's idle share of a unit outside the stretch: 1 - (busy
        time a unit in the stretch) / ``unit_s``; None without either."""
        if not self.has_device or not self.units or not self.unit_s:
            return None
        return 1.0 - self.busy_s() / self.units / self.unit_s

    def device_ops(self) -> list:
        """[[name, seconds]] of the device ops that took most time."""
        by: dict = {}
        for s, t, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[[what the host was doing, seconds]] over the ``LONGEST`` idle
        gaps of the stretch: each gap is named by the innermost span and the
        innermost op on the host at its middle, and gaps of one name add."""
        busy = self.busy_intervals()
        edges = [0.0] + [x for iv in busy for x in iv] + [self.stretch_s * 1e6]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:LONGEST]
        if not gaps:
            return []
        hs = np.array([h[0] for h in self.host] or [0.0])
        he = np.array([h[1] for h in self.host] or [0.0])
        by: dict = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0] if self.host else []
            span = op = None
            for i in sorted(inside, key=lambda i: he[i] - hs[i]):
                _, _, name, ann = self.host[i]
                if ann and span is None:
                    span = name
                elif not ann and op is None:
                    op = name
            label = " > ".join(x for x in (span, op) if x) or "host, no op recorded"
            by[label[:120]] = by.get(label[:120], 0.0) + (g1 - g0) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (which
    sets up the card's tracing, seconds on an H100's machine) falls in
    set-up and not in the window."""
    with torch.profiler.profile(activities=activities(device)):
        torch.zeros(1, device=device).add_(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def activities(device) -> list:
    """The profiler's activities for ``device``: the host's ops always, the
    card's when it is one."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


class Stretch:
    """Profiles units ``skip .. skip + units - 1`` of a closed loop run on
    this thread: call ``before(i)`` and ``after(i)`` around unit i. The
    card is synchronised at both ends, so the stretch holds exactly the
    units' work. ``began`` and ``ended`` are the host's clock
    (``time.perf_counter``) once ``start`` has synchronised and at the end
    of ``stop``."""

    def __init__(self, device, skip: int, units: int):
        self.device, self.skip, self.units = torch.device(device), skip, units
        self.prof = self.mark = None
        self.trace: Trace | None = None
        self.began = self.ended = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()  # the units before the stretch end outside it
        self.began = time.perf_counter()
        self.prof = torch.profiler.profile(activities=activities(self.device))
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def stop(self, units: int) -> None:
        self._sync()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.trace = Trace(self.prof, units)
        self.prof = self.mark = None
        self.ended = time.perf_counter()

    def before(self, i: int) -> None:
        if i == self.skip:
            self.start()

    def after(self, i: int) -> None:
        if self.prof is not None and i == self.skip + self.units - 1:
            self.stop(self.units)

    def finish(self, done: int, t0: float, t1: float) -> None:
        """At the window's close, after ``done`` units in the window from
        ``t0`` to ``t1`` (the host's clock): stop a profile the window ended
        inside of, with the units it holds, and set the trace's ``unit_s``
        from the units and the time outside the stretch."""
        if self.prof is not None:
            self.stop(done - self.skip)
        if self.trace is not None and done > self.trace.units:
            inside = min(self.ended, t1) - self.began
            self.trace.unit_s = (t1 - t0 - inside) / (done - self.trace.units)
