"""Profiling hooks (counterpart of ``epcnet_tpu/utils/profiling.py``).

``profile_region`` names a span of the program (``torch.profiler``'s
``record_function``; the model names its parts with it), and
``start_trace`` records a ``torch.profiler`` trace of a region and
writes it as a Chrome trace. ``top_device_ops`` and ``region_ms`` read the
recorded profile: the counterpart of the XPlane walk of
``scripts/hw_knn_trace.py::_trace_top_ops``.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity


def profile_region(name: str):
    """A named span, visible in the trace and in ``region_ms``, while a
    profiler records; otherwise nothing (about 1 us on the host, against
    about 13 us for an idle ``record_function``; the model's forward opens
    ten of them)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def start_trace(profile_dir: str):
    """Profile the region: CPU activity, and the card's when CUDA is
    available. Yields the ``torch.profiler.profile`` and writes
    ``<profile_dir>/trace.json`` (Chrome trace format) when the region ends.
    The counterpart of the JAX package's ``maybe_start_trace``; every caller
    here traces, so the directory is required."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _has_device_time(prof) -> bool:
    return any(e.device_type != DeviceType.CPU and e.device_time_total > 0
               for e in prof.events())


def top_device_ops(prof, top: int = 15) -> dict:
    """The profile's ops ranked by time, from ``prof.key_averages()``.

    Where the profile holds device activity, the rows are the device's own
    events (kernels, copies, fills; named spans excluded) ranked by device
    time; otherwise (a CPU profile) the CPU ops ranked by their own CPU time.
    Returns ``{"ranked_by": "device" | "cpu", "total_ms": <sum over all such
    events>, "top": [{"name", "count", "total_ms"}, ...]}``."""
    on_device = _has_device_time(prof)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue
        if on_device and e.device_type != DeviceType.CPU:
            us = e.self_device_time_total
        elif not on_device and e.device_type == DeviceType.CPU:
            us = e.self_cpu_time_total
        else:
            continue
        rows.append({"name": e.key[:160], "count": e.count, "total_ms": us / 1e3})
    rows.sort(key=lambda r: -r["total_ms"])
    return {"ranked_by": "device" if on_device else "cpu",
            "total_ms": sum(r["total_ms"] for r in rows), "top": rows[:top]}


def region_ms(prof, prefix: str) -> dict:
    """Time of each named span (``profile_region``) whose name starts with
    ``prefix``. Where the profile holds device activity: the device time of
    the work launched inside the span: each device event is attributed
    through its launch call (a ``cu*`` CUDA API call with the
    event's correlation id) that falls within the span's CPU time. That also
    covers kernels launched outside PyTorch's ops (the port's ctypes
    launches), which the profiler links to no op. It assumes one thread
    launches work while the profile records, as in a traced forward.
    Otherwise (a CPU profile): the span's CPU time. Returns ``{name:
    {"count", "total_ms"}}``.
    """
    events = list(prof.events())
    on_device = _has_device_time(prof)
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    work = [(launched_at[e.id], e.time_range.elapsed_us()) for e in events
            if e.device_type != DeviceType.CPU and e.id in launched_at
            and not getattr(e, "is_user_annotation", False)]
    out: dict = {}
    for s in events:
        if s.device_type != DeviceType.CPU or not s.name.startswith(prefix):
            continue
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0})
        row["count"] += 1
        if on_device:
            lo, hi = s.time_range.start, s.time_range.end
            row["total_ms"] += sum(us for t, us in work if lo <= t <= hi) / 1e3
        else:
            row["total_ms"] += s.cpu_time_total / 1e3
    return out
