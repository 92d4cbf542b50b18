"""What a profiled stretch of a run read on the device.

``profiled()`` wraps a stretch in ``torch.profiler`` (host and CUDA
activities); ``summarize`` reduces the trace to device seconds by kernel
name and by the harness's own spans (``span(name)``, a
``record_function`` range around a call into one layer of the program)
and the kernel launches the host made inside each span, the busy seconds, and the breakdown the result line carries: the device
operations that took most time, and the longest idle gaps by what the host
was doing then.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
from collections import defaultdict

import torch

SPAN_PREFIX = "slambench."
# the longest stretch a traced run profiles: a longer trace takes minutes
# to read
PROFILED_S = 5.0


def span(name: str):
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def collector_off():
    """Python's collector off: the profiler's events, and their reading,
    would otherwise set off collections that take tens of seconds."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@contextlib.contextmanager
def profiled():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with collector_off(), torch.profiler.profile(
            activities=acts, record_shapes=False) as prof:
        yield prof


def _dev_total(e) -> float:
    return (getattr(e, "device_time_total", None)
            or getattr(e, "cuda_time_total", 0.0) or 0.0)


def _dev_self(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0) or 0.0)


def _on_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


class Summary:
    """kernels {name: [count, device s]}, spans {name: device s of the
    kernels launched inside}, span_counts, busy_s, window_s, breakdown."""

    def __init__(self):
        self.kernels = {}
        self.spans = {}
        self.span_counts = {}
        self.launches = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.breakdown = None

    def kernel_s(self, *marks, exclude=()) -> float:
        """Device seconds of the kernels whose name holds one of `marks`
        and none of `exclude`."""
        return sum(s for k, (_, s) in self.kernels.items()
                   if any(m in k for m in marks)
                   and not any(x in k for x in exclude))


def summarize(prof, window_s: float) -> Summary:
    with collector_off():
        return _summarize(prof, window_s)


def _summarize(prof, window_s: float) -> Summary:
    out = Summary()
    out.window_s = window_s
    for e in prof.key_averages():
        if _on_device(e):
            # a span's range on the device's timeline is no operation
            if not e.key.startswith(SPAN_PREFIX):
                out.kernels[e.key] = [e.count, _dev_self(e) / 1e6]
        elif e.key.startswith(SPAN_PREFIX):
            name = e.key[len(SPAN_PREFIX):]
            out.spans[name] = _dev_total(e) / 1e6
            out.span_counts[name] = e.count
    out.busy_s = sum(s for _, s in out.kernels.values())
    evs = prof.events()
    out.launches = _launches_in_spans(evs)
    with contextlib.suppress(Exception):
        out.breakdown = _breakdown(evs, out)
    return out


def _launches_in_spans(evs) -> dict:
    """{span: kernel launches the host made inside it}, from the runtime
    API's launch calls in the trace."""
    spans = defaultdict(list)
    launches = []
    for e in evs:
        if _on_device(e):
            continue
        if e.name.startswith(SPAN_PREFIX):
            spans[e.name[len(SPAN_PREFIX):]].append(
                (e.time_range.start, e.time_range.end))
        elif "Launch" in e.name and e.name.startswith("cu"):
            launches.append(e.time_range.start)
    launches.sort()
    out = {}
    for name, iv in spans.items():
        out[name] = sum(bisect.bisect_right(launches, b)
                        - bisect.bisect_left(launches, a) for a, b in iv)
    return out


def _breakdown(evs, summary: Summary, n: int = 10) -> dict:
    """{"device_ops": [[name, s]], "idle_gaps": [[host op, s]]}: the ten
    device operations with most time, and the idle time between device
    operations summed by the innermost host operation running at the
    middle of each gap, ten largest."""
    top = sorted(summary.kernels.items(), key=lambda kv: -kv[1][1])[:n]
    device_ops = [[k[:120], s] for k, (_, s) in top]
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if _on_device(e) and not e.name.startswith(SPAN_PREFIX))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in evs
            if not _on_device(e) and not e.name.startswith("cuda")
            and e.time_range.end > e.time_range.start]
    host.sort()
    gaps = defaultdict(float)
    end = None
    starts = [h[0] for h in host]
    for s, e in dev:
        if end is not None and s > end:
            mid = (s + end) / 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for h in reversed(host[max(0, i - 200):i]):
                if h[1] >= mid and (best is None
                                    or h[1] - h[0] < best[1] - best[0]):
                    best = h
            label = best[2] if best else "(host between operators)"
            gaps[label] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": device_ops,
            "idle_gaps": [[k[:120], v] for k, v in idle]}
