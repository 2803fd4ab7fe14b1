"""Reading a ``torch.profiler`` chrome trace of a run's window.

The harness names three host spans with ``record_function``:
``kssd_bench.window`` (the whole measured window), ``kssd_bench.call``
(one call of the closed loop) and whatever the runner wraps (for the abv
search, ``kssd_bench.abv_search_batch``).  Device work is the trace's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; a kernel belongs to
the host span in which its launch (the ``cuda_runtime`` event of the same
correlation id) started.  ``from_profiler`` reads the profiler's events
in memory, ``read`` the same from an exported chrome trace; a window of
many small kernels makes a trace of millions of events, which the export
and its JSON take minutes to write and load.  Times inside a ``Trace``
are microseconds; this module returns seconds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "kssd_bench.window"


@dataclasses.dataclass
class Trace:
    device: list          # (ts, end, name, cat, correlation) in us
    launches: dict        # correlation -> host ts (us)
    spans: dict           # user annotation name -> [(ts, end)]
    host: list            # (ts, end, name) on the window's thread

    @property
    def window(self) -> tuple[float, float] | None:
        got = self.spans.get(WINDOW)
        return got[0] if got else None


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, launches = [], {}
    spans = collections.defaultdict(list)
    host_by_tid = collections.defaultdict(list)
    window_tid = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts = float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, end, e.get("name", ""), cat, corr))
        elif cat.startswith("cuda_"):        # the launch APIs
            if corr is not None:
                launches[corr] = ts
        elif cat in ("user_annotation", "cpu_op"):
            key = (e.get("pid"), e.get("tid"))
            host_by_tid[key].append((ts, end, e.get("name", "")))
            if cat == "user_annotation":
                spans[e.get("name", "")].append((ts, end))
                if e.get("name") == WINDOW:
                    window_tid = key
    for v in spans.values():
        v.sort()
    device.sort()
    return Trace(device, launches, dict(spans),
                 host_by_tid.get(window_tid, []))


def _category(e) -> str:
    """The chrome trace's ``cat`` of a profiler event (``activity_type``,
    or, where the profiler has no such method, worked out from the device
    and the name; a range of a host annotation on the device then reads
    as a kernel, which ``from_profiler`` drops by its name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CPU"):
        if e.is_user_annotation():
            return "user_annotation"
        return "cuda_runtime" if name.startswith("cuda") else "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler.profile``, read from its
    events in memory (no export)."""
    device, launches = [], {}
    spans = collections.defaultdict(list)
    host_by_tid = collections.defaultdict(list)
    window_tid = None
    for e in prof.profiler.kineto_results.events():
        cat = _category(e)
        if cat in DEVICE_CATS:
            ts = e.start_ns() * 1e-3
            device.append((ts, ts + e.duration_ns() * 1e-3, e.name(), cat,
                           e.correlation_id()))
        elif cat.startswith("cuda_"):
            launches[e.correlation_id()] = e.start_ns() * 1e-3
        elif cat in ("user_annotation", "cpu_op"):
            ts = e.start_ns() * 1e-3
            name = e.name()
            key = e.start_thread_id()
            host_by_tid[key].append((ts, ts + e.duration_ns() * 1e-3, name))
            if cat == "user_annotation":
                spans[name].append((ts, ts + e.duration_ns() * 1e-3))
                if name == WINDOW:
                    window_tid = key
    for v in spans.values():
        v.sort()
    device = sorted(d for d in device if d[2] not in spans)
    return Trace(device, launches, dict(spans),
                 host_by_tid.get(window_tid, []))


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_intervals(tr: Trace) -> list:
    """Merged device-busy intervals inside the window (us)."""
    w = tr.window
    if w is None:
        return []
    clipped = [(max(a, w[0]), min(b, w[1])) for a, b, *_ in tr.device
               if b > w[0] and a < w[1]]
    return _merged(clipped)


def busy_seconds(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) * 1e-6


def window_seconds(tr: Trace) -> float:
    w = tr.window
    return (w[1] - w[0]) * 1e-6 if w else 0.0


def kernel_seconds_in(tr: Trace, span: str) -> float:
    """Summed device time of the kernels launched inside host span
    ``span`` (every occurrence)."""
    iv = tr.spans.get(span, [])
    starts = [a for a, _ in iv]
    total = 0.0
    for a, b, _, cat, corr in tr.device:
        if cat != "kernel" or corr not in tr.launches:
            continue
        t = tr.launches[corr]
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= iv[i][1]:
            total += b - a
    return total * 1e-6


def _innermost(host):
    """(times, labels): from times[i] on, the innermost host event is
    labels[i] (None between events)."""
    times, labels, stack = [], [], []
    for ts, end, name in sorted(host, key=lambda e: (e[0], -e[1])):
        while stack and stack[-1][0] <= ts:
            t_end = stack.pop()[0]
            times.append(t_end)
            labels.append(stack[-1][1] if stack else None)
        stack.append((end, name))
        times.append(ts)
        labels.append(name)
    while stack:
        t_end = stack.pop()[0]
        times.append(t_end)
        labels.append(stack[-1][1] if stack else None)
    return times, labels


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    idle gaps summed by the innermost host event at each gap's middle."""
    w = tr.window
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    ops = collections.Counter()
    for a, b, name, _, _ in tr.device:
        if b > w[0] and a < w[1]:
            ops[name] += (min(b, w[1]) - max(a, w[0])) * 1e-6
    gaps, t = [], w[0]
    for a, b in busy_intervals(tr):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w[1] > t:
        gaps.append((t, w[1]))
    times, labels = _innermost(tr.host)
    idle = collections.Counter()
    for a, b in gaps:
        i = bisect.bisect_right(times, (a + b) / 2) - 1
        idle[(labels[i] if i >= 0 else None) or "(no host event)"] += \
            (b - a) * 1e-6
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
