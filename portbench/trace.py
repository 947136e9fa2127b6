"""The traced window: ``torch.profiler`` over the calls, read from its
Chrome-format trace.

The harness names its own spans (``torch.profiler.record_function``):
``portbench.window`` around the traced calls and ``portbench.<call>``
around each call. A device operation (a kernel, a copy or a fill) belongs to
a span when the host call that launched it, matched by the trace's
correlation id, started inside that span. Times in the trace are
microseconds; what this module returns is in seconds.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["WINDOW_SPAN", "TraceView", "load_chrome_trace", "profiled"]

WINDOW_SPAN = "portbench.window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
# entries of each list of the breakdown
_TOP = 10
_NAME_CHARS = 120


@dataclass
class TraceView:
    """What a traced window holds: the window, the device operations, the
    host events, and when each device operation was launched."""
    window: tuple                       # (start, end), us
    device_ops: list                    # dicts: name, cat, ts, dur, corr
    host: list                          # (ts, end, name) of host events
    spans: dict = field(default_factory=dict)   # name -> [(ts, end)]
    launch_ts: dict = field(default_factory=dict)  # corr -> host ts

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _merged(self) -> list:
        lo, hi = self.window
        iv = sorted((max(lo, op["ts"]), min(hi, op["ts"] + op["dur"]))
                    for op in self.device_ops)
        merged = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        return sum(b - a for a, b in self._merged()) * 1e-6

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def ops_under(self, name: str, cats=_DEVICE_CATS) -> list:
        """Device operations of ``cats`` launched inside a span ``name``."""
        spans = sorted(self.spans.get(name, ()))
        starts = [a for a, _ in spans]
        out = []
        for op in self.device_ops:
            ts = self.launch_ts.get(op["corr"])
            if op["cat"] not in cats or ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                out.append(op)
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window named by the innermost host event that covers
        each gap's middle (``host`` where none does)."""
        by_name = defaultdict(float)
        for op in self.device_ops:
            by_name[op["name"][:_NAME_CHARS]] += op["dur"] * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
        edges = [self.window[0]]
        for a, b in self._merged():
            edges += [a, b]
        edges.append(self.window[1])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:_TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at((a + b) / 2),
                               (b - a) * 1e-6] for a, b in gaps]}

    def _host_at(self, t: float) -> str:
        best = None
        for ts, end, name in self.host:
            if ts <= t <= end and (best is None or end - ts < best[0]):
                best = (end - ts, name)
        return best[1][:_NAME_CHARS] if best else "host"


def load_chrome_trace(trace: dict) -> TraceView:
    """A ``TraceView`` of a Chrome-format trace (as ``json.load`` reads
    ``export_chrome_trace``'s file) holding one ``WINDOW_SPAN``."""
    events = [e for e in trace.get("traceEvents", ())
              if e.get("ph") == "X"]
    spans = defaultdict(list)
    device_ops, host, launch_ts = [], [], {}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = e.get("args", {}).get("correlation")
        if cat in _DEVICE_CATS:
            device_ops.append({"name": name, "cat": cat, "ts": ts,
                               "dur": dur, "corr": corr})
            continue
        if cat == "user_annotation":
            spans[name].append((ts, ts + dur))
        if cat in _LAUNCH_CATS and corr is not None:
            launch_ts[corr] = ts
        if cat in _HOST_CATS:
            host.append((ts, ts + dur, name))
    windows = spans.get(WINDOW_SPAN)
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
    return TraceView(windows[0], device_ops, host, dict(spans), launch_ts)


def profiled(run_calls, with_cuda: bool) -> TraceView:
    """Run ``run_calls()`` under ``torch.profiler`` inside a
    ``WINDOW_SPAN``, and read the trace. The trace file goes to the
    temporary directory and is removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if with_cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            run_calls()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return load_chrome_trace(json.load(f))
    finally:
        os.unlink(path)
