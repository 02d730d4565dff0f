"""The device trace of a traced run: ``torch.profiler`` over the whole window,
read from the raw kineto events (``key_averages()`` takes minutes over a
window's million launches).

The trace's clock is put on the host's ``perf_counter`` by a marker: right
after the profiler starts, with the device drained, the host reads its clock
and launches one spin kernel; the marker's device start, less that reading,
is the offset (off by the launch latency, some microseconds).  The host's
spans then say what the host was doing in each idle gap of the device.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

MARKER = "spin_kernel"           # torch.cuda._sleep's kernel


class Trace:
    """A profiler held over the window; ``read`` reduces it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._h0 = 0.0

    def __enter__(self) -> "Trace":
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._h0 = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)

    def read(self, t0: float, t1: float, spans: list[tuple[str, float, float]],
             kernels: tuple[str, ...]) -> dict:
        """The trace over the window [t0, t1] (host perf_counter seconds):
        the device's busy seconds (the union of its operations' intervals),
        time by operation name, each of ``kernels``' launches and seconds
        (matched as substrings of the name), and idle seconds by the host
        span they fell in (``spans``: (kind, start, end), sorted, disjoint;
        outside them the control plane)."""
        from torch.autograd import DeviceType
        events = [(e.start_ns(), e.duration_ns(), e.name())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        marks = [s for s, _, name in events if MARKER in name]
        if not marks:
            raise RuntimeError("the trace holds no marker kernel: no device events were "
                               "recorded")
        origin = min(marks) - self._h0 * 1e9           # device ns at host second 0
        lo, hi = origin + t0 * 1e9, origin + t1 * 1e9
        by_name: dict[str, float] = defaultdict(float)
        counts = {k: [0, 0.0] for k in kernels}
        intervals = []
        for start, dur, name in events:
            end = start + dur
            if end <= lo or start >= hi or MARKER in name:
                continue
            by_name[name] += dur / 1e9
            for k in kernels:
                if k in name:
                    counts[k][0] += 1
                    counts[k][1] += dur / 1e9
            intervals.append((max(start, lo), min(end, hi)))
        intervals.sort()
        busy, gaps = 0.0, []
        cur_s, cur_e = None, None
        edge = lo
        for s, e in intervals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    edge = cur_e
                if s > edge:
                    gaps.append((edge, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            edge = cur_e
        if hi > edge:
            gaps.append((edge, hi))
        starts = [s for _, s, _ in spans]
        idle: dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            h = (g0 - origin) / 1e9
            i = bisect.bisect_right(starts, h) - 1
            kind = spans[i][0] if i >= 0 and spans[i][2] > h else "control plane"
            idle[kind] += (g1 - g0) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy / 1e9, "window_s": t1 - t0,
                "kernels": {k: {"launches": n, "seconds": s}
                            for k, (n, s) in counts.items()},
                "device_ops": [[name[:160], s] for name, s in top],
                "idle_gaps": sorted(([k, s] for k, s in idle.items()),
                                    key=lambda kv: -kv[1])}
