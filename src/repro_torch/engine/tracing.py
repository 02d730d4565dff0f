"""One tracer for the port's engine: host spans, counters, samples and
device spans, off by default.

A ``RolloutFleet`` owns one ``Tracer`` (``fleet.tracer``) and hands it to
every worker it builds; the workers' radix indexes and the ``EngineBackend``
over them write to the same one.  A worker built alone gets its own, off.
Only ``engine/`` writes to it: the control plane (``core/``) sees virtual
time alone.

* **Clock.** Every host stamp is ``now()``, ``time.perf_counter``: the clock
  a device trace can be mapped onto (a marker kernel launched at a known
  ``now()``), so each span can be placed on the device's timeline.
* **Spans.** ``with tracer.span(name):`` records ``(name, t0, t1, depth)``;
  spans nest, ``depth`` counts the spans open around one.
* **Counters, samples.** ``add`` sums, ``gauge`` keeps the largest value
  seen, ``sample`` appends one value to a distribution.
* **Device spans.** ``with tracer.device_span(name, device):`` records a
  pair of timing events on the device's current stream, and nothing on a
  CPU device.  Nothing waits for them until ``export``, which synchronises
  once: no call on the hot path does.
* **Methods.** ``@traced(name)`` runs a whole method inside
  ``self.tracer.span(name)`` (and ``traced(name, device="x")`` inside the
  device span ``x`` on ``self.device`` too); a part of a method is timed
  with ``with tracer.span(name):``.
* **Off** (the default), ``span`` and ``device_span`` return one shared null
  context, a ``traced`` method is called straight through, and ``add``,
  ``gauge`` and ``sample`` return at once: no clock is read, nothing is
  allocated, no event is created.

``export(since)`` returns plain data.  ``leaves`` cuts nested spans into
disjoint pieces, each named by the innermost span open over it: the labels
a device trace's idle gaps can be attributed by.
"""

from __future__ import annotations

import functools
import math
import time

import torch

now = time.perf_counter


class _Null:
    """The context ``span`` and ``device_span`` return while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("tracer", "name", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        tr = self.tracer
        self.depth = tr._depth
        tr._depth += 1
        self.t0 = now()

    def __exit__(self, *exc):
        t1 = now()
        tr = self.tracer
        tr._depth -= 1
        tr._spans.append((self.name, self.t0, t1, self.depth))
        return False


class _DeviceSpan:
    __slots__ = ("tracer", "name", "device", "t0", "start")

    def __init__(self, tracer: "Tracer", name: str, device: torch.device):
        self.tracer = tracer
        self.name = name
        self.device = device

    def __enter__(self):
        self.t0 = now()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(self.device))

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        self.tracer._events.append((self.name, self.t0, self.device, self.start, end))
        return False


class Tracer:
    """Spans, counters, samples and device spans of one fleet; off unless
    ``on`` is set."""

    def __init__(self, on: bool = False):
        self.on = on
        self._depth = 0
        self.clear()

    def clear(self) -> None:
        """Drop everything recorded so far (spans open now still close)."""
        self._spans: list[tuple[str, float, float, int]] = []
        self._events: list = []
        self.counters: dict[str, float] = {}
        self.samples: dict[str, list[float]] = {}

    def span(self, name: str):
        return _Span(self, name) if self.on else _NULL

    def device_span(self, name: str, device):
        if not self.on:
            return _NULL
        device = torch.device(device)
        return _DeviceSpan(self, name, device) if device.type == "cuda" else _NULL

    def add(self, name: str, value: float = 1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        if self.on and value > self.counters.get(name, -math.inf):
            self.counters[name] = value

    def sample(self, name: str, value: float) -> None:
        if self.on:
            self.samples.setdefault(name, []).append(value)

    def export(self, since: float = -math.inf) -> dict:
        """What was recorded, as plain data.  ``spans`` (name, t0, t1, depth),
        sorted by start, and the device spans are those that started at
        ``since`` or later; counters and samples are since ``clear()``.
        ``totals`` and ``device`` map a name to its count and seconds (the
        device's by its events); ``leaves`` are ``leaves(spans)``."""
        spans = sorted((s for s in self._spans if s[1] >= since),
                       key=lambda s: (s[1], s[3]))
        totals: dict[str, dict] = {}
        for name, t0, t1, _ in spans:
            tot = totals.setdefault(name, {"count": 0, "seconds": 0.0})
            tot["count"] += 1
            tot["seconds"] += t1 - t0
        events = [e for e in self._events if e[1] >= since]
        for device in dict.fromkeys(e[2] for e in events):
            torch.cuda.synchronize(device)
        device_totals: dict[str, dict] = {}
        for name, _, _, start, end in events:
            tot = device_totals.setdefault(name, {"count": 0, "seconds": 0.0})
            tot["count"] += 1
            tot["seconds"] += start.elapsed_time(end) / 1e3
        return {"spans": [list(s) for s in spans], "totals": totals,
                "counters": dict(self.counters),
                "samples": {k: list(v) for k, v in self.samples.items()},
                "device": device_totals, "leaves": leaves(spans)}


def traced(name: str, device: str | None = None):
    """Decorate a method of an object with a ``tracer`` (and, given
    ``device``, a ``device``): each call runs inside the span ``name`` (and
    the device span ``device``).  Off, the method is called as is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            tr = self.tracer
            if not tr.on:
                return fn(self, *args, **kwargs)
            if device is None:
                with _Span(tr, name):
                    return fn(self, *args, **kwargs)
            with _Span(tr, name), tr.device_span(device, self.device):
                return fn(self, *args, **kwargs)
        return call
    return wrap


def leaves(spans) -> list[tuple[str, float, float]]:
    """Nested spans ``(name, t0, t1, depth)``, sorted by ``(t0, depth)``, cut
    into disjoint ``(name, t0, t1)`` pieces in time order, each named by the
    innermost span open over it.  The pieces of a span's subtree cover it
    exactly; time outside every span has no piece."""
    out: list[tuple[str, float, float]] = []
    stack: list[tuple[str, float]] = []          # (name, t1) of the open spans
    pos = -math.inf                              # where the next piece starts
    for name, t0, t1, _ in spans:
        while stack and stack[-1][1] <= t0:
            top, end = stack.pop()
            if end > pos:
                out.append((top, pos, end))
            pos = end
        if stack and t0 > pos:
            out.append((stack[-1][0], pos, t0))
        stack.append((name, t1))
        pos = t0
    while stack:
        top, end = stack.pop()
        if end > pos:
            out.append((top, pos, end))
        pos = end
    return out
