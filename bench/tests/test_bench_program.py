"""The program's own tracer under the harness, at a tiny size on the CPU.

The harness leaves the fleet's tracer off, so a benchmark run, traced or
not, pays nothing for it.  Switched on over a window, the tracer reads what
the harness's spans see from outside: each decode call's host phases, the
radix index's own time and each lane's wait for a decode slot, within the
harness's own spans."""

from __future__ import annotations

import math

import pytest

from bench.tests import _tiny

CALLS = ("worker.admit", "worker.absorb", "worker.decode", "worker.release")


def _window(cell: str, switch_on: bool, seconds: float = 2.0, traced: bool = False):
    """A tiny window (a traced one if ``traced``); ``switch_on`` switches the
    fleet's tracer on after the warm-up, where the harness itself leaves it
    alone."""
    from bench import harness
    spec = _tiny.spec(cell)
    h = harness.Harness(spec["cfg_file"]["model"], spec["mix"], 7, "cpu", traced,
                        spec["cfg_file"]["serve"]["num_blocks"])
    h.warm()
    if switch_on:
        h.fleet.tracer.on = True
    rec = h.window(seconds, 0.0)
    return h, rec, h.fleet.tracer.export(h.t0)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_the_harness_leaves_the_tracer_off(traced):
    h, rec, out = _window("qwen3_8b.coding", False, seconds=1.0, traced=traced)
    assert not h.fleet.tracer.on and rec.generated > 0
    assert out == {"spans": [], "totals": {}, "counters": {}, "samples": {}, "device": {},
                   "leaves": []}


def _outermost(spans, prefix):
    """Seconds in spans named ``prefix*`` that no such span encloses."""
    total, end = 0.0, -math.inf
    for name, t0, t1, _ in spans:
        if name.startswith(prefix) and t0 >= end:
            total += t1 - t0
            end = t1
    return total


@pytest.mark.parametrize("cell", ["qwen3_8b.coding", "jamba_1period.reasoning"])
def test_the_tracer_reads_the_window_from_inside(cell):
    h, rec, out = _window(cell, True)
    tot = out["totals"]
    window = rec.window_s
    # the program's decode calls lie inside the harness's decode spans
    outside = sum(b - a for kind, a, b in rec.spans if kind == "decode")
    assert 0 < tot["worker.decode"]["seconds"] <= outside
    assert tot["worker.decode"]["count"] == rec.stats["decode_calls"]
    radix = _outermost(out["spans"], "radix.")
    assert 0 < radix < window
    # the host issuing the steps: inside the worker's own decode clock
    assert 0 < tot["decode.enqueue"]["seconds"] < rec.stats["decode_wall_s"]
    waits = out["samples"]["wait.step"] + out["samples"].get("wait.preempted", [])
    assert waits and min(waits) >= 0 and all(math.isfinite(w) for w in waits)
    inside = sum(tot[n]["seconds"] for n in CALLS if n in tot)
    assert 0 <= tot["runtime.run"]["seconds"] - inside < window
    assert out["device"] == {}                    # no device span on the CPU
    assert {name for name, _, _ in out["leaves"]} >= {"decode.enqueue", "decode.wait"}
