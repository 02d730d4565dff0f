"""Metric readers, one file a metric, found by the metric's name.

``bench/metrics/<name>.py`` defines ``read(run)``: the metric's value from
the run's record (``harness.Run``: its spans, the worker's counters over the
window, the harness's token accounting and the trace's reduction), or None
where the run holds nothing to read.  None leaves the metric out of the
result line; a share of a roofline or of a peak is never reported as 0 for
want of a reading."""

from __future__ import annotations

import importlib


def reader(name: str):
    return importlib.import_module(f"bench.metrics.{name}").read
