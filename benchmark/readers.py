"""The arithmetic the metric readers (benchmark/metrics/<name>.py) share.
Each takes a driver's record and returns None where the record has
nothing to read."""

from __future__ import annotations

import statistics


def step_s(record: dict, kind: str):
    """The window's wall over its steps (epochs or batches), in s."""
    if record.get("kind") != kind or not record.get("steps"):
        return None
    return record["window_s"] / record["steps"]


def step_ms(record: dict, kind: str):
    s = step_s(record, kind)
    return None if s is None else s * 1e3


def mfu_pct(record: dict, kind: str):
    """Model FLOPs of the window's steps over its wall, in % of the peak
    of the run's precision tier."""
    s = step_s(record, kind)
    if s is None:
        return None
    work = (record["flops_window"] if "flops_window" in record
            else record["flops_per_step"] * record["steps"])
    return 100.0 * work / record["window_s"] / record["peak_flops"]


def idle_pct(record: dict, kind: str):
    """100 x (1 - device busy per step in the profiled steps / wall per
    step of the unprofiled window)."""
    s, tr = step_s(record, kind), record.get("trace")
    if s is None or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / s)


def roofline_pct(record: dict, kind: str):
    """The attention op's bound over its time, summed over the layers."""
    at = record.get("attention")
    if record.get("kind") != kind or not at or at["time_s"] <= 0:
        return None
    return 100.0 * at["bound_s"] / at["time_s"]


def traced_ms(record: dict, kind: str, seconds):
    """Device ms per profiled step of the trace's `seconds` (a function of
    the reduced trace), or None where there is no trace or it is 0."""
    tr = record.get("trace")
    if record.get("kind") != kind or not tr:
        return None
    value = seconds(tr)
    return value / tr["steps"] * 1e3 if value > 0 else None


def p95(values):
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[18]


def median(values):
    return statistics.median(values) if values else None
