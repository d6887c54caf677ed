"""The device trace of a traced run with each device operation credited
to the program's spans (gatv2_tpu_torch/utils/metrics.py span): the
reduction of benchmark/trace.py, plus, per span name asked for, the
device seconds of the operations launched inside it.

A device operation is credited by its launch: the runtime call with the
same `correlation` id, on the host thread that made it, and the span
(a user annotation) on that thread whose interval holds the call. Spans
of the autograd thread hold the launches of the backward.
"""

from __future__ import annotations

import bisect
import json
import os
import pathlib
import tempfile
import time

import torch

from benchmark import trace


def span_seconds(events, names) -> dict:
    """{name: device seconds launched inside a span of that name}."""
    spans: dict = {}  # (tid, name) -> sorted [start, end] intervals
    launches = {}  # correlation -> (tid, ts)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in names:
            s = float(ev["ts"])
            spans.setdefault((ev.get("tid"), ev["name"]), []).append(
                (s, s + float(ev["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), float(ev["ts"]))
    for v in spans.values():
        v.sort()
    out = {name: 0.0 for name in names}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in \
                trace.DEVICE_CATEGORIES:
            continue
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        for name in names:
            iv = spans.get((tid, name))
            if not iv:
                continue
            i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                out[name] += float(ev["dur"]) / 1e6
    return out


def capture(step, steps: int, device, names) -> dict:
    """trace.capture's reduced trace of `steps` calls of step(), with
    "spans": span_seconds of the same events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    tmp = pathlib.Path(tempfile.gettempdir())
    path = tmp / f"gatv2_benchmark_trace_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    out = trace.analyse(events, wall, steps)
    if out:
        out["spans"] = span_seconds(events, names)
    return out


def host_span_seconds(fn, names):
    """(fn(), {name: host seconds inside spans of that name}) with fn run
    under a CPU-only profiler, which records the program's spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    out = {name: 0.0 for name in names}
    for ev in prof.events():
        if ev.is_user_annotation and ev.name in out:
            out[ev.name] += ev.time_range.elapsed_us() / 1e6
    return result, out
