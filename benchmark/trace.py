"""The device trace of a traced run: torch.profiler over a few steady
steps, reduced to the device's busy time, the top device operations by
category and the longest idle gaps by what the host was doing.

HAND_KERNELS and categorize are a frozen copy of
tools/torch_profile_roofline.py's table.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time

import torch

HAND_KERNELS = (
    ("sell_fwd_kernel", "K1 sell_fwd"),
    ("sell_bwd_dst_kernel", "K2 sell_bwd_dst"),
    ("sell_segsum_kernel", "K3 sell_segsum"),
    ("sell_bwd_src_kernel", "K4 sell_bwd_src"),
    ("pallas_fwd_kernel", "K5 pallas_fwd"),
    ("pallas_bwd_dst_kernel", "K6 pallas_bwd_dst"),
    ("pallas_segsum_kernel", "K7 pallas_segsum"),
    ("pallas_bwd_src_kernel", "K8 pallas_bwd_src"),
    ("merge_segments", "K6-K8 merge_segments"),
)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def categorize(name: str) -> str:
    """The category of a device operation by the name the profiler gives
    it: a hand kernel by its csrc symbol; collectives; dense GEMMs;
    scatters (index_add_, index_put, scatter); gathers (index_select,
    advanced indexing); layout copies (memcpy, memset, cat, copies);
    elementwise kernels and reductions; else other."""
    for symbol, kernel in HAND_KERNELS:
        if symbol in name:
            return kernel
    low = name.lower()
    if low.startswith("gloo:") or "nccl" in low:
        return "collective"
    if ("gemm" in low or "cutlass" in low or "cublas" in low
            or low in ("aten::mm", "aten::addmm")):
        return "dense_gemm"
    if ("indexfunc" in low or "index_add" in low or "index_put" in low
            or "scatter" in low):
        return "scatter_index_add"
    if ("gather" in low or "index_select" in low or "indexselect" in low
            or "gpu_index_kernel" in low or low == "aten::index"):
        return "gather_index_select"
    if ("memcpy" in low or "memset" in low or "catarraybatchedcopy" in low
            or "copy" in low or low == "aten::cat"):
        return "layout_copy"
    if "elementwise" in low or "reduce" in low or "softmax" in low:
        return "elementwise"
    return "other"


def capture(step, steps: int, device) -> dict:
    """Run step() `steps` times under torch.profiler (host and device),
    synchronising before and after; returns the reduced trace (analyse)."""
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
    return analyse(events, wall, steps)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(events, wall_s: float, steps: int) -> dict:
    """busy_s (the union of device intervals), window_s (the traced
    wall), steps, device_ops [[category, seconds]] and idle_gaps [[host
    op, seconds]] (the TOP longest gaps between device intervals, named
    by the innermost host op running at the gap's middle)."""
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                ev.get("name", ""))
        if cat in DEVICE_CATEGORIES:
            dev.append(span)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver"):
            host.append(span)
    if not dev:
        return {}
    merged = _union([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    by_cat: dict[str, float] = {}
    for s, e, name in dev:
        c = categorize(name)
        by_cat[c] = by_cat.get(c, 0.0) + (e - s) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:TOP]
    idle = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                else "no host op")
        idle.append([name, length / 1e6])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": wall_s,
        "steps": steps,
        "device_ops": sorted(by_cat.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": idle,
        "categories": by_cat,
        "h2d_s": sum(e - s for s, e, name in dev
                     if "htod" in name.lower()) / 1e6,
    }
