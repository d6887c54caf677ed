"""The data-driven core of the benchmark: finds a cell's configuration,
traffic, limits and metric readers by the names in BENCHMARK.json, runs
the traffic's driver, and assembles the result line.

    BENCHMARK.json                 cells, configurations, metrics
    benchmark/configs/<config>.json    sizes, widths, precision
    benchmark/traffic/<traffic>.json   parameters; "mode" names the driver
    benchmark/drivers/<mode>.py        one general driver per mode
    benchmark/limits/<cell>.json       the limit of each number compared
    benchmark/metrics/<metric>.py      read(record) -> value or None
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
from typing import Any

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the timed process may not hold (whole names)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gatv2_tpu")


@dataclasses.dataclass
class Context:
    """What a driver needs to run one cell once."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float  # the process's start on time.perf_counter's clock
    precision: str | None = None  # None: the configuration's
    check_only: bool = False  # the first steps and the comparison only


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(s: dict, name: str) -> dict:
    for w in s["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_of(s: dict, cell: dict) -> dict:
    for c in s["configs"]:
        if c["name"] == cell["config"]:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no configuration named {cell['config']!r}")


def traffic_of(cell: dict) -> dict:
    return load_json(BENCH / "traffic" / f"{cell['traffic']}.json")


def limits_of(cell: dict) -> dict:
    return load_json(BENCH / "limits" / f"{cell['name']}.json")


def context(name: str, seed: int, seconds: float, trace: bool, device,
            t0: float, **kw) -> Context:
    s = spec()
    cell = cell_entry(s, name)
    return Context(cell=name, config=config_of(s, cell),
                   traffic=traffic_of(cell), limits=limits_of(cell),
                   seed=seed, seconds=seconds, trace=trace, device=device,
                   t0=t0, **kw)


def metrics_of(s: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` prints: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    if not trace:
        return [m for m in s["end_to_end"]
                if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in metrics_of(s, cell, False)}
    return [m for m in s["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported
                             else [])]


def reader(name: str):
    """read(record) of benchmark/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics." + name.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(mod_name)
    if mod is None:
        sp = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return mod.read


def run_driver(ctx: Context) -> dict:
    """The record of one run of the cell's traffic driver."""
    mode = ctx.traffic["mode"]
    driver = importlib.import_module(f"benchmark.drivers.{mode}")
    return driver.run(ctx)


def read_metrics(metrics: list[dict], record: dict) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> list[str]:
    """Top-level names of FORBIDDEN_MODULES found in sys.modules."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def device_info(record: dict, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": record["memory_peak_bytes"]}
    if trace and record.get("trace"):
        info["busy_s"] = record["trace"]["busy_s"]
        info["window_s"] = record["trace"]["window_s"]
    return info


def result_line(record: dict, metrics: dict, device: dict, correct: bool,
                compared: dict, trace: bool) -> dict:
    line = {"correct": correct, "attempted": record["steps"],
            "failed": record["failed"], "metrics": metrics,
            "device": device}
    tr = record.get("trace")
    if trace and tr:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["compared"] = compared
    return line
