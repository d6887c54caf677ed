"""The result line's schema, and run.py without a card."""

import json
import pathlib
import subprocess
import sys

from benchmark import correct, harness
from benchmark.tests.tiny import tiny_context  # noqa: F401 (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def line_of(ctx, trace):
    s = harness.spec()
    record = harness.run_driver(ctx)
    record["memory_peak_bytes"] = 0
    if trace:
        record["trace"] = {"busy_s": 0.5, "window_s": 1.0, "steps": 2,
                           "device_ops": [["dense_gemm", 0.25]],
                           "idle_gaps": [["aten::item", 0.001]],
                           "categories": {"dense_gemm": 0.25},
                           "h2d_s": 0.01}
    metrics = harness.read_metrics(harness.metrics_of(s, ctx.cell, trace),
                                   record)
    ok, compared = correct.judge(record["numbers"], ctx.limits)
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 0}
    return json.loads(json.dumps(harness.result_line(
        record, metrics, device, ok, compared, trace)))


def test_untraced_line(tiny_context):
    line = line_of(tiny_context("ogbn-products.fullgraph"), False)
    assert list(line) == KEYS + ["compared"]
    assert set(line["metrics"]) == {"epoch_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] is True
    assert set(line["compared"]) == set(harness.limits_of(
        harness.cell_entry(harness.spec(), "ogbn-products.fullgraph")))


def test_traced_line_has_breakdown_and_per_layer_metrics(tiny_context):
    line = line_of(tiny_context("ogbn-products.sampled-step"), True)
    assert list(line) == KEYS + ["breakdown", "compared"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no CUDA event is recorded and the op is not timed: no
    # roofline
    assert {"sample_ms.pool", "mfu.step", "device_idle_pct.step",
            "gemm_ms.step", "h2d_copy_ms.step"} == set(line["metrics"])
    assert line["metrics"]["gemm_ms.step"]["value"] == 125.0
    assert line["compared"]["batch_invalid"]["value"] == 0
    assert line["correct"] is True


def test_metrics_of_each_cell():
    s = harness.spec()
    assert [m["name"] for m in harness.metrics_of(
        s, "ogbn-products.fullgraph", False)] == ["epoch_ms", "setup_s"]
    for cell in ("ogbn-products.fullgraph", "reddit.fullgraph"):
        assert [m["name"] for m in harness.metrics_of(s, cell, False)] == [
            "epoch_ms", "setup_s"]
        assert {m["name"] for m in harness.metrics_of(s, cell, True)} == {
            "mfu.epoch", "device_idle_pct.epoch", "attn_roofline.epoch"}
    assert [m["name"] for m in harness.metrics_of(
        s, "ogbn-products.sampled-step", False)] == [
        "step_ms", "step_ms_p95", "setup_s"]
    assert {m["name"] for m in harness.metrics_of(
        s, "ogbn-products.sampled-step", True)} == {
        "mfu.step", "device_idle_pct.step", "attn_roofline.step",
        "gemm_ms.step", "h2d_copy_ms.step", "sample_ms.pool"}
    for w in s["workloads"]:
        for trace in (False, True):
            names = [m["name"] for m in harness.metrics_of(s, w["name"],
                                                           trace)]
            assert names, (w["name"], trace)
            for name in names:
                assert callable(harness.reader(name))


def test_run_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ogbn-products.fullgraph", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr
