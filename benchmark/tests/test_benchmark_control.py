"""The control comes out not correct and the program correct, on the
card (gpu marker; skips without one): each cell's traffic at a size a
test run can hold (the graph cut to at most 2 M edges, widths as
configured), held to the cell's own limits. The control is the program
with its own TF32 projections (precision high), the nearest precision
below the configuration's fp32; calibrate.py reads the same at the
cells' full sizes."""

import time

import pytest
import torch

from benchmark import calibrate, correct, harness

CELLS = [w["name"] for w in harness.spec()["workloads"]]
MAX_EDGES = 2_000_000


def readings(cell, seed):
    ctx = harness.context(cell, seed, 0.0, False, torch.device("cuda", 0),
                          time.perf_counter(), check_only=True)
    cut = max(1, -(-ctx.config["num_edges"] // MAX_EDGES))
    ctx.config["num_edges"] //= cut
    ctx.config["num_nodes"] //= cut
    run = (calibrate.fullgraph_seed if ctx.traffic["mode"] == "fullgraph"
           else calibrate.driver_seed)
    rows = {r["variant"]: r for r in run(ctx, True)}
    return rows, ctx.limits


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    rows, limits = readings(cell, 2**31 + 977)
    ok, compared = correct.judge(rows["program"], limits)
    assert ok, compared
    for variant in ("control", "state_unchanged", "half_batch",
                    "doubled_backward"):
        ok, compared = correct.judge(rows[variant], limits)
        assert not ok, (variant, compared)
