"""The tiny_context fixture: a cell's traffic driver at a size a CPU test
run can hold. Test modules import it by name."""

import time

import pytest
import torch

from benchmark import harness

# a configuration a CPU test run can hold: the cells' heads (4,1,1; dims
# 64,32,16 cut to 8,4,4) on 700 nodes; remat on for the full graph, off
# for a sampled batch, as in the cells
TINY = dict(name="tiny", num_nodes=700, num_edges=5000, feature_dim=16,
            num_classes=5, num_layers=3, heads=[4, 1, 1], out_dims=[8, 4, 4],
            variant="edge", negative_slope=0.01, optimizer="adam", lr=0.01,
            precision="highest", remat_from_edges=4000)


def tiny_traffic(cell: str) -> dict:
    tr = harness.traffic_of(harness.cell_entry(harness.spec(), cell))
    if tr["mode"] == "replay":
        tr.update(batch_size=64, fanouts=[4, 3, 2], pool=5)
    return tr


@pytest.fixture
def tiny_context():
    """Context(cell, seconds, **kw) of a cell on the CPU at TINY's size,
    with the cell's traffic mode and limits."""
    torch.set_num_threads(2)

    def make(cell, seconds=0.5, seed=2**31 + 11, **kw):
        entry = harness.cell_entry(harness.spec(), cell)
        return harness.Context(
            cell=cell, config=dict(TINY), traffic=tiny_traffic(cell),
            limits=harness.limits_of(entry), seed=seed, seconds=seconds,
            trace=False, device=torch.device("cpu"),
            t0=time.perf_counter(), **kw)

    return make
