"""A run with the timed path broken underneath comes out not correct:
the harness's driver at a CPU size, one fault of faults.py at a time,
held to the cell's own limits; the sound run comes out correct."""

import pytest

from benchmark import correct, harness
from benchmark.faults import FAULTS, planted
from benchmark.tests.tiny import tiny_context  # noqa: F401 (fixture)

CELLS = [w["name"] for w in harness.spec()["workloads"]]


def judged(ctx, fault=None):
    if fault is None:
        record = harness.run_driver(ctx)
    else:
        with planted(fault):
            record = harness.run_driver(ctx)
    return correct.judge(record["numbers"], ctx.limits)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_context):
    ok, compared = judged(tiny_context(cell))
    assert ok, compared


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, tiny_context):
    ok, compared = judged(tiny_context(cell), fault)
    assert not ok, compared


def test_faults_are_removed_afterwards(tiny_context):
    from gatv2_tpu_torch.train import optim

    before = optim.apply_updates
    with planted("state_unchanged"):
        assert optim.apply_updates is not before
    assert optim.apply_updates is before
