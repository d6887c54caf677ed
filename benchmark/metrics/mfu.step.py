"""mfu.step: model FLOPs of the window's steps, from each replayed batch's
real nodes and edges (benchmark/flops.py), over the window's wall, in %
of the H100's peak at the configuration's precision."""

from benchmark import readers


def read(record):
    return readers.mfu_pct(record, "replay")
