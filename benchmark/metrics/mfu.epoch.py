"""mfu.epoch: model FLOPs of the window's epochs (benchmark/flops.py) over
its wall, in % of the H100's peak at the configuration's precision."""

from benchmark import readers


def read(record):
    return readers.mfu_pct(record, "fullgraph")
