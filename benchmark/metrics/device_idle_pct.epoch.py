"""device_idle_pct.epoch: 100 x (1 - device busy per epoch in the profiled
epochs / the unprofiled window's wall per epoch)."""

from benchmark import readers


def read(record):
    return readers.idle_pct(record, "fullgraph")
