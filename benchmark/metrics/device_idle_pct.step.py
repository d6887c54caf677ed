"""device_idle_pct.step: as device_idle_pct.epoch, per sampled step."""

from benchmark import readers


def read(record):
    return readers.idle_pct(record, "replay")
