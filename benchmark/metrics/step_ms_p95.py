"""step_ms_p95: the 95th percentile over the window's steps of the time
between consecutive step completions (a CUDA event after each step)."""

from benchmark import readers


def read(record):
    if record.get("kind") != "replay":
        return None
    return readers.p95(record.get("step_ms") or [])
