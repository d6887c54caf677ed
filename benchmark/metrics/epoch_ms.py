"""epoch_ms: full-graph training epoch (forward, loss, backward, Adam), the
window's wall on the host clock over the epochs completed in it."""

from benchmark import readers


def read(record):
    return readers.step_ms(record, "fullgraph")
