"""step_ms: sampled training step, the window's wall on the host clock
over the train_step calls completed in it (each copies its batch to the
card and reads its loss back)."""

from benchmark import readers


def read(record):
    return readers.step_ms(record, "replay")
