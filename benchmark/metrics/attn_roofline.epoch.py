"""attn_roofline.epoch: the attention op alone (forward + backward,
every layer, the cell's layout), its bound (benchmark/flops.py) over its
time."""

from benchmark import readers


def read(record):
    return readers.roofline_pct(record, "fullgraph")
