"""attn_roofline.step: the attention op alone (forward + backward, every
layer) on the first replayed batch's edge tiles, its bound from that
batch's real nodes and edges (benchmark/flops.py) over its time."""

from benchmark import readers


def read(record):
    return readers.roofline_pct(record, "replay")
