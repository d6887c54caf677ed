"""edge_grad_ms.epoch: device ms per traced epoch of the operations
launched inside the program's span attn.edge_grad (the sum of K2's dW_e
block partials), credited by launch correlation (benchmark/span_trace.py);
None where the program has no such span."""

from benchmark import readers


def read(record):
    return readers.traced_ms(
        record, "fullgraph",
        lambda tr: tr.get("spans", {}).get("attn.edge_grad", 0.0))
