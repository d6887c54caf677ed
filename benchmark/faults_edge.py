"""Faults of the edge-conditioned block planted under the timed path, to
show that the comparison of benchmark/correct.py catches them
(benchmark/calibrate_edge.py and the tests; never used by run.py):

  edge_term_dropped  the attention op's scores leave out W_e f (W_e taken
                     as 0, so dW_e is 0 too);
  zero_edge_grad     the scores read W_e f, but dW_e comes out 0.
"""

from __future__ import annotations

import contextlib

FAULTS = ("edge_term_dropped", "zero_edge_grad")


@contextlib.contextmanager
def planted(fault: str):
    from gatv2_tpu_torch.models import gatv2 as model

    saved = model.edge_attention

    def dropped(*args, w_e=None, **kw):
        return saved(*args, w_e=None if w_e is None else 0 * w_e, **kw)

    def no_grad(*args, w_e=None, **kw):
        if w_e is not None:
            w_e = w_e.detach() + 0 * w_e  # the same value, gradient 0
        return saved(*args, w_e=w_e, **kw)

    if fault == "edge_term_dropped":
        model.edge_attention = dropped
    elif fault == "zero_edge_grad":
        model.edge_attention = no_grad
    else:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    try:
        yield
    finally:
        model.edge_attention = saved
