"""Faults planted under the timed path, to show that the comparison of
benchmark/correct.py catches them (benchmark/tests and calibrate.py;
never used by run.py):

  state_unchanged   the optimizer step leaves every parameter as it was;
  half_batch        half of the labelled nodes left out of the loss, the
                    mean taken over the rest;
  doubled_backward  the attention op's answer altered where it is made:
                    the same output, twice its gradient.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "doubled_backward")


@contextlib.contextmanager
def planted(fault: str):
    from gatv2_tpu_torch.models import gatv2 as model
    from gatv2_tpu_torch.train import loop, minibatch, optim

    saved = (optim.apply_updates, loop.loss_fn, minibatch.loss_fn,
             model.edge_attention)
    attention, loss_fn = model.edge_attention, model.loss_fn

    def no_update(*args, **kw):
        return None

    def half_loss(params, features, src, dst, labels, config, **kw):
        labels = labels.clone()
        valid = torch.nonzero(labels >= 0)[:, 0]
        labels[valid[1::2]] = -1
        kw["num_valid"] = int(valid.numel() - valid[1::2].numel())
        return loss_fn(params, features, src, dst, labels, config, **kw)

    def doubled(*args, **kw):
        h = attention(*args, **kw)
        return h.detach() + 2 * (h - h.detach())

    if fault == "state_unchanged":
        optim.apply_updates = no_update
    elif fault == "half_batch":
        loop.loss_fn = minibatch.loss_fn = half_loss
    elif fault == "doubled_backward":
        model.edge_attention = doubled
    else:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    try:
        yield
    finally:
        (optim.apply_updates, loop.loss_fn, minibatch.loss_fn,
         model.edge_attention) = saved
