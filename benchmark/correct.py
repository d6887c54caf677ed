"""The comparison that decides `correct`: the program's first training
steps against the plain reference's from the same weights and inputs.

Numbers (each cell's limits file, benchmark/limits/<cell>.json, names
those it judges):
  loss           the largest relative gap of a step's loss, over the
                 steps (loss_steps: each step's, for the record);
  loss1          the first step's relative loss gap: the forward from
                 the same weights, before Adam's first step turns the
                 rounding of near-zero gradients into +-lr moves, which
                 swing the later steps' losses from seed to seed;
  grad1          the worst leaf's gap between the norm of the program's
                 first gradient (worked out from Adam's first moment after
                 step 1, m1 / (1 - beta1): the gradient as the optimizer
                 got it) and the norm of the reference's;
  grad1_median   the median leaf's such gap;
  grad1_wo       the classifier leaf's (w_o) first gradient: the norm of
                 the difference over the reference's norm (no softmax
                 lies between it and the loss, so no cancellation swells
                 its rounding: the steady number);
  change         the worst leaf's gap between the norms of the
                 parameters' change over the steps;
  batch_invalid  (sampled traffic) the sampled batches' violations of
                 reference/sampled.py, limit 0.
A gap of norms is measured against the larger of the reference leaf's
norm and the median leaf's norm, since some leaves are all but zero.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by rounding alone and are left out of the change.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.gatv2 import ADAM_BETAS

IGNORE_BELOW = 1e-3


def _norms(leaves):
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def _median(xs):
    s = sorted(xs)
    k = len(s)
    return 0.5 * (s[(k - 1) // 2] + s[k // 2])


def _worst(values) -> float:
    """The largest of `values`, or NaN if any is NaN."""
    values = list(values)
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values, default=0.0)


def _gaps(got, ref, keep=None):
    """|got - ref| / max(ref, median ref) of the kept leaves."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = _median([ref[i] for i in idx])
    return [abs(got[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx]


def training_numbers(prog: dict, ref: dict, params0) -> dict:
    """prog: {losses, m1, params} of the program (m1: Adam's first moment
    after step 1; params: the leaves after the last checked step); ref:
    reference.gatv2.train's result from params0. Leaves in the program's
    order, the classifier w_o last."""
    b1 = ADAM_BETAS[0]
    g_prog = [m / (1.0 - b1) for m in prog["m1"]]
    g_ref = ref["grads1"]
    ng_ref, ng_prog = _norms(g_ref), _norms(g_prog)
    keep = [n >= IGNORE_BELOW * _median(ng_ref) for n in ng_ref]
    ch_prog = _norms([p - q for p, q in zip(prog["params"], params0)])
    ch_ref = _norms([p - q for p, q in zip(ref["params"], params0)])
    diff = _norms([g - r for g, r in zip(g_prog, g_ref)])
    g1 = _gaps(ng_prog, ng_ref)
    loss_steps = [abs(p - r) / abs(r)
                  for p, r in zip(prog["losses"], ref["losses"])]
    return {
        "loss": _worst(loss_steps),
        "loss1": loss_steps[0],
        "loss_steps": loss_steps,
        "grad1": _worst(g1),
        "grad1_median": (math.nan if any(map(math.isnan, g1))
                         else _median(g1)),
        "grad1_wo": diff[-1] / max(ng_ref[-1], 1e-30),
        "change": _worst(_gaps(ch_prog, ch_ref, keep)),
        "left_out": [i for i, k in enumerate(keep) if not k],
        # per leaf: the first gradient's norms (reference, program), the
        # change's norms (reference, program), the gradients' difference
        "leaves": [list(x) for x in zip(ng_ref, ng_prog, ch_ref, ch_prog,
                                        diff)],
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers that have a
    limit; a NaN or missing number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and not math.isnan(value) and value <= limit
        ok = ok and good
        if value is not None and math.isnan(value):
            value = None  # JSON has no NaN
        out[name] = {"value": value, "limit": limit}
    return ok, out
