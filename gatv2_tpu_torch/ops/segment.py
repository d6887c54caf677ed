"""Segment reductions over dst-sorted edge arrays (port of
gatv2_tpu/ops/segment.py:30-75).

Numerical-parity details: softmax denominator `+ 1e-8`, exponent clamped at
-80 after max subtraction. Empty segments give -inf from segment_max, as in
JAX. Every segment id must lie in [0, num_segments).
"""

from __future__ import annotations

import torch

SOFTMAX_EPS = 1e-8
EXP_CLAMP = -80.0


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    out = data.new_full((num_segments, *data.shape[1:]), float("-inf"))
    idx = segment_ids.long().view(-1, *([1] * (data.dim() - 1)))
    return out.scatter_reduce_(0, idx.expand_as(data), data, reduce="amax")


def segment_softmax(
    scores: torch.Tensor,  # [E, ...] attention logits per edge
    segment_ids: torch.Tensor,  # [E] destination node per edge (sorted)
    num_segments: int,
) -> torch.Tensor:
    """Numerically-stable softmax over each destination's in-neighborhood.

    alpha_e = exp(s_e - max_seg) / (sum_seg exp(. - max_seg) + 1e-8)
    """
    ids = segment_ids.long()
    seg_max = segment_max(scores, ids, num_segments)
    # empty segments have -inf max; make the gathered max finite
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = scores - seg_max[ids]
    expd = torch.exp(torch.clamp(shifted, min=EXP_CLAMP))
    denom = segment_sum(expd, ids, num_segments)
    return expd / (denom[ids] + SOFTMAX_EPS)
