"""Multi-pass merged attention: the halo/compute overlap of the sharded
layer (port of the merged-softmax ops of gatv2_tpu/ops/sell_attention.py
and gatv2_tpu/ops/pallas_attention.py).

The destination softmax spans K edge subsets, each on its own bipartite
layout over one dst node space (the overlapped layer's local-source edges
in one pass, its halo-source edges in another). Each pass runs its
forward kernel unnormalised (u_k = sum exp(e - m_k) zs, with m_k and l_k,
in node order); the passes merge with the online-softmax rescale
(merge_passes). The backward runs each pass's single-pass backward with
the MERGED sigma = M + log(L + 1e-8) and output h, which span every pass
(r = <g, h>, the flash-attention identity), and sums the d_zd and d_a of
the passes. ops/sell_attention.sell_attention_merge (K1, then K2 and K3)
and ops/pallas_attention.edge_attention_pallas_merge (K5, then K6 and K7)
call it with their kernels.

The sharded layer's form (merged_attention_exchange, through
sell_attention_merge_exchange / edge_attention_pallas_merge_exchange) has
the boundary halo exchange inside: it takes the local projections and the
send buffer, starts the all_to_all, runs the local pass while the rows are
in flight, waits, then runs the halo pass. Its backward runs the halo
pass's backward first, starts the reverse all_to_all of the halo rows'
gradient, runs the local pass's backward under it and waits last. The
arithmetic and its order are merged_attention's, so the results are
bit-equal to an exchange that finishes before either pass.
"""

from __future__ import annotations

import torch

from gatv2_tpu_torch.ops.pallas_fwd import NEG_INF, STATS_L
from gatv2_tpu_torch.ops.segment import SOFTMAX_EPS


def merge_passes(parts, head_dim):
    """The online-softmax merge of K passes' node-order (u_k, m_k, l_k)
    [n, H*D], [n, H], [n, H] into (h, m_all, l_tot):

        M = max_k m_k;  h = sum_k e^{m_k - M} u_k / (sum_k e^{m_k - M} l_k
        + 1e-8)

    A pass without an edge at a node (m_k = -1e30) weighs 0 there; a node
    without any edge keeps M = -1e30 and gets h = 0."""
    m_all = parts[0][1]
    for _, m_k, _ in parts[1:]:
        m_all = torch.maximum(m_all, m_k)
    m_safe = torch.where(m_all <= NEG_INF, 0.0, m_all)
    u_tot = l_tot = 0.0
    for u_k, m_k, l_k in parts:
        c = torch.where(m_k <= NEG_INF, 0.0, torch.exp(m_k - m_safe))
        u_tot = u_tot + u_k * c.repeat_interleave(head_dim, dim=1)
        l_tot = l_tot + l_k * c
    h = u_tot / (l_tot.repeat_interleave(head_dim, dim=1) + SOFTMAX_EPS)
    return h, m_all, l_tot


def _flat(x):
    return x.reshape(x.shape[0], -1).float().contiguous()


def _merged_output(parts, a, num_nodes):
    """merge_passes of the passes' (u, m, l) -> (h [num_nodes, H*D], the
    merged sigma = M + log(L + 1e-8) [n_pad, H])."""
    h, m_all, l_tot = merge_passes(parts, a.shape[1])
    return h[:num_nodes], m_all + torch.log(l_tot + SOFTMAX_EPS)


def _shaped(h, like, a, num_nodes):
    return h if like.dim() == 2 else h.reshape(num_nodes, *a.shape)


class _Merge(torch.autograd.Function):
    """Forward: forward_raw per pass, then the merge. Backward: backward
    per pass against the merged stats and output."""

    @staticmethod
    def forward(ctx, zd, a, num_nodes, negative_slope, layouts, forward_raw,
                backward, *zs_parts):
        zd2 = _flat(zd)
        zs2s = [_flat(z) for z in zs_parts]
        layouts = [lay.to(zd.device) for lay in layouts]
        h, sigma = _merged_output(
            [forward_raw(z, zd2, a, lay, negative_slope)
             for z, lay in zip(zs2s, layouts)], a, num_nodes)
        ctx.save_for_backward(zd2, a, h, sigma, *zs2s)
        ctx.layouts, ctx.backward_fn, ctx.slope = layouts, backward, \
            negative_slope
        ctx.shapes = (zd.shape, [z.shape for z in zs_parts])
        return _shaped(h, zs_parts[0], a, num_nodes)

    @staticmethod
    def backward(ctx, grad_out):
        zd2, a, h, sigma, *zs2s = ctx.saved_tensors
        zd_shape, zs_shapes = ctx.shapes
        g2 = grad_out.reshape(h.shape).float().contiguous()
        dzd = da = 0.0
        dzs = []
        for z, lay, shape in zip(zs2s, ctx.layouts, zs_shapes):
            dzs_k, dzd_k, da_k = ctx.backward_fn(z, zd2, a, h, sigma, g2,
                                                 lay, ctx.slope)
            dzs.append(dzs_k.reshape(shape))
            dzd = dzd + dzd_k
            da = da + da_k
        return (dzd.reshape(zd_shape), da.to(a.dtype), None, None, None,
                None, None, *dzs)


def _collectives():
    # imported at call time: gatv2_tpu_torch.parallel imports the ops
    # modules, which import this one
    from gatv2_tpu_torch.parallel import collectives

    return collectives


class _MergeExchange(torch.autograd.Function):
    """The (local, halo) merge with the boundary exchange inside (module
    docstring): the exchange is in flight during the local pass, forward
    and backward."""

    @staticmethod
    def forward(ctx, zd, a, num_nodes, negative_slope, layouts, forward_raw,
                backward, group, zs_loc, send):
        cc = _collectives()
        zd2, zs2 = _flat(zd), _flat(zs_loc)
        lay_loc, lay_halo = (lay.to(zd.device) for lay in layouts)
        pending = cc.all_to_all_start(send, group)
        try:
            local = forward_raw(zs2, zd2, a, lay_loc, negative_slope)
        finally:
            halo = pending.wait()
        halo2 = _flat(halo.reshape(-1, *send.shape[2:]))
        h, sigma = _merged_output(
            [local, forward_raw(halo2, zd2, a, lay_halo, negative_slope)],
            a, num_nodes)
        ctx.save_for_backward(zd2, a, h, sigma, zs2, halo2)
        ctx.layouts, ctx.backward_fn, ctx.slope = (lay_loc, lay_halo), \
            backward, negative_slope
        ctx.group = group
        ctx.shapes = (zd.shape, zs_loc.shape, send.shape)
        return _shaped(h, zs_loc, a, num_nodes)

    @staticmethod
    def backward(ctx, grad_out):
        cc = _collectives()
        zd2, a, h, sigma, zs2, halo2 = ctx.saved_tensors
        zd_shape, zs_shape, send_shape = ctx.shapes
        lay_loc, lay_halo = ctx.layouts
        g2 = grad_out.reshape(h.shape).float().contiguous()
        dzs_h, dzd_h, da_h = ctx.backward_fn(halo2, zd2, a, h, sigma, g2,
                                             lay_halo, ctx.slope)
        rows = send_shape[0] * send_shape[1]
        pending = cc.all_to_all_start(dzs_h[:rows].reshape(send_shape),
                                      ctx.group)
        try:
            dzs_l, dzd_l, da_l = ctx.backward_fn(zs2, zd2, a, h, sigma, g2,
                                                 lay_loc, ctx.slope)
        finally:
            d_send = pending.wait()
        return ((dzd_l + dzd_h).reshape(zd_shape), (da_l + da_h).to(a.dtype),
                None, None, None, None, None, None, dzs_l.reshape(zs_shape),
                d_send)


def _check_layouts(layouts, a, name):
    """What both ops require of their (one per zs part) layouts:
    unchunked, one dst node space, at most STATS_L heads (`name` heads the
    errors)."""
    if any(lay.num_chunks != 1 for lay in layouts):
        raise ValueError("merge path supports num_chunks == 1 tiles only")
    n_pad = layouts[0].padded_num_nodes
    if any(lay.padded_num_nodes != n_pad for lay in layouts):
        raise ValueError("all parts must share the dst node space")
    if a.shape[0] > STATS_L:
        raise ValueError(f"{name} supports at most {STATS_L} heads")


def merged_attention(zs_parts, zd, a, num_nodes, *, negative_slope,
                     layouts, forward_raw, backward, name) -> torch.Tensor:
    """Attention over len(layouts) passes merged per destination.
    forward_raw(zs2, zd2, a, layout, slope) -> node-order (u [n_pad, H*D],
    m [n_pad, H], l [n_pad, H]) of one pass; backward(zs2, zd2, a, h,
    sigma, g2, layout, slope) -> (dzs, dzd, da) of one pass. Checks
    _check_layouts' conditions."""
    _check_layouts(layouts, a, name)
    return _Merge.apply(zd, a, num_nodes, negative_slope, layouts,
                        forward_raw, backward, *zs_parts)


def merged_attention_exchange(zs_loc, send, zd, a, num_nodes, *, group,
                              negative_slope, layouts, forward_raw, backward,
                              name) -> torch.Tensor:
    """merged_attention over layouts = (local, halo), the halo pass's
    source rows exchanged inside the op (module docstring): send [S, M,
    ...] holds the rows this rank sends to each of the S ranks of `group`
    (all_to_all over dim 0); the halo pass reads the S*M rows received.
    Differentiable in zs_loc, send, zd and a."""
    _check_layouts(layouts, a, name)
    return _MergeExchange.apply(zd, a, num_nodes, negative_slope,
                                tuple(layouts), forward_raw, backward, group,
                                zs_loc, send)
