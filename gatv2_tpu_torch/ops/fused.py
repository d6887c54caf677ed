"""The fused attention op, written once for both kernel families: the
single-pass op and the multi-pass merge of the sharded layer's overlap.

A kernel family (`Family`: the SELL kernels K1-K4 of ops/sell_attention.py,
the edge-tile kernels K5-K8 of ops/pallas_attention.py) supplies its
layout checks, its head-group width and the kernel sequences of one head
group: the forward, the unnormalised forward of a merge pass and the
backward. This module owns the rest:

  - the op's inputs: shapes checked against the layout, flat fp32
    projections [N, H*D] (`prepare`);
  - the head groups (`head_groups`): heads are independent, so the lanes
    of each launch's group are sliced, run and concatenated
    (`forward`, `forward_raw`, `backward`);
  - the autograd Function (`attention`): the saved tensors, the remat
    holder `kept`, the gradients reshaped and cast back to the inputs;
  - the merge (`merged_attention`, `merged_attention_exchange`).

The merge. The destination softmax spans K edge subsets, each on its own
bipartite layout over one dst node space (the overlapped layer's
local-source edges in one pass, its halo-source edges in another). Each
pass runs its forward kernel unnormalised (u_k = sum exp(e - m_k) zs, with
m_k and l_k, in node order); the passes merge with the online-softmax
rescale (merge_passes). The backward runs each pass's single-pass backward
with the MERGED sigma = M + log(L + 1e-8) and output h, which span every
pass (r = <g, h>, the flash-attention identity), and sums the d_zd and d_a
of the passes.

The sharded layer's form (merged_attention_exchange) has the boundary halo
exchange inside: it takes the local projections and the send buffer,
starts the all_to_all, runs the local pass while the rows are in flight,
waits, then runs the halo pass. Its backward runs the halo pass's backward
first, starts the reverse all_to_all of the halo rows' gradient, runs the
local pass's backward under it and waits last. The arithmetic and its
order are merged_attention's, so the results are bit-equal to an exchange
that finishes before either pass.
"""

from __future__ import annotations

import torch

from gatv2_tpu_torch.ops.pallas_fwd import NEG_INF, STATS_L
from gatv2_tpu_torch.ops.segment import SOFTMAX_EPS


class Family:
    """A kernel family of the fused op. Its layout (SellTiles, EdgeTiles)
    has num_nodes, padded_num_nodes, src_num_nodes, padded_src_nodes,
    num_chunks and to(device).

    setup_full_graph(graph, heads, out_dims, *, device, labels,
        budget_bytes, tile_e, edge_features) -> (layout, features, labels,
        num_valid) on the host: the family's full-graph layout.

    Per head group of h heads, on contiguous flat fp32 lanes [N, h*D]:
      forward(zs, zd, a, layout, num_nodes, slope, w_e) -> (out
          [num_nodes, h*D], *stats): the stats the backward reads;
      forward_raw(zs, zd, a, layout, slope) -> node-order (u [n_pad, h*D],
          m [n_pad, h], l [n_pad, h]) of one merge pass;
      backward(zs, zd, g, sigma, r, a, layout, slope, w_e) -> node-space
          (dzs [Ns, h*D], dzd [Nd, h*D], da [h, D], dW_e or None).
    """

    impl: str  # the impl name that selects the family
    layout_arg: str  # the op's keyword for its layout, in errors
    layout_hint: str  # how to build a layout, in errors
    layout_type: str  # the layout's class name, in errors
    max_hd: int  # lanes of one head
    # whether the layout carries per-edge features (w_e), and so whether
    # the family runs the edge-conditioned block
    edge_features: bool

    def heads_per_launch(self, head_dim: int) -> int:
        raise NotImplementedError

    def check(self, layout, a, w_e) -> None:
        """Family checks of the op's layout and w_e."""

    def check_merge(self, layout) -> None:
        """Family checks of a merge pass's layout."""

    def stream_dtype(self, streams: str) -> torch.dtype:
        """The dtype the projections stream in (rounded once to it)."""
        return torch.float32

    def sigma(self, *stats) -> torch.Tensor:
        """sigma = m + log(l + 1e-8) per node and head from forward's
        stats."""
        raise NotImplementedError

    def backward_rows(self, x: torch.Tensor, nd: int) -> torch.Tensor:
        """The backward's g, out or sigma as its kernels read them, given
        zd's nd rows."""
        return x


def head_groups(family: Family, num_heads: int, head_dim: int):
    """(h0, h1) head ranges of one kernel launch each (heads are
    independent, so groups change nothing)."""
    group = family.heads_per_launch(head_dim)
    return [(h0, min(h0 + group, num_heads))
            for h0 in range(0, num_heads, group)]


def _cat(xs, dim):
    return torch.cat(xs, dim) if len(xs) > 1 else xs[0]


def _groups(family, a, w_e=None):
    """Per head group: (heads, lanes, a [h, D] fp32, w_e [h, D, k] fp32 or
    None), a and w_e contiguous."""
    num_heads, head_dim = a.shape
    for h0, h1 in head_groups(family, num_heads, head_dim):
        yield (slice(h0, h1), slice(h0 * head_dim, h1 * head_dim),
               a[h0:h1].float().contiguous(),
               None if w_e is None else w_e[h0:h1].float().contiguous())


def prepare(family, zs, zd, a, num_nodes, layout, streams="f32", w_e=None):
    """Validate the op's inputs; returns (layout on zs's device, flat fp32
    zs [Ns, H*D], flat fp32 zd [Nd, H*D], the stream dtype), the
    projections rounded once to the stream dtype."""
    if layout is None:
        raise ValueError(
            f"impl={family.impl!r} requires {family.layout_arg} "
            f"({family.layout_hint})")
    family.check(layout, a, w_e)
    lay, name = layout, family.layout_arg
    if num_nodes not in (lay.num_nodes, lay.padded_num_nodes):
        raise ValueError(
            f"{name} built for {lay.num_nodes} (padded "
            f"{lay.padded_num_nodes}) dst nodes, got {num_nodes}")
    if zs.shape[0] not in (lay.src_num_nodes, lay.padded_src_nodes):
        raise ValueError(
            f"zs has {zs.shape[0]} rows; {name} src space is "
            f"{lay.src_num_nodes} (padded {lay.padded_src_nodes})")
    if zd.shape[0] not in (lay.num_nodes, lay.padded_num_nodes):
        raise ValueError(
            f"zd has {zd.shape[0]} rows; {name} dst space is "
            f"{lay.num_nodes} (padded {lay.padded_num_nodes})")
    sdt = family.stream_dtype(streams)
    num_heads, head_dim = a.shape
    if head_dim > family.max_hd:
        raise ValueError(
            f"head dim {head_dim} exceeds the {family.impl} kernels' "
            f"{family.max_hd} lanes")
    zs2 = zs.reshape(zs.shape[0], num_heads * head_dim).float()
    zd2 = zd.reshape(zd.shape[0], num_heads * head_dim).float()
    if sdt != torch.float32:
        zs2, zd2 = zs2.to(sdt).float(), zd2.to(sdt).float()
    return layout.to(zs.device), zs2, zd2, sdt


def forward(family, zs2, zd2, a, layout, num_nodes, negative_slope,
            w_e=None):
    """Flat fp32 zs/zd -> (out [num_nodes, H*D], *stats), the family's
    forward per head group, concatenated over the groups."""
    parts = [family.forward(zs2[:, lanes].contiguous(),
                            zd2[:, lanes].contiguous(), a_g, layout,
                            num_nodes, negative_slope, w_e_g)
             for _, lanes, a_g, w_e_g in _groups(family, a, w_e)]
    return tuple(_cat(x, 1) for x in zip(*parts))


def forward_raw(family, zs2, zd2, a, layout, negative_slope):
    """One merge pass on an unchunked layout: the family's unnormalised
    forward per head group -> node-order (u [n_pad, H*D], m [n_pad, H],
    l [n_pad, H])."""
    parts = [family.forward_raw(zs2[:, lanes].contiguous(),
                                zd2[:, lanes].contiguous(), a_g, layout,
                                negative_slope)
             for _, lanes, a_g, _ in _groups(family, a)]
    return tuple(_cat(x, 1) for x in zip(*parts))


def backward(family, zs2, zd2, a, out2, sigma, g2, layout, negative_slope,
             w_e=None):
    """The op's backward on `layout` (on g2's device): flat fp32 zs2
    [Ns, H*D], zd2 [Nd, H*D] (the forward's rounded values), out2 and the
    upstream gradient g2 [n, H*D], sigma [n or n_pad, H] ->
    (dzs [Ns, H*D], dzd [Nd, H*D], da [H, D]), and dW_e [H, D, k] fourth
    with w_e [H, D, k].

    Per head group: r = <g, out> per node and head (the softmax
    Jacobian's segment term), then the family's backward kernels."""
    head_dim = a.shape[1]
    g2, out2, sigma = (family.backward_rows(x, zd2.shape[0])
                       for x in (g2, out2, sigma))
    n = g2.shape[0]
    grads = []
    for heads, lanes, a_g, w_e_g in _groups(family, a, w_e):
        g_g = g2[:, lanes].contiguous()
        r = (g_g * out2[:, lanes]).view(
            n, heads.stop - heads.start, head_dim).sum(-1)
        grads.append(family.backward(
            zs2[:, lanes].contiguous(), zd2[:, lanes].contiguous(), g_g,
            sigma[:, heads], r, a_g, layout, negative_slope, w_e_g))
    dzs, dzd, da, dwe = zip(*grads)
    out = (_cat(dzs, 1), _cat(dzd, 1), _cat(da, 0))
    return out if w_e is None else out + (_cat(dwe, 0),)


class _FusedAttention(torch.autograd.Function):
    """The family's forward; its backward. The saved tensors are the
    forward's (rounded) zs/zd in the stream dtype, a, the output and the
    family's stats, as the JAX custom VJPs save them; the gradient passes
    straight through the rounding to the unrounded input.

    `kept` (a dict, or None) carries the node-space result from a
    checkpointed layer's first call to its recompute: an empty holder is
    filled with (out2, *stats); a filled one is emptied and its result
    saved in place of the forward's, whose kernel does not launch."""

    @staticmethod
    def forward(ctx, family, zs, zd, a, num_nodes, negative_slope, layout,
                streams, kept, w_e):
        layout, zs2, zd2, sdt = prepare(family, zs, zd, a, num_nodes,
                                        layout, streams, w_e)
        if kept:
            out2, *stats = kept.pop("result")
            attention.reused += len(head_groups(family, *a.shape))
        else:
            out2, *stats = forward(family, zs2, zd2, a, layout, num_nodes,
                                   negative_slope, w_e)
            if kept is not None:
                kept["result"] = (out2.detach(), *stats)
        ctx.save_for_backward(zs2.to(sdt), zd2.to(sdt), a, out2, *stats,
                              *(() if w_e is None else (w_e,)))
        ctx.family, ctx.layout, ctx.slope = family, layout, negative_slope
        ctx.num_stats = len(stats)
        ctx.shapes = (zs.shape, zd.shape, zs.dtype, zd.dtype)
        return out2 if zs.dim() == 2 else out2.reshape(num_nodes, *a.shape)

    @staticmethod
    def backward(ctx, grad_out):
        zs2, zd2, a, out2, *rest = ctx.saved_tensors
        stats, w_e = rest[:ctx.num_stats], rest[ctx.num_stats:]
        w_e = w_e[0] if w_e else None
        zs_shape, zd_shape, zs_dtype, zd_dtype = ctx.shapes
        g2 = grad_out.reshape(out2.shape).float().contiguous()
        grads = backward(ctx.family, zs2.float(), zd2.float(), a, out2,
                         ctx.family.sigma(*stats), g2, ctx.layout, ctx.slope,
                         w_e)
        dzs, dzd, da = grads[:3]
        dwe = None if w_e is None else grads[3].to(w_e.dtype)
        return (None, dzs.reshape(zs_shape).to(zs_dtype),
                dzd.reshape(zd_shape).to(zd_dtype), da.to(a.dtype),
                None, None, None, None, None, dwe)


def attention(
    family: Family,
    zs: torch.Tensor,  # [N, H, D] or flat [N, H*D]
    zd: torch.Tensor,  # same shape family as zs
    a: torch.Tensor,  # [H, D]
    num_nodes: int,
    *,
    negative_slope: float,
    layout,
    streams: str = "f32",
    kept: dict | None = None,
    w_e: torch.Tensor | None = None,
) -> torch.Tensor:
    """The fused single-pass op on `family`'s layout: out in the shape of
    zs, num_nodes rows; differentiable in zs, zd and a on any layout,
    chunked or not, and in w_e [H, D, k], which makes each score read the
    layout's per-edge features (families with edge_features). `kept`: a
    checkpointed layer's holder (models/gatv2.py), whose recompute reuses
    the first call's result instead of launching the forward kernel
    again; attention.reused counts the head groups it took."""
    return _FusedAttention.apply(family, zs, zd, a, num_nodes,
                                 negative_slope, layout, streams, kept, w_e)


# head groups whose forward a recompute took from `kept`
attention.reused = 0


# ---------------------------------------------------------------------------
# multi-pass merged attention (halo/compute overlap of the sharded layer)
# ---------------------------------------------------------------------------


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
    def forward(ctx, family, zd, a, num_nodes, negative_slope, layouts,
                *zs_parts):
        zd2 = _flat(zd)
        zs2s = [_flat(z) for z in zs_parts]
        layouts = [lay.to(zd.device) for lay in layouts]
        h, sigma = _merged_output(
            [forward_raw(family, z, zd2, a, lay, negative_slope)
             for z, lay in zip(zs2s, layouts)], a, num_nodes)
        ctx.save_for_backward(zd2, a, h, sigma, *zs2s)
        ctx.family, ctx.layouts, ctx.slope = family, layouts, negative_slope
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
            dzs_k, dzd_k, da_k = backward(ctx.family, z, zd2, a, h, sigma,
                                          g2, lay, ctx.slope)
            dzs.append(dzs_k.reshape(shape))
            dzd = dzd + dzd_k
            da = da + da_k
        return (None, dzd.reshape(zd_shape), da.to(a.dtype), None, None,
                None, *dzs)


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
    def forward(ctx, family, zd, a, num_nodes, negative_slope, layouts,
                group, zs_loc, send):
        cc = _collectives()
        zd2, zs2 = _flat(zd), _flat(zs_loc)
        lay_loc, lay_halo = (lay.to(zd.device) for lay in layouts)
        pending = cc.all_to_all_start(send, group)
        try:
            local = forward_raw(family, zs2, zd2, a, lay_loc, negative_slope)
        finally:
            halo = pending.wait()
        halo2 = _flat(halo.reshape(-1, *send.shape[2:]))
        h, sigma = _merged_output(
            [local, forward_raw(family, halo2, zd2, a, lay_halo,
                                negative_slope)], a, num_nodes)
        ctx.save_for_backward(zd2, a, h, sigma, zs2, halo2)
        ctx.family, ctx.layouts, ctx.slope = (family, (lay_loc, lay_halo),
                                              negative_slope)
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
        dzs_h, dzd_h, da_h = backward(ctx.family, halo2, zd2, a, h, sigma,
                                      g2, lay_halo, ctx.slope)
        rows = send_shape[0] * send_shape[1]
        pending = cc.all_to_all_start(dzs_h[:rows].reshape(send_shape),
                                      ctx.group)
        try:
            dzs_l, dzd_l, da_l = backward(ctx.family, zs2, zd2, a, h, sigma,
                                          g2, lay_loc, ctx.slope)
        finally:
            d_send = pending.wait()
        return (None, (dzd_l + dzd_h).reshape(zd_shape),
                (da_l + da_h).to(a.dtype), None, None, None, None,
                dzs_l.reshape(zs_shape), d_send)


def _check_merge(family, layouts, a, rows):
    """What the merge requires of its layouts, one per zs part of rows[k]
    rows: the family's checks, each part in its layout's (padded) src
    space, unchunked, one dst node space, at most STATS_L heads."""
    if len(layouts) != len(rows) or not layouts:
        raise ValueError(f"need one {family.layout_type} per zs part")
    for lay in layouts:
        family.check_merge(lay)
    for n, lay in zip(rows, layouts):
        if n not in (lay.src_num_nodes, lay.padded_src_nodes):
            raise ValueError(
                f"zs part has {n} rows; its tiles' src space is "
                f"{lay.src_num_nodes} (padded {lay.padded_src_nodes})")
    if any(lay.num_chunks != 1 for lay in layouts):
        raise ValueError("merge path supports num_chunks == 1 tiles only")
    n_pad = layouts[0].padded_num_nodes
    if any(lay.padded_num_nodes != n_pad for lay in layouts):
        raise ValueError("all parts must share the dst node space")
    if a.shape[0] > STATS_L:
        raise ValueError(
            f"the {family.impl} merge supports at most {STATS_L} heads")


def merged_attention(family, zs_parts, zd, a, num_nodes, *, negative_slope,
                     layouts) -> torch.Tensor:
    """Attention over K edge subsets, one unchunked bipartite layout each
    over one dst space, whose per-destination softmax is MERGED across the
    subsets (module docstring). Differentiable in every zs part, zd and
    a; returns num_nodes rows in the shape family of the zs parts."""
    layouts, zs_parts = tuple(layouts), tuple(zs_parts)
    _check_merge(family, layouts, a, [z.shape[0] for z in zs_parts])
    return _Merge.apply(family, zd, a, num_nodes, negative_slope, layouts,
                        *zs_parts)


def merged_attention_exchange(family, zs_loc, send, zd, a, num_nodes, *,
                              group, negative_slope, layouts) -> torch.Tensor:
    """merged_attention over layouts = (local, halo), the halo pass's
    source rows exchanged inside the op (module docstring): send [S, M,
    ...] holds the rows this rank sends to each of the S ranks of `group`
    (all_to_all over dim 0); the halo pass reads the S*M rows received.
    Differentiable in zs_loc, send, zd and a; bit-equal to
    merged_attention((zs_loc, all_to_all(send)), ...)."""
    layouts = tuple(layouts)
    _check_merge(family, layouts, a,
                 [zs_loc.shape[0], send.shape[0] * send.shape[1]])
    return _MergeExchange.apply(family, zd, a, num_nodes, negative_slope,
                                layouts, group, zs_loc, send)
