"""Plain PyTorch training of the edge-conditioned GATv2 block, the
reference of the port's edge_dim / residual / norm / loss fields.

For every directed edge i->j with features f_ij in R^k, and head h
(Brody et al., "How Attentive are Graph Attention Networks?",
arXiv:2105.14491, with the edge term of PyTorch Geometric's
GATv2Conv(edge_dim=k) inside the nonlinearity):
    pre_ij   = W_src,h x_i + W_dst,h x_j + W_e,h f_ij
    e_ij     = a_h . LeakyReLU(pre_ij)
    alpha_ij = softmax over the in-neighbours i of j of e_ij
    o_j,h    = sum_i alpha_ij * (W_src,h x_i)
    r_j      = W_res x_j
hidden layers: x'_j = ReLU(BatchNorm(concat_h o_j,h + r_j)), BatchNorm with
the batch's mean and biased variance over the nodes (eps 1e-5); the last
layer: x'_j = mean_h (o_j,h + r_j,h); logits = w_o x'; the loss is the mean
binary cross-entropy with logits over nodes x tasks. Adam (beta 0.9 /
0.999, eps 1e-8, bias correction by the step) updates every leaf. A node
with no in-edge aggregates nothing (o_j = 0).

Departures from the ogbn-proteins GAT of DGL's OGB examples, whose depth
and widths this block takes: no dropout, edge dropout or label reuse (they
are stochastic); no biases; the last layer averages its heads into one
D-wide vector and a linear classifier w_o [C, D] gives the C task logits,
where DGL's last layer outputs the C tasks per head and averages those.

Everything is fp32 with TF32 off, and every sum runs in a fixed order, so
one input gives one answer from run to run. The attention runs over
blocks of edges so that graphs of tens of millions of edges at H*D = 480
fit: the forward takes each destination's maximum score, then sums
exp(e - max) and exp(e - max) * zs per destination block by block; the
backward replays each block under autograd with the maximum held constant
and scatters the block's gradients.

Leaves, per layer in sorted-name order, those the layer has: a [H, D];
bn_b, bn_g [H*D] (hidden layers); w_dst [H, D, F]; w_e [H, D, k]; w_res
[H*D, F]; w_src [H, D, F]; then w_o [C, D_L].

Imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib

import torch

NEGATIVE_SLOPE = 0.2
BN_EPS = 1e-5
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# elements of one edge-block tensor [Eb, H, D]
BLOCK_ELEMENTS = 1 << 27


@contextlib.contextmanager
def fp32_exact():
    """IEEE fp32 matmuls (both TF32 switches off) and sums in a fixed
    order (deterministic index_add_ and scatter_reduce_), restored on
    exit. An op with no deterministic version warns rather than fails."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def _blocks(num_edges: int, per_edge: int):
    step = max(1, BLOCK_ELEMENTS // max(per_edge, 1))
    for lo in range(0, num_edges, step):
        yield lo, min(lo + step, num_edges)


def _scores(zs_e, zd_e, ef, a, w_e, slope):
    """a_h . LeakyReLU(zs_e + zd_e + W_e f): [Eb, H]."""
    pre = zs_e + zd_e + torch.einsum("ek,hdk->ehd", ef, w_e)
    return (torch.nn.functional.leaky_relu(pre, slope) * a).sum(-1)


class BlockedEdgeAttention(torch.autograd.Function):
    """o [N, H, D] from zs, zd [N, H, D], a [H, D], w_e [H, D, k], the
    edges (src, dst) and their features ef [E, k], block by block."""

    @staticmethod
    def forward(ctx, zs, zd, a, w_e, src, dst, ef, slope):
        n, nh, d = zs.shape
        e = src.shape[0]
        m = zs.new_full((n, nh), float("-inf"))
        for lo, hi in _blocks(e, nh * d):
            s, t = src[lo:hi], dst[lo:hi]
            sc = _scores(zs[s], zd[t], ef[lo:hi], a, w_e, slope)
            m.scatter_reduce_(0, t[:, None].expand_as(sc), sc, reduce="amax")
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        num = torch.zeros_like(zs)
        den = zs.new_zeros((n, nh))
        for lo, hi in _blocks(e, nh * d):
            s, t = src[lo:hi], dst[lo:hi]
            zs_e = zs[s]
            p = torch.exp(_scores(zs_e, zd[t], ef[lo:hi], a, w_e, slope)
                          - m[t])
            den.index_add_(0, t, p)
            num.index_add_(0, t, p[:, :, None] * zs_e)
        has = den > 0
        safe = torch.where(has, den, torch.ones_like(den))
        out = torch.where(has[:, :, None], num / safe[:, :, None],
                          torch.zeros_like(num))
        ctx.save_for_backward(zs, zd, a, w_e, src, dst, ef, m, safe, has,
                              out)
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, g):
        zs, zd, a, w_e, src, dst, ef, m, den, has, out = ctx.saved_tensors
        nh, d = a.shape
        g_num = torch.where(has[:, :, None], g / den[:, :, None],
                            torch.zeros_like(g))
        g_den = -(g_num * out).sum(-1)
        d_zs = torch.zeros_like(zs)
        d_zd = torch.zeros_like(zd)
        d_a = torch.zeros_like(a)
        d_we = torch.zeros_like(w_e)
        for lo, hi in _blocks(src.shape[0], nh * d):
            s, t = src[lo:hi], dst[lo:hi]
            with torch.enable_grad():
                zs_e = zs[s].detach().requires_grad_(True)
                zd_e = zd[t].detach().requires_grad_(True)
                a_l = a.detach().requires_grad_(True)
                w_l = w_e.detach().requires_grad_(True)
                p = torch.exp(_scores(zs_e, zd_e, ef[lo:hi], a_l, w_l,
                                      ctx.slope) - m[t])
                v = p[:, :, None] * zs_e
                gs, gd, ga, gw = torch.autograd.grad(
                    (v, p), (zs_e, zd_e, a_l, w_l), (g_num[t], g_den[t]))
            d_zs.index_add_(0, s, gs)
            d_zd.index_add_(0, t, gd)
            d_a += ga
            d_we += gw
        return d_zs, d_zd, d_a, d_we, None, None, None, None


def batch_norm(x, gamma, beta):
    """Training-mode BatchNorm over the rows of x [N, C]."""
    mean = x.mean(0)
    var = (x - mean).square().mean(0)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta


def layer_leaves(num_layers: int, l: int) -> tuple[str, ...]:
    """The names of layer l's leaves, in order."""
    bn = ("bn_b", "bn_g") if l < num_layers - 1 else ()
    return ("a", *bn, "w_dst", "w_e", "w_res", "w_src")


def forward(leaves, features, src, dst, edge_feat, heads, out_dims, *,
            slope=NEGATIVE_SLOPE):
    """Logits [N, C] from the leaves (module docstring's order)."""
    x = features
    n = features.shape[0]
    num_layers = len(heads)
    i = 0
    for l in range(num_layers):
        names = layer_leaves(num_layers, l)
        p = dict(zip(names, leaves[i:i + len(names)]))
        i += len(names)
        h, d = heads[l], out_dims[l]
        zs = (x @ p["w_src"].reshape(h * d, -1).T).view(n, h, d)
        zd = (x @ p["w_dst"].reshape(h * d, -1).T).view(n, h, d)
        o = BlockedEdgeAttention.apply(zs, zd, p["a"], p["w_e"], src, dst,
                                       edge_feat, slope)
        y = o.reshape(n, h * d) + x @ p["w_res"].T
        if l < num_layers - 1:
            x = torch.relu(batch_norm(y, p["bn_g"], p["bn_b"]))
        else:
            x = y.view(n, h, d).mean(1)
    return x @ leaves[-1].T


def bce(logits, labels):
    """Mean binary cross-entropy with logits over nodes x tasks."""
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype))


def train(leaves0, steps, heads, out_dims, *, lr, slope=NEGATIVE_SLOPE):
    """Adam training from leaves0 over `steps`, a list of per-step inputs
    (features, src, dst, edge_feat, labels [N, C]). Returns {losses:
    [float], grads1: the first step's gradient leaves, params: the leaves
    after the last step}."""
    params = [p.detach().clone() for p in leaves0]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = ADAM_BETAS
    losses, grads1 = [], None
    with fp32_exact():
        for t, (features, src, dst, edge_feat, labels) in enumerate(steps,
                                                                    1):
            ps = [p.requires_grad_(True) for p in params]
            loss = bce(forward(ps, features, src, dst, edge_feat, heads,
                               out_dims, slope=slope), labels)
            grads = torch.autograd.grad(loss, ps)
            losses.append(float(loss.detach()))
            if grads1 is None:
                grads1 = [g.detach().clone() for g in grads]
            with torch.no_grad():
                params = [p.detach() for p in ps]
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = mi / (1 - b1 ** t)
                    v_hat = vi / (1 - b2 ** t)
                    p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
    return dict(losses=losses, grads1=grads1, params=params)
