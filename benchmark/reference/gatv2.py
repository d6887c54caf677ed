"""Plain PyTorch GATv2 training, the benchmark's reference.

For every directed edge i->j and head h (Brody et al., "How Attentive are
Graph Attention Networks?", arXiv:2105.14491):
    e_ij     = a_h . LeakyReLU(W_src_h x_i + W_dst_h x_j)
    alpha_ij = softmax over the in-neighbours of j of e_ij
    h_j      = sum_i alpha_ij * (W_src_h x_i)
Hidden layers apply LeakyReLU (slope 0.01) per head and concatenate the
heads; the last layer applies LeakyReLU and averages its heads (the
reference repository's "edge" variant); a linear classifier w_o gives the
logits. The loss is the mean cross-entropy over the labelled nodes; Adam
(beta 0.9 / 0.999, eps 1e-8, bias correction by the step) updates every
leaf. A node with no in-edge aggregates nothing (h_j = 0).

Everything is fp32 with TF32 off, and every sum runs in a fixed order, so
one input gives one answer from run to run. The attention runs over
blocks of edges so that products-scale graphs fit: the forward takes each
destination's maximum score, then sums exp(e - max) and exp(e - max) * zs per
destination block by block; the backward replays each block under
autograd with the maximum held constant (the softmax does not depend on
it) and scatters the block's gradients. Departures from the published
description: none in the arithmetic; the program's softmax adds 1e-8 to
its denominators (below fp32 rounding for a denominator >= 1), this one
does not.

Imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib

import torch

NEGATIVE_SLOPE = 0.01
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# elements of one edge-block tensor [Eb, H, D]
BLOCK_ELEMENTS = 1 << 27


@contextlib.contextmanager
def fp32_exact():
    """IEEE fp32 matmuls (both TF32 switches off) and sums in a fixed
    order (PyTorch's deterministic index_add_ and scatter_add_ in place of
    atomics, whose order moved the first gradient's norms by ~1e-5 from
    one run to the next), restored on exit. An op with no deterministic
    version warns rather than fails."""
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


def _scores(zs_e, zd_e, a):
    """a_h . LeakyReLU(zs_e + zd_e): [Eb, H]."""
    s = torch.nn.functional.leaky_relu(zs_e + zd_e, NEGATIVE_SLOPE)
    return (s * a).sum(-1)


class BlockedAttention(torch.autograd.Function):
    """h [N, H, D] from zs, zd [N, H, D], a [H, D] and the edges (src,
    dst), computed block by block."""

    @staticmethod
    def forward(ctx, zs, zd, a, src, dst):
        n, nh, d = zs.shape
        e = src.shape[0]
        m = zs.new_full((n, nh), float("-inf"))
        for lo, hi in _blocks(e, nh * d):
            s, t = src[lo:hi], dst[lo:hi]
            sc = _scores(zs[s], zd[t], a)
            m.scatter_reduce_(0, t[:, None].expand_as(sc), sc, reduce="amax")
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        num = torch.zeros_like(zs)
        den = zs.new_zeros((n, nh))
        for lo, hi in _blocks(e, nh * d):
            s, t = src[lo:hi], dst[lo:hi]
            zs_e = zs[s]
            p = torch.exp(_scores(zs_e, zd[t], a) - m[t])
            den.index_add_(0, t, p)
            num.index_add_(0, t, p[:, :, None] * zs_e)
        has = den > 0
        safe = torch.where(has, den, torch.ones_like(den))
        out = torch.where(has[:, :, None], num / safe[:, :, None],
                          torch.zeros_like(num))
        ctx.save_for_backward(zs, zd, a, src, dst, m, safe, has, out)
        return out

    @staticmethod
    def backward(ctx, g):
        zs, zd, a, src, dst, m, den, has, out = ctx.saved_tensors
        nh, d = a.shape
        # out = num / den: the gradients of the two per-destination sums
        g_num = torch.where(has[:, :, None], g / den[:, :, None],
                            torch.zeros_like(g))
        g_den = -(g_num * out).sum(-1)
        d_zs = torch.zeros_like(zs)
        d_zd = torch.zeros_like(zd)
        d_a = torch.zeros_like(a)
        for lo, hi in _blocks(src.shape[0], nh * d):
            s, t = src[lo:hi], dst[lo:hi]
            with torch.enable_grad():
                zs_e = zs[s].detach().requires_grad_(True)
                zd_e = zd[t].detach().requires_grad_(True)
                a_l = a.detach().requires_grad_(True)
                p = torch.exp(_scores(zs_e, zd_e, a_l) - m[t])
                v = p[:, :, None] * zs_e
                gs, gd, ga = torch.autograd.grad(
                    (v, p), (zs_e, zd_e, a_l), (g_num[t], g_den[t]))
            d_zs.index_add_(0, s, gs)
            d_zd.index_add_(0, t, gd)
            d_a += ga
        return d_zs, d_zd, d_a, None, None


def forward(leaves, features, src, dst, heads, out_dims):
    """Logits [N, C]. leaves: per layer a [H, D], w_dst [H, D, F], w_src
    [H, D, F]; then w_o [C, D_L]."""
    x = features
    n = features.shape[0]
    num_layers = len(heads)
    for l in range(num_layers):
        a, w_dst, w_src = leaves[3 * l: 3 * l + 3]
        h, d = heads[l], out_dims[l]
        zs = (x @ w_src.reshape(h * d, -1).T).view(n, h, d)
        zd = (x @ w_dst.reshape(h * d, -1).T).view(n, h, d)
        y = torch.nn.functional.leaky_relu(
            BlockedAttention.apply(zs, zd, a, src, dst), NEGATIVE_SLOPE)
        x = y.reshape(n, h * d) if l < num_layers - 1 else y.mean(1)
    return x @ leaves[-1].T


def cross_entropy(logits, labels, labelled):
    """Mean cross-entropy over the nodes where `labelled` is True."""
    logp = torch.log_softmax(logits[labelled], -1)
    return -logp.gather(1, labels[labelled][:, None]).mean()


def train(leaves0, steps, heads, out_dims, *, lr):
    """Adam training from leaves0 over `steps`, a list of per-step inputs
    (features, src, dst, labels, labelled). Returns {losses: [float],
    grads1: the first step's gradient leaves, params: the leaves after the
    last step}."""
    params = [p.detach().clone() for p in leaves0]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = ADAM_BETAS
    losses, grads1 = [], None
    with fp32_exact():
        for t, (features, src, dst, labels, labelled) in enumerate(steps, 1):
            ps = [p.requires_grad_(True) for p in params]
            loss = cross_entropy(
                forward(ps, features, src, dst, heads, out_dims), labels,
                labelled)
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
