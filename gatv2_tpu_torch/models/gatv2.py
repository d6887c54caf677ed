"""Multi-layer multi-head GATv2 for full-graph node classification (port of
gatv2_tpu/models/gatv2.py:53-218).

For every directed edge i->j and head h:
    e_ij     = a_h . LeakyReLU(W_src_h x_i + W_dst_h x_j)
    alpha_ij = softmax over the in-neighbours of j of e_ij
    h_j      = sum_i alpha_ij * (W_src_h x_i)
computed as two dense projections per layer, then edge attention
(ops/attention.py). Hidden layers apply LeakyReLU per head and concatenate;
the last layer averages heads — LeakyReLU then mean ('edge' variant) or
mean then LeakyReLU ('node' variant). A linear classifier gives the logits.

Parameters keep the JAX shapes: w_src, w_dst [H, D, F], a [H, D],
w_o [C, D_L].

The edge-conditioned block (ModelConfig edge_dim, residual, norm, loss;
the ogbn-proteins GAT of DGL's OGB examples) adds per layer, each only
when its field is set:
    w_e [H, D, k]     e_ij reads LeakyReLU(W_src x_i + W_dst x_j + W_e f_ij)
    w_res [H*D, F]    o_j += W_res x_j (before the activation)
    bn_g, bn_b [H*D]  norm 'batch' (hidden layers): x' = ReLU(BN(o)) with
                      the statistics of the real nodes only (padding rows
                      of a SELL node grid are left out), running mean and
                      variance (momentum 0.1, eps 1e-5) for inference; the
                      last layer then takes the plain head mean.
loss 'bce' is the mean binary cross-entropy with logits over [N, C] labels.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.utils.checkpoint
from torch import nn

from gatv2_tpu_torch.config import ModelConfig
from gatv2_tpu_torch.device import resolve_device
from gatv2_tpu_torch.ops.attention import edge_attention
from gatv2_tpu_torch.utils.metrics import span


@contextlib.contextmanager
def _tf32(enabled: bool):
    """Set both TF32 switches for the enclosed matmuls, then restore them.
    'highest' runs with both False (IEEE fp32), 'high' with both True."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def dense(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w.T at a precision tier: 'highest' = IEEE fp32; 'high' = TF32;
    'default' = bf16-rounded inputs with fp32 products and accumulation."""
    if precision == "default":
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    with _tf32(precision == "high"):
        return x @ w.T


BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batch_norm(x, gamma, beta, mean_buf, var_buf, num_real: int, *,
               training: bool, update: bool):
    """BatchNorm over the rows of x [N, C]: in training with the mean and
    (biased) variance of the first num_real rows, the real nodes, and then,
    if `update`, the running statistics moved by BN_MOMENTUM (the unbiased
    variance, as torch.nn.BatchNorm1d keeps it); else with the running
    statistics. Every row is normalised; padding rows past num_real take
    no part in the statistics or their gradients."""
    if not training:
        mean, var = mean_buf, var_buf
    else:
        xr = x[:num_real]
        mean = xr.mean(0)
        var = (xr - mean).square().mean(0)
        if update:
            with torch.no_grad():
                n = xr.shape[0]
                mean_buf.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                var_buf.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * var * (n / max(n - 1, 1)))
    return (x - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta


class GATv2Layer(nn.Module):
    def __init__(self, heads: int, out_dim: int, in_dim: int, *,
                 edge_dim: int = 0, residual: bool = False,
                 norm: bool = False):
        super().__init__()
        self.w_src = nn.Parameter(torch.empty(heads, out_dim, in_dim))
        self.w_dst = nn.Parameter(torch.empty(heads, out_dim, in_dim))
        self.a = nn.Parameter(torch.empty(heads, out_dim))
        hd = heads * out_dim
        self.w_e = (nn.Parameter(torch.empty(heads, out_dim, edge_dim))
                    if edge_dim else None)
        self.w_res = (nn.Parameter(torch.empty(hd, in_dim)) if residual
                      else None)
        self.bn_g = self.bn_b = None
        if norm:
            self.bn_g = nn.Parameter(torch.ones(hd))
            self.bn_b = nn.Parameter(torch.zeros(hd))
            self.register_buffer("bn_mean", torch.zeros(hd))
            self.register_buffer("bn_var", torch.ones(hd))

    def named_leaves(self) -> list[tuple[str, nn.Parameter]]:
        """(name, parameter) of this layer in sorted-name order (the
        checkpoint's and the optimizer's): a, bn_b, bn_g, w_dst, w_e,
        w_res, w_src, those the configuration has."""
        names = ("a", "bn_b", "bn_g", "w_dst", "w_e", "w_res", "w_src")
        return [(k, getattr(self, k)) for k in names
                if getattr(self, k) is not None]

    def project(self, x: torch.Tensor, precision: str):
        """Flat projections (zs, zd), each [N, H*D]."""
        h, d, f = self.w_src.shape
        return (dense(x, self.w_src.reshape(h * d, f), precision),
                dense(x, self.w_dst.reshape(h * d, f), precision))

    def forward(self, x, src, dst, *, is_last: bool, config: ModelConfig,
                impl: str, edge_tiles=None, kept=None, edge_feat=None,
                num_real: int | None = None, update_stats: bool = True):
        """One GATv2 layer: [N, H*D] (hidden) or [N, D] (last layer).
        `kept`: the attention op's holder under remat (edge_attention).
        edge_feat [E, k]: the edge features of impl 'torch' (edge_attention);
        num_real: the real rows BatchNorm's statistics take (all by
        default); update_stats: whether training moves the running
        statistics (not in a remat recompute)."""
        num_nodes = x.shape[0]
        nh, hdim = self.a.shape
        zs, zd = self.project(x, config.precision)
        h = edge_attention(
            zs, zd, self.a, src, dst, num_nodes,
            negative_slope=config.negative_slope, impl=impl,
            edge_tiles=edge_tiles, streams=config.streams, kept=kept,
            edge_feat=edge_feat, w_e=self.w_e,
        )
        if self.w_res is not None:
            h = (h.reshape(num_nodes, nh * hdim)
                 + dense(x, self.w_res, config.precision))
        if config.norm == "batch":
            h = h.reshape(num_nodes, nh * hdim)
            if is_last:
                return h.view(num_nodes, nh, hdim).mean(dim=1)
            training = self.training and torch.is_grad_enabled()
            return torch.relu(batch_norm(
                h, self.bn_g, self.bn_b, self.bn_mean, self.bn_var,
                num_nodes if num_real is None else num_real,
                training=training, update=update_stats))
        slope = config.negative_slope
        if not is_last:
            # per-head LeakyReLU, then concat heads
            return nn.functional.leaky_relu(h, slope).reshape(num_nodes, -1)
        h = h.reshape(num_nodes, nh, hdim)
        if config.variant == "edge":
            return nn.functional.leaky_relu(h, slope).mean(dim=1)
        return nn.functional.leaky_relu(h.mean(dim=1), slope)


def _recomputed_under_span(layer):
    """layer, run under the span model.remat from its second call on:
    torch.utils.checkpoint calls it once in the forward and again, to
    recompute its activations, in each backward. Both calls share one
    holder: with a fused attention op ('sell', 'pallas') the first keeps
    the op's node-space result in it, the recompute hands it back to the
    op instead of running the op's forward kernel again ('torch' ignores
    it)."""
    calls = 0
    kept = {}

    def run(*args, **kw):
        nonlocal calls
        calls += 1
        if calls == 1:
            return layer(*args, kept=kept, **kw)
        with span("model.remat"):
            return layer(*args, kept=kept, update_stats=False, **kw)

    return run


class GATv2(nn.Module):
    """The GATv2 stack plus the classifier weight w_o."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        last = config.num_layers - 1
        self.layers = nn.ModuleList(
            GATv2Layer(h, d, f, edge_dim=config.edge_dim,
                       residual=config.residual,
                       norm=config.norm == "batch" and l < last)
            for l, (h, d, f) in enumerate(
                zip(config.heads, config.out_dims, config.layer_in_dims))
        )
        self.w_o = nn.Parameter(
            torch.empty(config.num_classes, config.out_dims[-1])
        )

    def forward(self, features, src, dst, config: ModelConfig, *,
                impl: str = "torch", edge_tiles=None,
                edge_feat=None) -> torch.Tensor:
        """Logits [N, C]. With config.remat, and only while autograd
        records, each layer runs under torch.utils.checkpoint: its
        activations are recomputed in the backward pass instead of kept
        (jax.checkpoint in the JAX package). What is recomputed depends on
        the impl. 'torch': the whole layer, its edge-sized attention
        included. 'sell' and 'pallas': the projections and the elementwise
        ops; the attention op's node-space result (out and its softmax
        statistics) is kept from the forward, so K1 / K5 run once a step
        and K2-K4 / K6-K8 read the result they would without remat.
        edge_feat [E, k]: the edge features of impl 'torch' (src/dst's
        edge order; edge_attention). BatchNorm's statistics
        take the layout's real nodes (edge_tiles.num_nodes) or every
        row."""
        x = features
        remat = config.remat and torch.is_grad_enabled()
        extra = {}
        if config.extended:
            extra = dict(edge_feat=edge_feat, num_real=getattr(
                edge_tiles, "num_nodes", features.shape[0]))
        for l, layer in enumerate(self.layers):
            kw = dict(is_last=(l == len(self.layers) - 1), config=config,
                      impl=impl, edge_tiles=edge_tiles, **extra)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _recomputed_under_span(layer), x, src, dst,
                    use_reentrant=False, **kw)
            else:
                x = layer(x, src, dst, **kw)
        return dense(x, self.w_o, config.precision)


def init_params(config: ModelConfig, generator: torch.Generator) -> GATv2:
    """Xavier/Glorot uniform init with the reference's limits, on the CPU.

    W_src/W_dst/a: U(-l, l), l = sqrt(6 / (2*in_dim + out_dim)).
    W_o: U(-l, l), l = sqrt(6 / (C + out_dim_last)).
    Draws come from `generator`, so a seed fixes them (they differ from
    the JAX package's jax.random draws for the same seed).
    """
    model = GATv2(config)
    with torch.no_grad():
        for layer in model.layers:
            h, d, f = layer.w_src.shape
            limit = math.sqrt(6.0 / (2 * f + d))
            for p in (layer.w_src, layer.w_dst, layer.a):
                p.uniform_(-limit, limit, generator=generator)
            init_block_params(layer, generator)
        c, d_last = model.w_o.shape
        model.w_o.uniform_(
            -math.sqrt(6.0 / (c + d_last)), math.sqrt(6.0 / (c + d_last)),
            generator=generator,
        )
    return model


def init_block_params(layer: GATv2Layer, generator: torch.Generator):
    """Glorot-uniform draws of a layer's w_e (fan k + D) and w_res (fan F
    + H*D), those it has, in that order; BatchNorm starts at 1 and 0."""
    if layer.w_e is not None:
        h, d, k = layer.w_e.shape
        limit = math.sqrt(6.0 / (k + d))
        layer.w_e.uniform_(-limit, limit, generator=generator)
    if layer.w_res is not None:
        hd, f = layer.w_res.shape
        limit = math.sqrt(6.0 / (f + hd))
        layer.w_res.uniform_(-limit, limit, generator=generator)


def init_params_for_variant(
    config: ModelConfig, generator: torch.Generator
) -> GATv2:
    """Init in the draw layout of the selected reference variant: 'edge'
    draws each layer's W as one fused [H, D, 2F] tensor
    (params_io.init_params_fused), 'node' draws W_src and W_dst apart
    (init_params)."""
    if config.variant == "edge":
        from gatv2_tpu_torch.models.params_io import init_params_fused

        return init_params_fused(config, generator)
    return init_params(config, generator)


def _as_tensor(x, device):
    return None if x is None else torch.as_tensor(x, device=device)


def model_forward(
    params: GATv2,
    features,
    src,
    dst,
    config: ModelConfig,
    *,
    impl: str = "torch",
    edge_tiles=None,
    device: str | torch.device = "cuda",
    edge_feat=None,
) -> torch.Tensor:
    """Full model: GATv2 stack + linear classifier. Returns logits [N, C]
    on `device` (CUDA unless the caller asks for the CPU; raises when CUDA
    is asked for and absent). Inputs may be numpy arrays or tensors; they
    and `params` (in place, as nn.Module.to does) move to `device`.
    src/dst are the real edges (impl='torch'); edge_tiles the SellTiles
    (impl='sell') or EdgeTiles (impl='pallas'); edge_feat [E, k] the edge
    features of impl 'torch'."""
    dev = resolve_device(device)
    params = params.to(dev)
    if edge_tiles is not None:
        edge_tiles = edge_tiles.to(dev)
    return params(
        _as_tensor(features, dev), _as_tensor(src, dev),
        _as_tensor(dst, dev), config, impl=impl, edge_tiles=edge_tiles,
        edge_feat=_as_tensor(edge_feat, dev),
    )


def bce_and_accuracy(
    logits: torch.Tensor, labels, num_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean binary cross-entropy with logits over nodes x tasks, and the
    share of (node, task) pairs whose sign of the logit matches the 0/1
    label. labels [N, C]; rows whose first entry is < 0 are padding and
    count in neither sum; `num_valid` (rows) is then the denominator."""
    labels = torch.as_tensor(labels, device=logits.device)
    valid = (labels[:, :1] >= 0)
    y = torch.where(valid, labels, 0).to(logits.dtype)
    nll = nn.functional.binary_cross_entropy_with_logits(
        logits, y, reduction="none")
    hit = ((logits > 0) == (y > 0)) & valid
    denom = (labels.shape[0] if num_valid is None else num_valid) \
        * labels.shape[1]
    return torch.where(valid, nll, 0.0).sum() / denom, hit.sum() / denom


def loss_and_accuracy(
    logits: torch.Tensor, labels, num_valid: int | None = None,
    loss: str = "ce",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy + argmax accuracy over all nodes, from logits via
    log-softmax (no 1e-12 clamp). Rows with label < 0 are padding: they
    count in neither sum; `num_valid` is then the denominator. loss='bce':
    bce_and_accuracy over [N, C] multi-label labels."""
    if loss == "bce":
        return bce_and_accuracy(logits, labels, num_valid)
    labels = torch.as_tensor(labels, device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(1, safe[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == safe) & valid
    denom = labels.shape[0] if num_valid is None else num_valid
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / denom, correct.sum() / denom


def loss_fn(
    params: GATv2,
    features,
    src,
    dst,
    labels,
    config: ModelConfig,
    *,
    impl: str = "torch",
    edge_tiles=None,
    num_valid: int | None = None,
    edge_feat=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy, or binary cross-entropy with config.loss
    'bce'; accuracy) of the model on features already on the parameters'
    device; differentiable in params."""
    logits = params(features, src, dst, config, impl=impl,
                    edge_tiles=edge_tiles, edge_feat=edge_feat)
    return loss_and_accuracy(logits, labels, num_valid, config.loss)
