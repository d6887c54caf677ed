"""Edge-space GATv2 attention: SDDMM score -> segment softmax -> SpMM (port
of gatv2_tpu/ops/attention.py), and the one place that maps an impl to its
kernel family and its layout.

Implementations, selectable with `impl=`:
  'torch' — gathers + segment reductions in plain PyTorch: the port's
            oracle, the counterpart of the JAX package's 'xla' path;
  'sell'  — the SELL family of the fused op (ops/fused.py,
            ops/sell_attention.py: K1-K4);
  'pallas' — the edge-tile family of the fused op (ops/fused.py,
            ops/pallas_attention.py: K5-K8).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gatv2_tpu_torch.ops import fused
from gatv2_tpu_torch.ops.pallas_attention import EDGE_TILES
from gatv2_tpu_torch.ops.segment import segment_softmax, segment_sum
from gatv2_tpu_torch.ops.sell_attention import SELL
from gatv2_tpu_torch.utils.metrics import span

_FAMILIES = {f.impl: f for f in (SELL, EDGE_TILES)}


def family(impl: str) -> fused.Family | None:
    """The kernel family of `impl`, None for 'torch'; ValueError for an
    unknown impl."""
    if impl == "torch":
        return None
    if impl not in _FAMILIES:
        raise ValueError(
            f"unknown impl {impl!r}; expected 'torch', 'sell' or 'pallas'")
    return _FAMILIES[impl]


def edge_attention(
    zs: torch.Tensor,  # [N, H, D] or flat [N, H*D] src projections
    zd: torch.Tensor,  # same shape as zs: dst projections
    a: torch.Tensor,  # [H, D] attention vectors
    src: torch.Tensor | None,  # [E] int, unused by 'sell' and 'pallas'
    dst: torch.Tensor | None,  # [E] int, sorted ascending, all < num_nodes
    num_nodes: int,
    *,
    negative_slope: float,
    impl: str = "torch",
    edge_tiles: Any = None,
    streams: str = "f32",
    kept: dict | None = None,
    edge_feat: torch.Tensor | None = None,  # [E, k] in src/dst's edge order
    w_e: torch.Tensor | None = None,  # [H, D, k]
) -> torch.Tensor:
    """Returns per-head aggregated features h (the shape of zs):

        e_e   = a_h . LeakyReLU(zs[src_e] + zd[dst_e] + W_e,h f_e)
        alpha = segment_softmax(e, dst)
        h_j   = sum_{e: dst_e = j} alpha_e * zs[src_e]

    The edge term is there only with w_e: the 'torch' path reads f from
    edge_feat, 'sell' from its layout's per-slot table (built with
    edge_features) and ignores edge_feat; 'pallas' takes no edge features.
    The op is differentiable in w_e; f takes no gradient.

    kept: a checkpointed layer's holder of the fused op's node-space
    result ('sell', 'pallas'): the layer's first call fills it, its
    recompute in the backward takes it and launches no forward kernel.
    The 'torch' path ignores it.
    """
    fam = family(impl)
    if fam is None:
        if (edge_feat is None) != (w_e is None):
            raise ValueError("impl 'torch': edge_feat and w_e go together")
        return _edge_attention_torch(
            zs, zd, a, src, dst, num_nodes, negative_slope=negative_slope,
            edge_feat=edge_feat, w_e=w_e,
        )
    if not fam.edge_features and (w_e is not None or edge_feat is not None):
        raise ValueError(
            f"impl {impl!r} takes no edge features (edge_dim > 0 runs on "
            "impl 'torch' or 'sell')")
    return fused.attention(
        fam, zs, zd, a, num_nodes, negative_slope=negative_slope,
        layout=edge_tiles, streams=streams, kept=kept, w_e=w_e,
    )


def _edge_attention_torch(
    zs, zd, a, src, dst, num_nodes, *, negative_slope, edge_feat=None,
    w_e=None,
) -> torch.Tensor:
    """Counterpart of gatv2_tpu.ops.attention._edge_attention_xla, with
    the edge term W_e f inside the LeakyReLU when w_e is given."""
    src, dst = src.long(), dst.long()
    zs_e = zs.view(zs.shape[0], *a.shape)[src]  # [E, H, D]
    pre = zs_e + zd.view(zd.shape[0], *a.shape)[dst]
    if w_e is not None:
        pre = pre + torch.einsum("ek,hdk->ehd", edge_feat, w_e)
    s = torch.nn.functional.leaky_relu(pre, negative_slope)
    e = torch.einsum("ehd,hd->eh", s, a)  # [E, H] attention logits
    alpha = segment_softmax(e, dst, num_nodes)
    h = segment_sum(alpha[:, :, None] * zs_e, dst, num_nodes)  # [N, H, D]
    return h.view(num_nodes, *zs.shape[1:])


def edge_features_for(graph, model_config):
    """The graph's edge features [E, k] when the model reads them
    (model_config.edge_dim > 0), else None; ValueError when the model
    wants features the graph lacks or of another width."""
    if model_config.edge_dim == 0:
        return None
    ef = graph.edge_features
    if ef is None or ef.shape[1] != model_config.edge_dim:
        raise ValueError(
            f"edge_dim={model_config.edge_dim} needs the graph's edge "
            f"features of that width; it has "
            f"{'none' if ef is None else ef.shape[1]}")
    return ef


class FullGraph(NamedTuple):
    """A full-graph run's inputs on the device (full_graph_inputs)."""

    layout: Any  # SellTiles / EdgeTiles, None for 'torch'
    features: torch.Tensor  # [N or n_pad, F]
    labels: torch.Tensor  # [N or n_pad] (or [.., C]); -1 on padding rows
    num_valid: int | None  # the real node count when rows were padded
    src: torch.Tensor | None  # [E] ('torch' only)
    dst: torch.Tensor | None
    edge_feat: torch.Tensor | None  # [E, k] ('torch' with edge_dim > 0)


def full_graph_inputs(graph, model_config, impl: str, *, device,
                      labels=None, budget_bytes=None,
                      tile_e=None) -> FullGraph:
    """The inputs of full-graph training or inference through `impl` on
    `device`: the family's layout (setup_full_graph_sell for 'sell',
    setup_full_graph for 'pallas': chunked by budget_bytes or the device's
    default budget; tile_e for 'pallas' only), copied to the device under
    the spans setup.layout and layout.to_device, with the features and
    labels (default graph.labels) padded to its node grid; or, for
    'torch', the graph's edges src/dst. The edge features of
    model_config.edge_dim go into the SELL layout or, for 'torch',
    edge_feat. A family whose layout carries no edge features refuses the
    edge-conditioned block (ValueError naming `--impl`)."""
    fam = family(impl)
    as_t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    labels = graph.labels if labels is None else labels
    if fam is None:
        return FullGraph(None, as_t(graph.features), as_t(labels), None,
                         as_t(graph.src), as_t(graph.dst),
                         as_t(edge_features_for(graph, model_config)))
    if not fam.edge_features:
        model_config.check_full_graph_only(f"--impl {impl}")
    layout, feats, labels, num_valid = fam.setup_full_graph(
        graph, model_config.heads, model_config.out_dims, device=device,
        labels=labels, budget_bytes=budget_bytes, tile_e=tile_e,
        edge_features=edge_features_for(graph, model_config))
    with span("setup.layout"), span("layout.to_device"):
        layout = layout.to(device)
    return FullGraph(layout, as_t(feats), as_t(labels), num_valid, None,
                     None, None)
