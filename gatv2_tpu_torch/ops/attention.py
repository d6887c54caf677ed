"""Edge-space GATv2 attention: SDDMM score -> segment softmax -> SpMM (port
of gatv2_tpu/ops/attention.py).

Implementations, selectable with `impl=`:
  'torch' — gathers + segment reductions in plain PyTorch: the port's
            oracle, the counterpart of the JAX package's 'xla' path;
  'sell'  — the SELL layout through the hand-written CUDA forward kernel
            (ops/sell_attention.py);
  'pallas' — the edge-tile layout through the hand-written CUDA kernels
            K5-K7 (ops/pallas_attention.py).
"""

from __future__ import annotations

from typing import Any

import torch

from gatv2_tpu_torch.ops.segment import segment_softmax, segment_sum


def edge_attention(
    zs: torch.Tensor,  # [N, H, D] src projections; 'sell' and 'pallas'
    #                    also take flat [N, H*D]
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
    edge_features); 'pallas' takes no edge features. The op is
    differentiable in w_e; f takes no gradient.

    kept: a checkpointed layer's holder of the fused op's node-space
    result ('sell', 'pallas'): the layer's first call fills it, its
    recompute in the backward takes it and launches no forward kernel.
    The 'torch' path takes none.
    """
    if impl == "torch":
        if (edge_feat is None) != (w_e is None):
            raise ValueError("impl 'torch': edge_feat and w_e go together")
        return _edge_attention_torch(
            zs, zd, a, src, dst, num_nodes, negative_slope=negative_slope,
            edge_feat=edge_feat, w_e=w_e,
        )
    if impl == "sell":
        from gatv2_tpu_torch.ops.sell_attention import sell_attention

        return sell_attention(
            zs, zd, a, num_nodes, negative_slope=negative_slope,
            sell_tiles=edge_tiles, streams=streams, kept=kept, w_e=w_e,
        )
    if w_e is not None or edge_feat is not None:
        raise ValueError(
            f"impl {impl!r} takes no edge features (edge_dim > 0 runs on "
            "impl 'torch' or 'sell')")
    if impl == "pallas":
        from gatv2_tpu_torch.ops.pallas_attention import edge_attention_pallas

        return edge_attention_pallas(
            zs, zd, a, num_nodes, negative_slope=negative_slope,
            edge_tiles=edge_tiles, kept=kept,
        )
    raise ValueError(
        f"unknown impl {impl!r}; expected 'torch', 'sell' or 'pallas'")


def _edge_attention_torch(
    zs, zd, a, src, dst, num_nodes, *, negative_slope, edge_feat=None,
    w_e=None,
) -> torch.Tensor:
    """Counterpart of gatv2_tpu.ops.attention._edge_attention_xla, with
    the edge term W_e f inside the LeakyReLU when w_e is given."""
    src, dst = src.long(), dst.long()
    zs_e = zs[src]  # [E, H, D]
    pre = zs_e + zd[dst]
    if w_e is not None:
        pre = pre + torch.einsum("ek,hdk->ehd", edge_feat, w_e)
    s = torch.nn.functional.leaky_relu(pre, negative_slope)
    e = torch.einsum("ehd,hd->eh", s, a)  # [E, H] attention logits
    alpha = segment_softmax(e, dst, num_nodes)
    return segment_sum(alpha[:, :, None] * zs_e, dst, num_nodes)  # [N, H, D]
