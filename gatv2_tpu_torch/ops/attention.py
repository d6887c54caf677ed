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
) -> torch.Tensor:
    """Returns per-head aggregated features h (the shape of zs):

        e_e   = a_h . LeakyReLU(zs[src_e] + zd[dst_e])
        alpha = segment_softmax(e, dst)
        h_j   = sum_{e: dst_e = j} alpha_e * zs[src_e]

    kept: a checkpointed layer's holder of the fused op's node-space
    result ('sell', 'pallas'): the layer's first call fills it, its
    recompute in the backward takes it and launches no forward kernel.
    The 'torch' path takes none.
    """
    if impl == "torch":
        return _edge_attention_torch(
            zs, zd, a, src, dst, num_nodes, negative_slope=negative_slope
        )
    if impl == "sell":
        from gatv2_tpu_torch.ops.sell_attention import sell_attention

        return sell_attention(
            zs, zd, a, num_nodes, negative_slope=negative_slope,
            sell_tiles=edge_tiles, streams=streams, kept=kept,
        )
    if impl == "pallas":
        from gatv2_tpu_torch.ops.pallas_attention import edge_attention_pallas

        return edge_attention_pallas(
            zs, zd, a, num_nodes, negative_slope=negative_slope,
            edge_tiles=edge_tiles, kept=kept,
        )
    raise ValueError(
        f"unknown impl {impl!r}; expected 'torch', 'sell' or 'pallas'")


def _edge_attention_torch(
    zs, zd, a, src, dst, num_nodes, *, negative_slope
) -> torch.Tensor:
    """Counterpart of gatv2_tpu.ops.attention._edge_attention_xla."""
    src, dst = src.long(), dst.long()
    zs_e = zs[src]  # [E, H, D]
    s = torch.nn.functional.leaky_relu(zs_e + zd[dst], negative_slope)
    e = torch.einsum("ehd,hd->eh", s, a)  # [E, H] attention logits
    alpha = segment_softmax(e, dst, num_nodes)
    return segment_sum(alpha[:, :, None] * zs_e, dst, num_nodes)  # [N, H, D]
