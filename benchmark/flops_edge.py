"""Operation and byte counts of the edge-conditioned GATv2 block (the
ogbn-proteins configuration), beside benchmark/flops.py's counts of the
plain block, whose arithmetic and peaks they extend.

`model_flops` counts dense projections (zs, zd and the residual W_res x
per layer, and the classifier) and per-edge work: the attention's 6D+10
FLOPs per edge and head (flops.edge_flops_fwd) and the edge term W_e f,
2*k*H*D FLOPs per edge; a training step is 3x the forward (a matmul's
backward costs twice its forward). BatchNorm, the loss and recompute
under remat are not counted.

`attention_bound_s` bounds the attention op alone (forward + backward of
one layer) from N, E, H*D and k only: each input read once (zs, zd, the
output's gradient, a, W_e, the graph and the edge features), each output
written once (the output, d_zs, d_zd, d_a, dW_e), whatever kernel, gather
or chunking implements it; the edge term's 2*k*H*D FLOPs an edge counted
forward and twice that backward.
"""

from __future__ import annotations

from benchmark import flops


def edge_term_flops_fwd(num_edges: int, heads: int, dim: int,
                        edge_dim: int) -> float:
    """Forward FLOPs of W_e f over every edge of one layer."""
    return 2.0 * num_edges * edge_dim * heads * dim


def model_flops(num_nodes: int, num_edges: int, in_dim: int,
                num_classes: int, heads, out_dims, edge_dim: int) -> float:
    """Model FLOPs of one training step of the edge-conditioned stack
    (residual on every layer) plus the classifier."""
    in_dims = [in_dim] + [heads[l] * out_dims[l]
                          for l in range(len(heads) - 1)]
    dense = edge = 0.0
    for l, (h, d) in enumerate(zip(heads, out_dims)):
        dense += 3 * 2.0 * num_nodes * in_dims[l] * h * d  # zs, zd, W_res x
        edge += (flops.edge_flops_fwd(num_edges, h, d)
                 + edge_term_flops_fwd(num_edges, h, d, edge_dim))
    dense += 2.0 * num_nodes * out_dims[-1] * num_classes  # classifier
    return flops.FWD_BWD * (dense + edge)


def attention_bytes(num_nodes: int, num_edges: int, hd: int,
                    edge_dim: int) -> float:
    """flops.attention_bytes plus the edge features [E, k] read, W_e
    [H*D, k] read and dW_e written, each once."""
    f32 = 4
    return (flops.attention_bytes(num_nodes, num_edges, hd)
            + f32 * (num_edges * edge_dim + 2.0 * hd * edge_dim))


def attention_bound_s(num_nodes: int, num_edges: int, heads: int, dim: int,
                      edge_dim: int) -> float:
    """The least time of one layer's op forward + backward on one H100:
    the larger of its bytes over HBM bandwidth and its fp32 operations
    over the fp32 peak."""
    ops = flops.FWD_BWD * (flops.edge_flops_fwd(num_edges, heads, dim)
                           + edge_term_flops_fwd(num_edges, heads, dim,
                                                 edge_dim))
    return max(attention_bytes(num_nodes, num_edges, heads * dim, edge_dim)
               / flops.PEAK_HBM_BYTES_PER_S,
               ops / (flops.PEAK_FP32_TFLOPS * 1e12))
