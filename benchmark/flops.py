"""Operation and byte counts of the benchmark's metrics, and the H100's
peaks they are divided by.

`model_flops` is a frozen copy of the arithmetic of the port's bench
(gatv2_tpu_torch/bench.py flops_per_epoch): dense projections (zs and zd
per layer, and the classifier) and per-edge work (score dot, softmax,
aggregation: 6D+10 FLOPs per edge and head); a matmul's backward costs
twice its forward, so a training step is 3x the forward. Recompute under
remat is not counted.

`attention_roofline` counts the attention op alone (forward + backward of
one layer) from N, E and H*D only: each input read once and each output
written once, whatever kernel, gather or chunking implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_FP32_TFLOPS = 67.0  # fp32 outside the tensor cores
PEAK_TFLOPS = {"highest": (67.0, "fp32"), "high": (495.0, "tf32"),
               "default": (989.0, "bf16")}
PEAK_HBM_BYTES_PER_S = 3.35e12

FWD_BWD = 3.0


def edge_flops_fwd(num_edges: int, heads: int, dim: int) -> float:
    """Forward FLOPs of the attention op of one layer."""
    return num_edges * heads * (6.0 * dim + 10.0)


def model_flops(num_nodes: int, num_edges: int, in_dim: int,
                num_classes: int, heads, out_dims) -> float:
    """Model FLOPs of one training step (forward, backward, update) of the
    GATv2 stack plus classifier on a graph of num_nodes and num_edges."""
    in_dims = [in_dim] + [heads[l] * out_dims[l]
                          for l in range(len(heads) - 1)]
    dense = edge = 0.0
    for l, (h, d) in enumerate(zip(heads, out_dims)):
        dense += 2 * 2.0 * num_nodes * in_dims[l] * h * d  # zs and zd
        edge += edge_flops_fwd(num_edges, h, d)
    dense += 2.0 * num_nodes * out_dims[-1] * num_classes  # classifier
    return FWD_BWD * (dense + edge)


def attention_bytes(num_nodes: int, num_edges: int, hd: int) -> float:
    """Bytes of the op's forward + backward of one layer, each once: read
    zs, zd, the output's gradient [N, HD] and a [HD]; the graph (E source
    ids, N+1 row offsets); write the output, d_zs, d_zd [N, HD] and d_a."""
    f32 = i32 = 4
    return (f32 * (6.0 * num_nodes * hd + 2.0 * hd)
            + i32 * (num_edges + num_nodes + 1.0))


def attention_bound_s(num_nodes: int, num_edges: int, heads: int,
                      dim: int) -> float:
    """The least time of one layer's op forward + backward on one H100:
    the larger of its bytes over HBM bandwidth and its fp32 operations over
    the fp32 peak."""
    ops = FWD_BWD * edge_flops_fwd(num_edges, heads, dim)
    return max(attention_bytes(num_nodes, num_edges, heads * dim)
               / PEAK_HBM_BYTES_PER_S, ops / (PEAK_FP32_TFLOPS * 1e12))
