"""Checks of sampled minibatches against the benchmark's own graph, and
the subgraph a batch hands the reference.

A batch is valid when its nodes are distinct ids of the graph, its seeds
(its first num_seeds nodes) are new to the stream, every one of its edges
is an edge of the graph (as often as the graph has it), no node takes
more in-edges than the largest fanout or its in-degree, and every seed
takes exactly min(in-degree, first fanout): the seeds form the first
frontier and are expanded in full.
"""

from __future__ import annotations

import torch


class GraphIndex:
    """The graph's edges as sorted keys dst * N + src, for lookups."""

    def __init__(self, graph: dict):
        self.n = graph["num_nodes"]
        self.row_ptr = graph["row_ptr"]
        self.keys = torch.sort(graph["dst"] * self.n + graph["src"]).values

    def count(self, keys: torch.Tensor) -> torch.Tensor:
        return (torch.searchsorted(self.keys, keys, right=True)
                - torch.searchsorted(self.keys, keys))

    def in_degree(self, nodes: torch.Tensor) -> torch.Tensor:
        return self.row_ptr[nodes + 1] - self.row_ptr[nodes]


def batch_violations(index: GraphIndex, node_ids, src, dst, num_nodes: int,
                     num_edges: int, num_seeds: int, fanouts,
                     seen_seeds: set) -> int:
    """The number of ways the batch breaks the rules above (0: valid).
    node_ids, src, dst: the batch's global node ids and local edge ids
    (numpy or tensors); seen_seeds gains this batch's seeds."""
    dev = index.keys.device
    nodes = torch.as_tensor(node_ids[:num_nodes], device=dev).long()
    s = torch.as_tensor(src[:num_edges], device=dev).long()
    t = torch.as_tensor(dst[:num_edges], device=dev).long()
    bad = 0
    bad += int(((nodes < 0) | (nodes >= index.n)).sum())
    bad += num_nodes - int(torch.unique(nodes).numel())
    bad += int(((s < 0) | (s >= num_nodes) | (t < 0)
                | (t >= num_nodes)).sum())
    if bad:
        return bad
    seeds = nodes[:num_seeds].tolist()
    bad += len(seen_seeds.intersection(seeds))
    seen_seeds.update(seeds)
    keys, reps = torch.unique(nodes[t] * index.n + nodes[s],
                              return_counts=True)
    bad += int((reps > index.count(keys)).sum())
    taken = torch.bincount(t, minlength=num_nodes)
    deg = index.in_degree(nodes)
    bad += int(((taken > max(fanouts)) | (taken > deg)).sum())
    bad += int((taken[:num_seeds]
                != deg[:num_seeds].clamp(max=fanouts[0])).sum())
    return bad


def subgraph(graph: dict, node_ids, src, dst, num_nodes: int,
             num_edges: int, num_seeds: int):
    """(features, src, dst, labels, labelled) of the batch's subgraph for
    the reference: the graph's own feature rows and labels of the batch's
    nodes, its edges in local ids, and the seeds as the labelled nodes."""
    dev = graph["features"].device
    nodes = torch.as_tensor(node_ids[:num_nodes], device=dev).long()
    labelled = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    labelled[:num_seeds] = True
    return (graph["features"][nodes],
            torch.as_tensor(src[:num_edges], device=dev).long(),
            torch.as_tensor(dst[:num_edges], device=dev).long(),
            graph["labels"][nodes], labelled)
