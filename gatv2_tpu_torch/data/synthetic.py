"""Synthetic graph generators for tests and benchmarks (port of
gatv2_tpu/data/synthetic.py; numpy only, so the same seed gives the same
bytes in both packages)."""

from __future__ import annotations

import numpy as np

from gatv2_tpu_torch.data.graph import Graph


def random_graph(
    num_nodes: int,
    num_edges: int,
    feature_dim: int,
    num_classes: int,
    seed: int = 0,
    planted_signal: float = 0.0,
) -> Graph:
    """Random directed graph in CSR form.

    With `planted_signal > 0`, features carry class-correlated structure so a
    model can actually learn (used by end-to-end training tests).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    features = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    if planted_signal > 0:
        centroids = rng.standard_normal((num_classes, feature_dim)).astype(np.float32)
        features += planted_signal * centroids[labels]

    # sample edges, sort by dst to build CSR
    src = rng.integers(0, num_nodes, size=num_edges).astype(np.int32)
    if planted_signal > 0:
        # homophilous rewiring: half the edges connect same-class nodes
        dst = rng.integers(0, num_nodes, size=num_edges).astype(np.int32)
        same = rng.random(num_edges) < 0.5
        by_class = [np.where(labels == c)[0] for c in range(num_classes)]
        for i in np.where(same)[0]:
            pool = by_class[labels[dst[i]]]
            src[i] = pool[rng.integers(0, len(pool))]
    else:
        dst = rng.integers(0, num_nodes, size=num_edges).astype(np.int32)

    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(features=features, row_ptr=row_ptr, col_idx=src, labels=labels)


def powerlaw_graph(
    num_nodes: int,
    num_edges: int,
    feature_dim: int,
    num_classes: int,
    seed: int = 0,
    alpha: float = 1.2,
) -> Graph:
    """Random directed graph with Zipf-like in- AND out-degree skew.

    Both endpoints are drawn from a Zipf(alpha) rank distribution over
    independently permuted node ranks (hub dst ids are not hub src ids).
    Same CSR output contract as random_graph.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    features = rng.standard_normal((num_nodes, feature_dim)).astype(
        np.float32
    )

    # Zipf over ranks: P(rank k) ∝ (k+1)^-alpha, sampled by inverse CDF
    w = (np.arange(num_nodes, dtype=np.float64) + 1.0) ** -alpha
    cdf = np.cumsum(w)
    cdf /= cdf[-1]

    def draw(perm_seed):
        ranks = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int64)
        perm = np.random.default_rng(perm_seed).permutation(num_nodes)
        return perm[ranks].astype(np.int32)

    src = draw(seed + 1)
    dst = draw(seed + 2)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(features=features, row_ptr=row_ptr, col_idx=src, labels=labels)


def chain_graph(num_nodes: int, feature_dim: int, num_classes: int, seed: int = 0) -> Graph:
    """Deterministic tiny graph: i -> i+1 edges plus self-loops at even nodes."""
    rng = np.random.default_rng(seed)
    edges = []  # (src, dst)
    for i in range(num_nodes - 1):
        edges.append((i, i + 1))
    for i in range(0, num_nodes, 2):
        edges.append((i, i))
    edges.sort(key=lambda e: e[1])
    src = np.array([e[0] for e in edges], dtype=np.int32)
    dst = np.array([e[1] for e in edges], dtype=np.int32)
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    features = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    labels = (np.arange(num_nodes) % num_classes).astype(np.int32)
    return Graph(features=features, row_ptr=row_ptr, col_idx=src, labels=labels)
