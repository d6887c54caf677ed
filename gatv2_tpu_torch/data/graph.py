"""Graph container: CSR adjacency + node features + labels (port of
gatv2_tpu/data/graph.py).

`row_ptr[j]..row_ptr[j+1]` delimits the edges whose destination is node j,
and `col_idx` holds their sources, so the COO `dst` array is sorted
ascending. Self-loops are not added implicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side graph. All arrays are numpy; move to a device at use."""

    features: np.ndarray  # [N, F] float32
    row_ptr: np.ndarray  # [N+1] int32, CSR over destination nodes
    col_idx: np.ndarray  # [E] int32, source node of each edge
    labels: np.ndarray  # [N] int32

    def __post_init__(self):
        self.features = np.ascontiguousarray(self.features, dtype=np.float32)
        self.row_ptr = np.ascontiguousarray(self.row_ptr, dtype=np.int32)
        self.col_idx = np.ascontiguousarray(self.col_idx, dtype=np.int32)
        self.labels = np.ascontiguousarray(self.labels, dtype=np.int32)
        n = self.features.shape[0]
        if self.row_ptr.shape[0] != n + 1:
            raise ValueError(
                f"row_ptr length {self.row_ptr.shape[0]} != num_nodes+1 ({n + 1})"
            )
        if self.labels.shape[0] != n:
            raise ValueError(f"labels length {self.labels.shape[0]} != num_nodes {n}")
        if self.row_ptr[-1] != self.col_idx.shape[0]:
            raise ValueError(
                f"row_ptr[-1]={self.row_ptr[-1]} != num_edges={self.col_idx.shape[0]}"
            )
        # out-of-range ids would index past the feature table on the device
        if (np.diff(self.row_ptr) < 0).any():
            raise ValueError("row_ptr must be non-decreasing")
        if self.col_idx.size:
            lo, hi = int(self.col_idx.min()), int(self.col_idx.max())
            if lo < 0 or hi >= n:
                raise ValueError(
                    f"col_idx contains node id {lo if lo < 0 else hi} outside "
                    f"[0, {n}) — is the dataset 1-indexed?"
                )

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def num_edges(self) -> int:
        return self.col_idx.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        """Inferred as max(label)+1."""
        return int(self.labels.max()) + 1 if self.labels.size else 0

    @property
    def max_degree(self) -> int:
        """Max in-degree (the reference prints it at start-up)."""
        return int(np.diff(self.row_ptr).max()) if self.num_nodes else 0

    @property
    def src(self) -> np.ndarray:
        """COO source indices == col_idx."""
        return self.col_idx

    @property
    def dst(self) -> np.ndarray:
        """COO destination indices: row index repeated by in-degree (sorted)."""
        return np.repeat(
            np.arange(self.num_nodes, dtype=np.int32), np.diff(self.row_ptr)
        )


def edges_to_csr(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
    make_undirected: bool = False, dedup: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Directed edge list -> (row_ptr, col_idx) CSR over DESTINATIONS
    (dst-major stable sort).

    make_undirected: add the reversed edges first.
    dedup: drop duplicate (src, dst) pairs (multi-edges kept by default).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if make_undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    order = np.lexsort((src, dst)) if dedup else np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if dedup and src.size:
        keep = np.ones(src.shape[0], bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
    row_ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=row_ptr[1:])
    return row_ptr, src
