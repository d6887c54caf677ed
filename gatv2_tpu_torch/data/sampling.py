"""Neighbour-sampling data loader for minibatch training (port of
gatv2_tpu/data/sampling.py).

Each batch is a node-induced sampled subgraph of fixed, padded shapes:
  - `batch_size` seed nodes (the nodes the loss is computed on),
  - L rounds of frontier expansion sampling at most `fanout[l]` in-neighbours
    per frontier node (without replacement when degree > fanout),
  - the traversed edges, re-indexed to subgraph-local ids and dst-sorted,
  - labels: real for seeds, -1 elsewhere (masked by the loss).

Sampling runs on the host and is deterministic under a seed. Two engines
with the same semantics and the JAX package's random streams, so each gives
the JAX package's batches byte for byte:
  - native C++ (native/sampler.cpp through utils/native_loader.py, built at
    first use) — 'auto' means this one; a failed build raises;
  - numpy/Python ('python'), which draws from np.random.default_rng(seed)
    exactly as the JAX package's does.
With emit_tiles='pallas' each batch carries its fixed-budget EdgeTiles,
emitted by the native library on the native engine (an emission that does
not fit raises) and by prepare_edge_tiles on the python engine. With
emit_tiles='sell' it carries its SellTiles, both sides split, in the
geometry sell_minibatch_geometry fixes for the whole batch stream: the
native engine emits them with native emit_sell_tiles only (the numpy build
costs far more per batch at Products scale), the python engine builds them
with prepare_minibatch_sell_tiles.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np

from gatv2_tpu_torch.data.graph import Graph
from gatv2_tpu_torch.utils.metrics import span

@dataclasses.dataclass(frozen=True)
class MiniBatch:
    features: np.ndarray | None  # [max_nodes, F] host-gathered rows, or
    #   None when the trainer gathers rows from a device-resident table
    src: np.ndarray  # [max_edges] local ids (pad: 0)
    dst: np.ndarray  # [max_edges] local ids sorted (pad: max_nodes)
    labels: np.ndarray  # [max_nodes] (-1 on non-seeds and padding)
    num_seeds: int  # loss normaliser
    num_nodes: int  # real nodes in this batch
    num_edges: int  # real edges in this batch
    tiles: object = None  # EdgeTiles or SellTiles (emit_tiles mode; fixed
    #   shapes)
    node_ids: np.ndarray | None = None  # [max_nodes] global ids (pad: 0)


class NeighborSampler:
    """Iterable over sampled subgraph batches covering all seed nodes once
    per epoch."""

    def __init__(
        self,
        graph: Graph,
        batch_size: int,
        fanouts: Sequence[int],
        *,
        seed: int = 0,
        edge_multiple: int = 128,
        engine: str = "auto",  # 'auto' (= 'native') | 'native' | 'python'
        seed_nodes: np.ndarray | None = None,  # restrict seeds (e.g. a
        #   train split); default: every node once per epoch
        emit_tiles: bool | str = False,  # True/'pallas': attach each
        #   batch's fixed-shape EdgeTiles; 'sell': its SellTiles
        gather_features: bool = False,  # True: gather feature rows on the
        #   host into each batch; False: batches carry node_ids only
        budget: str = "auto",  # static-shape budget policy:
        #   'auto'  — analytic worst case capped at the graph size (exact);
        #   'worst' — the uncapped analytic worst case;
        #   'probe' — ~1.35x the largest of a few throwaway batches (a rare
        #             over-budget batch truncates neighbours, never seeds).
    ):
        self.graph = graph
        # the native ABI takes int64 row_ptr: convert once
        self._row_ptr64 = np.ascontiguousarray(graph.row_ptr, np.int64)
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts)
        self.seed = seed
        self.seed_pool = (
            np.arange(graph.num_nodes, dtype=np.int64)
            if seed_nodes is None
            else np.asarray(seed_nodes, np.int64)
        )
        self.rng = np.random.default_rng(seed)
        self._batch_counter = 0
        if engine == "auto":
            engine = "native"
        if engine not in ("native", "python"):
            raise ValueError(
                f"engine must be 'auto', 'native' or 'python', got {engine!r}")
        if engine == "native":
            from gatv2_tpu_torch.utils import native_loader

            native_loader.build()  # raises if the library cannot be built
        self.engine = engine
        # static shape budget: analytic no-dedup worst case ...
        max_nodes = batch_size
        max_edges = 0
        frontier = batch_size
        for f in self.fanouts:
            max_edges += frontier * f
            frontier = frontier * f
            max_nodes += frontier
        if budget not in ("auto", "worst", "probe"):
            raise ValueError(
                f"budget must be 'auto', 'worst' or 'probe', got {budget!r}")
        if budget in ("auto", "probe"):
            # ... capped at the graph: a subgraph holds at most N unique
            # nodes, and each neighbourhood is expanded at most once
            max_nodes = min(max_nodes, graph.num_nodes)
            max_edges = min(max_edges, graph.num_edges)
        if emit_tiles is True:
            emit_tiles = "pallas"
        if emit_tiles not in (False, None, "pallas", "sell"):
            raise ValueError(
                f"emit_tiles must be False, True/'pallas' or 'sell', got "
                f"{emit_tiles!r}")
        self.emit_tiles = emit_tiles or False
        self.gather_features = gather_features
        self._set_budgets(max_nodes, max_edges, edge_multiple)
        if budget == "probe":
            self._probe_budgets(edge_multiple)

    def _set_budgets(self, max_nodes: int, max_edges: int,
                     edge_multiple: int):
        if self.emit_tiles:
            # node dim padded to the tile grid: every batch's EdgeTiles then
            # has identical shapes
            max_nodes = -(-max_nodes // 128) * 128
        self.max_nodes = max_nodes
        self.max_edges = max(
            edge_multiple, -(-max_edges // edge_multiple) * edge_multiple)
        self._tile_budget = self.max_edges // 128 + self.max_nodes // 128
        if self.emit_tiles == "sell":
            from gatv2_tpu_torch.ops.sell_attention import (
                sell_minibatch_geometry,
            )

            self._sell_fixed = sell_minibatch_geometry(self.max_nodes,
                                                       self.max_edges)

    def _probe_budgets(self, edge_multiple: int, *, rounds: int = 4,
                       margin: float = 1.35):
        """Shrink the static budget to ~margin x the largest of a few probe
        batches, drawn from a throwaway random stream: the training batch
        stream is unaffected."""
        prng = np.random.default_rng((self.seed << 1) ^ 0x9E3779B9)
        emit, self.emit_tiles = self.emit_tiles, False  # probe without tiles
        rng_state = self.rng.bit_generator.state
        counter = self._batch_counter
        worst_nodes, worst_edges = self.max_nodes, self.max_edges
        seen_n, seen_e = 1, 1
        try:
            for _ in range(rounds):
                seeds = prng.choice(
                    self.seed_pool,
                    size=min(self.batch_size, self.seed_pool.shape[0]),
                    replace=False,
                )
                b = self.sample(np.sort(seeds))
                seen_n = max(seen_n, b.num_nodes)
                seen_e = max(seen_e, b.num_edges)
        finally:
            self.emit_tiles = emit
            self.rng.bit_generator.state = rng_state
            self._batch_counter = counter
        self._set_budgets(
            min(worst_nodes, int(seen_n * margin)),
            min(worst_edges, int(seen_e * margin)),
            edge_multiple,
        )

    def __iter__(self) -> Iterator[MiniBatch]:
        pool = self.seed_pool
        order = pool[self.rng.permutation(pool.shape[0])]
        for lo in range(0, order.shape[0], self.batch_size):
            yield self.sample(order[lo: lo + self.batch_size])

    def batches_per_epoch(self) -> int:
        return math.ceil(self.seed_pool.shape[0] / self.batch_size)

    def iter_groups(self, num_ranks: int, rank: int
                    ) -> Iterator[tuple[MiniBatch | None, MiniBatch | None]]:
        """One epoch of the same batch stream as __iter__, in groups of
        num_ranks consecutive batches (data-parallel super-steps): per group
        (batch rank of the group, or None past the epoch's last batch; and,
        only then, the group's first batch, which pads it). The python
        engine draws every batch (its neighbour draws share the stream's
        generator); the native engine samples only those, since its
        per-batch seed comes from the batch counter."""
        pool = self.seed_pool
        order = pool[self.rng.permutation(pool.shape[0])]
        nb = self.batches_per_epoch()
        bs = self.batch_size
        base = self._batch_counter
        for g0 in range(0, nb, num_ranks):
            idx = g0 + rank
            if self.engine == "python":
                group = [self.sample(order[i * bs:(i + 1) * bs])
                         for i in range(g0, min(g0 + num_ranks, nb))]
                yield ((group[rank], None) if idx < nb
                       else (None, group[0]))
                continue
            i = idx if idx < nb else g0
            self._batch_counter = base + i  # sample() adds one, as in order
            b = self.sample(order[i * bs:(i + 1) * bs])
            yield (b, None) if idx < nb else (None, b)
        if self.engine == "native":
            self._batch_counter = base + nb

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        """The batch of `seeds`: the engine's draw under the span
        sample.draw, then its tiles under sample.tiles."""
        # both engines map labels positionally onto the first len(seeds)
        # local nodes; a duplicate seed would collapse in the node map
        if np.unique(np.asarray(seeds)).shape[0] != len(seeds):
            raise ValueError("sample(seeds) requires unique seed node ids")
        with span("sample.draw"):
            b = (self._sample_native(seeds) if self.engine == "native"
                 else self._sample_python(seeds))
        if not self.emit_tiles:
            return b
        with span("sample.tiles"):
            return dataclasses.replace(b, tiles=self._tiles(b))

    def _tiles(self, b: MiniBatch):
        """Batch b's tiles of the kind emit_tiles names."""
        if self.emit_tiles == "sell":
            return self._sell_tiles(b)
        from gatv2_tpu_torch.ops.pallas_attention import (
            edge_tiles_from_native,
            prepare_edge_tiles,
        )

        if self.engine == "native":
            from gatv2_tpu_torch.utils import native_loader

            raw = native_loader.emit_tiles(
                b.src, b.dst, b.num_edges, self.max_nodes, 128,
                self._tile_budget)
            return edge_tiles_from_native(raw, self.max_nodes, 128,
                                          self._tile_budget)
        real = b.dst[: b.num_edges]
        row_ptr = np.zeros(self.max_nodes + 1, np.int64)
        np.cumsum(np.bincount(real, minlength=self.max_nodes),
                  out=row_ptr[1:])
        return prepare_edge_tiles(
            row_ptr, b.src[: b.num_edges], self.max_nodes, tile_e=128,
            fixed_edge_tiles=self._tile_budget)

    def _sell_tiles(self, b: MiniBatch):
        """Batch b's SellTiles in the stream's fixed geometry."""
        from gatv2_tpu_torch.ops.sell_attention import (
            DEFAULT_SPLIT_CAP,
            prepare_minibatch_sell_tiles,
            sell_tiles_from_native,
        )

        if self.engine == "native":
            from gatv2_tpu_torch.utils import native_loader

            raw = native_loader.emit_sell_tiles(
                b.src, b.dst, b.num_edges, self.max_nodes, DEFAULT_SPLIT_CAP,
                self._sell_fixed)
            return sell_tiles_from_native(raw, self.max_nodes,
                                          self._sell_fixed)
        return prepare_minibatch_sell_tiles(
            b.src, b.dst, b.num_edges, self.max_nodes, self._sell_fixed)

    def _sample_native(self, seeds: np.ndarray) -> MiniBatch:
        from gatv2_tpu_torch.utils import native_loader

        g = self.graph
        self._batch_counter += 1
        nodes, src, dst, num_nodes, num_edges = native_loader.sample_batch(
            self._row_ptr64, g.col_idx, np.asarray(seeds, np.int32),
            np.asarray(self.fanouts, np.int32), self.max_nodes,
            self.max_edges, rng_seed=(self.seed << 20) + self._batch_counter,
        )
        features = None
        if self.gather_features:
            features = native_loader.gather_rows(
                g.features, nodes[:num_nodes], self.max_nodes)
        node_ids = np.zeros(self.max_nodes, np.int32)
        node_ids[:num_nodes] = nodes[:num_nodes]
        labels = np.full(self.max_nodes, -1, np.int32)
        labels[: len(seeds)] = g.labels[seeds]
        return MiniBatch(
            features=features, src=src, dst=dst, labels=labels,
            num_seeds=len(seeds), num_nodes=num_nodes, num_edges=num_edges,
            node_ids=node_ids,
        )

    def _sample_python(self, seeds: np.ndarray) -> MiniBatch:
        g = self.graph
        row_ptr, col_idx = g.row_ptr, g.col_idx

        local_of = {int(s): i for i, s in enumerate(seeds)}
        nodes = list(int(s) for s in seeds)
        edges_src: list[int] = []
        edges_dst: list[int] = []

        frontier = list(nodes)
        for fanout in self.fanouts:
            next_frontier = []
            for v in frontier:
                lo_e, hi_e = row_ptr[v], row_ptr[v + 1]
                deg = hi_e - lo_e
                if deg == 0:
                    continue
                if deg <= fanout:
                    picked = col_idx[lo_e:hi_e]
                else:
                    idx = self.rng.choice(deg, size=fanout, replace=False)
                    picked = col_idx[lo_e + idx]
                for u in picked:
                    u = int(u)
                    if u not in local_of:
                        if len(nodes) >= self.max_nodes:
                            continue  # static budget exhausted (rare)
                        local_of[u] = len(nodes)
                        nodes.append(u)
                        next_frontier.append(u)
                    if len(edges_src) >= self.max_edges:
                        continue  # edge budget exhausted (probe margin):
                        #           truncates neighbours, never seeds, as
                        #           native/sampler.cpp does
                    edges_src.append(local_of[u])
                    edges_dst.append(local_of[v])
            frontier = next_frontier

        nodes_arr = np.asarray(nodes, np.int64)
        num_nodes = len(nodes)
        num_edges = len(edges_src)

        features = None
        if self.gather_features:
            features = np.zeros((self.max_nodes, g.feature_dim), np.float32)
            features[:num_nodes] = g.features[nodes_arr]
        node_ids = np.zeros(self.max_nodes, np.int32)
        node_ids[:num_nodes] = nodes_arr
        labels = np.full(self.max_nodes, -1, np.int32)
        labels[: len(seeds)] = g.labels[seeds]

        src = np.zeros(self.max_edges, np.int32)
        dst = np.full(self.max_edges, self.max_nodes, np.int32)
        if num_edges:
            s = np.asarray(edges_src, np.int32)
            d = np.asarray(edges_dst, np.int32)
            order = np.argsort(d, kind="stable")
            src[:num_edges] = s[order]
            dst[:num_edges] = d[order]

        return MiniBatch(
            features=features, src=src, dst=dst, labels=labels,
            num_seeds=len(seeds), num_nodes=num_nodes, num_edges=num_edges,
            node_ids=node_ids,
        )


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator on a background thread with a bounded queue, so host
    sampling overlaps the device step. If the consumer abandons the
    generator (an exception in the step, an early break), a stop flag
    releases the worker instead of leaving it blocked on the full queue;
    an exception in the worker is raised on the consumer's side."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
