"""Host-side graph partitioning for multi-GPU training (port of
gatv2_tpu/parallel/partition.py). numpy only.

Strategy: edge partitioning by destination-node blocks. Nodes are split
into `num_shards` contiguous blocks (edge- or node-balanced), each padded
to a common `nodes_per_shard` with isolated dummy nodes (label -1); every
edge lives on the shard that owns its destination, so the segment softmax
and aggregation are local to the shard. Only the source-side projections
cross shards, by an all_gather or a boundary halo exchange per layer
(parallel/sharded.py).

Per-shard layouts (edge tiles, SELL tiles) are built for every shard and
padded to one common shape with the JAX package's padding sentinels
(`_stack_tiles`), so shard r's layout here is byte-equal to slice r of the
JAX package's stacked layout. A rank moves only its own shard's layout to
its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gatv2_tpu_torch.data.graph import Graph


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-shard arrays laid end to end (shard s owns rows
    [s * nodes_per_shard, (s+1) * nodes_per_shard) of the node arrays and
    [s * edges_per_shard, (s+1) * edges_per_shard) of the edge arrays).

    Nodes live in contiguous global-id blocks (block s = global ids
    [node_bounds[s], node_bounds[s+1])). The padded SLOT id of global node
    g in block s is `s * nodes_per_shard + (g - node_bounds[s])`; `src` is
    stored in slot ids, so it indexes the all_gather's output directly.

    features  [S * nodes_per_shard, F]   (block-scattered, 0 on padding)
    labels    [S * nodes_per_shard]      (-1 on padding slots)
    src       [S * edges_per_shard]      source SLOT ids
    dst_local [S * edges_per_shard]      dst id RELATIVE to its shard block
                                         (= nodes_per_shard on padding edges)
    """

    features: np.ndarray
    labels: np.ndarray
    src: np.ndarray
    dst_local: np.ndarray
    num_shards: int
    nodes_per_shard: int
    edges_per_shard: int
    num_real_nodes: int
    num_real_edges: int
    node_bounds: np.ndarray  # [S+1] global-id block boundaries
    edge_counts: np.ndarray  # [S] real (pre-padding) edges per shard

    @property
    def padded_num_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    def shard_rows(self, s: int) -> slice:
        """Shard s's rows of the node arrays."""
        return slice(s * self.nodes_per_shard, (s + 1) * self.nodes_per_shard)

    def shard_edges(self, s: int) -> slice:
        """Shard s's entries of the edge arrays."""
        return slice(s * self.edges_per_shard, (s + 1) * self.edges_per_shard)

    def slot_of(self, global_ids: np.ndarray) -> np.ndarray:
        """Global node ids -> padded slot ids."""
        g = np.asarray(global_ids, np.int64)
        s = np.searchsorted(self.node_bounds, g, side="right") - 1
        return (s * self.nodes_per_shard + g - self.node_bounds[s]).astype(
            np.int64)

    def scatter_nodes(self, values: np.ndarray, fill) -> np.ndarray:
        """Re-lay a [N, ...] global-node-order array into partition (slot)
        order, with `fill` on padding slots (split masks, labels)."""
        values = np.asarray(values)
        out = np.full((self.padded_num_nodes,) + values.shape[1:], fill,
                      values.dtype)
        out[self.slot_of(np.arange(self.num_real_nodes))] = values
        return out

    def balance_report(self) -> str:
        c = self.edge_counts
        lo, hi = (int(c.min()), int(c.max())) if c.size else (0, 0)
        waste = 1.0 - c.sum() / max(self.num_shards * self.edges_per_shard, 1)
        blocks = np.diff(self.node_bounds)
        return (
            f"edges/shard min={lo} max={hi} (ratio "
            f"{hi / max(lo, 1):.2f}), padded to {self.edges_per_shard} "
            f"({waste * 100:.1f}% padding); nodes/shard "
            f"min={int(blocks.min()) if blocks.size else 0} "
            f"max={int(blocks.max()) if blocks.size else 0} "
            f"(padded to {self.nodes_per_shard})"
        )


def partition_graph(
    graph: Graph, num_shards: int, *, edge_multiple: int = 128,
    node_multiple: int = 8, balance: str = "edges",
) -> PartitionedGraph:
    """Partition by contiguous dst blocks.

    balance='edges' (default): block boundaries by cumulative edge count,
    so every shard owns ~E/S edges even on power-law graphs, with each
    block capped at twice the even node share (the padded node buffers
    are the largest block's size). balance='nodes': equal node blocks."""
    n, f = graph.num_nodes, graph.feature_dim
    if balance not in ("edges", "nodes"):
        raise ValueError(f"balance must be 'edges' or 'nodes', got {balance!r}")

    row_ptr = graph.row_ptr.astype(np.int64)
    e_total = graph.num_edges
    if balance == "edges" and e_total > 0:
        targets = (np.arange(1, num_shards, dtype=np.int64) * e_total
                   ) // num_shards
        inner = np.searchsorted(row_ptr, targets, side="left")
        node_bounds = np.concatenate(([0], inner, [n])).astype(np.int64)
        node_bounds = np.maximum.accumulate(node_bounds)  # monotone guard
        # cap every block at 2x the even share: clamp b_s <= s*cap, then a
        # backward pass b_s = max(b_s, b_{s+1} - cap)
        cap = min(n, 2 * (-(-n // num_shards)))
        s_idx = np.arange(num_shards + 1, dtype=np.int64)
        node_bounds = np.minimum(node_bounds, s_idx * cap)
        for s in range(num_shards - 1, 0, -1):
            node_bounds[s] = max(node_bounds[s], node_bounds[s + 1] - cap)
    else:
        per = -(-n // num_shards)
        node_bounds = np.minimum(
            np.arange(num_shards + 1, dtype=np.int64) * per, n)

    block_sizes = np.diff(node_bounds)
    nodes_per_shard = int(block_sizes.max()) if num_shards else 0
    nodes_per_shard = max(
        node_multiple, -(-nodes_per_shard // node_multiple) * node_multiple)
    n_pad = num_shards * nodes_per_shard

    features = np.zeros((n_pad, f), np.float32)
    labels = np.full(n_pad, -1, np.int32)
    for s in range(num_shards):
        lo, hi = node_bounds[s], node_bounds[s + 1]
        o = s * nodes_per_shard
        features[o: o + (hi - lo)] = graph.features[lo:hi]
        labels[o: o + (hi - lo)] = graph.labels[lo:hi]

    src, dst = graph.src, graph.dst  # dst sorted ascending
    ebounds = row_ptr[node_bounds]
    counts = np.diff(ebounds)
    edges_per_shard = int(counts.max()) if counts.size else 0
    edges_per_shard = max(
        edge_multiple, -(-edges_per_shard // edge_multiple) * edge_multiple)

    src_block = np.searchsorted(node_bounds, src, side="right") - 1
    src_slot = (src_block.astype(np.int64) * nodes_per_shard
                + src.astype(np.int64) - node_bounds[src_block]
                ).astype(np.int32)

    src_p = np.zeros((num_shards, edges_per_shard), np.int32)
    dst_l = np.full((num_shards, edges_per_shard), nodes_per_shard, np.int32)
    for s in range(num_shards):
        lo, hi = ebounds[s], ebounds[s + 1]
        c = hi - lo
        src_p[s, :c] = src_slot[lo:hi]
        dst_l[s, :c] = dst[lo:hi] - node_bounds[s]

    return PartitionedGraph(
        features=features, labels=labels, src=src_p.reshape(-1),
        dst_local=dst_l.reshape(-1), num_shards=num_shards,
        nodes_per_shard=nodes_per_shard, edges_per_shard=edges_per_shard,
        num_real_nodes=n, num_real_edges=graph.num_edges,
        node_bounds=node_bounds, edge_counts=counts.astype(np.int64),
    )


def _shard_csr(dst_shard, src_shard, nps):
    """One shard's padded edge slice -> its real edges' local CSR:
    (row_ptr [nps+1], src_s); dst stays sorted."""
    real = dst_shard < nps
    dst_s = dst_shard[real]
    src_s = src_shard[real]
    counts = np.bincount(dst_s, minlength=nps)
    row_ptr = np.zeros(nps + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, src_s


def _src_space(pg: PartitionedGraph, halo_plan):
    """(source id space size, [S, E_s] source ids) of the per-shard edge
    sets: [local | halo rows] with a halo plan, the padded global space
    otherwise."""
    if halo_plan is not None:
        return halo_plan.space_size, halo_plan.src_halo
    return pg.padded_num_nodes, pg.src.reshape(pg.num_shards, -1)


def prepare_partitioned_tiles(
    pg: PartitionedGraph, tile_e: int | None = 128, num_chunks: int = 1,
    halo_plan: "HaloPlan | None" = None, max_hd: int | None = None,
) -> list:
    """Per-shard edge tilings (ops.pallas_attention.EdgeTiles), one per
    shard, in one common shape. Each shard's edge set is bipartite: its
    destinations are the shard's local nodes, its sources the ids of the
    gather space (the all_gather's output, or [local | halo rows])."""
    from gatv2_tpu_torch.ops.pallas_attention import prepare_edge_tiles

    nps = pg.nodes_per_shard
    n_glob, src_all = _src_space(pg, halo_plan)
    dst_all = pg.dst_local.reshape(pg.num_shards, -1)
    per_shard = []
    for s in range(pg.num_shards):
        row_ptr, src_s = _shard_csr(dst_all[s], src_all[s], nps)
        per_shard.append(prepare_edge_tiles(
            row_ptr, src_s, nps, tile_e=tile_e, num_chunks=num_chunks,
            num_src_nodes=n_glob, max_hd=max_hd))
        if tile_e is None:
            # every shard must share shard 0's auto-selected tile size
            tile_e = per_shard[0].tile_e
    return _stack_tiles(per_shard)


def _build_sell_shards(src_all, dst_all, nps, n_glob, split_cap="default",
                       num_chunks=1):
    """Per-shard bipartite SELL layouts with both sides' column and
    row-slice counts forced to the cross-shard max (fixed mode), so every
    shard's arrays have one shape.

    split_cap: "default" uses the library default (hub rows split into
    virtual rows); None disables splitting (the merge path needs it)."""
    from gatv2_tpu_torch.ops.sell_attention import (
        DEFAULT_SPLIT_CAP,
        TILE_N,
        _side_geometry,
        prepare_sell_tiles,
    )

    cap = DEFAULT_SPLIT_CAP if split_cap == "default" else split_cap
    shards = []
    cols_d = cols_s = tiles_d = tiles_s = 1
    max_deg_d = max_deg_s = 0
    for s in range(len(dst_all)):
        row_ptr, src_s = _shard_csr(dst_all[s], src_all[s], nps)
        shards.append((row_ptr, src_s))
        deg_d = np.diff(row_ptr)
        deg_s = np.bincount(src_s, minlength=n_glob)
        # geometry under the actual chunk count, so the cross-shard max is
        # a valid fixed tile count for every shard's chunk grid
        t_d, _, e_ell, _ = _side_geometry(deg_d, num_chunks, split_cap=cap)
        t_s, _, e2_ell, _ = _side_geometry(deg_s, num_chunks, split_cap=cap)
        cols_d = max(cols_d, e_ell // TILE_N)
        cols_s = max(cols_s, e2_ell // TILE_N)
        tiles_d = max(tiles_d, t_d)
        tiles_s = max(tiles_s, t_s)
        max_deg_d = max(max_deg_d, int(deg_d.max(initial=0)))
        max_deg_s = max(max_deg_s, int(deg_s.max(initial=0)))

    if cap is None:
        hub = max(max_deg_d, max_deg_s)
        if hub > 4 * DEFAULT_SPLIT_CAP:
            raise ValueError(
                f"split_cap=None (the merged-softmax overlap path) on a "
                f"hub-heavy partition: max degree {hub} would pad its "
                f"whole SELL slice to the hub degree (10-49x measured on "
                f"Zipf graphs). Use the single-pass sharded SELL layer "
                f"(no --overlap), which splits hub rows."
            )

    # the split decision is uniform across shards: split whenever any
    # shard would
    any_split_d = cap is not None and max_deg_d > cap
    any_split_s = cap is not None and max_deg_s > cap

    if len(shards) == 1:
        # one shard: the tight layout, without fixed-mode padding
        row_ptr, src_s = shards[0]
        return _stack_tiles([prepare_sell_tiles(
            row_ptr, src_s, nps, num_src_nodes=n_glob,
            num_chunks=num_chunks, split_cap=cap)])
    return _stack_tiles([
        prepare_sell_tiles(
            row_ptr, src_s, nps, num_src_nodes=n_glob,
            fixed=(cols_d, cols_s, tiles_d, tiles_s), split_cap=cap,
            num_chunks=num_chunks, force_split=(any_split_d, any_split_s))
        for row_ptr, src_s in shards
    ])


def prepare_partitioned_sell_tiles(
    pg: PartitionedGraph, halo_plan: "HaloPlan | None" = None,
    num_chunks: int | None = 1, heads=None, out_dims=None,
    budget_bytes=None,
) -> list:
    """Per-shard SELL layouts (ops.sell_attention.SellTiles), one per shard
    in one common shape: the impl='sell' counterpart of
    prepare_partitioned_tiles.

    num_chunks=None picks the chunk count from the model widths
    (heads/out_dims) so each shard's edge-space temporaries fit
    budget_bytes (default: the CPU policy of default_chunk_budget); the
    worst shard decides, since all shards share one chunk grid."""
    nps = pg.nodes_per_shard
    n_glob, src_all = _src_space(pg, halo_plan)
    dst_all = pg.dst_local.reshape(pg.num_shards, -1)
    if num_chunks is None:
        from gatv2_tpu_torch.ops.sell_attention import (
            default_chunk_budget,
            suggest_chunks_for_graph,
        )

        num_chunks = 1
        if heads is not None:
            for s in range(pg.num_shards):
                row_ptr, src_s = _shard_csr(dst_all[s], src_all[s], nps)
                num_chunks = max(num_chunks, suggest_chunks_for_graph(
                    row_ptr, src_s, n_glob, heads, out_dims,
                    budget_bytes=(budget_bytes if budget_bytes is not None
                                  else default_chunk_budget(
                                      "cpu", int(row_ptr[-1]))),
                ))
    return _build_sell_shards(src_all, dst_all, nps, n_glob,
                              num_chunks=num_chunks)


def prepare_overlap_sell_tiles(pg: PartitionedGraph, plan: "HaloPlan",
                               split: "OverlapSplit") -> tuple[list, list]:
    """Per-shard SELL layout pairs for the overlap layer
    (ops.sell_attention.sell_attention_merge): the LOCAL pass's source
    space is the shard's own nodes, the HALO pass's the halo table. Both
    unsplit: the merged softmax merges stats across passes, not across a
    node's virtual rows. Returns (local tiles per shard, halo tiles per
    shard)."""
    nps = pg.nodes_per_shard
    return (
        _build_sell_shards(split.local_src, split.local_dst, nps, nps,
                           split_cap=None),
        _build_sell_shards(split.halo_src, split.halo_dst, nps,
                           plan.halo_size, split_cap=None),
    )


def _array_fields(t):
    return [f.name for f in dataclasses.fields(t)
            if isinstance(getattr(t, f.name), np.ndarray)]


def _aux(t):
    """The non-array fields of a layout (nested sides included): what the
    JAX package keeps as a pytree's static aux data."""
    out = []
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if dataclasses.is_dataclass(v):
            out.append((f.name, _aux(v)))
        elif not isinstance(v, np.ndarray):
            out.append((f.name, v))
    return out


def _pad_to(arrs):
    """Zero-pad each array to the max shape across them."""
    shape = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
    return [np.pad(a, [(0, m - s) for s, m in zip(a.shape, shape)])
            for a in arrs]


def _stack_tiles(per_shard: list) -> list:
    """Pad every array of every shard's layout to the max shape across
    shards (the tail is never read: offsets cover the real tiles only),
    then re-fill the added regions of the gather-id arrays with each
    side's padding sentinel (_harden_pad_ids). The non-array fields must
    agree across shards (a mismatch would make a kernel stream wrong edge
    ranges). Returns the padded layouts, one per shard."""
    aux0 = _aux(per_shard[0])
    for s, t in enumerate(per_shard[1:], 1):
        if _aux(t) != aux0:
            raise ValueError(
                f"shard {s}'s tile aux data (tile_e/chunking/node counts) "
                f"differs from shard 0's — stacked tiles must be uniform")

    def pad_obj(objs):
        repl = {}
        for f in dataclasses.fields(objs[0]):
            v = getattr(objs[0], f.name)
            if dataclasses.is_dataclass(v):
                subs = pad_obj([getattr(o, f.name) for o in objs])
                for o_i, sub in enumerate(subs):
                    repl.setdefault(o_i, {})[f.name] = sub
            elif isinstance(v, np.ndarray):
                for o_i, a in enumerate(_pad_to([getattr(o, f.name)
                                                 for o in objs])):
                    repl.setdefault(o_i, {})[f.name] = a
        return [dataclasses.replace(o, **repl.get(i, {}))
                for i, o in enumerate(objs)]

    return _harden_pad_ids(pad_obj(per_shard), per_shard)


def _harden_pad_ids(out: list, per_shard: list) -> list:
    """Re-fill the regions the padding across shards ADDED to the gather-id
    arrays with each side's pad sentinel instead of zeros: a zero aliases
    row 0, so a kernel that read one slot too many would accumulate into a
    real row; the sentinel (the opposite side's padded node count) names
    none."""

    def refill(padded, orig, sentinel):
        if orig.shape == padded.shape:
            return padded
        a = padded.copy()
        mask = np.ones(a.shape, bool)
        mask[tuple(slice(0, d) for d in orig.shape)] = False
        a[mask] = sentinel
        return a

    first = per_shard[0]
    result = []
    for t, orig in zip(out, per_shard):
        if getattr(first, "dst_side", None) is not None:
            # EdgeTiles: ids_grp pads match no row of the chunk grid
            from gatv2_tpu_torch.ops.pallas_attention import TILE_N

            s_tiles = (t.src_tiles_per_chunk if t.src_tiles_per_chunk >= 0
                       else t.tiles_per_chunk)
            t = dataclasses.replace(
                t,
                dst_side=dataclasses.replace(t.dst_side, ids_grp=refill(
                    t.dst_side.ids_grp, orig.dst_side.ids_grp,
                    t.tiles_per_chunk * TILE_N)),
                src_side=dataclasses.replace(t.src_side, ids_grp=refill(
                    t.src_side.ids_grp, orig.src_side.ids_grp,
                    s_tiles * TILE_N)),
            )
        elif hasattr(first, "srcs"):
            # SellTiles: gather ids address the OPPOSITE side's node grid
            d_pad, s_pad = t.padded_num_nodes, t.padded_src_nodes
            t = dataclasses.replace(
                t,
                dst=dataclasses.replace(
                    t.dst,
                    gather_ids=refill(t.dst.gather_ids, orig.dst.gather_ids,
                                      s_pad),
                    ids_grp=refill(t.dst.ids_grp, orig.dst.ids_grp, s_pad)),
                srcs=dataclasses.replace(
                    t.srcs,
                    gather_ids=refill(t.srcs.gather_ids,
                                      orig.srcs.gather_ids, d_pad),
                    ids_grp=refill(t.srcs.ids_grp, orig.srcs.ids_grp,
                                   d_pad)),
            )
        result.append(t)
    return result


def prepare_overlap_tiles(pg: PartitionedGraph, plan: "HaloPlan",
                          split: "OverlapSplit", tile_e: int = 128
                          ) -> tuple[list, list]:
    """Per-shard edge-tile pairs for the overlap layer
    (ops.pallas_attention.edge_attention_pallas_merge): the LOCAL pass's
    source space is the shard's own nodes, the HALO pass's the halo table.
    Returns (local tiles per shard, halo tiles per shard)."""
    from gatv2_tpu_torch.ops.pallas_attention import prepare_edge_tiles

    nps = pg.nodes_per_shard

    def build(src_all, dst_all, n_src):
        per = []
        for s in range(pg.num_shards):
            row_ptr, src_s = _shard_csr(dst_all[s], src_all[s], nps)
            per.append(prepare_edge_tiles(row_ptr, src_s, nps, tile_e=tile_e,
                                          num_src_nodes=n_src))
        return _stack_tiles(per)

    return (build(split.local_src, split.local_dst, nps),
            build(split.halo_src, split.halo_dst, plan.halo_size))


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Boundary-only exchange plan.

    Instead of all_gathering every node's source projection, each shard
    sends only the rows its peers' edges reference. A shard's own rows are
    never exchanged: the sharded layer gathers from the concatenation
    [zs_loc (nps rows) | halo table (S*M exchanged rows)].

      send_ids [S, S, M]  send_ids[i, j] = i-local node ids shard j needs
                          from shard i (0-padded to the common
                          off-diagonal max M; the i == j block is unused);
      src_halo [S, E_s]   each edge's source remapped to its gather slot:
                          a local source -> its zs_loc row (< nps); a remote
                          source from shard i at send position k ->
                          nps + i*M + k.
    """

    send_ids: np.ndarray  # [S, S, M] int32
    src_halo: np.ndarray  # [S, edges_per_shard] int32 (gather-slot ids)
    halo_size: int  # S * M (exchanged rows per shard)
    m_per_pair: int
    nodes_per_shard: int  # local rows preceding the halo table

    @property
    def space_size(self) -> int:
        """Rows of the per-shard gather space: [zs_loc | halo table]."""
        return self.nodes_per_shard + self.halo_size


def halo_exchange_plan(pg: PartitionedGraph, *,
                       pad_multiple: int = 8) -> HaloPlan:
    s_count, nps = pg.num_shards, pg.nodes_per_shard
    src = pg.src.reshape(s_count, -1)
    dst = pg.dst_local.reshape(s_count, -1)

    # per (owner i, consumer j != i): sorted unique i-local ids j references
    needed: list[list[np.ndarray]] = []
    m = 1
    for j in range(s_count):
        real = dst[j] < nps
        uniq = np.unique(src[j][real])
        owners = uniq // nps
        per_owner = []
        for i in range(s_count):
            if i == j:
                per_owner.append(np.empty(0, np.int64))  # own rows: local
                continue
            ids = uniq[owners == i] - i * nps
            per_owner.append(ids.astype(np.int64))
            m = max(m, len(ids))
        needed.append(per_owner)
    m = -(-m // pad_multiple) * pad_multiple

    send_ids = np.zeros((s_count, s_count, m), np.int32)
    for j in range(s_count):
        for i in range(s_count):
            ids = needed[j][i]
            send_ids[i, j, : len(ids)] = ids

    src_halo = np.zeros((s_count, src.shape[1]), np.int32)
    for j in range(s_count):
        real = dst[j] < nps
        g_ids = src[j][real].astype(np.int64)
        owners = g_ids // nps
        local = g_ids - owners * nps
        slots = np.empty(g_ids.shape[0], np.int64)
        for i in range(s_count):
            sel = owners == i
            if not sel.any():
                continue
            if i == j:
                slots[sel] = local[sel]
                continue
            k = np.searchsorted(needed[j][i], local[sel])
            slots[sel] = nps + i * m + k
        src_halo[j, real] = slots.astype(np.int32)
    return HaloPlan(send_ids=send_ids, src_halo=src_halo,
                    halo_size=s_count * m, m_per_pair=m, nodes_per_shard=nps)


@dataclasses.dataclass(frozen=True)
class OverlapSplit:
    """Edge split for halo/compute overlap. Each shard's edges are divided
    by source ownership: LOCAL edges (source owned by the shard) read
    zs_loc directly and can run while the halo exchange is in flight;
    HALO edges read the exchanged halo-table rows. The destination softmax
    spans both sets, so the layer merges per-set online-softmax stats.

    local_src [S, E_l]  source row in zs_loc (pad 0)
    local_dst [S, E_l]  local dst (pad nodes_per_shard)
    halo_src  [S, E_h]  slot in the halo table (pad 0)
    halo_dst  [S, E_h]  local dst (pad nodes_per_shard)
    """

    local_src: np.ndarray
    local_dst: np.ndarray
    halo_src: np.ndarray
    halo_dst: np.ndarray


def overlap_split_plan(pg: PartitionedGraph, plan: HaloPlan, *,
                       pad_multiple: int = 8) -> OverlapSplit:
    s_count, nps = pg.num_shards, pg.nodes_per_shard
    src = pg.src.reshape(s_count, -1)  # slot ids
    dst = pg.dst_local.reshape(s_count, -1)
    halo = plan.src_halo

    locals_, halos = [], []
    for j in range(s_count):
        real = dst[j] < nps
        own = (src[j] // nps) == j
        li = real & own
        hi = real & ~own
        locals_.append((src[j][li] % nps, dst[j][li]))
        # src_halo numbers remote rows nps + slot; the halo pass gathers
        # from the halo table alone
        halos.append((halo[j][hi] - nps, dst[j][hi]))

    def pad_stack(pairs):
        m = max((p[0].shape[0] for p in pairs), default=0)
        m = max(pad_multiple, -(-m // pad_multiple) * pad_multiple)
        s_arr = np.zeros((s_count, m), np.int32)
        d_arr = np.full((s_count, m), nps, np.int32)
        for j, (s_, d_) in enumerate(pairs):
            s_arr[j, : s_.shape[0]] = s_
            d_arr[j, : d_.shape[0]] = d_
        return s_arr, d_arr

    ls, ld = pad_stack(locals_)
    hs, hd = pad_stack(halos)
    return OverlapSplit(local_src=ls, local_dst=ld, halo_src=hs, halo_dst=hd)
