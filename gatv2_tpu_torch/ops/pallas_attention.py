"""Streamed-operand GATv2 attention: the edge-tile layout and the op (port
of gatv2_tpu/ops/pallas_attention.py).

Layout (numpy, built on the host, byte-equal to the JAX package's): the
destination nodes are cut into tiles of 128; each tile owns a contiguous
run of its destination-sorted edges, padded to a multiple of `tile_e`
(padding edges carry dst = the node count and src = 0). A src-sorted
mirror of the same edges (the CSC view) serves the backward's d_zs, with
`gather_perm` mapping each mirror entry to its edge's dst-sorted slot.
`num_chunks=G` groups the node tiles into G chunks with chunk-relative ids
(`_TileSide`); minibatch batches use a fixed edge-tile budget so every
batch's layout has the same shapes (`fixed_edge_tiles`,
`edge_tiles_from_native`).

The op is the edge-tile family (`EDGE_TILES`) of the fused op of
ops/fused.py. It runs K5 (ops/pallas_fwd.py) once per chunk and head group
in the forward. On an unchunked layout its backward runs K6
(ops/pallas_bwd_dst.py) over the destination rows, which writes one packet
per edge, and K7 (ops/pallas_segsum.py), which sums the packets per source
row. On a chunked one it runs K6 once per destination chunk without
packets, then K8 (ops/pallas_bwd_src.py) once per source chunk, which
rebuilds each edge's packet from the destination side's node-order tables:
no edge-space buffer is held.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gatv2_tpu_torch.ops import fused
from gatv2_tpu_torch.ops.pallas_bwd_dst import pallas_bwd_dst
from gatv2_tpu_torch.ops.pallas_bwd_src import pallas_bwd_src
from gatv2_tpu_torch.ops.pallas_fwd import MAX_HD, STATS_L, TILE_N, pallas_fwd
from gatv2_tpu_torch.ops.pallas_segsum import pallas_segsum
from gatv2_tpu_torch.ops.segment import SOFTMAX_EPS
from gatv2_tpu_torch.ops.sell_attention import default_chunk_budget

TILE_E = 128  # default edges per edge tile (see prepare_edge_tiles)

_FLAT_ARRAYS = ("src", "dst", "tile_offsets", "src_sorted_ids",
                "gather_perm", "src_tile_offsets")


@dataclasses.dataclass(frozen=True)
class _TileSide:
    """One tiling direction (dst-sorted CSR view or src-sorted CSC view),
    grouped into chunks of node tiles. Leaves are int32 numpy arrays on the
    host, or tensors after EdgeTiles.to(device).

    ids_grp      [G, chunk_et * te] — the per-edge node id this side
                 segments by (dst ids for the CSR side, src ids for the CSC
                 side), RELATIVE to the chunk's node base; tiles_per_chunk
                 * 128 on padding slots (matches no row).
    other_grp    [G, chunk_et * te] — the opposite endpoint's GLOBAL node
                 id; 0 on padding.
    rel_offsets  [G, tiles_per_chunk + 1] — per-chunk edge-tile offsets,
                 relative to the chunk's base.
    """

    ids_grp: np.ndarray
    other_grp: np.ndarray
    rel_offsets: np.ndarray


@dataclasses.dataclass(frozen=True)
class EdgeTiles:
    """Per-node-tile-aligned edge layout (host-precomputed). The flat views
    of the dst-sorted layout and its src-sorted mirror back the unchunked
    backward (K7 reads src_sorted_ids, gather_perm and src_tile_offsets);
    they are dummies [1] when num_chunks > 1."""

    src: np.ndarray  # [E_pad] (dst-sorted layout)
    dst: np.ndarray  # [E_pad] (num_nodes on padding)
    tile_offsets: np.ndarray  # [T+1], in units of edge tiles
    num_nodes: int
    num_node_tiles: int
    src_sorted_ids: np.ndarray  # [E2_pad] (padded src count on padding)
    gather_perm: np.ndarray  # [E2_pad] (position in the dst layout)
    src_tile_offsets: np.ndarray  # [T+1], edge-tile units
    tile_e: int = TILE_E
    num_chunks: int = 1
    tiles_per_chunk: int = 0  # dst node tiles per chunk
    dst_side: _TileSide | None = None
    src_side: _TileSide | None = None
    # bipartite edge sets: src space != dst space; -1 -> monopartite
    num_src_nodes: int = -1
    src_tiles_per_chunk: int = -1

    @property
    def padded_num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def padded_num_nodes(self) -> int:
        """Padded DST-space node count."""
        return self.num_chunks * self.tiles_per_chunk * TILE_N

    @property
    def src_num_nodes(self) -> int:
        return self.num_nodes if self.num_src_nodes < 0 else self.num_src_nodes

    @property
    def padded_src_nodes(self) -> int:
        t = (self.tiles_per_chunk if self.src_tiles_per_chunk < 0
             else self.src_tiles_per_chunk)
        return self.num_chunks * t * TILE_N

    def to(self, device: str | torch.device) -> "EdgeTiles":
        """The same layout with every leaf an int32 tensor on `device` (a
        leaf already there is not copied). numpy leaves that view one
        buffer (a native batch's grouped views are its flat arrays) cross
        to the device once."""
        moved: dict[tuple[int, int], torch.Tensor] = {}

        def move(x):
            if not (isinstance(x, np.ndarray) and x.flags.c_contiguous):
                return torch.as_tensor(x, device=device)
            key = (x.__array_interface__["data"][0], x.nbytes)
            if key not in moved:
                moved[key] = torch.as_tensor(x.reshape(-1), device=device)
            return moved[key].view(x.shape)

        def side(s):
            return _TileSide(move(s.ids_grp), move(s.other_grp),
                             move(s.rel_offsets))

        return dataclasses.replace(
            self, dst_side=side(self.dst_side), src_side=side(self.src_side),
            **{f: move(getattr(self, f)) for f in _FLAT_ARRAYS},
        )


def _vmem_cap_tile_e(max_hd: int) -> int:
    """The JAX package's cap on tile_e: the largest te whose
    double-buffered backward scratch fits the TPU core's VMEM budget. Kept
    so the layouts stay byte-equal to the JAX package's."""
    budget = 12 << 20
    cap = budget // (8 * (4 * max_hd + 128))
    return max(TILE_E, (cap // TILE_E) * TILE_E)


def _auto_tile_e(counts_d: np.ndarray, counts_s: np.ndarray,
                 max_hd: int | None = None) -> int:
    """Edges per edge tile, as the JAX package picks it: the largest of
    128, 256 and 512 whose padding overhead stays under 4% (and under the
    VMEM cap when the widest layer's lane count is given)."""
    cap = _vmem_cap_tile_e(max_hd) if max_hd else 512
    base = None
    best = TILE_E
    for te in (128, 256, 512):
        padded = 0
        for counts in (counts_d, counts_s):
            padded += int(np.sum(-(-counts // te))) * te
        if te == 128:
            base = max(padded, 1)
        elif te <= cap and padded <= 1.04 * base:
            best = te
    return best


def _group_side(ids, other, tile_offsets, num_nodes, num_chunks,
                tiles_per_chunk, te, min_chunk_et=None) -> _TileSide:
    """Cut one side's flat layout into chunks of tiles_per_chunk node
    tiles, with chunk-relative segment ids; min_chunk_et forces the width
    (static cross-batch shapes)."""
    t_pad = num_chunks * tiles_per_chunk
    ext = np.concatenate(
        [tile_offsets, np.full(t_pad + 1 - len(tile_offsets), tile_offsets[-1])]
    ).astype(np.int64)
    chunk_et = min_chunk_et or 1
    for g in range(num_chunks):
        chunk_et = max(chunk_et, int(ext[(g + 1) * tiles_per_chunk]
                                     - ext[g * tiles_per_chunk]))
    pad_id = tiles_per_chunk * TILE_N
    ids_grp = np.full((num_chunks, chunk_et * te), pad_id, np.int32)
    other_grp = np.zeros((num_chunks, chunk_et * te), np.int32)
    rel = np.zeros((num_chunks, tiles_per_chunk + 1), np.int32)
    for g in range(num_chunks):
        lo = int(ext[g * tiles_per_chunk])
        hi = int(ext[(g + 1) * tiles_per_chunk])
        c = (hi - lo) * te
        seg = ids[lo * te: hi * te].astype(np.int64)
        node_base = g * tiles_per_chunk * TILE_N
        ids_grp[g, :c] = np.where(seg < num_nodes, seg - node_base,
                                  pad_id).astype(np.int32)
        other_grp[g, :c] = other[lo * te: hi * te]
        rel[g] = (ext[g * tiles_per_chunk: (g + 1) * tiles_per_chunk + 1]
                  - lo).astype(np.int32)
    return _TileSide(ids_grp=ids_grp, other_grp=other_grp, rel_offsets=rel)


def prepare_edge_tiles(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    num_nodes: int,
    tile_e: int | None = None,
    num_chunks: int = 1,
    num_src_nodes: int | None = None,
    fixed_edge_tiles: int | None = None,
    max_hd: int | None = None,
) -> EdgeTiles:
    """Build the tile-aligned edge layouts from CSR (host side, once per
    graph or batch); every leaf is a numpy array.

    tile_e=None picks the edge-tile size from the degree profile
    (_auto_tile_e, capped by max_hd, the widest layer's lane count).
    num_chunks=G groups the node tiles into G chunks. num_src_nodes:
    bipartite edge sets (col_idx holds global source ids while row_ptr
    covers local destinations); default monopartite. fixed_edge_tiles:
    force both sides' total edge-tile counts to this value (an error if the
    layout needs more), so every batch of a minibatch stream has the same
    shapes."""
    row_ptr = np.asarray(row_ptr, np.int64)
    ns = num_nodes if num_src_nodes is None else num_src_nodes
    num_node_tiles = max(1, -(-num_nodes // TILE_N))
    num_src_tiles = max(1, -(-ns // TILE_N))
    degrees = np.diff(row_ptr)
    dst_all = np.repeat(np.arange(num_nodes, dtype=np.int32), degrees)

    # per-dst-tile edge counts: CSR rows are contiguous, so a tile's count
    # is one row_ptr difference; each tile's fill is one contiguous copy
    tile_row_lo = row_ptr[
        np.minimum(np.arange(num_node_tiles) * TILE_N, num_nodes)]
    tile_row_hi = row_ptr[
        np.minimum((np.arange(num_node_tiles) + 1) * TILE_N, num_nodes)]
    counts = (tile_row_hi - tile_row_lo).astype(np.int64)
    src_counts = np.bincount(np.minimum(col_idx, ns - 1) // TILE_N,
                             minlength=num_src_tiles)
    if tile_e is None:
        tile_e = _auto_tile_e(counts, src_counts, max_hd)
    te = tile_e

    padded = -(-counts // te) * te
    tile_offsets = np.zeros(num_node_tiles + 1, np.int32)
    np.cumsum(padded // te, out=tile_offsets[1:])
    e_pad = max(int(tile_offsets[-1]) * te, te)

    src = np.zeros(e_pad, np.int32)
    dst = np.full(e_pad, num_nodes, np.int32)
    for i in range(num_node_tiles):
        lo = int(tile_row_lo[i])
        c = int(counts[i])
        o = int(tile_offsets[i]) * te
        src[o: o + c] = col_idx[lo: lo + c]
        dst[o: o + c] = dst_all[lo: lo + c]

    # src-sorted mirror: the real edges' positions in the dst layout, stably
    # re-sorted by src node, padded per src tile like the dst layout
    real_pos = np.nonzero(dst < num_nodes)[0].astype(np.int32)
    order = np.argsort(src[real_pos], kind="stable")
    pos_sorted = real_pos[order]
    src_sorted = src[pos_sorted]
    counts2 = np.bincount(src_sorted // TILE_N, minlength=num_src_tiles)
    starts2 = np.concatenate([[0], np.cumsum(counts2)])
    padded2 = -(-counts2 // te) * te
    src_tile_offsets = np.zeros(num_src_tiles + 1, np.int32)
    np.cumsum(padded2 // te, out=src_tile_offsets[1:])
    e2_pad = max(int(src_tile_offsets[-1]) * te, te)
    # padding entries carry the PADDED src count, which no src row has
    ns_pad_id = num_src_tiles * TILE_N
    src_sorted_ids = np.full(e2_pad, ns_pad_id, np.int32)
    gather_perm = np.zeros(e2_pad, np.int32)
    for i in range(num_src_tiles):
        c = int(counts2[i])
        s, o = int(starts2[i]), int(src_tile_offsets[i]) * te
        src_sorted_ids[o: o + c] = src_sorted[s: s + c]
        gather_perm[o: o + c] = pos_sorted[s: s + c]

    if fixed_edge_tiles is not None:
        if num_chunks != 1:
            raise ValueError("fixed_edge_tiles requires num_chunks == 1")
        for name, used in (("dst", int(tile_offsets[-1])),
                           ("src", int(src_tile_offsets[-1]))):
            if used > fixed_edge_tiles:
                raise ValueError(
                    f"fixed_edge_tiles={fixed_edge_tiles} too small for the "
                    f"{name} layout ({used} edge tiles needed)")
        want = fixed_edge_tiles * te

        def widen(arr, fill):
            out = np.full(want, fill, arr.dtype)
            out[: arr.shape[0]] = arr
            return out

        dst = widen(dst, num_nodes)  # extra slots: padding edges
        src = widen(src, 0)
        src_sorted_ids = widen(src_sorted_ids, ns_pad_id)
        gather_perm = widen(gather_perm, 0)
        e2_pad = want

    num_chunks = max(1, min(num_chunks, num_node_tiles))
    tiles_per_chunk = -(-num_node_tiles // num_chunks)
    src_tiles_per_chunk = -(-num_src_tiles // num_chunks)

    dst_side = _group_side(dst, src, tile_offsets, num_nodes, num_chunks,
                           tiles_per_chunk, te, min_chunk_et=fixed_edge_tiles)
    # the CSC side segments by src ids and carries the edges' dst ids
    dst_of_src = np.zeros(e2_pad, np.int32)
    real2 = src_sorted_ids < ns
    dst_of_src[real2] = dst[gather_perm[real2]]
    src_side = _group_side(src_sorted_ids, dst_of_src, src_tile_offsets, ns,
                           num_chunks, src_tiles_per_chunk, te,
                           min_chunk_et=fixed_edge_tiles)

    if num_chunks > 1:
        # chunked layouts use the grouped views only
        src = dst = np.zeros(1, np.int32)
        tile_offsets = src_tile_offsets = np.zeros(1, np.int32)
        src_sorted_ids = gather_perm = np.zeros(1, np.int32)

    return EdgeTiles(
        src=src, dst=dst, tile_offsets=tile_offsets, num_nodes=num_nodes,
        num_node_tiles=num_node_tiles, src_sorted_ids=src_sorted_ids,
        gather_perm=gather_perm, src_tile_offsets=src_tile_offsets,
        tile_e=te, num_chunks=num_chunks, tiles_per_chunk=tiles_per_chunk,
        dst_side=dst_side, src_side=src_side,
        num_src_nodes=-1 if num_src_nodes is None else num_src_nodes,
        src_tiles_per_chunk=(-1 if num_src_nodes is None
                             else src_tiles_per_chunk),
    )


def edge_tiles_from_native(raw: dict, max_nodes: int, te: int,
                           fixed_edge_tiles: int) -> EdgeTiles:
    """Wrap the native emit_tiles output (utils.native_loader.emit_tiles)
    into an EdgeTiles equal to prepare_edge_tiles(..., tile_e=te,
    fixed_edge_tiles=...): only the fixed-budget num_chunks=1 minibatch
    layout, whose grouped views are the flat arrays (node base 0, pad id
    max_nodes). Leaves stay numpy."""
    num_node_tiles = max_nodes // TILE_N
    want = fixed_edge_tiles * te
    if raw["src"].shape[0] != want:
        raise ValueError(
            f"native tile arrays hold {raw['src'].shape[0]} edge slots but "
            f"fixed_edge_tiles={fixed_edge_tiles} x te={te} = {want}")
    dst_side = _TileSide(ids_grp=raw["dst"][None],
                         other_grp=raw["src"][None],
                         rel_offsets=raw["tile_offsets"][None])
    src_side = _TileSide(ids_grp=raw["src_sorted_ids"][None],
                         other_grp=raw["dst_of_src"][None],
                         rel_offsets=raw["src_tile_offsets"][None])
    return EdgeTiles(
        src=raw["src"], dst=raw["dst"], tile_offsets=raw["tile_offsets"],
        num_nodes=max_nodes, num_node_tiles=num_node_tiles,
        src_sorted_ids=raw["src_sorted_ids"],
        gather_perm=raw["gather_perm"],
        src_tile_offsets=raw["src_tile_offsets"], tile_e=te, num_chunks=1,
        tiles_per_chunk=num_node_tiles, dst_side=dst_side, src_side=src_side,
    )


def suggest_num_chunks(num_edges: int, max_hd: int, *,
                       budget_bytes: int = 4 << 30) -> int:
    """Chunk count so edge-space temporaries stay under budget_bytes, by
    the JAX package's live-set model (so both packages chunk a graph
    alike): unchunked, (4*hd + 128) fp32 lanes per edge; chunked, the widest
    per-chunk set is (3*hd + 128) lanes per edge of a chunk."""
    if num_edges * (4 * max_hd + 128) * 4 <= budget_bytes:
        return 1
    need = num_edges * (3 * max_hd + 128) * 4
    return max(2, -(-need // budget_bytes))


def setup_full_graph(graph, heads, out_dims, *, device, labels=None,
                     budget_bytes=None, tile_e=None):
    """One-stop full-graph setup for impl='pallas': builds the edge tiling,
    chunked so the edge-space temporaries fit budget_bytes (default:
    default_chunk_budget(device, graph.num_edges)), and pads features and
    labels (default graph.labels; a split-masked copy in training) to the
    padded node grid once.

    Returns (edge_tiles, features, labels, num_valid), all on the host;
    num_valid is None when no padding row was added. Padding labels are -1
    (ignored by the loss)."""
    e = graph.num_edges
    if budget_bytes is None:
        budget_bytes = default_chunk_budget(device, e)
    max_hd = max(-(-h * d // 128) * 128 for h, d in zip(heads, out_dims))
    # per-launch lane width: layers above STATS_L heads run in head groups
    kernel_hd = max(-(-min(h, STATS_L) * d // 128) * 128
                    for h, d in zip(heads, out_dims))
    et = prepare_edge_tiles(
        graph.row_ptr, graph.col_idx, graph.num_nodes, tile_e=tile_e,
        num_chunks=suggest_num_chunks(e, max_hd, budget_bytes=budget_bytes),
        max_hd=kernel_hd,
    )
    feats = graph.features
    labels = graph.labels if labels is None else labels
    num_valid = None
    n, n_pad = graph.num_nodes, et.padded_num_nodes
    if n_pad != n:
        f_pad = np.zeros((n_pad, graph.feature_dim), np.float32)
        f_pad[:n] = graph.features
        l_pad = np.full(n_pad, -1, np.int32)
        l_pad[:n] = labels
        feats, labels, num_valid = f_pad, l_pad, n
    return et, feats, labels, num_valid


# ---------------------------------------------------------------------------
# the op: the edge-tile family of ops/fused.py
# ---------------------------------------------------------------------------


def sigma_r_table(sigma: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-node backward stats [n, 2*STATS_L] for one head group of h <=
    STATS_L heads, as the JAX package's _sigma_r_table lays them out:
    sigma = m + log(l + 1e-8) in lanes [0, h), r = <g, out> in lanes
    [STATS_L, STATS_L + h), zeros elsewhere."""
    n, h = r.shape
    sr = r.new_zeros((n, 2 * STATS_L))
    sr[:, :h] = sigma[:n]
    sr[:, STATS_L: STATS_L + h] = r
    return sr


def _bwd_group(zs_g, zd_g, g_g, sr, a_g, et, negative_slope):
    """One head group's backward kernels -> (dzs rows, dzd rows, da), rows
    of the padded node grids. Unchunked: K6 over the dst rows with its c1
    packets, K7 over the src rows. Chunked: K6 once per dst chunk without
    packets, on the chunk's rows of zd, g and sr (d_a summed over the chunks
    in order), then K8 once per src chunk on the chunk's rows of zs, which
    rebuilds each edge's packet from zd, g and sr by global dst id."""
    kw = dict(negative_slope=negative_slope)
    side = et.dst_side
    if et.num_chunks == 1:
        dzd_rows, da, c1 = pallas_bwd_dst(
            zs_g, zd_g, g_g, sr, a_g, side.ids_grp[0], side.other_grp[0],
            side.rel_offsets[0], et.tile_e, **kw)
        dzs_rows = pallas_segsum(c1, et.gather_perm, et.src_sorted_ids,
                                 et.src_tile_offsets, et.tile_e)
        return dzs_rows, dzd_rows, da
    rows_c = et.tiles_per_chunk * TILE_N
    dzd_parts, da = [], None
    for g in range(et.num_chunks):
        lo = g * rows_c
        dzd_c, da_c, _ = pallas_bwd_dst(
            zs_g, zd_g[lo:], g_g[lo:], sr[lo:], a_g, side.ids_grp[g],
            side.other_grp[g], side.rel_offsets[g], et.tile_e,
            emit_c1=False, **kw)
        dzd_parts.append(dzd_c)
        da = da_c if da is None else da + da_c
    src = et.src_side
    rows_cs = et.padded_src_nodes // et.num_chunks
    dzs_parts = [
        pallas_bwd_src(zs_g[g * rows_cs:], zd_g, g_g, sr, a_g,
                       src.ids_grp[g], src.other_grp[g], src.rel_offsets[g],
                       et.tile_e, **kw)
        for g in range(et.num_chunks)
    ]
    return torch.cat(dzs_parts), torch.cat(dzd_parts), da


class _EdgeTileFamily(fused.Family):
    """The edge-tile kernels: K5 forward per chunk, K6 and K7 backward, or
    K6 and K8 per chunk on a chunked layout; at most STATS_L = 16 heads and
    MAX_HD lanes a launch; the stats are the forward's m and l [n_pad, H].
    The kernels compute in fp32 at every --precision tier and stream fp32
    (the JAX package's tiers change only its one-hot MXU products, which
    these kernels do not have); the layout carries no edge features."""

    impl = "pallas"
    layout_arg = "edge_tiles"
    layout_hint = ("ops.pallas_attention.prepare_edge_tiles(row_ptr, "
                   "col_idx, num_nodes)")
    layout_type = "EdgeTiles"
    max_hd = MAX_HD
    edge_features = False

    def heads_per_launch(self, head_dim):
        return min(STATS_L, max(1, MAX_HD // head_dim))

    def setup_full_graph(self, graph, heads, out_dims, *, device, labels,
                         budget_bytes, tile_e, edge_features):
        return setup_full_graph(graph, heads, out_dims, device=device,
                                labels=labels, budget_bytes=budget_bytes,
                                tile_e=tile_e)

    def sigma(self, m, l):
        return m + torch.log(l + SOFTMAX_EPS)

    def forward(self, zs, zd, a, et, num_nodes, negative_slope, w_e):
        """One K5 launch per chunk -> (out [num_nodes, h*D], m [n_pad, h],
        l [n_pad, h])."""
        side = et.dst_side
        rows_c = et.tiles_per_chunk * TILE_N
        parts = [
            pallas_fwd(zs, zd[g * rows_c:], a, side.ids_grp[g],
                       side.other_grp[g], side.rel_offsets[g], et.tile_e,
                       negative_slope=negative_slope)
            for g in range(et.num_chunks)
        ]
        out, m, l = (torch.cat(x) if len(x) > 1 else x[0]
                     for x in zip(*parts))
        return out[:num_nodes], m, l

    def forward_raw(self, zs, zd, a, et, negative_slope):
        """K5 with normalize=False on an unchunked layout."""
        side = et.dst_side
        return pallas_fwd(zs, zd, a, side.ids_grp[0], side.other_grp[0],
                          side.rel_offsets[0], et.tile_e,
                          negative_slope=negative_slope, normalize=False)

    def backward(self, zs, zd, g, sigma, r, a, et, negative_slope, w_e):
        dzs_rows, dzd_rows, da = _bwd_group(
            zs, zd, g, sigma_r_table(sigma, r), a, et, negative_slope)
        return dzs_rows[: zs.shape[0]], dzd_rows[: zd.shape[0]], da, None


EDGE_TILES = _EdgeTileFamily()

# (zs2, zd2, a, et, num_nodes, negative_slope) -> (out [num_nodes, H*D],
# m [n_pad, H], l [n_pad, H]): fused.forward on the edge-tile kernels
pallas_forward = functools.partial(fused.forward, EDGE_TILES)

def edge_attention_pallas(
    zs: torch.Tensor,  # [N, H, D] or flat [N, H*D]
    zd: torch.Tensor,  # same shape family as zs
    a: torch.Tensor,  # [H, D]
    num_nodes: int,
    *,
    negative_slope: float,
    edge_tiles: EdgeTiles,
    kept: dict | None = None,
) -> torch.Tensor:
    """Drop-in replacement for the 'torch' edge attention on the edge-tile
    layout (see the module docstring): fused.attention on the edge-tile
    kernels. Returns out in the shape of zs, num_nodes rows; differentiable
    in zs, zd and a on any layout, chunked or not."""
    return fused.attention(EDGE_TILES, zs, zd, a, num_nodes,
                           negative_slope=negative_slope, layout=edge_tiles,
                           kept=kept)


def edge_attention_pallas_merge(
    zs_parts,  # K src-space projections, each [N_k, H, D] or flat [N_k, H*D]
    zd: torch.Tensor,  # [N_dst, H, D] / [N_dst, H*D] dst projections
    a: torch.Tensor,  # [H, D]
    num_nodes: int,  # real dst-node count
    *,
    negative_slope: float,
    edge_tiles_parts,  # K bipartite EdgeTiles (num_chunks=1, same dst space)
) -> torch.Tensor:
    """Edge-tile attention over K edge subsets whose per-destination
    softmax is MERGED across subsets (port of
    gatv2_tpu/ops/pallas_attention.py edge_attention_pallas_merge;
    ops/fused.py merged_attention): each pass runs K5 unnormalised; the
    backward runs K6 and K7 per pass."""
    return fused.merged_attention(EDGE_TILES, zs_parts, zd, a, num_nodes,
                                  negative_slope=negative_slope,
                                  layouts=edge_tiles_parts)
