"""SELL-128 GATv2 attention: host layout and the forward op (port of
gatv2_tpu/ops/sell_attention.py).

Layout (numpy, built once per graph, byte-equal to the JAX package's):
destination nodes are sorted by in-degree and grouped into slices of 128
rows; each slice's edges are stored column-major, padded to the slice's
widest row. A 128-edge column then holds at most one edge per destination
row, so the softmax and the aggregation accumulate per row. Rows whose
degree exceeds the split cap become several virtual rows (power-law hubs);
their partial softmax states are merged back per node with the
online-softmax rescale. Sampled minibatch training builds one layout per
batch (prepare_minibatch_sell_tiles, or the native emitter through
sell_tiles_from_native) with a geometry fixed for the whole batch stream
(sell_minibatch_geometry) and both sides split.

Padding semantics the op and its kernel keep:
  - padding slots carry the opposite side's padded node count as gather
    id, and a column's real slots are exactly its first `cnt` rows
    (slices are length-descending);
  - a padding slot's score is -1e30, so exp(clip(sc - m, -80, 0)) leaves
    a row with edges unchanged;
  - rows with no edges output exactly 0, with m = -1e30 (finite).

The op is the SELL family (`SELL`) of the fused op of ops/fused.py. Its
forward runs K1 (ops/sell_fwd.py) once per chunk of slices and head
group. On an unchunked layout the backward runs K2 (ops/sell_bwd_dst.py)
over the dst rows, which writes one packet per edge, and K3
(ops/sell_segsum.py), which sums the packets per src row. On a chunked one
it runs K2 once per dst chunk without packets, then K4 (ops/sell_bwd_src.py)
once per src chunk, which rebuilds each edge's packet from the dst side's
node-order tables: no edge-space buffer is held. With edge features K2
writes each edge's compact packet instead (alpha and de per head, the
pre-activation's signs: 144 bytes at 6 heads of 80), one buffer for the
head group's chunks, and K4 reads it through the layout's ell_perm in
place of the rebuild.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gatv2_tpu_torch.ops import fused
from gatv2_tpu_torch.ops.segment import SOFTMAX_EPS, segment_max, segment_sum
from gatv2_tpu_torch.ops.sell_bwd_dst import compact_buffer, sell_bwd_dst
from gatv2_tpu_torch.ops.sell_bwd_src import sell_bwd_src
from gatv2_tpu_torch.ops.sell_fwd import (
    MAX_HD,
    NEG_INF,
    TILE_N,
    heads_per_launch,
    sell_fwd,
)
from gatv2_tpu_torch.ops.sell_segsum import sell_segsum
from gatv2_tpu_torch.utils.metrics import span
from gatv2_tpu_torch.utils.native_loader import sell_output_lengths

_SIDE_ARRAYS = (
    "perm", "inv", "vsort", "sids", "gather_ids", "cnt", "col_off",
    "ids_grp", "cnt_grp", "rel_off",
)


@dataclasses.dataclass(frozen=True)
class _SellSide:
    """One SELL tiling direction (dst-sorted for the forward, src-sorted
    for the backward's d_zs), optionally grouped into chunks. Leaves are
    int32 numpy arrays on the host, or tensors after SellTiles.to(device).

    perm        [rows_pad] — row j accumulates node perm[j] (repeats when
                split; padding rows carry the node grid's padded count).
    inv         [node_pad] — node n's row (unsplit sides; dummy [1] when
                split).
    vsort       [rows_pad] — row indices ordered by node id, pads last
                (split sides; dummy [1] when unsplit).
    sids        [rows_pad] — perm[vsort], the ascending node ids the
                split merge keys on (dummy when unsplit).
    gather_ids  [e_ell] — the opposite endpoint's node id per ELL slot;
                padding slots carry the opposite side's padded node count.
                Dummy [1] when num_chunks > 1.
    cnt         [e_ell / 128] — valid-row count per 128-edge column.
    col_off     [T+1] — cumulative column counts per slice.
    ids_grp     [G, Ec] — per-chunk gather ids.
    cnt_grp     [G, Ec / 128] — per-chunk column counts.
    rel_off     [G, spc+1] — per-chunk chunk-relative column offsets.
    split       whether any node was split across rows.
    """

    perm: np.ndarray
    inv: np.ndarray
    vsort: np.ndarray
    sids: np.ndarray
    gather_ids: np.ndarray
    cnt: np.ndarray
    col_off: np.ndarray
    ids_grp: np.ndarray
    cnt_grp: np.ndarray
    rel_off: np.ndarray
    split: bool = False


@dataclasses.dataclass(frozen=True)
class _EdgeSellSide(_SellSide):
    """A dst side that carries each slot's edge features
    (prepare_sell_tiles with edge_features); a layout without them, and
    every src side, has plain _SellSides.

    edge_feat   [G, Ec, k] fp32 — each slot's edge features, in the slot
                order of ids_grp, zeros in padding slots.
    """

    edge_feat: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class SellTiles:
    """Host-precomputed SELL-128 layout (static per graph).

    dst       — in-degree-sorted slices over destination nodes (streams
                src ids): the forward.
    srcs      — out-degree-sorted slices over source nodes (streams dst
                ids): the backward's d_zs.
    ell_perm  [e2_ell] — src-ELL slot -> dst-ELL slot of the same edge;
                padding -> e_ell. Chunked with edge features, [G, Ec_src]:
                src chunk c's slot -> c_d * Ec_dst + the edge's slot in its
                dst chunk c_d, the row of K2's compact packets (padding ->
                G * Ec_dst); a dummy [1] on other chunked layouts.
    """

    dst: _SellSide
    srcs: _SellSide
    ell_perm: np.ndarray
    num_nodes: int  # real dst-node count
    num_src_nodes: int  # real src-node count (== num_nodes if monopartite)
    num_dst_tiles: int  # TOTAL dst row slices (num_chunks * spc_dst)
    num_src_tiles: int
    e_ell: int
    e2_ell: int
    num_edges: int
    pad_overhead: float  # e_ell / max(num_edges, 1) — layout diagnostic
    num_chunks: int = 1
    spc_dst: int = 0  # slices per chunk, dst side
    spc_src: int = 0
    node_pad_dst: int = -1  # padded node grids; -1 -> num_*_tiles * TILE_N
    node_pad_src: int = -1

    @property
    def edge_dim(self) -> int:
        """Width k of the per-slot edge features (0 without them)."""
        if not isinstance(self.dst, _EdgeSellSide):
            return 0
        return int(self.dst.edge_feat.shape[-1])

    @property
    def padded_num_nodes(self) -> int:
        return (
            self.num_dst_tiles * TILE_N
            if self.node_pad_dst < 0
            else self.node_pad_dst
        )

    @property
    def src_num_nodes(self) -> int:
        """Real src-node count (EdgeTiles' name for it)."""
        return self.num_src_nodes

    @property
    def padded_src_nodes(self) -> int:
        return (
            self.num_src_tiles * TILE_N
            if self.node_pad_src < 0
            else self.node_pad_src
        )

    def to(self, device: str | torch.device) -> "SellTiles":
        """The same layout with every leaf an int32 tensor on `device`
        (a leaf already there is not copied)."""

        def move(x):
            return torch.as_tensor(x, device=device)

        def side(s):
            moved = {f: move(getattr(s, f)) for f in _SIDE_ARRAYS}
            if isinstance(s, _EdgeSellSide):
                moved["edge_feat"] = move(s.edge_feat)
            return dataclasses.replace(s, **moved)

        return dataclasses.replace(
            self, dst=side(self.dst), srcs=side(self.srcs),
            ell_perm=move(self.ell_perm),
        )


def _vrow_lengths(deg: np.ndarray, split_cap: int | None, force=False):
    """Virtual-row decomposition of a degree profile.

    Returns (split, vnode [nvr], vlen [nvr], vbase [num_rows+1]): unsplit
    sides get exactly one row per node (including empty nodes), split
    sides get ceil(deg/cap) rows per NONEMPTY node. force=True selects
    split mode even below the cap (per-batch layouts need one mode for the
    whole batch stream)."""
    num_rows = len(deg)
    split = split_cap is not None and (
        force
        or (num_rows > 0 and deg.size > 0
            and int(deg.max(initial=0)) > split_cap)
    )
    if not split:
        vbase = np.arange(num_rows + 1, dtype=np.int64)
        return False, np.arange(num_rows, dtype=np.int64), deg.astype(
            np.int64
        ), vbase
    nvr_node = -(-deg // split_cap)
    vbase = np.zeros(num_rows + 1, np.int64)
    np.cumsum(nvr_node, out=vbase[1:])
    nvr = int(vbase[-1])
    vnode = np.repeat(np.arange(num_rows, dtype=np.int64), nvr_node)
    k = np.arange(nvr, dtype=np.int64) - np.repeat(vbase[:-1], nvr_node)
    vlen = np.minimum(deg[vnode] - k * split_cap, split_cap)
    return True, vnode, vlen, vbase


def _side_geometry(deg: np.ndarray, num_chunks: int, split_cap=None):
    """(t2 total slices, spc slices/chunk, e_ell, g) for one side — exact,
    without building the arrays (the balancing reorder never changes slice
    widths, only their order). Both sides use the same chunk count."""
    _, _, vlen, _ = _vrow_lengths(np.asarray(deg, np.int64), split_cap)
    nvr = max(1, len(vlen))
    t_real = max(1, -(-nvr // TILE_N))
    g = max(1, num_chunks)
    spc = -(-t_real // g)
    t2 = g * spc
    vlen_pad = np.zeros(t2 * TILE_N, np.int64)
    vlen_pad[: len(vlen)] = vlen
    widths = np.sort(vlen_pad)[::-1].reshape(t2, TILE_N).max(axis=1)
    return t2, spc, max(int(widths.sum()) * TILE_N, TILE_N), g


def _build_sell_side(ptr, opp_ids, num_rows, opp_pad_rows, num_chunks,
                     fixed=None, split_cap=None, force_split=False):
    """One side's SELL layout from its CSR view.

    ptr [num_rows+1], opp_ids [E]: the opposite endpoint of each edge in
    this side's sorted order. Returns (_SellSide, slot[E] int64 — each
    edge's ELL slot, in this side's edge order, for cross-side permutes —
    e_ell, t2 row slices, spc slices per chunk, node_pad).

    fixed=(cols, tiles): force the edge arrays' total column count and the
    row-slice count (ValueError if the real layout needs more), so every
    array keeps one shape across graphs that share the tuple; the tail
    columns are padding and never streamed."""
    ptr = np.asarray(ptr, np.int64)
    deg = np.diff(ptr)
    num_edges = int(ptr[-1])
    split, vnode, vlen, vbase = _vrow_lengths(deg, split_cap,
                                              force=force_split)
    nvr = len(vnode)
    t_real = max(1, -(-max(nvr, 1) // TILE_N))
    g = max(1, num_chunks)
    if fixed is not None:
        # forced before the chunk rounding, so t2 = g * ceil(tiles / g) is
        # the same for every graph that shares the fixed tuple
        fixed_cols, fixed_tiles = fixed
        if t_real > fixed_tiles:
            raise ValueError(
                f"fixed tiles={fixed_tiles} too small: this side needs "
                f"{t_real} row slices"
            )
        t_real = fixed_tiles
    spc = -(-t_real // g)
    t2 = g * spc
    rows_pad = t2 * TILE_N
    vlen_pad = np.zeros(rows_pad, np.int64)
    vlen_pad[:nvr] = vlen
    order0 = np.argsort(-vlen_pad, kind="stable")
    widths0 = vlen_pad[order0].reshape(t2, TILE_N).max(axis=1)
    if g > 1:
        # deal slices (already width-descending) greedily into g chunks of
        # exactly spc slices each, lightest-loaded first
        loads = np.zeros(g, np.int64)
        fill = np.zeros(g, np.int64)
        assign = np.empty(t2, np.int64)
        for s in range(t2):
            cands = np.nonzero(fill < spc)[0]
            b = cands[np.argmin(loads[cands])]
            assign[s] = b
            loads[b] += widths0[s]
            fill[b] += 1
        slice_order = np.argsort(assign, kind="stable")
    else:
        slice_order = np.arange(t2)
    # final row p holds (pre-sort) virtual row vorder[p]
    vorder = order0.reshape(t2, TILE_N)[slice_order].reshape(-1)
    vpos = np.empty(rows_pad, np.int64)
    vpos[vorder] = np.arange(rows_pad, dtype=np.int64)
    if split:
        # decoupled node grid: rows are virtual; padding rows carry the
        # node grid's appended-zero-row index
        node_pad = max(TILE_N, -(-num_rows // TILE_N) * TILE_N)
        vnode_ext = np.concatenate(
            [vnode, np.full(rows_pad - nvr, node_pad, np.int64)]
        )
        perm = vnode_ext[vorder].astype(np.int32)
        inv = np.zeros(1, np.int32)  # direct restore unavailable
        vsort = np.argsort(perm, kind="stable").astype(np.int32)
        sids = perm[vsort]
    else:
        # one row per padded-grid node id: perm is a permutation of the
        # row grid and the node grid is the row grid
        node_pad = rows_pad
        perm = vorder.astype(np.int32)
        inv = np.empty(rows_pad, np.int32)
        inv[perm] = np.arange(rows_pad, dtype=np.int32)
        vsort = np.zeros(1, np.int32)
        sids = np.zeros(1, np.int32)
    widths = widths0[slice_order]
    col_off = np.zeros(t2 + 1, np.int64)
    np.cumsum(widths, out=col_off[1:])
    e_ell = max(int(col_off[-1]) * TILE_N, TILE_N)
    if fixed is not None:
        if e_ell > fixed_cols * TILE_N:
            raise ValueError(
                f"fixed_cols={fixed_cols} too small: this layout needs "
                f"{e_ell // TILE_N} columns"
            )
        e_ell = fixed_cols * TILE_N

    gather = np.full(e_ell, opp_pad_rows, np.int32)
    # per-column valid-row counts: column c of a slice holds real edges in
    # exactly its first #{rows: vlen > c} rows
    cnt = np.zeros(e_ell // TILE_N, np.int32)
    if num_edges:
        vlen_sl = vlen_pad[vorder].reshape(t2, TILE_N)
        for s in range(t2):
            w = int(widths[s])
            if w:
                asc = vlen_sl[s][::-1]
                c0 = int(col_off[s])
                cnt[c0 : c0 + w] = (
                    TILE_N
                    - np.searchsorted(
                        asc, np.arange(w, dtype=np.int64), side="right"
                    )
                ).astype(np.int32)
        own = np.repeat(np.arange(num_rows, dtype=np.int64), deg)
        rank = np.arange(num_edges, dtype=np.int64) - np.repeat(ptr[:-1], deg)
        cap = split_cap if split else (int(deg.max()) + 1 if len(deg) else 1)
        vr0 = vbase[own] + rank // cap
        within = rank % cap
        pos = vpos[vr0]
        slot = (col_off[pos // TILE_N] + within) * TILE_N + pos % TILE_N
        gather[slot] = opp_ids
    else:
        slot = np.zeros(0, np.int64)

    if g > 1:
        bounds = col_off[::spc]  # [g+1] chunk column boundaries
        ec = max(int(np.diff(bounds).max()), 1) * TILE_N
        ids_grp = np.full((g, ec), opp_pad_rows, np.int32)
        cnt_grp = np.zeros((g, ec // TILE_N), np.int32)
        rel = np.zeros((g, spc + 1), np.int32)
        for k in range(g):
            lo, hi = int(bounds[k]) * TILE_N, int(bounds[k + 1]) * TILE_N
            ids_grp[k, : hi - lo] = gather[lo:hi]
            cnt_grp[k, : (hi - lo) // TILE_N] = cnt[
                int(bounds[k]) : int(bounds[k + 1])
            ]
            rel[k] = (
                col_off[k * spc : (k + 1) * spc + 1] - col_off[k * spc]
            ).astype(np.int32)
        # only the grouped layout is consumed when chunked
        gather = np.zeros(1, np.int32)
        cnt = np.zeros(1, np.int32)
        col_flat = np.zeros(1, np.int32)
    else:
        ids_grp = gather[None]
        cnt_grp = cnt[None]
        rel = col_off[None].astype(np.int32)
        col_flat = col_off.astype(np.int32)
    side = _SellSide(
        perm=np.asarray(perm, np.int32),
        inv=np.asarray(inv, np.int32),
        vsort=np.asarray(vsort, np.int32),
        sids=np.asarray(sids, np.int32),
        gather_ids=gather,
        cnt=cnt,
        col_off=np.asarray(col_flat, np.int32),
        ids_grp=ids_grp,
        cnt_grp=cnt_grp,
        rel_off=rel,
        split=split,
    )
    return side, slot, e_ell, t2, spc, node_pad


def _with_edge_features(side: _SellSide, slot: np.ndarray,
                        feats: np.ndarray) -> _EdgeSellSide:
    """`side` with its per-slot edge features [G, Ec, k] in the slot order
    of its ids_grp: feats [E, k] in this side's edge order (the order
    `slot` gives each edge's ELL slot in), zeros in padding slots."""
    g, ec = side.ids_grp.shape
    out = np.zeros((g, ec, feats.shape[1]), np.float32)
    if g == 1:
        out[0, slot] = feats
    else:
        out[_chunk_of(side, slot)] = feats
    return _EdgeSellSide(**{f.name: getattr(side, f.name)
                            for f in dataclasses.fields(side)},
                         edge_feat=out)


def _chunk_of(side: _SellSide, slot: np.ndarray):
    """(chunk, slot within the chunk) of flat ELL slots of a chunked side:
    chunk c holds the flat layout's columns from the sum of the earlier
    chunks' widths (rel_off[:, -1]) on."""
    bounds = np.zeros(side.ids_grp.shape[0] + 1, np.int64)
    np.cumsum(side.rel_off[:, -1].astype(np.int64) * TILE_N, out=bounds[1:])
    chunk = np.searchsorted(bounds, slot, side="right") - 1
    return chunk, slot - bounds[chunk]


def _compact_ell_perm(dst, srcs, slot_d, slot_s, order) -> np.ndarray:
    """A chunked layout's ell_perm [G, Ec_src] (SellTiles): for each src
    slot, the row of the same edge's compact packet, c_d * Ec_dst + its
    slot in dst chunk c_d; padding -> G * Ec_dst. slot_d / slot_s: each
    edge's flat ELL slot in CSR / CSC order, order the CSC permutation."""
    g, ec_d = dst.ids_grp.shape
    if g * ec_d >= 2 ** 31:
        raise ValueError(
            f"{g} x {ec_d} dst slots exceed the int32 packet index")
    out = np.full(srcs.ids_grp.shape, g * ec_d, np.int32)
    chunk_d, within_d = _chunk_of(dst, slot_d[order])
    chunk_s, within_s = _chunk_of(srcs, slot_s)
    out[chunk_s, within_s] = chunk_d * ec_d + within_d
    return out


def suggest_num_chunks_sell(
    e_ell: int, e2_ell: int, max_hd: int, *, budget_bytes: int
) -> int:
    """Chunk count so SELL edge-space temporaries stay under budget_bytes.

    The JAX package's live-set formula of the training backward:
    unchunked, phase 1 holds zs [E, hd] + the c1 packets [E, hd] and phase
    2a the permuted packets [E2, hd]; chunked, the widest per-chunk set is
    phase 2b's [zd | g] stream [E2/G, 2hd] + sr [E2/G, 128]. The port's own
    chunked backward builds none of those streams (K4 reads the node-order
    tables itself), so this chunks earlier than the port's live set needs.

    The formula is the JAX package's, the counts are not always:
    suggest_chunks_for_graph passes the widest head group's H*D as it is,
    where the JAX package rounds it up to a multiple of 128 lanes. At
    narrow widths the port therefore keeps one chunk at budgets where the
    JAX package already chunks, and then jumps further: at H*D = 16 it
    goes from 1 to 4 chunks where the JAX package goes from 1 to 2."""
    if (2 * e_ell + e2_ell) * max_hd * 4 <= budget_bytes:
        return 1
    need = max(e_ell * max_hd, e2_ell * (2 * max_hd + 128)) * 4
    return max(2, -(-need // budget_bytes))


DEFAULT_SPLIT_CAP = 256

# chunk budget when the layout is built for the CPU: the JAX package's
# policy (gatv2_tpu/ops/pallas_attention.py default_chunk_budget), 6 GiB
# below 30M edges and 2 GiB from there on
CPU_CHUNK_BUDGET = 6 << 30
CPU_CHUNK_BUDGET_LARGE = 2 << 30
LARGE_GRAPH_EDGES = 30_000_000


def default_chunk_budget(device: str | torch.device, num_edges: int = 0) -> int:
    """Edge-temporary budget for auto-chunking: a quarter of the CUDA
    device's free memory (the rest holds features, projections and
    activations), or the JAX package's budget for a graph of num_edges
    edges on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return free // 4
    if num_edges >= LARGE_GRAPH_EDGES:
        return CPU_CHUNK_BUDGET_LARGE
    return CPU_CHUNK_BUDGET


def prepare_sell_tiles(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    num_nodes: int,
    num_src_nodes: int | None = None,
    num_chunks: int = 1,
    fixed: tuple[int, int, int, int] | None = None,
    split_cap: int | None = DEFAULT_SPLIT_CAP,
    force_split: tuple[bool, bool] = (False, False),
    edge_features: np.ndarray | None = None,
) -> SellTiles:
    """Build the two-sided SELL-128 layout from CSR (host side, once per
    graph or per sampled batch). Every leaf is a numpy array until
    SellTiles.to(device) moves the layout (the JAX package's as_numpy=True
    is therefore the only mode and has no option here).

    num_src_nodes: bipartite edge sets (col_idx holds global source ids
    while row_ptr covers local destinations); default monopartite.
    num_chunks=G groups each side's slices into G balanced chunks.
    split_cap: rows above this degree split into virtual rows (None
    disables). force_split=(dst, src): split that side's rows even below
    the cap. fixed=(dst_cols, src_cols, dst_tiles, src_tiles): force both
    sides' total column and row-slice counts, so that layouts built for
    different edge sets have identical shapes (ValueError if one needs
    more); num_edges is then -1 and pad_overhead 0.0, the same for every
    layout of the tuple. edge_features [E, k] (CSR edge order): the dst
    side carries them per slot (_EdgeSellSide.edge_feat) and a chunked
    layout its ell_perm, built under the span layout.edge_features;
    without them nothing more is built or held."""
    row_ptr = np.asarray(row_ptr, np.int64)
    col_idx = np.asarray(col_idx, np.int32)
    ns = num_nodes if num_src_nodes is None else num_src_nodes
    num_edges = int(row_ptr[-1])
    fx_d = fx_s = None
    if fixed is not None:
        fx_d = (fixed[0], fixed[2])
        fx_s = (fixed[1], fixed[3])

    # the degrees and node grids: the same bincount and geometry as the
    # chunk plan's (suggest_chunks_for_graph), under its span
    with span("layout.chunk_plan"):
        deg_s = (np.bincount(col_idx, minlength=ns) if num_edges
                 else np.zeros(ns, np.int64))

        # each side's padding slots point at the OTHER side's appended
        # zero row, so both sides' padded node grids are fixed up front;
        # an unsplit side's node grid is its row grid (chunk padding and a
        # fixed slice count can extend it)
        node_pad_d = max(TILE_N, -(-num_nodes // TILE_N) * TILE_N)
        node_pad_s = max(TILE_N, -(-ns // TILE_N) * TILE_N)
        deg_d = np.diff(row_ptr)
        split_d, _, _, _ = _vrow_lengths(deg_d, split_cap,
                                         force=force_split[0])
        split_s, _, _, _ = _vrow_lengths(deg_s.astype(np.int64), split_cap,
                                         force=force_split[1])
        if not split_d:
            t2_d0 = _side_geometry(deg_d, num_chunks)[0]
            if fixed is not None:
                t2_d0 = max(t2_d0, fixed[2])
            node_pad_d = t2_d0 * TILE_N
        if not split_s:
            t2_s0 = _side_geometry(deg_s, num_chunks)[0]
            if fixed is not None:
                t2_s0 = max(t2_s0, fixed[3])
            node_pad_s = t2_s0 * TILE_N

    with span("layout.dst_side"):
        dst_side, slot_d, e_ell, t2_d, spc_d, node_pad_d = _build_sell_side(
            row_ptr, col_idx, num_nodes, node_pad_s, num_chunks,
            fixed=fx_d, split_cap=split_cap, force_split=force_split[0],
        )

    # CSC view: edges stably re-sorted by src
    with span("layout.csc_sort"):
        order = np.argsort(col_idx, kind="stable")
        sptr = np.zeros(ns + 1, np.int64)
        np.cumsum(deg_s, out=sptr[1:])
        dst_all = np.repeat(
            np.arange(num_nodes, dtype=np.int32), np.diff(row_ptr)
        )
        dst_by_src = dst_all[order]
    with span("layout.src_side"):
        src_side, slot_s, e2_ell, t2_s, spc_s, node_pad_s = _build_sell_side(
            sptr, dst_by_src, ns, node_pad_d, num_chunks,
            fixed=fx_s, split_cap=split_cap, force_split=force_split[1],
        )
    g = max(1, num_chunks)
    if g > 1:
        ell_perm = np.zeros(1, np.int32)  # K3 unused when chunked
    else:
        ell_perm = np.full(e2_ell, e_ell, np.int32)
        if num_edges:
            ell_perm[slot_s] = slot_d[order]
    if edge_features is not None:
        with span("layout.edge_features"):
            ef = np.asarray(edge_features, np.float32)
            if ef.ndim != 2 or ef.shape[0] != num_edges:
                raise ValueError(
                    f"edge_features {ef.shape} must be [num_edges="
                    f"{num_edges}, k]")
            dst_side = _with_edge_features(dst_side, slot_d, ef)
            if g > 1:
                ell_perm = _compact_ell_perm(dst_side, src_side, slot_d,
                                             slot_s, order)

    return SellTiles(
        dst=dst_side,
        srcs=src_side,
        ell_perm=ell_perm,
        num_nodes=num_nodes,
        num_src_nodes=ns,
        num_dst_tiles=t2_d,
        num_src_tiles=t2_s,
        e_ell=e_ell,
        e2_ell=e2_ell,
        num_edges=-1 if fixed is not None else num_edges,
        pad_overhead=0.0 if fixed is not None else e_ell / max(num_edges, 1),
        num_chunks=g,
        spc_dst=spc_d,
        spc_src=spc_s,
        node_pad_dst=node_pad_d,
        node_pad_src=node_pad_s,
    )


def suggest_chunks_for_graph(
    row_ptr, col_idx, num_nodes, heads, out_dims, *, budget_bytes
) -> int:
    """Chunk count for a CSR graph: exact e_ell/e2_ell pre-sizing plus the
    live-set budget."""
    # the widest head group one K1 launch takes (see sell_forward)
    max_hd = max(
        min(h, heads_per_launch(d)) * d for h, d in zip(heads, out_dims)
    )
    deg_d = np.diff(np.asarray(row_ptr, np.int64))
    deg_s = np.bincount(np.asarray(col_idx, np.int64), minlength=num_nodes)
    _, _, e_ell_est, _ = _side_geometry(
        deg_d, 1, split_cap=DEFAULT_SPLIT_CAP
    )
    _, _, e2_ell_est, _ = _side_geometry(
        deg_s, 1, split_cap=DEFAULT_SPLIT_CAP
    )
    return suggest_num_chunks_sell(
        e_ell_est, e2_ell_est, max_hd, budget_bytes=budget_bytes
    )


def setup_full_graph_sell(
    graph, heads, out_dims, *, device, labels=None, budget_bytes=None,
    edge_features=None,
):
    """One-stop full-graph SELL setup: builds the two-sided layout —
    auto-chunked so the edge-space temporaries fit budget_bytes (default:
    default_chunk_budget(device, graph.num_edges)) — and pads features and
    labels (default graph.labels; a split-masked copy in training) to the
    padded node grid once.

    Returns (sell_tiles, features, labels, num_valid), all on the host;
    num_valid is None when no padding row was added. Padding labels are
    -1 (ignored by the loss; whole rows of [N, C] multi-label labels).
    edge_features [E, k] (CSR edge order), or None: the layout carries
    them per slot (prepare_sell_tiles). Runs under the span setup.layout,
    its steps under layout.chunk_plan, .dst_side, .csc_sort, .src_side,
    .edge_features and .pad."""
    with span("setup.layout"):
        if budget_bytes is None:
            budget_bytes = default_chunk_budget(device, graph.num_edges)
        with span("layout.chunk_plan"):
            num_chunks = suggest_chunks_for_graph(
                graph.row_ptr, graph.col_idx, graph.num_nodes, heads,
                out_dims, budget_bytes=budget_bytes,
            )
        st = prepare_sell_tiles(
            graph.row_ptr, graph.col_idx, graph.num_nodes,
            num_chunks=num_chunks, edge_features=edge_features,
        )
        with span("layout.pad"):
            labels = graph.labels if labels is None else labels
            feats, num_valid = graph.features, None
            n, n_pad = graph.num_nodes, st.padded_num_nodes
            if n_pad != n:
                feats = np.zeros((n_pad, graph.feature_dim), np.float32)
                feats[:n] = graph.features
                labels = np.asarray(labels)
                padded = np.full((n_pad, *labels.shape[1:]), -1, np.int32)
                padded[:n] = labels
                labels, num_valid = padded, n
    return st, feats, labels, num_valid


def sell_minibatch_geometry(
    max_nodes: int, max_edges: int, split_cap: int = DEFAULT_SPLIT_CAP
) -> tuple[int, int, int, int]:
    """Fixed (dst_cols, src_cols, dst_tiles, src_tiles) covering ANY
    subgraph with <= max_nodes nodes and <= max_edges edges under forced
    virtual-row splitting, so that per-batch prepare_sell_tiles(fixed=...)
    has one shape across a sampler's whole batch stream and never raises
    for a batch inside the budget.

    cols bound: e_ell = sum_s 128*w_s with slice widths w_s taken from
    length-descending rows, so for s >= 1 every row of slice s-1 has
    vlen >= w_s and 128*w_s <= slice s-1's edge total; summing,
    sum_{s>=1} 128*w_s <= E. Forced splitting caps w_0 <= split_cap.
    Hence cols <= ceil(E/128) + split_cap.

    tiles bound: virtual rows = sum over nonempty nodes of ceil(deg/cap)
    <= #nonempty + E/cap <= min(max_nodes, E) + E/cap."""
    cols = -(-max_edges // TILE_N) + split_cap
    nvr = min(max_nodes, max_edges) + max_edges // split_cap
    tiles = -(-max(nvr, 1) // TILE_N)
    return (cols, cols, tiles, tiles)


def prepare_minibatch_sell_tiles(
    src: np.ndarray, dst: np.ndarray, num_edges: int, max_nodes: int,
    fixed: tuple[int, int, int, int],
) -> SellTiles:
    """Per-batch SELL layout of a sampled subgraph (impl='sell' minibatch
    training): a local-id edge list whose first num_edges entries are real
    and sorted by dst (ValueError otherwise, as the native emitter fails),
    the fixed geometry of sell_minibatch_geometry, both sides split."""
    real = np.asarray(dst[:num_edges])
    if real.size and (np.diff(real) < 0).any():
        raise ValueError(
            "prepare_minibatch_sell_tiles: the real edges must be sorted by "
            "dst (NeighborSampler emits them so)")
    row_ptr = np.zeros(max_nodes + 1, np.int64)
    np.cumsum(np.bincount(real, minlength=max_nodes), out=row_ptr[1:])
    return prepare_sell_tiles(
        row_ptr, np.asarray(src[:num_edges]), max_nodes,
        num_chunks=1, fixed=fixed, split_cap=DEFAULT_SPLIT_CAP,
        force_split=(True, True),
    )


def sell_tiles_from_native(
    raw: dict, max_nodes: int, fixed: tuple[int, int, int, int]
) -> SellTiles:
    """Assemble a SellTiles from native emit_sell_tiles output (see
    utils/native_loader.py; byte-identical to prepare_minibatch_sell_tiles).
    Every raw array must be int32 of the length the fixed geometry gives
    it (ValueError otherwise)."""
    cols_d, cols_s, tiles_d, tiles_s = fixed
    node_pad = max(TILE_N, -(-max_nodes // TILE_N) * TILE_N)
    dummy = np.zeros(1, np.int32)
    for key, n in sell_output_lengths(fixed).items():
        a = raw[key]
        if a.dtype != np.int32 or a.shape != (n,):
            raise ValueError(
                f"sell_tiles_from_native: {key} is {a.dtype}{a.shape}, the "
                f"fixed geometry {fixed} needs int32[{n}]")

    def side(tag):
        gather, cnt, col_off = (raw[f"{k}_{tag}"]
                                for k in ("gather", "cnt", "col_off"))
        return _SellSide(
            perm=raw[f"perm_{tag}"], inv=dummy, vsort=raw[f"vsort_{tag}"],
            sids=raw[f"sids_{tag}"], gather_ids=gather, cnt=cnt,
            col_off=col_off, ids_grp=gather[None], cnt_grp=cnt[None],
            rel_off=col_off[None], split=True,
        )

    return SellTiles(
        dst=side("d"),
        srcs=side("s"),
        ell_perm=raw["ell_perm"],
        num_nodes=max_nodes,
        num_src_nodes=max_nodes,
        num_dst_tiles=tiles_d,
        num_src_tiles=tiles_s,
        e_ell=cols_d * TILE_N,
        e2_ell=cols_s * TILE_N,
        num_edges=-1,  # the fixed-mode aux of prepare_sell_tiles
        pad_overhead=0.0,
        num_chunks=1,
        spc_dst=tiles_d,
        spc_src=tiles_s,
        node_pad_dst=node_pad,
        node_pad_src=node_pad,
    )


# ---------------------------------------------------------------------------
# the op: the SELL family of ops/fused.py
# ---------------------------------------------------------------------------


def _merge_rows_dst(u_p, m_p, l_p, side, n_pad, head_dim):
    """Virtual-row space (u, m, l) -> node space (out, sigma): the exact
    online-softmax merge over each node's virtual rows."""
    vs = side.vsort.long()
    ids = side.sids.long()  # ascending node ids, pads last
    m_s, l_s, u_s = m_p[vs], l_p[vs], u_p[vs]
    # empty nodes keep a finite max, as in the JAX package
    m_n = segment_max(m_s, ids, n_pad + 1)[:n_pad].clamp(min=NEG_INF)
    m_z = torch.cat([m_n, m_n.new_zeros((1, m_n.shape[1]))])
    c = torch.exp(m_s - m_z[ids])  # [rows, H]
    u_n = segment_sum(
        u_s * c.repeat_interleave(head_dim, dim=1), ids, n_pad + 1
    )[:n_pad]
    l_n = segment_sum(l_s * c, ids, n_pad + 1)[:n_pad]
    out = u_n / (l_n.repeat_interleave(head_dim, dim=1) + SOFTMAX_EPS)
    return out, m_n + torch.log(l_n + SOFTMAX_EPS)


def _edge_kw(side, g, w_e):
    """K1/K2/K4's edge arguments for chunk g of `side`: none without W_e."""
    if w_e is None:
        return {}
    return dict(edge_feat=side.edge_feat[g], w_e=w_e)


def _rows_to_nodes_sum(x_rows, side, node_pad, n_rows):
    """Row-space gradients -> the first n_rows nodes: a direct inverse take
    (unsplit side) or a sorted segment sum over each node's virtual rows
    (split side; padding rows carry node_pad and are dropped)."""
    if not side.split:
        return x_rows[side.inv[:n_rows].long()]
    return segment_sum(
        x_rows[side.vsort.long()], side.sids, node_pad + 1
    )[:n_rows]


def _fit_rows(x, n):
    """x [m, ...] cut or zero-padded to n rows. Rows past the real node
    count have no edge, so no kernel reads what they hold."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros((n - x.shape[0], *x.shape[1:]))])


def _edge_grad(dwe_part, heads, head_dim):
    """dW_e [H, D, k] of a head group from K2's partials [P, k, H*D]: one
    sum over P in a fixed order, under the span attn.edge_grad."""
    with span("attn.edge_grad"):
        dwe = dwe_part.sum(0)
        return dwe.t().reshape(heads, head_dim, dwe.shape[0])


def _bwd_heads(zs_g, zd_g, g_g, sigma_g, r, a_g, st, negative_slope,
               w_e=None):
    """One head group's backward kernels -> row-space (dzs rows, dzd rows,
    da, dW_e or None). Unchunked: K2 over the dst rows with its c1 packets,
    K3 over the src rows. Chunked: K2 once per dst chunk without packets
    (d_a summed over the chunks in order, dW_e's block partials added in
    launch order), then K4 once per src chunk, which rebuilds each edge's
    packet from the dst side's node-order tables; with w_e, K2 writes each
    edge's compact packet into one buffer for the group's chunks and K4
    reads it through st.ell_perm instead."""
    kw = dict(negative_slope=negative_slope)
    tables = (zs_g, zd_g, g_g, sigma_g, r, a_g)
    if st.num_chunks == 1:
        out = sell_bwd_dst(
            *tables, st.dst.perm, st.dst.gather_ids, st.dst.cnt,
            st.dst.col_off, **_edge_kw(st.dst, 0, w_e), **kw)
        dzd_rows, da, c1 = out[:3]
        dzs_rows = sell_segsum(c1, st.ell_perm, st.srcs.cnt, st.srcs.col_off)
        dwe = None if w_e is None else _edge_grad(out[3], *a_g.shape)
        return dzs_rows, dzd_rows, da, dwe

    def chunks(side, spc):
        rows_c = spc * TILE_N
        for g in range(st.num_chunks):
            yield g, (side.perm[g * rows_c: (g + 1) * rows_c],
                      side.ids_grp[g], side.cnt_grp[g], side.rel_off[g])

    compact = None
    if w_e is not None:
        ec_d = st.dst.ids_grp.shape[1]
        compact = compact_buffer(st.num_chunks * ec_d, *a_g.shape,
                                 dtype=zs_g.dtype, device=zs_g.device)
    dzd_parts, da, dwe_part = [], None, None
    for g, lay in chunks(st.dst, st.spc_dst):
        ekw = _edge_kw(st.dst, g, w_e)
        if w_e is not None:
            ekw.update(dwe_part=dwe_part,
                       compact=compact[g * ec_d: (g + 1) * ec_d])
        out = sell_bwd_dst(*tables, *lay, emit_c1=False, **ekw, **kw)
        dzd_c, da_c = out[:2]
        if w_e is not None:
            dwe_part = out[3]
        dzd_parts.append(dzd_c)
        da = da_c if da is None else da + da_c
    dzs_parts = [
        sell_bwd_src(*tables, *lay, **kw, **({} if compact is None else dict(
            compact=compact, ell_perm=st.ell_perm[g])))
        for g, lay in chunks(st.srcs, st.spc_src)]
    del compact
    dwe = None if w_e is None else _edge_grad(dwe_part, *a_g.shape)
    with span("attn.join"):
        return torch.cat(dzs_parts), torch.cat(dzd_parts), da, dwe


class _Sell(fused.Family):
    """The SELL kernels: K1 forward per chunk (split rows merged back per
    node), K2 and K3 backward, or K2 and K4 per chunk on a chunked layout;
    heads_per_launch(D) heads a launch; the stats are sigma [num_nodes,
    H]; streams='bf16' rounds the projections once to bfloat16; w_e reads
    the layout's per-slot edge features."""

    impl = "sell"
    layout_arg = "sell_tiles"
    layout_hint = "ops.sell_attention.prepare_sell_tiles(row_ptr, col_idx, n)"
    layout_type = "SellTiles"
    max_hd = MAX_HD
    edge_features = True

    def heads_per_launch(self, head_dim):
        return heads_per_launch(head_dim)

    def setup_full_graph(self, graph, heads, out_dims, *, device, labels,
                         budget_bytes, tile_e, edge_features):
        return setup_full_graph_sell(
            graph, heads, out_dims, device=device, labels=labels,
            budget_bytes=budget_bytes, edge_features=edge_features)

    def check(self, st, a, w_e):
        if w_e is not None and (st.edge_dim == 0
                                or w_e.shape != (*a.shape, st.edge_dim)):
            raise ValueError(
                f"w_e {tuple(w_e.shape)} needs a layout built with edge "
                f"features of its width (prepare_sell_tiles(edge_features="
                f"...)); this one carries {st.edge_dim}")

    def check_merge(self, st):
        if st.dst.split or st.srcs.split:
            raise ValueError(
                "merge path needs UNSPLIT layouts (build its tiles with "
                "split_cap=None; prepare_overlap_sell_tiles does)")

    def stream_dtype(self, streams):
        if streams not in ("f32", "bf16"):
            raise ValueError(
                f"streams must be 'f32' or 'bf16', got {streams!r}")
        return torch.bfloat16 if streams == "bf16" else torch.float32

    def sigma(self, sigma):
        return sigma

    def backward_rows(self, x, nd):
        # K2 and K4 read g, sigma and r in zd's node space
        return _fit_rows(x, nd)

    def forward(self, zs, zd, a, st, num_nodes, negative_slope, w_e):
        """One K1 launch per chunk -> node-space (out [num_nodes, h*D],
        sigma [num_nodes, h])."""
        side = st.dst
        rows_c = st.spc_dst * TILE_N
        outs, ms, ls = [], [], []
        for g in range(st.num_chunks):
            o, m, l = sell_fwd(
                zs, zd, a, side.perm[g * rows_c: (g + 1) * rows_c],
                side.ids_grp[g], side.cnt_grp[g], side.rel_off[g],
                negative_slope=negative_slope, normalize=not side.split,
                **_edge_kw(side, g, w_e),
            )
            outs.append(o)
            ms.append(m)
            ls.append(l)
        with span("attn.join"):
            out_p, m_p, l_p = (torch.cat(x) if len(x) > 1 else x[0]
                               for x in (outs, ms, ls))
            if side.split:
                out, sigma = _merge_rows_dst(
                    out_p, m_p, l_p, side, st.padded_num_nodes, a.shape[1]
                )
                return out[:num_nodes], sigma[:num_nodes]
            inv = side.inv[:num_nodes].long()
            return out_p[inv], m_p[inv] + torch.log(l_p[inv] + SOFTMAX_EPS)

    def forward_raw(self, zs, zd, a, st, negative_slope):
        """K1 with normalize=False on an unsplit, unchunked layout, rows
        restored to node order."""
        inv = st.dst.inv.long()
        u, m, l = sell_fwd(
            zs, zd, a, st.dst.perm, st.dst.gather_ids, st.dst.cnt,
            st.dst.col_off, negative_slope=negative_slope, normalize=False)
        return u[inv], m[inv], l[inv]

    def backward(self, zs, zd, g, sigma, r, a, st, negative_slope, w_e):
        """The backward kernels (_bwd_heads), then rows -> nodes on both
        sides."""
        dzs_rows, dzd_rows, da, dwe = _bwd_heads(
            zs, zd, g, sigma.contiguous(), r, a, st, negative_slope, w_e)
        with span("attn.join"):
            dzd = _rows_to_nodes_sum(dzd_rows, st.dst, st.padded_num_nodes,
                                     zd.shape[0])
            dzs = _rows_to_nodes_sum(dzs_rows, st.srcs, st.padded_src_nodes,
                                     zs.shape[0])
        return dzs, dzd, da, dwe


SELL = _Sell()


def sell_forward(
    zs: torch.Tensor,  # [N, H, D] or flat [N, H*D]
    zd: torch.Tensor,  # same shape family as zs
    a: torch.Tensor,  # [H, D]
    num_nodes: int,
    *,
    negative_slope: float,
    sell_tiles: SellTiles,
    streams: str = "f32",
    w_e: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SELL attention forward. Returns (out, sigma): out in the shape of
    zs restricted to num_nodes rows, sigma = m + log(l + 1e-8) per node and
    head [num_nodes, H] (the statistic the backward reuses).

    Heads run in groups of heads_per_launch(D) per K1 launch (at most 32
    heads and 512 lanes); heads are independent, so groups change nothing.
    streams='bf16': zs and zd are rounded once to bfloat16 and carried as
    fp32, so the result equals the exact path on rounded projections.
    w_e [H, D, k]: the scores read the layout's per-slot edge features."""
    st, zs2, zd2, _ = fused.prepare(SELL, zs, zd, a, num_nodes, sell_tiles,
                                    streams, w_e)
    out, sigma = fused.forward(SELL, zs2, zd2, a, st, num_nodes,
                               negative_slope, w_e)
    if zs.dim() != 2:
        out = out.reshape(num_nodes, *a.shape)
    return out, sigma


def sell_attention(
    zs: torch.Tensor,
    zd: torch.Tensor,
    a: torch.Tensor,
    num_nodes: int,
    *,
    negative_slope: float,
    sell_tiles: SellTiles,
    streams: str = "f32",
    kept: dict | None = None,
    w_e: torch.Tensor | None = None,
) -> torch.Tensor:
    """Drop-in replacement for the 'torch' edge attention on the SELL
    layout (see the module docstring): fused.attention on the SELL
    kernels. Returns out in the shape of zs; differentiable in zs, zd and
    a on any layout, chunked or not, and in w_e [H, D, k], which makes each
    score read the layout's per-slot edge features (SellTiles built with
    edge_features)."""
    return fused.attention(SELL, zs, zd, a, num_nodes,
                           negative_slope=negative_slope, layout=sell_tiles,
                           streams=streams, kept=kept, w_e=w_e)


def sell_attention_merge(
    zs_parts,  # K src-space projections, each [N_k, H, D] or flat [N_k, H*D]
    zd: torch.Tensor,  # [N_dst, H, D] / [N_dst, H*D] dst projections
    a: torch.Tensor,  # [H, D]
    num_nodes: int,  # real dst-node count
    *,
    negative_slope: float,
    sell_tiles_parts,  # K bipartite SellTiles (num_chunks=1, same dst space)
) -> torch.Tensor:
    """SELL attention over K edge subsets whose per-destination softmax is
    MERGED across subsets (port of gatv2_tpu/ops/sell_attention.py
    sell_attention_merge; ops/fused.py merged_attention): each pass runs
    K1 unnormalised, restored to node order (each pass has its own
    degree-sorted rows); the backward runs K2 and K3 per pass."""
    return fused.merged_attention(SELL, zs_parts, zd, a, num_nodes,
                                  negative_slope=negative_slope,
                                  layouts=sell_tiles_parts)
