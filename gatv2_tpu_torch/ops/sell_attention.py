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

The forward runs K1 (ops/sell_fwd.py) once per chunk of slices and head
group. On an unchunked layout the backward runs K2 (ops/sell_bwd_dst.py)
over the dst rows, which writes one packet per edge, and K3
(ops/sell_segsum.py), which sums the packets per src row. On a chunked one
it runs K2 once per dst chunk without packets, then K4 (ops/sell_bwd_src.py)
once per src chunk, which rebuilds each edge's packet from the dst side's
node-order tables: no edge-space buffer is held.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gatv2_tpu_torch.ops.merge import (
    merged_attention,
    merged_attention_exchange,
)
from gatv2_tpu_torch.ops.segment import SOFTMAX_EPS, segment_max, segment_sum
from gatv2_tpu_torch.ops.sell_bwd_dst import sell_bwd_dst
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
    """A side that carries each slot's edge features (prepare_sell_tiles
    with edge_features); a layout without them has plain _SellSides.

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
                padding -> e_ell (dummy when num_chunks > 1).
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
    `slot` gives each edge's ELL slot in), zeros in padding slots. Chunk k
    holds the flat layout's columns from the sum of the earlier chunks'
    widths (rel_off[:, -1]) on."""
    g, ec = side.ids_grp.shape
    out = np.zeros((g, ec, feats.shape[1]), np.float32)
    if g == 1:
        out[0, slot] = feats
    else:
        bounds = np.zeros(g + 1, np.int64)
        np.cumsum(side.rel_off[:, -1].astype(np.int64) * TILE_N,
                  out=bounds[1:])
        chunk = np.searchsorted(bounds, slot, side="right") - 1
        out[chunk, slot - bounds[chunk]] = feats
    return _EdgeSellSide(**{f.name: getattr(side, f.name)
                            for f in dataclasses.fields(side)},
                         edge_feat=out)


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
    layout of the tuple. edge_features [E, k] (CSR edge order): each side
    carries them per slot (_EdgeSellSide.edge_feat), built under the span
    layout.edge_features; without them nothing more is built or held."""
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
    if edge_features is not None:
        with span("layout.edge_features"):
            ef = np.asarray(edge_features, np.float32)
            if ef.ndim != 2 or ef.shape[0] != num_edges:
                raise ValueError(
                    f"edge_features {ef.shape} must be [num_edges="
                    f"{num_edges}, k]")
            dst_side = _with_edge_features(dst_side, slot_d, ef)
            src_side = _with_edge_features(src_side, slot_s, ef[order])
    g = max(1, num_chunks)
    if g > 1:
        ell_perm = np.zeros(1, np.int32)  # packet path unused when chunked
    else:
        ell_perm = np.full(e2_ell, e_ell, np.int32)
        if num_edges:
            ell_perm[slot_s] = slot_d[order]

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
# the op
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


def _forward_heads(zs, zd, a, st, num_nodes, negative_slope, w_e=None):
    """One head group: flat fp32 zs/zd [*, H*D] -> node-space
    (out [num_nodes, H*D], sigma [num_nodes, H])."""
    side = st.dst
    rows_c = st.spc_dst * TILE_N
    outs, ms, ls = [], [], []
    for g in range(st.num_chunks):
        o, m, l = sell_fwd(
            zs, zd, a, side.perm[g * rows_c : (g + 1) * rows_c],
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


def _prepare(zs, zd, a, num_nodes, sell_tiles, streams, w_e=None):
    """Validate the op's inputs; returns (layout on zs's device, flat fp32
    zs [Ns, H*D], flat fp32 zd [Nd, H*D]), rounded once to bfloat16 with
    streams='bf16'."""
    if sell_tiles is None:
        raise ValueError(
            "impl='sell' requires sell_tiles "
            "(ops.sell_attention.prepare_sell_tiles(row_ptr, col_idx, n))"
        )
    st = sell_tiles
    if w_e is not None and (st.edge_dim == 0
                            or w_e.shape != (*a.shape, st.edge_dim)):
        raise ValueError(
            f"w_e {tuple(w_e.shape)} needs a layout built with edge features "
            f"of its width (prepare_sell_tiles(edge_features=...)); this one "
            f"carries {st.edge_dim}")
    if num_nodes not in (st.num_nodes, st.padded_num_nodes):
        raise ValueError(
            f"sell_tiles built for {st.num_nodes} "
            f"(padded {st.padded_num_nodes}) dst nodes, got {num_nodes}"
        )
    if zs.shape[0] not in (st.num_src_nodes, st.padded_src_nodes):
        raise ValueError(
            f"zs has {zs.shape[0]} rows; sell_tiles src space is "
            f"{st.num_src_nodes} (padded {st.padded_src_nodes})"
        )
    if zd.shape[0] not in (st.num_nodes, st.padded_num_nodes):
        raise ValueError(
            f"zd has {zd.shape[0]} rows; sell_tiles dst space is "
            f"{st.num_nodes} (padded {st.padded_num_nodes})"
        )
    if streams not in ("f32", "bf16"):
        raise ValueError(f"streams must be 'f32' or 'bf16', got {streams!r}")
    num_heads, head_dim = a.shape
    if head_dim > MAX_HD:
        raise ValueError(
            f"head dim {head_dim} exceeds the SELL kernel's {MAX_HD} lanes"
        )
    zs2 = zs.reshape(zs.shape[0], num_heads * head_dim).float()
    zd2 = zd.reshape(zd.shape[0], num_heads * head_dim).float()
    if streams == "bf16":
        zs2 = zs2.to(torch.bfloat16).float()
        zd2 = zd2.to(torch.bfloat16).float()
    return st.to(zs.device), zs2, zd2


def _head_groups(num_heads, head_dim):
    """(h0, h1) head ranges of one kernel launch each: heads_per_launch(D)
    heads at a time (heads are independent, so groups change nothing)."""
    group = heads_per_launch(head_dim)
    return [(h0, min(h0 + group, num_heads))
            for h0 in range(0, num_heads, group)]


def _forward_flat(zs2, zd2, a, st, num_nodes, negative_slope, w_e=None):
    """Flat fp32 zs/zd -> node-space (out [num_nodes, H*D], sigma
    [num_nodes, H]), one K1 launch per chunk and head group."""
    num_heads, head_dim = a.shape
    outs, sigmas = [], []
    for h0, h1 in _head_groups(num_heads, head_dim):
        lanes = slice(h0 * head_dim, h1 * head_dim)
        o, s = _forward_heads(
            zs2[:, lanes].contiguous(), zd2[:, lanes].contiguous(),
            a[h0:h1].float().contiguous(), st, num_nodes, negative_slope,
            None if w_e is None else w_e[h0:h1].float().contiguous(),
        )
        outs.append(o)
        sigmas.append(s)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    sigma = torch.cat(sigmas, dim=1) if len(sigmas) > 1 else sigmas[0]
    return out, sigma


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
    st, zs2, zd2 = _prepare(zs, zd, a, num_nodes, sell_tiles, streams, w_e)
    out, sigma = _forward_flat(zs2, zd2, a, st, num_nodes, negative_slope,
                               w_e)
    if zs.dim() != 2:
        out = out.reshape(num_nodes, *a.shape)
    return out, sigma


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
    packet from the dst side's node-order tables."""
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

    dzd_parts, da, dwe_part = [], None, None
    for g, lay in chunks(st.dst, st.spc_dst):
        ekw = _edge_kw(st.dst, g, w_e)
        if w_e is not None:
            ekw["dwe_part"] = dwe_part
        out = sell_bwd_dst(*tables, *lay, emit_c1=False, **ekw, **kw)
        dzd_c, da_c = out[:2]
        if w_e is not None:
            dwe_part = out[3]
        dzd_parts.append(dzd_c)
        da = da_c if da is None else da + da_c
    dzs_parts = [sell_bwd_src(*tables, *lay, **_edge_kw(st.srcs, g, w_e),
                              **kw)
                 for g, lay in chunks(st.srcs, st.spc_src)]
    dwe = None if w_e is None else _edge_grad(dwe_part, *a_g.shape)
    with span("attn.join"):
        return torch.cat(dzs_parts), torch.cat(dzd_parts), da, dwe


def sell_backward(zs2, zd2, a, out2, sigma, g2, st, negative_slope,
                  w_e=None):
    """The op's backward on the layout `st` (on g2's device): flat fp32 zs2
    [Ns, H*D], zd2 [Nd, H*D] (the forward's rounded values), out2 and the
    upstream gradient g2 [n, H*D], sigma [n, H], n the op's num_nodes ->
    (dzs [Ns, H*D], dzd [Nd, H*D], da [H, D]), and dW_e [H, D, k] fourth
    with w_e [H, D, k] (the layout's edge features then enter the scores).

    Per head group: r = <g, out> per node and head (the softmax Jacobian's
    segment term), the backward kernels (_bwd_heads: K2 and K3, or K2 and
    K4 per chunk), then rows -> nodes on both sides."""
    num_heads, head_dim = a.shape
    # K2 and K4 read g, sigma and r in zd's node space
    nd = zd2.shape[0]
    g2, out2, sigma = (_fit_rows(x, nd) for x in (g2, out2, sigma))
    dzs, dzd, da, dwe = [], [], [], []
    for h0, h1 in _head_groups(num_heads, head_dim):
        lanes = slice(h0 * head_dim, h1 * head_dim)
        g_g = g2[:, lanes].contiguous()
        r = (g_g * out2[:, lanes]).view(nd, h1 - h0, head_dim).sum(-1)
        dzs_rows, dzd_rows, da_g, dwe_g = _bwd_heads(
            zs2[:, lanes].contiguous(), zd2[:, lanes].contiguous(), g_g,
            sigma[:, h0:h1].contiguous(), r, a[h0:h1].float().contiguous(),
            st, negative_slope,
            None if w_e is None else w_e[h0:h1].float().contiguous(),
        )
        dwe.append(dwe_g)
        with span("attn.join"):
            dzd.append(_rows_to_nodes_sum(
                dzd_rows, st.dst, st.padded_num_nodes, zd2.shape[0]))
            dzs.append(_rows_to_nodes_sum(
                dzs_rows, st.srcs, st.padded_src_nodes, zs2.shape[0]))
        da.append(da_g)
    out = (torch.cat(dzs, 1) if len(dzs) > 1 else dzs[0],
           torch.cat(dzd, 1) if len(dzd) > 1 else dzd[0],
           torch.cat(da, 0) if len(da) > 1 else da[0])
    if w_e is None:
        return out
    return out + (torch.cat(dwe, 0) if len(dwe) > 1 else dwe[0],)


class _SellAttention(torch.autograd.Function):
    """Forward through K1; backward through K2 and K3 (K2 and K4 on a
    chunked layout). The saved tensors are the forward's (rounded) zs/zd in
    the stream dtype, a, the output and sigma, as the JAX custom VJP saves
    them; the gradient passes straight through the bf16 rounding to the
    unrounded input.

    `kept` (a dict, or None) carries the node-space result from a
    checkpointed layer's first call to its recompute: an empty holder is
    filled with (out2, sigma); a filled one is emptied and its result
    saved in place of K1's, which does not launch."""

    @staticmethod
    def forward(ctx, zs, zd, a, num_nodes, negative_slope, sell_tiles,
                streams, kept, w_e):
        st, zs2, zd2 = _prepare(zs, zd, a, num_nodes, sell_tiles, streams,
                                w_e)
        if kept:
            out2, sigma = kept.pop("result")
            sell_attention.reused += len(_head_groups(*a.shape))
        else:
            out2, sigma = _forward_flat(zs2, zd2, a, st, num_nodes,
                                        negative_slope, w_e)
            if kept is not None:
                kept["result"] = out2.detach(), sigma
        sdt = torch.bfloat16 if streams == "bf16" else torch.float32
        ctx.save_for_backward(zs2.to(sdt), zd2.to(sdt), a, out2, sigma,
                              *(() if w_e is None else (w_e,)))
        ctx.st, ctx.slope = st, negative_slope
        ctx.shapes = (zs.shape, zd.shape, zs.dtype, zd.dtype)
        return out2 if zs.dim() == 2 else out2.reshape(num_nodes, *a.shape)

    @staticmethod
    def backward(ctx, grad_out):
        zs2, zd2, a, out2, sigma, *w_e = ctx.saved_tensors
        w_e = w_e[0] if w_e else None
        zs_shape, zd_shape, zs_dtype, zd_dtype = ctx.shapes
        g2 = grad_out.reshape(out2.shape).float().contiguous()
        grads = sell_backward(
            zs2.float(), zd2.float(), a, out2, sigma, g2, ctx.st, ctx.slope,
            w_e,
        )
        dzs, dzd, da = grads[:3]
        dwe = None if w_e is None else grads[3].to(w_e.dtype)
        return (dzs.reshape(zs_shape).to(zs_dtype),
                dzd.reshape(zd_shape).to(zd_dtype), da.to(a.dtype),
                None, None, None, None, None, dwe)


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
    layout (see the module docstring). Returns out in the shape of zs;
    differentiable in zs, zd and a on any layout, chunked or not, and in
    w_e [H, D, k], which makes each score read the layout's per-slot edge
    features (SellTiles built with edge_features). `kept`: a checkpointed
    layer's holder (models/gatv2.py), whose recompute reuses the first
    call's result instead of running K1 again."""
    return _SellAttention.apply(
        zs, zd, a, num_nodes, negative_slope, sell_tiles, streams, kept, w_e
    )


# head groups whose forward a recompute took from `kept` instead of K1
sell_attention.reused = 0


def _forward_raw(zs2, zd2, a, st, negative_slope):
    """One pass of the merge on an unsplit, unchunked layout: K1 with
    normalize=False per head group, rows restored to node order ->
    (u [n_pad, H*D], m [n_pad, H], l [n_pad, H])."""
    num_heads, head_dim = a.shape
    inv = st.dst.inv.long()
    parts = []
    for h0, h1 in _head_groups(num_heads, head_dim):
        lanes = slice(h0 * head_dim, h1 * head_dim)
        u, m, l = sell_fwd(
            zs2[:, lanes].contiguous(), zd2[:, lanes].contiguous(),
            a[h0:h1].float().contiguous(), st.dst.perm, st.dst.gather_ids,
            st.dst.cnt, st.dst.col_off, negative_slope=negative_slope,
            normalize=False)
        parts.append((u[inv], m[inv], l[inv]))
    return tuple(torch.cat(x, dim=1) if len(x) > 1 else x[0]
                 for x in zip(*parts))


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
    sell_attention_merge): the overlapped sharded layer's local-source
    edges in one pass, its halo-source edges in another, so only the halo
    pass waits on the exchange.

    Each pass runs K1 unnormalised (u_k = sum exp(e - m_k) zs, with m_k
    and l_k), restored to node order (each pass has its own degree-sorted
    rows); the passes merge with the online-softmax rescale. The backward
    is exact; see ops/merge.py. Differentiable in every zs
    part, zd and a; returns num_nodes rows in the shape family of the zs
    parts."""
    sts = tuple(sell_tiles_parts)
    zs_parts = tuple(zs_parts)
    _check_merge_parts(sts, [z.shape[0] for z in zs_parts])
    return merged_attention(
        zs_parts, zd, a, num_nodes, negative_slope=negative_slope,
        layouts=sts, forward_raw=_forward_raw, backward=sell_backward,
        name="sell_attention_merge")


def _check_merge_parts(sts, rows):
    """One unsplit SellTiles per zs part, each part `rows[k]` rows of its
    tiles' (padded) src space."""
    if len(sts) != len(rows) or not sts:
        raise ValueError("need one SellTiles per zs part")
    if any(st.dst.split or st.srcs.split for st in sts):
        raise ValueError(
            "merge path needs UNSPLIT layouts (build its tiles with "
            "split_cap=None; prepare_overlap_sell_tiles does)")
    for n, st in zip(rows, sts):
        if n not in (st.num_src_nodes, st.padded_src_nodes):
            raise ValueError(
                f"zs part has {n} rows; its tiles' src space "
                f"is {st.num_src_nodes} (padded {st.padded_src_nodes})")


def sell_attention_merge_exchange(
    zs_loc: torch.Tensor,  # [N_loc, H*D] / [N_loc, H, D] local projections
    send: torch.Tensor,  # [S, M, ...] the rows this rank sends each peer
    zd: torch.Tensor,  # [N_dst, H, D] / [N_dst, H*D] dst projections
    a: torch.Tensor,  # [H, D]
    num_nodes: int,  # real dst-node count
    *,
    group,  # the S ranks of the exchange
    negative_slope: float,
    sell_tiles_parts,  # (local, halo) SellTiles; halo src space S*M rows
) -> torch.Tensor:
    """sell_attention_merge of the overlapped sharded layer with the
    boundary halo exchange inside (ops/merge.py): K1 of the local pass
    runs while the all_to_all of `send` is in flight, the halo pass's K1
    after its wait; in the backward the reverse exchange of the halo rows'
    gradient runs under the local pass's K2 + K3. Bit-equal to
    sell_attention_merge((zs_loc, all_to_all(send)), ...)."""
    sts = tuple(sell_tiles_parts)
    _check_merge_parts(sts, [zs_loc.shape[0], send.shape[0] * send.shape[1]])
    return merged_attention_exchange(
        zs_loc, send, zd, a, num_nodes, group=group,
        negative_slope=negative_slope, layouts=sts, forward_raw=_forward_raw,
        backward=sell_backward, name="sell_attention_merge_exchange")
