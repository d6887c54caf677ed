"""The layout facts K1, K2, K4 (csrc/sell_*.cu) and K5 (csrc/pallas_fwd.cu)
derive their per-row ranges from, held on the CPU against a numpy
derivation from the graph's CSR:

- K5 reads a node tile's sorted destination ids once and takes each row's
  edge range [lo, hi) from adjacent differences (padding ids name no row of
  the tile). Here that rule, written in numpy, must give every node exactly
  its in-edges, whole layouts, chunked and fixed-budget ones included.
- K4 counts a source row's real slots with one binary search over its
  slice's column counts, which is right only if the counts never rise
  along a slice (real slots are a prefix of the row's columns). Here the
  count must equal the row's real slots, and the slots' destination ids
  must be the node's out-edges, split rows included.
- K1 (csrc/sell_fwd.cu) and K2 (csrc/sell_bwd_dst.cu) count a destination
  row's real slots by the same rule over the destination side: the slots'
  source ids must be the node's in-edges, split rows included.
"""

import numpy as np
import pytest

from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops import sell_attention as tsa

TILE_N = 128


def _csr(case):
    if case == "uniform":
        g = random_graph(700, 3500, 4, 3, seed=3)
    elif case == "power-law":  # hubs: split SELL rows, long edge ranges
        g = powerlaw_graph(600, 5000, 4, 3, seed=4, alpha=1.2)
    else:  # whole node tiles without an edge, and nodes without out-edges
        n = 520
        deg = np.zeros(n, np.int64)
        deg[:60] = 3
        deg[300:330] = 9
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        rng = np.random.default_rng(5)
        col = rng.integers(0, 203, size=int(row_ptr[-1])).astype(np.int32)
        return row_ptr, col, n
    return g.row_ptr, g.col_idx, g.num_nodes


def k5_row_ranges(ids, rel_offsets, te):
    """[lo, hi) per row of one chunk, by K5's rule: over each tile's edge
    range, a slot whose id names a row of the tile opens that row's range
    where the previous slot's id differs and closes it where the next
    one's does; a row no slot names keeps [0, 0)."""
    tiles = len(rel_offsets) - 1
    lo = np.zeros(tiles * TILE_N, np.int64)
    hi = np.zeros(tiles * TILE_N, np.int64)
    for t in range(tiles):
        a, b = int(rel_offsets[t]) * te, int(rel_offsets[t + 1]) * te
        seg = ids[a:b].astype(np.int64)
        if seg.size == 0:
            continue
        d = seg - t * TILE_N
        ok = (d >= 0) & (d < TILE_N)
        change = seg[1:] != seg[:-1]
        first = ok & np.r_[True, change]
        last = ok & np.r_[change, True]
        pos = np.arange(a, b)
        lo[t * TILE_N + d[first]] = pos[first]
        hi[t * TILE_N + d[last]] = pos[last] + 1
    return lo, hi


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse"])
@pytest.mark.parametrize("opts", [
    dict(), dict(num_chunks=3), dict(tile_e=128, fixed_edge_tiles=80),
])
def test_k5_row_ranges_are_the_in_edges(case, opts):
    row_ptr, col_idx, n = _csr(case)
    et = tpa.prepare_edge_tiles(row_ptr, col_idx, n, **opts)
    side = et.dst_side
    rows_c = et.tiles_per_chunk * TILE_N
    for c in range(et.num_chunks):
        ids, src = side.ids_grp[c], side.other_grp[c]
        lo, hi = k5_row_ranges(ids, side.rel_offsets[c], et.tile_e)
        for row in range(rows_c):
            node = c * rows_c + row
            want = (np.sort(col_idx[row_ptr[node]:row_ptr[node + 1]])
                    if node < n else np.zeros(0, col_idx.dtype))
            assert np.array_equal(np.sort(src[lo[row]:hi[row]]), want), node
            assert bool((ids[lo[row]:hi[row]] == row).all()), node


def test_k5_row_ranges_of_a_sampled_batch():
    """A batch's fixed-budget layout: in-edges only into the first 180 of
    640 nodes, so node tiles 2..4 hold no edge."""
    rng = np.random.default_rng(8)
    dst = np.sort(rng.integers(0, 180, size=900))
    src = rng.integers(0, 290, size=900).astype(np.int32)
    row_ptr = np.zeros(641, np.int64)
    np.cumsum(np.bincount(dst, minlength=640), out=row_ptr[1:])
    et = tpa.prepare_edge_tiles(row_ptr, src, 640, tile_e=128,
                                fixed_edge_tiles=30)
    side = et.dst_side
    lo, hi = k5_row_ranges(side.ids_grp[0], side.rel_offsets[0], et.tile_e)
    assert np.array_equal(hi - lo, np.diff(row_ptr))
    assert not (hi - lo)[256:].any()


def sell_row_slots(cnt, c0, ncols, r):
    """The real-slot count of row r of a slice by the rule of K1, K2 and K4
    (sell_row_slots in csrc/lane_groups.cuh): the first column k of the
    slice with cnt[c0 + k] <= r (a binary search)."""
    lo, hi = 0, ncols
    while lo < hi:
        mid = (lo + hi) // 2
        if cnt[c0 + mid] > r:
            lo = mid + 1
        else:
            hi = mid
    return lo


def slots_by_node(side, spc, num_chunks):
    """{node: the opposite ids of its rows' real slots} over every chunk of
    a SELL side, each row's slots counted by sell_row_slots; checks on the
    way that the column counts never rise along a slice and that the
    counted slots are the row's real ones, a prefix of its columns."""
    got = {}
    for c in range(num_chunks):
        cnt, rel, ids = side.cnt_grp[c], side.rel_off[c], side.ids_grp[c]
        for s in range(spc):
            c0, ncols = int(rel[s]), int(rel[s + 1] - rel[s])
            col_cnt = cnt[c0:c0 + ncols]
            assert bool((np.diff(col_cnt) <= 0).all())  # never rises
            real = np.arange(TILE_N)[:, None] < col_cnt[None, :]
            for r in range(TILE_N):
                deg = sell_row_slots(cnt, c0, ncols, r)
                assert deg == int(real[r].sum())
                assert bool(real[r, :deg].all())  # a prefix
                if deg == 0:
                    continue
                node = int(side.perm[(c * spc + s) * TILE_N + r])
                got.setdefault(node, []).extend(
                    ids[(c0 + np.arange(deg)) * TILE_N + r].tolist())
    return got


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse"])
@pytest.mark.parametrize("chunks", [1, 3])
def test_k4_row_slots_are_the_out_edges(case, chunks):
    row_ptr, col_idx, n = _csr(case)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    got = slots_by_node(st.srcs, st.spc_src, st.num_chunks)
    dst_of = np.repeat(np.arange(n), np.diff(row_ptr))
    for node in range(n):
        want = np.sort(dst_of[col_idx == node])
        assert np.array_equal(np.sort(got.get(node, [])), want), node


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse"])
@pytest.mark.parametrize("chunks", [1, 3])
def test_k1_k2_row_slots_are_the_in_edges(case, chunks):
    row_ptr, col_idx, n = _csr(case)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    assert st.dst.split == (case == "power-law")  # split rows covered
    got = slots_by_node(st.dst, st.spc_dst, st.num_chunks)
    for node in range(n):
        want = np.sort(col_idx[row_ptr[node]:row_ptr[node + 1]])
        assert np.array_equal(np.sort(got.get(node, [])), want), node
