"""The layout facts K1, K2, K4 (csrc/sell_*.cu) and K5-K8
(csrc/pallas_*.cu) derive their per-row ranges from, held on the CPU
against a numpy derivation from the graph's CSR:

- K5 and K6 read a node tile's sorted destination ids once and take each
  row's edge range [lo, hi) from adjacent differences (padding ids name no
  row of the tile). Here that rule, written in numpy, must give every node
  exactly its in-edges, whole layouts, chunked and fixed-budget ones
  included. K8 applies the same rule to the source side's tiles: every
  source node must get exactly its out-edges.
- K6 and K8 split rows longer than 256 edges (csrc/edge_tiles.cuh): over
  the block's lane groups up to 1024 edges, over segment blocks of 1024
  slots beyond, whose partials a second launch adds in segment order. A
  mirror of that walk must cover each row's edges once, contiguously and
  in the order the kernels add them.
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
from gatv2_tpu_torch.ops.pallas_bwd_dst import SEG

TILE_N = 128
HUB = 256  # csrc/edge_tiles.cuh kHub


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


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse"])
@pytest.mark.parametrize("chunks", [1, 3])
def test_k8_row_ranges_are_the_out_edges(case, chunks):
    row_ptr, col_idx, n = _csr(case)
    et = tpa.prepare_edge_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    side = et.src_side
    rows_c = et.padded_src_nodes // et.num_chunks
    dst_of = np.repeat(np.arange(n), np.diff(row_ptr))
    for c in range(et.num_chunks):
        ids, dst = side.ids_grp[c], side.other_grp[c]
        assert bool((ids[(ids < 0) | (ids >= rows_c)] >= rows_c).all())
        lo, hi = k5_row_ranges(ids, side.rel_offsets[c], et.tile_e)
        for row in range(rows_c):
            node = c * rows_c + row
            want = np.sort(dst_of[col_idx == node])
            assert np.array_equal(np.sort(dst[lo[row]:hi[row]]), want), node
            assert bool((ids[lo[row]:hi[row]] == row).all()), node


def split_part(lo, hi, q, parts):
    """Part q of `parts` equal contiguous parts of [lo, hi) (split_part in
    csrc/edge_tiles.cuh)."""
    per = -(-(hi - lo) // parts)
    p_lo = min(hi, lo + q * per)
    return p_lo, min(hi, p_lo + per)


def long_run_at(ids, rel_offsets, te, rows, p):
    """(row, lo, hi) of the run through slot p if it is longer than SEG
    slots, else None (long_run_at in csrc/edge_tiles.cuh, its two-load
    rejection and binary searches included)."""
    r, half = int(ids[p]), SEG // 2
    if r >= rows:
        return None
    if not ((p >= half and ids[p - half] == r)
            or (p + half < len(ids) and ids[p + half] == r)):
        return None
    t = r // TILE_N
    a, b = int(rel_offsets[t]) * te, p
    while a < b:
        m = (a + b) // 2
        a, b = (m + 1, b) if ids[m] < r else (a, m)
    lo = a
    a, b = p + 1, int(rel_offsets[t + 1]) * te
    while a < b:
        m = (a + b) // 2
        a, b = (m + 1, b) if ids[m] <= r else (a, m)
    return (r, lo, a) if a - lo > SEG else None


def hub_walk(ids, rel_offsets, te, groups):
    """{row: the slots of its edges in the order K6 and K8 add them}, by
    the kernels' rule with `groups` lane groups a block: a row of at most
    HUB edges in one group; up to SEG edges in equal parts over the groups,
    added in part order; longer rows by the segment blocks (segment_runs:
    slot 0 the long run through the segment's first slot if it started
    before, slot 1 the one starting inside), each part over the groups,
    added by the merge launch in segment order. Checks on the way that
    every segment partial is read exactly once."""
    rows = (len(rel_offsets) - 1) * TILE_N
    lo, hi = k5_row_ranges(ids, rel_offsets, te)
    order = {}
    for row in range(rows):
        n = int(hi[row] - lo[row])
        if 0 < n <= SEG:
            parts = [(lo[row], hi[row])] if n <= HUB else [
                split_part(lo[row], hi[row], q, groups)
                for q in range(groups)]
            order[row] = [p for a, b in parts for p in range(a, b)]
    partials, starts = {}, {}
    for k in range(-(-len(ids) // SEG)):
        p0, p1 = k * SEG, min((k + 1) * SEG, len(ids))
        first = long_run_at(ids, rel_offsets, te, rows, p0)
        runs = [first if first and first[1] < p0 else None, None]
        if first and first[1] == p0:
            runs[1] = first
        else:
            last = long_run_at(ids, rel_offsets, te, rows, p1 - 1)
            if last and (first is None or last[0] != first[0]):
                runs[1] = last
        for slot, run in enumerate(runs):
            if run is None:
                continue
            r, a, b = run
            parts = [split_part(max(a, p0), min(b, p1), q, groups)
                     for q in range(groups)]
            partials[k, slot] = (r, [p for x, y in parts
                                     for p in range(x, y)])
        if runs[1]:
            starts[k] = runs[1]
    for k, (r, _, b) in starts.items():
        assert r not in order  # the tile blocks left the row alone
        keys = [(k, 1)] + [(kk, 0) for kk in range(k + 1, (b - 1) // SEG + 1)]
        order[r] = []
        for key in keys:
            row, slots = partials.pop(key)
            assert row == r, (key, row, r)
            order[r] += slots
    assert not partials, partials  # no partial is left unread
    return order


@pytest.mark.parametrize("long_len", [255, 256, 257, 300, 1024, 1025,
                                      12_000])
@pytest.mark.parametrize("side", ["dst", "src"])
def test_hub_split_covers_each_row_once_in_order(long_len, side):
    """Rows of long_len edges at different slot offsets: node 0 (tile 0)
    and node 300 (tile 2) as destinations, node 7 and node 450 as sources;
    the other rows 0-4 edges. On 1 and 3 chunks, with 4 to 32 groups."""
    rng = np.random.default_rng(long_len)
    n = 1000
    others = np.setdiff1d(np.arange(n), [0, 300, 7, 450])
    dst = [np.repeat(others, rng.integers(0, 5, size=others.size))]
    src = [rng.choice(others, size=dst[0].size)]
    for hub_dst in (0, 300):
        dst.append(np.full(long_len, hub_dst))
        src.append(rng.choice(others, size=long_len))
    for hub_src in (7, 450):
        dst.append(rng.choice(others, size=long_len))
        src.append(np.full(long_len, hub_src))
    dst, src = np.concatenate(dst), np.concatenate(src)
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    col_idx = src[order].astype(np.int32)
    for chunks in (1, 3):
        et = tpa.prepare_edge_tiles(row_ptr, col_idx, n, num_chunks=chunks)
        s = et.dst_side if side == "dst" else et.src_side
        for c in range(et.num_chunks):
            ids, rel = s.ids_grp[c], s.rel_offsets[c]
            lo, hi = k5_row_ranges(ids, rel, et.tile_e)
            for groups in (4, 8, 16, 32):
                walk = hub_walk(ids, rel, et.tile_e, groups)
                assert sorted(walk) == np.nonzero(hi > lo)[0].tolist()
                for row, slots in walk.items():
                    assert slots == list(range(lo[row], hi[row])), row
        lengths = np.diff(row_ptr) if side == "dst" else np.bincount(
            col_idx, minlength=n)
        assert int(lengths.max()) == long_len


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
