"""The layout facts K1, K2, K4 (csrc/sell_*.cu) and K5-K8
(csrc/pallas_*.cu) derive their per-row ranges from, held on the CPU
against a numpy derivation from the graph's CSR:

- K5 and K6 read a node tile's sorted destination ids once and take each
  row's edge range [lo, hi) from adjacent differences (padding ids name no
  row of the tile). Here that rule, written in numpy, must give every node
  exactly its in-edges, whole layouts, chunked and fixed-budget ones
  included. K8 applies the same rule to the source side's tiles: every
  source node must get exactly its out-edges.
- K6, K7 and K8 split rows longer than 256 edges (csrc/edge_tiles.cuh):
  over the block's lane groups up to 1024 edges, over segment blocks of
  1024 slots beyond, whose partials a second launch adds in segment order.
  A mirror of that walk must cover each row's edges once, contiguously and
  in the order the kernels add them.
- K7 (csrc/pallas_segsum.cu) applies the tile rule and the walk to the
  unchunked layout's source-sorted entries (src_sorted_ids,
  src_tile_offsets) and reads each entry's packet through gather_perm:
  every source node must get exactly the destination-sorted slots of its
  out-edges. K7 reads a tile's ids a window of 128 slots at a time and
  jumps over the inside of long runs, whose ends a block-wide search finds
  (tile_ranges<true>, block_lower_bound): mirrored, that walk must give
  the same ranges as reading every slot. A numpy mirror of K7's summation
  order (fp32 sums along the walk, partials added in part and segment
  order) must match the JAX kernel (_segsum_src, interpret mode) and the
  port's twin.
- K4 counts a source row's real slots with one binary search over its
  slice's column counts, which is right only if the counts never rise
  along a slice (real slots are a prefix of the row's columns). Here the
  count must equal the row's real slots, and the slots' destination ids
  must be the node's out-edges, split rows included.
- K1 (csrc/sell_fwd.cu) and K2 (csrc/sell_bwd_dst.cu) count a destination
  row's real slots by the same rule over the destination side: the slots'
  source ids must be the node's in-edges, split rows included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu.ops import pallas_attention as jpa
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.pallas_bwd_dst import SEG
from gatv2_tpu_torch.ops.pallas_segsum import pallas_segsum

TILE_N = 128
HUB = 256  # csrc/edge_tiles.cuh kHub
K7_SPLIT = 32  # csrc/pallas_segsum.cu kSplitLen


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


def hub_parts(ids, rel_offsets, te, groups, split=HUB):
    """{row: its partials in the order K6, K7 and K8 add them, each partial
    a list of parts in group order, each part a list of slots in the order
    one lane group adds them}, by the kernels' rule with `groups` lane
    groups a block: a row of at most `split` edges (HUB for K6 and K8,
    K7_SPLIT for K7) in one group (one partial of one part); up to SEG
    edges in equal parts over the groups, which
    merge_groups adds in part order (one partial); longer rows by the
    segment blocks (segment_runs: slot 0 the long run through the
    segment's first slot if it started before, slot 1 the one starting
    inside), one partial a segment, each over the groups, added by the
    merge launch in segment order. Checks on the way that every segment
    partial is read exactly once."""
    rows = (len(rel_offsets) - 1) * TILE_N
    lo, hi = k5_row_ranges(ids, rel_offsets, te)
    order = {}
    for row in range(rows):
        n = int(hi[row] - lo[row])
        if 0 < n <= SEG:
            parts = [(lo[row], hi[row])] if n <= split else [
                split_part(lo[row], hi[row], q, groups)
                for q in range(groups)]
            order[row] = [[list(range(a, b)) for a, b in parts]]
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
        if 0 < p0 and p1 < len(ids) and ids[p0] < rows and \
                ids[p0 - 1] == ids[p0] == ids[p1]:
            # K7's shortcut (segment_runs<true>) takes such a segment as
            # inside one long run, without a search: so must the full rule
            assert runs[1] is None and runs[0][1] < p0 and runs[0][2] > p1
        for slot, run in enumerate(runs):
            if run is None:
                continue
            r, a, b = run
            parts = [split_part(max(a, p0), min(b, p1), q, groups)
                     for q in range(groups)]
            partials[k, slot] = (r, [list(range(x, y)) for x, y in parts])
        if runs[1]:
            starts[k] = runs[1]
    for k, (r, _, b) in starts.items():
        assert r not in order  # the tile blocks left the row alone
        keys = [(k, 1)] + [(kk, 0) for kk in range(k + 1, (b - 1) // SEG + 1)]
        order[r] = []
        for key in keys:
            row, parts = partials.pop(key)
            assert row == r, (key, row, r)
            order[r].append(parts)
    assert not partials, partials  # no partial is left unread
    return order


def hub_walk(ids, rel_offsets, te, groups, split=HUB):
    """{row: the slots of its edges in the order K6, K7 and K8 add them}
    (hub_parts, flattened)."""
    return {row: [p for partial in parts for part in partial for p in part]
            for row, parts in hub_parts(ids, rel_offsets, te, groups,
                                        split).items()}


def _long_rows_csr(long_len):
    """(row_ptr, col_idx, n): rows of long_len edges at different slot
    offsets, node 0 (tile 0) and node 300 (tile 2) as destinations, node 7
    and node 450 as sources; the other rows 0-4 edges."""
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
    return row_ptr, src[order].astype(np.int32), n


@pytest.mark.parametrize("long_len", [255, 256, 257, 300, 1024, 1025,
                                      12_000])
@pytest.mark.parametrize("side", ["dst", "src"])
def test_hub_split_covers_each_row_once_in_order(long_len, side):
    """Rows of long_len edges at different slot offsets (_long_rows_csr).
    On 1 and 3 chunks, with 4 to 32 groups."""
    row_ptr, col_idx, n = _long_rows_csr(long_len)
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


def _batch_csr():
    """A sampled batch's shape: in-edges only into the first 180 of 640
    nodes, from sources below 290, so source tiles 3 and 4 hold no
    entry."""
    rng = np.random.default_rng(8)
    dst = np.sort(rng.integers(0, 180, size=900))
    src = rng.integers(0, 290, size=900).astype(np.int32)
    row_ptr = np.zeros(641, np.int64)
    np.cumsum(np.bincount(dst, minlength=640), out=row_ptr[1:])
    return row_ptr, src, 640


def _k7_layout(case):
    """An unchunked layout K7 runs on: _csr's graphs, a fixed-budget batch
    with empty source tiles, or _long_rows_csr's source rows ("long-<n>")."""
    if case == "batch":
        row_ptr, col_idx, n = _batch_csr()
        return tpa.prepare_edge_tiles(row_ptr, col_idx, n, tile_e=128,
                                      fixed_edge_tiles=30), n
    if case.startswith("long-"):
        row_ptr, col_idx, n = _long_rows_csr(int(case[5:]))
    else:
        row_ptr, col_idx, n = _csr(case)
    return tpa.prepare_edge_tiles(row_ptr, col_idx, n), n


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse", "batch"])
def test_k7_entries_are_the_out_edge_slots(case):
    """K7's tile rule on the source-sorted entries gives every source node
    the destination-sorted slots of exactly its out-edges (through
    gather_perm); padding entries carry the padded node count."""
    et, n = _k7_layout(case)
    assert et.num_chunks == 1
    ids, perm = et.src_sorted_ids, et.gather_perm
    rows = (len(et.src_tile_offsets) - 1) * TILE_N
    assert bool((ids[ids >= n] == rows).all())
    side = et.dst_side
    real = side.ids_grp[0] < et.tiles_per_chunk * TILE_N
    src_of_slot = side.other_grp[0]
    lo, hi = k5_row_ranges(ids, et.src_tile_offsets, et.tile_e)
    for row in range(rows):
        want = np.nonzero(real & (src_of_slot == row))[0]
        assert np.array_equal(np.sort(perm[lo[row]:hi[row]]), want), row
        assert bool((ids[lo[row]:hi[row]] == row).all()), row
    if case == "batch":
        assert not (hi - lo)[3 * TILE_N:].any()  # empty source tiles


@pytest.mark.parametrize("long_len", [32, 33, 255, 256, 257, 300, 1024,
                                      1025, 12_000])
def test_k7_hub_walk_covers_each_row_once_in_order(long_len):
    """The walk over K7's source-sorted entries, with 4 to 32 groups, adds
    each row's entries once and in entry order: sources 7 and 450 of
    long_len edges beside rows of 0-4 (32 and 33: around K7's split
    length)."""
    et, _ = _k7_layout(f"long-{long_len}")
    ids, rel = et.src_sorted_ids, et.src_tile_offsets
    lo, hi = k5_row_ranges(ids, rel, et.tile_e)
    assert int((hi - lo).max()) == long_len
    for groups in (4, 8, 16, 32):
        walk = hub_walk(ids, rel, et.tile_e, groups, K7_SPLIT)
        assert sorted(walk) == np.nonzero(hi > lo)[0].tolist()
        for row, slots in walk.items():
            assert slots == list(range(lo[row], hi[row])), row


def block_lower_bound(ids, lo, hi, key):
    """The first slot of [lo, hi) whose id is >= key, or hi, by the rule of
    block_lower_bound in csrc/edge_tiles.cuh: each round a probe at the
    last slot of each of 128 equal parts, the parts found below key
    skipped; with the number of rounds."""
    rounds = 0
    while lo < hi:
        step = -(-(hi - lo) // TILE_N)
        x = lo + (np.arange(TILE_N) + 1) * step - 1
        ok = x < hi
        below = int((ids[x[ok]] < key).sum())
        lo += below * step
        hi = min(hi, lo + step - 1)
        rounds += 1
    return lo, rounds


def k7_tile_ranges(ids, rel_offsets, te):
    """([lo, hi) per row, windows read per tile) by K7's walk
    (tile_ranges<true>): each tile's ids a window of 128 slots at a time,
    run ends marked where adjacent ids differ; when the run through a
    window's last slot also fills the next window, its end comes from
    block_lower_bound and the walk goes on from there."""
    tiles = len(rel_offsets) - 1
    lo = np.zeros(tiles * TILE_N, np.int64)
    hi = np.zeros(tiles * TILE_N, np.int64)
    windows = np.zeros(tiles, np.int64)
    for t in range(tiles):
        t_lo, t_hi = int(rel_offsets[t]) * te, int(rel_offsets[t + 1]) * te
        base, w = t * TILE_N, t_lo
        while w < t_hi:
            windows[t] += 1
            for p in range(w, min(w + TILE_N, t_hi)):
                d = int(ids[p])
                if not base <= d < base + TILE_N:
                    continue
                if p == t_lo or ids[p - 1] != d:
                    lo[d] = p
                if p + 1 == t_hi or ids[p + 1] != d:
                    hi[d] = p + 1
            nxt = w + TILE_N
            w = nxt
            if nxt + TILE_N > t_hi or ids[nxt - 1] != ids[nxt + TILE_N - 1]:
                continue
            r = int(ids[nxt - 1])
            w, _ = block_lower_bound(ids, nxt + TILE_N, t_hi, r + 1)
            if base <= r < base + TILE_N:
                hi[r] = w
    return lo, hi, windows


def test_block_lower_bound_is_the_lower_bound():
    """Against np.searchsorted on sorted runs of 1 to 2e5 equal ids, keys
    below, inside and above them, and empty ranges."""
    rng = np.random.default_rng(3)
    ids = np.repeat(np.arange(40), rng.integers(1, 6, size=40))
    ids = np.sort(np.concatenate([ids, np.full(200_000, 17)]))
    for lo, hi in ((0, ids.size), (5, 9), (7, 7), (100, 150_000),
                   (ids.size - 3, ids.size)):
        for key in (-1, 0, 17, 18, 25, 40, 41):
            want = lo + int(np.searchsorted(ids[lo:hi], key))
            got, rounds = block_lower_bound(ids, lo, hi, key)
            assert got == want, (lo, hi, key)
            assert rounds <= 3


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse", "batch",
                                  "long-255", "long-257", "long-300",
                                  "long-1025", "long-12000"])
def test_k7_jumping_walk_gives_the_tile_ranges(case):
    """K7's walk gives every row the run that reading every slot gives
    (k5_row_ranges), and reads the tiles of the 12,000-edge sources in
    under a third of their windows."""
    et, _ = _k7_layout(case)
    ids, rel, te = et.src_sorted_ids, et.src_tile_offsets, et.tile_e
    lo, hi, windows = k7_tile_ranges(ids, rel, te)
    want_lo, want_hi = k5_row_ranges(ids, rel, te)
    assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)
    slots = np.diff(rel) * te
    if case == "long-12000":
        hub_tiles = slots > 12_000
        assert hub_tiles.sum() == 2
        assert bool((3 * windows[hub_tiles] < slots[hub_tiles] // TILE_N)
                    .all())
    assert bool((windows <= -(-slots // TILE_N)).all())


def k7_groups(hd):
    """Lane groups a 128-thread K7 block holds: csrc/lane_groups.cuh's
    geometry(1, hd) with 16-byte vectors when hd is a multiple of 4 (the
    port's tables are aligned), a power of two of lanes up to 32 a row."""
    qph = hd // 4 if hd % 4 == 0 else hd
    lanes = 1
    while lanes < min(qph, 32):
        lanes *= 2
    return TILE_N // lanes


def k7_mirror(c1, perm, ids, rel_offsets, te):
    """K7's dzs in numpy, in its summation order: each part of the walk
    (hub_parts) summed in fp32 slot by slot from 0, a partial's parts added
    in group order, a row's partials in segment order; rows without an
    entry 0. NaN in packets no entry names never reaches it."""
    hd = c1.shape[1]
    rows = (len(rel_offsets) - 1) * TILE_N
    dzs = np.zeros((rows, hd), np.float32)
    for row, partials in hub_parts(ids, rel_offsets, te, k7_groups(hd),
                                   K7_SPLIT).items():
        total = None
        for parts in partials:
            merged = None
            for part in parts:
                acc = np.zeros(hd, np.float32)
                for p in part:
                    acc += c1[perm[p]]
                merged = acc if merged is None else merged + acc
            total = merged if total is None else total + merged
        dzs[row] = total
    return dzs


def _jax_k7(c1, et):
    """JAX's K7 (_segsum_src, interpret mode) as the JAX op's unchunked
    backward runs it: the packets lane-padded to 128, permuted to
    source-sorted order by take(c1, gather_perm)."""
    hd = c1.shape[1]
    hd_pad = 128 * -(-hd // 128)
    c1_pad = jnp.zeros((c1.shape[0], hd_pad), jnp.float32).at[:, :hd].set(
        jnp.asarray(c1))
    t = len(et.src_tile_offsets) - 1
    dzs = jpa._segsum_src(
        jpa._take(c1_pad, jnp.asarray(et.gather_perm)),
        jnp.asarray(et.src_sorted_ids)[None, :],
        jnp.asarray(et.src_tile_offsets), t, te=et.tile_e, hd=hd_pad,
        precision="highest", interpret=True)
    return np.asarray(dzs)[:, :hd]


@pytest.mark.parametrize("case,hd", [
    ("uniform", 16), ("power-law", 32), ("sparse", 21), ("batch", 16),
    ("long-33", 16), ("long-300", 16), ("long-1025", 256),
    ("long-12000", 16),
])
def test_k7_summation_order_matches_jax_and_twin(case, hd):
    """The mirror of K7's summation order against the JAX kernel and the
    port's twin on the same seeded packets (finite everywhere: the JAX
    kernel masks padding by a one-hot product, 0 x packet). Tolerance rtol
    1e-5, atol 1e-5 x the largest |dzs|: all three are fp32 sums of up to
    12,000 packets, in three orders (the walk's parts; edge tiles of
    one-hot products; index_add_ in entry order). With NaN in the padding
    packets the mirror is unchanged: it never reads them."""
    et, _ = _k7_layout(case)
    rng = np.random.default_rng(hd)
    c1 = rng.standard_normal((et.dst_side.ids_grp[0].size, hd),
                             dtype=np.float32)
    args = (et.gather_perm, et.src_sorted_ids, et.src_tile_offsets, et.tile_e)
    got = k7_mirror(c1, *args)
    want = _jax_k7(c1, et)
    tol = dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, **tol)
    before = pallas_segsum.launches
    twin = pallas_segsum(torch.as_tensor(c1), *(torch.as_tensor(a)
                                                for a in args[:3]), et.tile_e)
    assert pallas_segsum.launches == before  # the CPU runs the twin
    np.testing.assert_allclose(got, twin.numpy(), **tol)
    real = et.dst_side.ids_grp[0] < et.tiles_per_chunk * TILE_N
    c1[~real] = np.nan
    assert np.array_equal(k7_mirror(c1, *args), got)
