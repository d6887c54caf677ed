"""The port's SELL backward against the JAX package's, on the CPU: K2's, K3's
and K4's plain twins against the JAX kernels _sell_bwd_dst, _sell_segsum and
_sell_bwd_src run in interpret mode on the same numpy inputs, and
torch.autograd gradients of sell_attention (the twins) on unchunked and
chunked layouts against jax.grad of the JAX op (interpret mode) and of its
XLA oracle.

Tolerances are the JAX suite's own for SELL gradients (tests/test_sell.py):
rtol 2e-4 / atol 5e-5, and 5e-4 / 1e-4 on split layouts, whose hub rows sum
hundreds of terms that cancel. K2's per-edge packets c1 are held to the
forward's 1e-5 (tests/test_torch_sell.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu.ops import sell_attention as jsa
from gatv2_tpu.ops.attention import _edge_attention_xla
from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.sell_bwd_dst import sell_bwd_dst
from gatv2_tpu_torch.ops.sell_bwd_src import sell_bwd_src
from gatv2_tpu_torch.ops.sell_fwd import TILE_N
from gatv2_tpu_torch.ops.sell_segsum import sell_segsum
from test_torch_sell import LAYOUTS, SLOPE, _zza

GRAD_TOL = dict(rtol=2e-4, atol=5e-5)
SPLIT_GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
C1_TOL = dict(rtol=1e-5, atol=1e-5)


def _real_slots(cnt):
    """[Ec] bool: the ELL slots that hold an edge (row < the column's cnt)."""
    return (np.arange(TILE_N)[None, :] < np.asarray(cnt)[:, None]).reshape(-1)


def _lane_table(x, rows, hd):
    """x [m, hd_real] -> [rows + 1, hd]: lane-padded to the JAX kernels'
    128-lane width, zero rows below (the appended row padding ids read)."""
    t = np.zeros((rows + 1, hd), np.float32)
    t[: x.shape[0], : x.shape[1]] = x
    return jnp.asarray(t)


def _k2_inputs(case, h, d, seed):
    """A layout and K2's inputs as the op builds them: random zs, zd, g, a;
    sigma from the forward; r = <g, out> per node and head."""
    row_ptr, col_idx, n = LAYOUTS[case][0]()
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n)
    zs, zd, a = _zza(n, h, d, seed)
    g = np.random.default_rng(seed + 100).normal(size=zs.shape).astype(
        np.float32)
    out, sigma = tsa.sell_forward(
        *(torch.from_numpy(x) for x in (zs, zd, a)), n, negative_slope=SLOPE,
        sell_tiles=st)
    r = (torch.from_numpy(g) * out).view(n, h, d).sum(-1)
    return st, (zs, zd, g, sigma.numpy(), r.numpy(), a)


def _jax_k2(zs, zd, g, sigma, r, a, st):
    """JAX's K2 (_sell_bwd_dst, interpret mode) with its inputs built as the
    JAX op's backward builds them: lane-padded tables with a zero row, the
    packed [sigma | r] block, pre-gathered rows and zs stream."""
    h, d = a.shape
    hd = -(-h * d // 128) * 128
    n_pad = st.padded_num_nodes
    zs_z = _lane_table(zs, st.padded_src_nodes, hd)
    zd_z, g_z = (_lane_table(x, n_pad, hd) for x in (zd, g))
    sr = np.zeros((n_pad + 1, 128), np.float32)
    sr[: sigma.shape[0], :h] = sigma
    sr[: r.shape[0], jsa.STATS_L : jsa.STATS_L + h] = r
    a2, bdiag, rsig, rr, _, a_rep = jsa._sell_matrices(jnp.asarray(a), hd)
    perm = jnp.asarray(st.dst.perm)
    dzd, da_parts, c1 = jsa._sell_bwd_dst(
        jnp.take(zs_z, jnp.asarray(st.dst.gather_ids), axis=0),
        jnp.asarray(st.dst.cnt), jnp.take(zd_z, perm, axis=0),
        jnp.take(g_z, perm, axis=0), jnp.take(jnp.asarray(sr), perm, axis=0),
        a2, bdiag, rsig, rr, a_rep, jnp.asarray(st.dst.col_off),
        st.num_dst_tiles, negative_slope=SLOPE, hd=hd, precision="highest",
        interpret=True,
    )
    return (np.asarray(dzd)[:, : h * d], np.asarray(da_parts).sum(0)[: h * d],
            np.asarray(c1)[:, : h * d])


@pytest.mark.parametrize("case,h,d", [
    ("uniform", 4, 16), ("zipf-split", 2, 32), ("isolated", 3, 8),
    ("zero-edge", 2, 8),
])
def test_k2_twin_matches_jax_kernel(case, h, d):
    st, inputs = _k2_inputs(case, h, d, 3)
    side = st.dst
    before = sell_bwd_dst.launches
    dzd, da, c1 = sell_bwd_dst(
        *(torch.from_numpy(x) for x in (*inputs, side.perm, side.gather_ids,
                                        side.cnt, side.col_off)),
        negative_slope=SLOPE,
    )
    assert sell_bwd_dst.launches == before  # the CPU runs the twin
    j_dzd, j_da, j_c1 = _jax_k2(*inputs, st)
    tol = SPLIT_GRAD_TOL if side.split else GRAD_TOL
    np.testing.assert_allclose(dzd.numpy(), j_dzd, **tol)
    np.testing.assert_allclose(da.numpy().reshape(-1), j_da, **tol)
    real = _real_slots(side.cnt)
    np.testing.assert_allclose(c1.numpy()[real], j_c1[real], **C1_TOL)
    # rows without an edge get exactly 0, as in the masked JAX algebra
    empty = np.diff(LAYOUTS[case][0]()[0]) == 0
    if empty.any() and not side.split:
        rows = side.inv[: len(empty)][empty]
        assert (dzd.numpy()[rows] == 0).all()


@pytest.mark.parametrize("case,hd", [
    ("uniform", 64), ("zipf-split", 48), ("isolated", 16), ("zero-edge", 8),
])
def test_k3_twin_matches_jax_kernel(case, hd):
    row_ptr, col_idx, n = LAYOUTS[case][0]()
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n)
    c1 = np.random.default_rng(6).normal(size=(st.e_ell, hd)).astype(
        np.float32)
    before = sell_segsum.launches
    dzs = sell_segsum(*(torch.from_numpy(x) for x in (
        c1, st.ell_perm, st.srcs.cnt, st.srcs.col_off)))
    assert sell_segsum.launches == before
    hd_pad = -(-hd // 128) * 128
    c1_l = jnp.asarray(np.pad(c1, ((0, 0), (0, hd_pad - hd))))
    want = jsa._sell_segsum(
        jnp.take(c1_l, jnp.asarray(st.ell_perm), axis=0, mode="clip"),
        jnp.asarray(st.srcs.col_off), jnp.asarray(st.srcs.cnt),
        st.num_src_tiles, hd=hd_pad, interpret=True,
    )
    tol = SPLIT_GRAD_TOL if st.srcs.split else GRAD_TOL
    np.testing.assert_allclose(dzs.numpy(), np.asarray(want)[:, :hd], **tol)


def _few_sources(n=1000):
    """Edges only out of nodes 0..99: on 3 chunks one src chunk holds every
    edge (SELL: its one wide slice; edge tiles: the first node tile) and
    the other two hold none."""
    rng = np.random.default_rng(3)
    dst = np.sort(rng.integers(0, n, size=3000))
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    return row_ptr, rng.integers(0, 100, size=3000).astype(np.int32), n


K4_CASES = {
    # case: (make, num_chunks, h, d)
    "uniform": (LAYOUTS["chunked"][0], 3, 4, 16),
    "zipf-split": (LAYOUTS["zipf-split-chunked"][0], 3, 2, 32),
    "zero-edge-chunks": (_few_sources, 3, 3, 8),
}


def _jax_k4(zs, zd, g, sigma, r, a, st, chunk):
    """JAX's K4 (_sell_bwd_src, interpret mode) on one src chunk, with its
    inputs built as the JAX op's chunked backward (body2) builds them:
    lane-padded node tables with an appended zero row, the zd, g and
    [sigma | r] streams gathered per slot by global dst id, the chunk's
    resident zs rows gathered through the src side's perm."""
    h, d = a.shape
    hd = -(-h * d // 128) * 128
    n_pad = st.padded_num_nodes
    zs_z = _lane_table(zs, st.padded_src_nodes, hd)
    zd_z, g_z = (_lane_table(x, n_pad, hd) for x in (zd, g))
    sr = np.zeros((n_pad + 1, 128), np.float32)
    sr[: sigma.shape[0], :h] = sigma
    sr[: r.shape[0], jsa.STATS_L : jsa.STATS_L + h] = r
    a2, bdiag, rsig, rr, _, a_rep = jsa._sell_matrices(jnp.asarray(a), hd)
    rows_c = st.spc_src * TILE_N
    ids = jnp.asarray(st.srcs.ids_grp[chunk])
    perm = jnp.asarray(st.srcs.perm[chunk * rows_c : (chunk + 1) * rows_c])
    dzs = jsa._sell_bwd_src(
        jnp.take(zd_z, ids, axis=0), jnp.take(g_z, ids, axis=0),
        jnp.take(jnp.asarray(sr), ids, axis=0), jnp.take(zs_z, perm, axis=0),
        a2, bdiag, jnp.concatenate([rsig, rr], axis=1), a_rep,
        jnp.asarray(st.srcs.rel_off[chunk]), st.spc_src, negative_slope=SLOPE,
        hd=hd, precision="highest", interpret=True,
    )
    return np.asarray(dzs)[:, : h * d]


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_twin_matches_jax_kernel(case):
    make, chunks, h, d = K4_CASES[case]
    row_ptr, col_idx, n = make()
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    assert st.num_chunks == chunks
    zs, zd, a = _zza(n, h, d, 7)
    g = np.random.default_rng(107).normal(size=zs.shape).astype(np.float32)
    out, sigma = tsa.sell_forward(
        *(torch.from_numpy(x) for x in (zs, zd, a)), n, negative_slope=SLOPE,
        sell_tiles=st)
    r = (torch.from_numpy(g) * out).view(n, h, d).sum(-1).numpy()
    inputs = (zs, zd, g, sigma.numpy(), r, a)
    side, rows_c = st.srcs, st.spc_src * TILE_N
    tol = SPLIT_GRAD_TOL if side.split else GRAD_TOL
    empty_chunks = 0
    for c in range(chunks):
        before = sell_bwd_src.launches
        dzs = sell_bwd_src(
            *(torch.from_numpy(x) for x in (
                *inputs, side.perm[c * rows_c : (c + 1) * rows_c],
                side.ids_grp[c], side.cnt_grp[c], side.rel_off[c])),
            negative_slope=SLOPE,
        ).numpy()
        assert sell_bwd_src.launches == before  # the CPU runs the twin
        np.testing.assert_allclose(dzs, _jax_k4(*inputs, st, c), **tol)
        if not side.rel_off[c].any():  # a chunk without an edge: exactly 0
            empty_chunks += 1
            assert (dzs == 0).all()
    assert empty_chunks == (2 if case == "zero-edge-chunks" else 0)


def _h20_graph():
    g = random_graph(150, 600, 8, 3, seed=9)
    return g.row_ptr, g.col_idx, g.num_nodes


GRAD_CASES = {
    # case: (make, h, d, flat, streams, num_chunks)
    "uniform": (LAYOUTS["uniform"][0], 4, 16, False, "f32", 1),
    "zipf-split": (LAYOUTS["zipf-split"][0], 2, 32, True, "f32", 1),
    "isolated": (LAYOUTS["isolated"][0], 2, 16, False, "f32", 1),
    "zero-edge": (LAYOUTS["zero-edge"][0], 2, 8, True, "f32", 1),
    "h20": (_h20_graph, 20, 8, True, "f32", 1),
    "zipf-split-bf16": (LAYOUTS["zipf-split"][0], 3, 24, False, "bf16", 1),
    # chunked layouts: K2 per dst chunk without packets, K4 per src chunk
    "h20-chunked": (LAYOUTS["chunked"][0], 20, 8, True, "f32", 3),
    "chunked-bf16": (LAYOUTS["chunked"][0], 3, 24, False, "bf16", 3),
}


def _jax_grads(fn, zs, zd, a):
    def loss(zs_, zd_, a_):
        return jnp.sum(jnp.sin(fn(zs_, zd_, a_)))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(v) for v in (zs, zd, a)))]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_sell_attention_grads_match_jax(case):
    make, h, d, flat, streams, chunks = GRAD_CASES[case]
    row_ptr, col_idx, n = make()
    shape = (n, h * d) if flat else (n, h, d)
    zs, zd, a = _zza(n, h, d, 4)
    zs, zd = zs.reshape(shape), zd.reshape(shape)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    assert st.num_chunks == chunks
    x = [torch.from_numpy(v).requires_grad_() for v in (zs, zd, a)]
    out = tsa.sell_attention(*x, n, negative_slope=SLOPE, sell_tiles=st,
                             streams=streams)
    torch.sin(out).sum().backward()
    got = [v.grad.numpy() for v in x]

    j_st = jsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    want_sell = _jax_grads(lambda zs_, zd_, a_: jsa.sell_attention(
        zs_, zd_, a_, None, None, n, negative_slope=SLOPE, sell_tiles=j_st,
        interpret=True, streams=streams), zs, zd, a)
    tol = SPLIT_GRAD_TOL if st.dst.split or st.srcs.split else GRAD_TOL
    for p, q in zip(got, want_sell):
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p, q, **tol)
    if streams == "f32":
        # the JAX suite holds bf16 streams against the exact kernels on
        # rounded inputs only: rounding makes ties at s == 0 likely, where
        # the oracle's autodiff takes the other LeakyReLU branch
        src = jnp.asarray(col_idx, jnp.int32)
        dst = jnp.asarray(np.repeat(np.arange(n, dtype=np.int32),
                                    np.diff(row_ptr)))
        want_xla = _jax_grads(lambda zs_, zd_, a_: _edge_attention_xla(
            zs_.reshape(n, h, d), zd_.reshape(n, h, d), a_, src, dst, n,
            negative_slope=SLOPE).reshape(shape), zs, zd, a)
        for p, q in zip(got, want_xla):
            np.testing.assert_allclose(p, q, **tol)
    empty = np.diff(row_ptr) == 0
    assert (got[1].reshape(n, -1)[empty] == 0).all()  # no in-edge: no d_zd


@pytest.mark.parametrize("case", ["chunked", "zipf-split-chunked"])
def test_chunked_layout_backward_raises_k4(case):
    """The backward on a chunked layout (K2 per dst chunk without packets,
    K4 per src chunk) against the JAX op's chunked backward, and against
    the port's own unchunked backward; inference on the chunked layout
    still runs."""
    make, chunks = LAYOUTS[case]
    row_ptr, col_idx, n = make()
    zs, zd, a = _zza(n, 2, 16, 5)
    got = {}
    for g in (1, chunks):
        st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=g)
        x = [torch.from_numpy(v).requires_grad_() for v in (zs, zd, a)]
        out = tsa.sell_attention(*x, n, negative_slope=SLOPE, sell_tiles=st)
        torch.sin(out).sum().backward()
        got[g] = [v.grad.numpy() for v in x]
    j_st = jsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    want = _jax_grads(lambda zs_, zd_, a_: jsa.sell_attention(
        zs_, zd_, a_, None, None, n, negative_slope=SLOPE, sell_tiles=j_st,
        interpret=True), zs, zd, a)
    tol = SPLIT_GRAD_TOL if st.dst.split or st.srcs.split else GRAD_TOL
    for p, q, u in zip(got[chunks], want, got[1]):
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p, q, **tol)
        np.testing.assert_allclose(p, u, **tol)
    with torch.no_grad():  # inference on a chunked layout
        out = tsa.sell_attention(*(torch.from_numpy(v) for v in (zs, zd, a)),
                                 n, negative_slope=SLOPE, sell_tiles=st)
    assert out.shape == (n, 32) and bool(torch.isfinite(out).all())
