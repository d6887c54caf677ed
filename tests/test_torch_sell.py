"""The port's SELL path (gatv2_tpu_torch.ops.sell_attention / sell_fwd)
against the JAX package's: layout leaves byte-equal, K1's plain twin against
the JAX kernel run in interpret mode (as tests/test_sell.py runs it), and
the forward op against the JAX op. Tolerance: fp32 allclose with
rtol = atol = 1e-5 (sums run in another order; no other difference)."""

import jax  # noqa: F401  (the JAX package under comparison)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu.ops import sell_attention as jsa
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.ops import build
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.attention import edge_attention
from gatv2_tpu_torch.ops.sell_fwd import sell_fwd

RTOL = ATOL = 1e-5
SLOPE = 0.2
_STATIC = (
    "num_nodes", "num_src_nodes", "num_dst_tiles", "num_src_tiles", "e_ell",
    "e2_ell", "num_edges", "pad_overhead", "num_chunks", "spc_dst", "spc_src",
    "node_pad_dst", "node_pad_src",
)


def _csr(g):
    return g.row_ptr, g.col_idx, g.num_nodes


def _zero_edge(n=10):
    return np.zeros(n + 1, np.int64), np.zeros(0, np.int32), n


def _hub_and_isolated(n=260):
    """Node 0 is a hub (degree 200), nodes 1..50 have no in-edge."""
    rng = np.random.default_rng(7)
    deg = np.zeros(n, np.int64)
    deg[0] = 200
    deg[51:] = rng.integers(0, 4, size=n - 51)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col_idx = rng.integers(0, n, size=int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col_idx, n


LAYOUTS = {
    "uniform": (lambda: _csr(random_graph(500, 2300, 8, 3, seed=11)), 1),
    "zipf-split": (lambda: _csr(powerlaw_graph(800, 9000, 8, 3, seed=17)), 1),
    "chunked": (lambda: _csr(random_graph(700, 3200, 8, 3, seed=13)), 3),
    "zipf-split-chunked": (
        lambda: _csr(powerlaw_graph(900, 12000, 8, 3, seed=6, alpha=1.1)), 3),
    "zero-edge": (_zero_edge, 1),
    "isolated": (_hub_and_isolated, 1),
}


def assert_same_sell_layout(got, want):
    """The port's SellTiles `got` and the JAX package's `want`: every leaf
    numpy on the port's side and byte-equal, every static field equal."""
    for side in ("dst", "srcs"):
        gs, ws = getattr(got, side), getattr(want, side)
        assert gs.split == ws.split
        for f in tsa._SIDE_ARRAYS:
            a, b = getattr(gs, f), np.asarray(getattr(ws, f))
            assert isinstance(a, np.ndarray), (side, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (side, f)
            assert a.tobytes() == b.tobytes(), (side, f)
    assert got.ell_perm.tobytes() == np.asarray(want.ell_perm).tobytes()
    for f in _STATIC:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_leaves_byte_equal(case):
    make, chunks = LAYOUTS[case]
    row_ptr, col_idx, n = make()
    got = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    want = jsa.prepare_sell_tiles(
        row_ptr, col_idx, n, num_chunks=chunks, as_numpy=True
    )
    assert_same_sell_layout(got, want)
    if case == "zipf-split":
        assert got.dst.split and got.srcs.split


def _zza(n, h, d, seed):
    rng = np.random.default_rng(seed)
    zs = rng.normal(size=(n, h * d)).astype(np.float32)
    zd = rng.normal(size=(n, h * d)).astype(np.float32)
    a = rng.normal(size=(h, d)).astype(np.float32)
    return zs, zd, a


def _jax_k1(zs, zd, a, st, normalize):
    """JAX's K1 (_sell_forward, interpret mode) on the unchunked layout
    `st` (numpy leaves), with its inputs built as sell_attention builds
    them: lane-padded to hd, zero row appended, pre-gathered."""
    n_rows, hd_real = zs.shape
    hd = -(-hd_real // 128) * 128

    def table(z, rows):
        t = np.zeros((rows + 1, hd), np.float32)
        t[: z.shape[0], :hd_real] = z
        return jnp.asarray(t)

    zs_z = table(zs, st.padded_src_nodes)
    zd_z = table(zd, st.padded_num_nodes)
    a2, _, _, _, s_sel, _ = jsa._sell_matrices(jnp.asarray(a), hd)
    out, sig = jsa._sell_forward(
        jnp.take(zs_z, jnp.asarray(st.dst.gather_ids), axis=0, mode="clip"),
        jnp.asarray(st.dst.cnt),
        jnp.take(zd_z, jnp.asarray(st.dst.perm), axis=0, mode="clip"),
        a2, s_sel, jnp.asarray(st.dst.col_off), st.num_dst_tiles,
        negative_slope=SLOPE, hd=hd, precision="highest", interpret=True,
        normalize=normalize,
    )
    return np.asarray(out)[:, :hd_real], np.asarray(sig)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("case,h,d", [
    ("uniform", 4, 16), ("zipf-split", 2, 32), ("isolated", 3, 24),
    ("zero-edge", 2, 8),
])
def test_k1_twin_matches_jax_kernel(case, h, d, normalize):
    row_ptr, col_idx, n = LAYOUTS[case][0]()
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n)
    zs, zd, a = _zza(n, h, d, 1)
    side = st.dst
    before = sell_fwd.launches
    out, m, l = sell_fwd(
        *(torch.from_numpy(x) for x in (zs, zd, a, side.perm, side.gather_ids,
                                        side.cnt, side.col_off)),
        negative_slope=SLOPE, normalize=normalize,
    )
    assert sell_fwd.launches == before  # the CPU runs the twin, no launch
    j_out, j_sig = _jax_k1(zs, zd, a, st, normalize)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=RTOL, atol=ATOL)
    if normalize:
        sigma = m + torch.log(l + 1e-8)
        np.testing.assert_allclose(sigma.numpy(), j_sig[:, :h],
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(m.numpy(), j_sig[:, :h], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(l.numpy(), j_sig[:, 16 : 16 + h],
                                   rtol=RTOL, atol=ATOL)


def _jax_op(zs, zd, a, row_ptr, col_idx, n, chunks, flat, streams):
    st = jsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    h, d = a.shape
    shape = (n, h * d) if flat else (n, h, d)
    return np.asarray(jsa.sell_attention(
        jnp.asarray(zs.reshape(shape)), jnp.asarray(zd.reshape(shape)),
        jnp.asarray(a), None, None, n, negative_slope=SLOPE, sell_tiles=st,
        interpret=True, streams=streams,
    ))


@pytest.mark.parametrize("case,h,d,flat,streams", [
    ("uniform", 4, 16, False, "f32"),
    ("zipf-split", 2, 32, True, "f32"),
    ("chunked", 2, 32, True, "f32"),
    ("zipf-split-chunked", 2, 16, False, "f32"),
    ("isolated", 2, 16, False, "f32"),
    ("zero-edge", 2, 8, True, "f32"),
    ("chunked", 2, 32, True, "bf16"),
    ("zipf-split", 3, 24, False, "bf16"),
])
def test_sell_attention_matches_jax(case, h, d, flat, streams):
    make, chunks = LAYOUTS[case]
    row_ptr, col_idx, n = make()
    zs, zd, a = _zza(n, h, d, 2)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks)
    shape = (n, h * d) if flat else (n, h, d)
    out = tsa.sell_attention(
        torch.from_numpy(zs).reshape(shape), torch.from_numpy(zd).reshape(shape),
        torch.from_numpy(a), n, negative_slope=SLOPE, sell_tiles=st,
        streams=streams,
    )
    want = _jax_op(zs, zd, a, row_ptr, col_idx, n, chunks, flat, streams)
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
    if case in ("isolated", "zero-edge"):
        empty = np.diff(row_ptr) == 0
        assert (out.numpy().reshape(n, -1)[empty] == 0).all()


def test_head_groups_match_jax():
    """H=20 at D=32 runs as K1 launches of 16 + 4 heads (the kernel's
    512-lane budget); the JAX op splits the same way (16-head stats)."""
    g = random_graph(150, 600, 8, 3, seed=9)
    zs, zd, a = _zza(g.num_nodes, 20, 32, 3)
    st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, g.num_nodes)
    out, sigma = tsa.sell_forward(
        *(torch.from_numpy(x) for x in (zs, zd, a)), g.num_nodes,
        negative_slope=SLOPE, sell_tiles=st,
    )
    assert sigma.shape == (g.num_nodes, 20)
    want = _jax_op(zs, zd, a, g.row_ptr, g.col_idx, g.num_nodes, 1, True, "f32")
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


def test_sell_matches_torch_path_and_sigma_is_finite():
    """Split hub rows (degree > 256) against the port's torch path, run in
    float64 so that only the SELL path's fp32 rounding is measured."""
    g = powerlaw_graph(1200, 20000, 8, 3, seed=4, alpha=1.2)
    n = g.num_nodes
    zs, zd, a = (torch.from_numpy(x) for x in _zza(n, 2, 32, 21))
    st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, n)
    assert st.dst.split
    out, sigma = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                  sell_tiles=st)
    ref = edge_attention(
        zs.double().view(n, 2, 32), zd.double().view(n, 2, 32), a.double(),
        torch.from_numpy(g.src), torch.from_numpy(g.dst), n,
        negative_slope=SLOPE, impl="torch",
    ).reshape(n, -1).float()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.isfinite(sigma).all()


def test_backward_raises():
    """The backward runs on an unchunked layout (K2 and K3) and on a
    chunked one (K2 per chunk, then K4), with the same gradients: the
    chunked backward no longer raises. Its parity with JAX is
    tests/test_torch_sell_bwd.py."""
    g = random_graph(200, 900, 8, 3, seed=4)
    grads = []
    for chunks in (1, 3):
        zs, zd, a = (torch.from_numpy(x) for x in _zza(g.num_nodes, 2, 8, 5))
        zs.requires_grad_()
        a.requires_grad_()
        st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, g.num_nodes,
                                    num_chunks=chunks)
        assert st.num_chunks == chunks
        out = tsa.sell_attention(zs, zd, a, g.num_nodes, negative_slope=SLOPE,
                                 sell_tiles=st)
        out.sum().backward()
        assert bool(torch.isfinite(zs.grad).all())
        grads.append((zs.grad, a.grad))
    for p, q in zip(*grads):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=RTOL, atol=ATOL)


def test_pallas_impl_not_ported():
    """impl='pallas' is ported now (tests/test_torch_pallas.py): it needs
    its edge tiles, and an unknown impl still raises."""
    z = torch.zeros(4, 1, 2)
    with pytest.raises(ValueError, match="requires edge_tiles"):
        edge_attention(z, z, torch.zeros(1, 2), None, None, 4,
                       negative_slope=SLOPE, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        edge_attention(z, z, torch.zeros(1, 2), None, None, 4,
                       negative_slope=SLOPE, impl="xla")


def test_chunk_budget_forces_chunked_layout():
    """budget_bytes forces the chunked layout; the result does not change."""
    g = random_graph(700, 3200, 8, 3, seed=13)
    st1, f1, _, _ = tsa.setup_full_graph_sell(g, (2,), (32,), device="cpu")
    st3, f3, l3, nv = tsa.setup_full_graph_sell(
        g, (2,), (32,), device="cpu", budget_bytes=200_000
    )
    assert st1.num_chunks == 1 and st3.num_chunks > 1
    assert f3.shape[0] == st3.padded_num_nodes and nv == g.num_nodes
    assert (l3[g.num_nodes:] == -1).all()
    zs, zd, a = (torch.from_numpy(x) for x in _zza(g.num_nodes, 2, 32, 8))
    outs = [tsa.sell_forward(zs, zd, a, g.num_nodes, negative_slope=SLOPE,
                             sell_tiles=st)[0] for st in (st1, st3)]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA toolkit: building the kernel fails loudly."""
    import torch.utils.cpp_extension as ce

    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(ce, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("sell_fwd")
    assert not list(tmp_path.iterdir())
