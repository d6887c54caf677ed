"""The port's merged-softmax ops (ops/sell_attention.sell_attention_merge,
ops/pallas_attention.edge_attention_pallas_merge; on the CPU through the
plain twins of K1-K3 and K5-K7) against the JAX package's, run in
interpret mode, on two hand-built passes over one destination space: a
LOCAL pass whose sources are the destination nodes themselves and a HALO
pass whose sources index a separate table, as the overlapped sharded
layer builds them. Also: each merge against the port's single-pass op on
the union of both passes, and K5's twin with normalize=False against the
JAX kernel's _forward_chunk(normalize=False).

Tolerances: forward 1e-5 (rtol and atol), gradients rtol 5e-4 / atol 1e-6
(tests/test_sharding.py:147, the JAX suite's sharded-gradient bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu.ops import pallas_attention as jpa
from gatv2_tpu.ops import sell_attention as jsa
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd

SLOPE = 0.2
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-4, atol=1e-6)


def _passes(n=300, m=90, seed=0):
    """Two passes over n destination nodes: local edges (sources among the
    n nodes) and halo edges (sources among m halo rows). Nodes 0..19 have
    no in-edge, nodes 20..39 local edges only, nodes 40..59 halo edges
    only. Returns [(row_ptr, col, n_src)] x 2."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n_src in enumerate((n, m)):
        deg = rng.integers(0, 6, size=n)
        deg[:20] = 0
        deg[20 + 20 * (1 - k): 40 + 20 * (1 - k)] = 0
        deg[150] = 40 + 30 * k  # a busier row in each pass
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        col = rng.integers(0, n_src, size=int(row_ptr[-1])).astype(np.int32)
        out.append((row_ptr, col, n_src))
    return out


def _inputs(n, m, h, d, seed):
    rng = np.random.default_rng(seed)
    zs_loc, zd, w = (rng.standard_normal((n, h * d)).astype(np.float32)
                     for _ in range(3))
    zs_halo = rng.standard_normal((m, h * d)).astype(np.float32)
    a = (rng.standard_normal((h, d)) / np.sqrt(d)).astype(np.float32)
    return zs_loc, zs_halo, zd, a, w


def _layouts(kind, passes, n, package):
    if kind == "sell":
        return [package.prepare_sell_tiles(rp, col, n, num_src_nodes=ns,
                                           split_cap=None)
                for rp, col, ns in passes]
    return [package.prepare_edge_tiles(rp, col, n, num_src_nodes=ns)
            for rp, col, ns in passes]


def _jax_merge(kind, zs_loc, zs_halo, zd, a, w, n, layouts):
    args = tuple(jnp.asarray(x) for x in (zs_loc, zs_halo, zd, a))

    def f(zl, zh, zd_, a_):
        if kind == "sell":
            return jsa.sell_attention_merge(
                (zl, zh), zd_, a_, n, negative_slope=SLOPE,
                sell_tiles_parts=layouts, interpret=True)
        return jpa.edge_attention_pallas_merge(
            (zl, zh), zd_, a_, n, negative_slope=SLOPE,
            edge_tiles_parts=layouts, interpret=True)

    out = f(*args)
    grads = jax.grad(lambda *x: jnp.sum(jnp.sin(f(*x) + w)),
                     argnums=(0, 1, 2, 3))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(fn, inputs, w):
    x = [torch.tensor(v, requires_grad=True) for v in inputs]
    out = fn(*x)
    torch.sin(out + torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), [v.grad.numpy() for v in x]


def _port_merge(kind, zs_loc, zs_halo, zd, a, w, n, layouts):
    def fn(zl, zh, zd_, a_):
        if kind == "sell":
            return tsa.sell_attention_merge(
                (zl, zh), zd_, a_, n, negative_slope=SLOPE,
                sell_tiles_parts=layouts)
        return tpa.edge_attention_pallas_merge(
            (zl, zh), zd_, a_, n, negative_slope=SLOPE,
            edge_tiles_parts=layouts)

    return _port(fn, (zs_loc, zs_halo, zd, a), w)


def _single_pass(kind, passes, zs_loc, zs_halo, zd, a, w, n):
    """The port's single-pass op on the union of both passes' edges, the
    sources in one space [local | halo]."""
    (rp1, c1, _), (rp2, c2, m) = passes
    dst = np.concatenate([np.repeat(np.arange(n), np.diff(rp1)),
                          np.repeat(np.arange(n), np.diff(rp2))])
    src = np.concatenate([c1, c2 + n]).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    col = src[order]

    def fn(zl, zh, zd_, a_):
        space = torch.cat([zl, zh])
        if kind == "sell":
            st = tsa.prepare_sell_tiles(row_ptr, col, n, num_src_nodes=n + m)
            return tsa.sell_attention(space, zd_, a_, n, negative_slope=SLOPE,
                                      sell_tiles=st)
        et = tpa.prepare_edge_tiles(row_ptr, col, n, num_src_nodes=n + m)
        return tpa.edge_attention_pallas(space, zd_, a_, n,
                                         negative_slope=SLOPE, edge_tiles=et)

    return _port(fn, (zs_loc, zs_halo, zd, a), w)


@pytest.mark.parametrize("kind,h,d", [("sell", 2, 8), ("pallas", 4, 4)])
def test_merge_matches_jax_and_single_pass(kind, h, d):
    n, m = 300, 90
    passes = _passes(n, m, seed=h * 10 + d)
    inputs = _inputs(n, m, h, d, seed=h + d)
    w = inputs[-1]
    j_lay = _layouts(kind, passes, n, jsa if kind == "sell" else jpa)
    t_lay = _layouts(kind, passes, n, tsa if kind == "sell" else tpa)
    out, grads = _port_merge(kind, *inputs, n, t_lay)
    j_out, j_grads = _jax_merge(kind, *inputs, n, j_lay)
    np.testing.assert_allclose(out, j_out, **FWD)
    for name, got, want in zip(("dzs_loc", "dzs_halo", "dzd", "da"), grads,
                               j_grads):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD)
    s_out, s_grads = _single_pass(kind, passes, *inputs[:4], w, n)
    np.testing.assert_allclose(out, s_out, **FWD)
    for name, got, want in zip(("dzs_loc", "dzs_halo", "dzd", "da"), grads,
                               s_grads):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD)
    # nodes without an in-edge in either pass: output and d_zd exactly 0
    assert (out[:20] == 0).all() and (grads[2][:20] == 0).all()


def test_merge_guards():
    n = 300
    passes = _passes(n)
    split = [tsa.prepare_sell_tiles(rp, col, n, num_src_nodes=ns)
             for rp, col, ns in passes]
    zs = [torch.zeros(p[2], 8) for p in passes]
    with pytest.raises(ValueError, match="need one SellTiles"):
        tsa.sell_attention_merge(zs[:1], torch.zeros(n, 8),
                                 torch.zeros(2, 4), n, negative_slope=SLOPE,
                                 sell_tiles_parts=split)
    with pytest.raises(ValueError, match="at most 16 heads"):
        tsa.sell_attention_merge(
            [torch.zeros(p[2], 17) for p in passes], torch.zeros(n, 17),
            torch.zeros(17, 1), n, negative_slope=SLOPE,
            sell_tiles_parts=_layouts("sell", passes, n, tsa))
    chunked = [tpa.prepare_edge_tiles(rp, col, n, num_src_nodes=ns,
                                      num_chunks=2)
               for rp, col, ns in passes]
    with pytest.raises(ValueError, match="num_chunks == 1"):
        tpa.edge_attention_pallas_merge(zs, torch.zeros(n, 8),
                                        torch.zeros(2, 4), n,
                                        negative_slope=SLOPE,
                                        edge_tiles_parts=chunked)


def test_k5_unnormalised_matches_jax_kernel():
    """K5's twin with normalize=False: the raw accumulator, m and l against
    the JAX kernel's _forward_chunk(normalize=False), a row of 300 edges
    (three edge tiles) and nodes without an in-edge included."""
    from test_torch_pallas import _hub_and_isolated

    row_ptr, col, n = _hub_and_isolated()
    h, d = 4, 8
    rng = np.random.default_rng(5)
    zs, zd = (rng.standard_normal((n, h * d)).astype(np.float32)
              for _ in range(2))
    a = (rng.standard_normal((h, d)) / np.sqrt(d)).astype(np.float32)
    et_j = jpa.prepare_edge_tiles(row_ptr, col, n)
    et_t = tpa.prepare_edge_tiles(row_ptr, col, n)
    side = et_j.dst_side
    rows, hd = et_j.tiles_per_chunk * 128, 128
    pad = lambda x, r: jnp.zeros((r, hd), jnp.float32).at[
        : x.shape[0], : x.shape[1]].set(jnp.asarray(x))
    zs_e = jnp.take(pad(zs, n), side.other_grp[0], axis=0)
    zd_e = jnp.take(pad(zd, rows + 1), jnp.minimum(side.ids_grp[0], rows),
                    axis=0)
    a_sel, r_mat, _ = jpa._head_matrices(jnp.asarray(a), hd)
    j_u, j_m, j_l = jpa._forward_chunk(
        zs_e, zd_e, side.ids_grp[0][None, :], side.rel_offsets[0], a_sel,
        r_mat, num_heads=h, negative_slope=SLOPE, te=et_j.tile_e,
        precision="highest", interpret=True, normalize=False)
    s = et_t.to("cpu").dst_side
    args = (torch.tensor(zs), torch.tensor(zd), torch.tensor(a),
            s.ids_grp[0], s.other_grp[0], s.rel_offsets[0], et_t.tile_e)
    u, m, l = pallas_fwd(*args, negative_slope=SLOPE, normalize=False)
    np.testing.assert_allclose(u.numpy(), np.asarray(j_u)[:, : h * d], **FWD)
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m)[:, :h], **FWD)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l)[:, :h], **FWD)
    no_in = np.diff(row_ptr) == 0
    assert (u.numpy()[:n][no_in] == 0).all()
    assert (m.numpy()[:n][no_in] == -1e30).all()
    # normalising the raw accumulator gives the normalised output
    out, _, _ = pallas_fwd(*args, negative_slope=SLOPE)
    np.testing.assert_allclose(
        out.numpy(), (u / (l.repeat_interleave(d, 1) + 1e-8)).numpy(),
        rtol=1e-6, atol=1e-7)
