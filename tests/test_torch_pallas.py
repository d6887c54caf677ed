"""The port's streamed-operand attention (ops/pallas_attention.py, on the
CPU through the plain twins of K5, K6 and K7) against the JAX package's
edge_attention_pallas run in interpret mode, and against the port's own
torch path, on the same numpy inputs. Also: K5's softmax statistics against
the JAX kernel's, K8's twin against the JAX kernel, the chunked forward and
backward, and impl='pallas' through the model.

Tolerances are the JAX suite's for its pallas path
(tests/test_pallas_attention.py): forward rtol 2e-5 / atol 2e-6, gradients
rtol 2e-5 / atol 5e-6 (degree-1 nodes' true d_zd is 0, and the +1e-8
softmax denominator leaves a residue the two formulations round apart).
The JAX suite's graph has 160 edges and gradients of order 1; here d_a sums
one term per edge (up to 3000, |d_a| up to ~100) and a hub's d_zs one per
out-edge, and fp32 rounds such a sum in its own scale, so each gradient's
atol is 5e-6 times its largest magnitude (at least 1). Both packages
compute in fp32 at the 'highest' tier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu.ops import pallas_attention as jpa
from gatv2_tpu_torch.config import ModelConfig
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models.gatv2 import init_params, model_forward
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops.attention import edge_attention
from gatv2_tpu_torch.ops.pallas_bwd_src import pallas_bwd_src
from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd
from test_torch_sell_bwd import _few_sources

SLOPE = 0.2
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_RTOL, GRAD_ATOL = 2e-5, 5e-6


def _assert_grad_close(got, want, name):
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=name)


def _hub_and_isolated(n=300):
    """Node 150 a hub of in-degree 300 (three edge tiles in one node tile),
    nodes 0..59 without an in-edge."""
    rng = np.random.default_rng(7)
    deg = np.zeros(n, np.int64)
    deg[60:] = rng.integers(1, 4, size=n - 60)
    deg[150] = 300
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col = rng.integers(0, n, size=int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col, n


def _minibatch_shaped(max_nodes=640, budget=30):
    """A sampled batch's layout: 640 padded nodes of which 290 are real and
    only 180 have in-edges, a fixed edge-tile budget, node tiles 3 and 4
    without an edge."""
    rng = np.random.default_rng(8)
    dst = np.sort(rng.integers(0, 180, size=900)).astype(np.int32)
    src = rng.integers(0, 290, size=900).astype(np.int32)
    row_ptr = np.zeros(max_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=max_nodes), out=row_ptr[1:])
    return row_ptr, src, max_nodes, dict(tile_e=128, fixed_edge_tiles=budget)


def _case(name):
    """(row_ptr, col_idx, n, layout options); a '-chunked' name is the
    same graph on 3 chunks."""
    if name.endswith("-chunked"):
        *csr, opts = _case(name[: -len("-chunked")])
        return (*csr, dict(opts, num_chunks=3))
    if name == "few-sources":
        return (*_few_sources(), {})
    if name == "uniform":
        g = random_graph(300, 1500, 4, 3, seed=1)
        return g.row_ptr, g.col_idx, g.num_nodes, {}
    if name == "power-law":
        g = powerlaw_graph(400, 3000, 4, 3, seed=2, alpha=1.2)
        return g.row_ptr, g.col_idx, g.num_nodes, {}
    if name == "hub-isolated":
        return (*_hub_and_isolated(), {})
    return _minibatch_shaped()


CASES = [("uniform", 4, 16), ("uniform", 20, 4), ("power-law", 2, 24),
         ("hub-isolated", 4, 8), ("minibatch", 3, 16),
         # chunked layouts: K6 per dst chunk without packets, K8 per src chunk
         ("power-law-chunked", 2, 24), ("uniform-chunked", 20, 4)]


def _inputs(n, h, d, seed):
    rng = np.random.default_rng(seed)
    zs, zd, w = (rng.standard_normal((n, h * d)).astype(np.float32)
                 for _ in range(3))
    a = (rng.standard_normal((h, d)) / np.sqrt(d)).astype(np.float32)
    return zs, zd, a, w


def _jax_op(zs, zd, a, w, n, et):
    """(out, (dzs, dzd, da)) of the JAX op in interpret mode, with the loss
    sum(sin(out + w)) (the JAX suite's sum(sin(out)), shifted per element)."""
    args = tuple(jnp.asarray(x) for x in (zs, zd, a))

    def f(zs_, zd_, a_):
        return jpa.edge_attention_pallas(
            zs_, zd_, a_, None, None, n, negative_slope=SLOPE, edge_tiles=et,
            interpret=True)

    out = f(*args)
    grads = jax.grad(lambda *x: jnp.sum(jnp.sin(f(*x) + w)),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_op(zs, zd, a, w, n, et, impl="pallas", row_ptr=None, col=None):
    x = [torch.tensor(v, requires_grad=True) for v in (zs, zd, a)]
    if impl == "pallas":
        out = tpa.edge_attention_pallas(*x, n, negative_slope=SLOPE,
                                        edge_tiles=et)
    else:
        h, d = a.shape
        dst = np.repeat(np.arange(n), np.diff(row_ptr))
        out = edge_attention(
            x[0].view(n, h, d), x[1].view(n, h, d), x[2],
            torch.as_tensor(col), torch.as_tensor(dst), n,
            negative_slope=SLOPE, impl="torch").reshape(n, h * d)
    torch.sin(out + torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), [v.grad.numpy() for v in x]


@pytest.mark.parametrize("case,h,d", CASES)
def test_op_matches_jax_and_torch(case, h, d):
    row_ptr, col, n, opts = _case(case)
    zs, zd, a, w = _inputs(n, h, d, seed=h * 100 + d)
    et_j = jpa.prepare_edge_tiles(row_ptr, col, n, **opts)
    et_t = tpa.prepare_edge_tiles(row_ptr, col, n, **opts)
    out, grads = _port_op(zs, zd, a, w, n, et_t)
    j_out, j_grads = _jax_op(zs, zd, a, w, n, et_j)
    np.testing.assert_allclose(out, j_out, **FWD_TOL)
    for name, got, want in zip(("dzs", "dzd", "da"), grads, j_grads):
        _assert_grad_close(got, want, name)
    r_out, r_grads = _port_op(zs, zd, a, w, n, None, impl="torch",
                              row_ptr=row_ptr, col=col)
    np.testing.assert_allclose(out, r_out, **FWD_TOL)
    for name, got, want in zip(("dzs", "dzd", "da"), grads, r_grads):
        _assert_grad_close(got, want, name)
    # nodes without an in-edge: output and d_zd exactly 0
    no_in = np.diff(row_ptr) == 0
    assert (out[no_in] == 0).all() and (grads[1][no_in] == 0).all()


def test_forward_stats_match_jax_kernel():
    """K5's m and l (the backward's residuals, invisible in the op's
    output) against the JAX kernel's real head lanes, a hub spanning
    several edge tiles included."""
    row_ptr, col, n = _hub_and_isolated()
    h, d = 4, 8
    zs, zd, a, _ = _inputs(n, h, d, seed=3)
    et_j = jpa.prepare_edge_tiles(row_ptr, col, n)
    et_t = tpa.prepare_edge_tiles(row_ptr, col, n)
    side = et_j.dst_side
    rows = et_j.tiles_per_chunk * 128
    hd = 128
    pad = lambda x, r: jnp.zeros((r, hd), jnp.float32).at[
        : x.shape[0], : x.shape[1]].set(jnp.asarray(x))
    zs_e = jnp.take(pad(zs, n), side.other_grp[0], axis=0)
    zd_e = jnp.take(pad(zd, rows + 1), jnp.minimum(side.ids_grp[0], rows),
                    axis=0)
    a_sel, r_mat, _ = jpa._head_matrices(jnp.asarray(a), hd)
    _, j_m, j_l = jpa._forward_chunk(
        zs_e, zd_e, side.ids_grp[0][None, :], side.rel_offsets[0], a_sel,
        r_mat, num_heads=h, negative_slope=SLOPE, te=et_j.tile_e,
        precision="highest", interpret=True)
    s = et_t.to("cpu").dst_side
    _, m, l = pallas_fwd(torch.tensor(zs), torch.tensor(zd), torch.tensor(a),
                         s.ids_grp[0], s.other_grp[0], s.rel_offsets[0],
                         et_t.tile_e, negative_slope=SLOPE)
    np.testing.assert_allclose(m.numpy(), np.asarray(j_m)[:, :h], **FWD_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l)[:, :h], **FWD_TOL)
    no_in = np.diff(row_ptr) == 0
    assert (m.numpy()[:n][no_in] == -1e30).all()
    assert (l.numpy()[:n][no_in] == 0).all()


def _jax_k8(zs, zd, g, sr, a, et, chunk):
    """JAX's K8 (_bwd_src_chunk, interpret mode) on one src chunk, with its
    inputs built as the JAX op's chunked backward (body2) builds them:
    lane-padded node tables, the zd, g and sigma_r streams gathered per
    edge by global dst id, the chunk's zs rows gathered by chunk-relative
    src id with an appended zero row."""
    h, d = a.shape
    hd = 128 * -(-h * d // 128)
    rows_cs = et.padded_src_nodes // et.num_chunks

    def table(x, rows, lanes=hd):
        return jnp.zeros((rows, lanes), jnp.float32).at[
            : x.shape[0], : x.shape[1]].set(jnp.asarray(x))

    zs_flat = table(zs, et.padded_src_nodes)
    zd_flat, g_flat = (table(x, et.padded_num_nodes) for x in (zd, g))
    sig_r = table(sr, et.padded_num_nodes, 128)
    side = et.src_side
    sids = jnp.asarray(side.ids_grp[chunk])
    dids = jnp.asarray(side.other_grp[chunk])
    zs_z = jnp.concatenate([zs_flat[chunk * rows_cs: (chunk + 1) * rows_cs],
                            jnp.zeros((1, hd), jnp.float32)])
    a_sel, r_mat, a_rep = jpa._head_matrices(jnp.asarray(a), hd)
    dzs = jpa._bwd_src_chunk(
        jnp.take(zs_z, jnp.minimum(sids, rows_cs), axis=0),
        jnp.take(zd_flat, dids, axis=0), jnp.take(g_flat, dids, axis=0),
        jnp.take(sig_r, dids, axis=0), sids[None, :],
        jnp.asarray(side.rel_offsets[chunk]), a_sel, r_mat, a_rep,
        rows_cs // 128, num_heads=h, negative_slope=SLOPE, te=et.tile_e,
        precision="highest", interpret=True)
    return np.asarray(dzs)[:, : h * d]


@pytest.mark.parametrize("case,h,d", [
    ("uniform", 4, 16), ("power-law", 2, 24), ("few-sources", 3, 8)])
def test_k8_twin_matches_jax_kernel(case, h, d):
    """K8's twin on every src chunk of a 3-chunk layout against the JAX
    kernel: uniform degrees, power-law out-hubs, and chunks without an
    edge (whose dzs is exactly 0)."""
    row_ptr, col, n, _ = _case(case)
    et = tpa.prepare_edge_tiles(row_ptr, col, n, num_chunks=3)
    zs, zd, a, g = _inputs(n, h, d, seed=9)
    t_et = et.to("cpu")
    _, m, l = tpa.pallas_forward(torch.tensor(zs), torch.tensor(zd),
                                 torch.tensor(a), t_et, n, SLOPE)
    out = tpa.pallas_forward(torch.tensor(zs), torch.tensor(zd),
                             torch.tensor(a), t_et, n, SLOPE)[0]
    r = (torch.tensor(g) * out).view(n, h, d).sum(-1)
    sr = tpa.sigma_r_table(m + torch.log(l + 1e-8), r)
    side = t_et.src_side
    rows_cs = et.padded_src_nodes // et.num_chunks
    empty = 0
    for c in range(et.num_chunks):
        before = pallas_bwd_src.launches
        dzs = pallas_bwd_src(
            torch.tensor(zs)[c * rows_cs:], torch.tensor(zd), torch.tensor(g),
            sr, torch.tensor(a), side.ids_grp[c], side.other_grp[c],
            side.rel_offsets[c], et.tile_e, negative_slope=SLOPE).numpy()
        assert pallas_bwd_src.launches == before  # the CPU runs the twin
        _assert_grad_close(dzs, _jax_k8(zs, zd, g, sr.numpy(), a, et, c),
                           f"dzs chunk {c}")
        if not et.src_side.rel_offsets[c].any():
            empty += 1
            assert (dzs == 0).all()
    assert empty < et.num_chunks and (case != "few-sources" or empty == 2)


def test_chunked_forward_and_k8_error():
    """A chunked layout: the forward (one K5 call per chunk) and, under
    autograd, the gradients (K6 per dst chunk without packets, K8 per src
    chunk) match the JAX package's chunked op; the chunked backward no
    longer raises."""
    g = random_graph(700, 3200, 4, 3, seed=13)
    n, h, d = g.num_nodes, 2, 16
    zs, zd, a, w = _inputs(n, h, d, seed=5)
    et_j = jpa.prepare_edge_tiles(g.row_ptr, g.col_idx, n, num_chunks=3)
    et_t = tpa.prepare_edge_tiles(g.row_ptr, g.col_idx, n, num_chunks=3)
    assert et_t.num_chunks == 3
    want = jpa.edge_attention_pallas(
        *(jnp.asarray(x) for x in (zs, zd, a)), None, None, n,
        negative_slope=SLOPE, edge_tiles=et_j, interpret=True)
    with torch.no_grad():
        got = tpa.edge_attention_pallas(
            *(torch.tensor(x) for x in (zs, zd, a)), n,
            negative_slope=SLOPE, edge_tiles=et_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    out, grads = _port_op(zs, zd, a, w, n, et_t)
    j_out, j_grads = _jax_op(zs, zd, a, w, n, et_j)
    np.testing.assert_allclose(out, j_out, **FWD_TOL)
    for name, p, q in zip(("dzs", "dzd", "da"), grads, j_grads):
        _assert_grad_close(p, q, name)


def test_model_pallas_matches_torch():
    """impl='pallas' through the model (flat projections, padded node grid
    from setup_full_graph) against impl='torch'."""
    g = random_graph(300, 1600, 12, 4, seed=21)
    cfg = ModelConfig(num_layers=2, heads=(3, 1), out_dims=(8, 8),
                      num_classes=g.num_classes, in_dim=g.feature_dim)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    et, feats, _, _ = tpa.setup_full_graph(g, cfg.heads, cfg.out_dims,
                                           device="cpu")
    assert feats.shape[0] == et.padded_num_nodes > g.num_nodes
    with torch.no_grad():
        got = model_forward(model, feats, None, None, cfg, impl="pallas",
                            edge_tiles=et, device="cpu")[: g.num_nodes]
        want = model_forward(model, g.features, g.src, g.dst, cfg,
                             impl="torch", device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="requires edge_tiles"):
        edge_attention(torch.zeros(4, 2), torch.zeros(4, 2),
                       torch.zeros(1, 2), None, None, 4,
                       negative_slope=SLOPE, impl="pallas")
