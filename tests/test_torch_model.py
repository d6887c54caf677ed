"""The port's segment ops, edge attention, model and parameter IO
(gatv2_tpu_torch) against the JAX package, on the same numpy inputs and the
same parameters carried across by params_from_numpy. Tolerance: fp32
allclose, rtol = atol = 1e-5 (sums run in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu import config as jconfig
from gatv2_tpu.models import gatv2 as jmodel
from gatv2_tpu.models import params_io as jpio
from gatv2_tpu.ops import segment as jseg
from gatv2_tpu.ops import sell_attention as jsa
from gatv2_tpu.ops.attention import _edge_attention_xla
from gatv2_tpu_torch import config as tconfig
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models import gatv2 as tmodel
from gatv2_tpu_torch.models import params_io as tpio
from gatv2_tpu_torch.ops import segment as tseg
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.attention import edge_attention

RTOL = ATOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    ids[ids == 7] = 8  # segment 7 stays empty
    data = rng.normal(size=(200, 3)).astype(np.float32)
    t_ids, t_data = torch.from_numpy(ids), torch.from_numpy(data)
    j_ids, j_data = jnp.asarray(ids), jnp.asarray(data)
    for tf, jf in ((tseg.segment_sum, jseg.segment_sum),
                   (tseg.segment_max, jseg.segment_max),
                   (tseg.segment_softmax, jseg.segment_softmax)):
        got = tf(t_data, t_ids, 30).numpy()
        want = np.asarray(jf(j_data, j_ids, 30))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isneginf(tseg.segment_max(t_data, t_ids, 30)[7].numpy()).all()


@pytest.mark.parametrize("graph", ["uniform", "powerlaw-isolated"])
def test_torch_edge_attention_matches_xla(graph):
    g = (random_graph(40, 160, 12, 3, seed=7) if graph == "uniform"
         else powerlaw_graph(300, 1500, 4, 3, seed=2))
    n = g.num_nodes
    rng = np.random.default_rng(1)
    zs, zd = (rng.normal(size=(n, 3, 8)).astype(np.float32) for _ in range(2))
    a = rng.normal(size=(3, 8)).astype(np.float32)
    got = edge_attention(
        *(torch.from_numpy(x) for x in (zs, zd, a, g.src, g.dst)), n,
        negative_slope=0.2, impl="torch",
    ).numpy()
    want = np.asarray(_edge_attention_xla(
        *(jnp.asarray(x) for x in (zs, zd, a, g.src, g.dst)), n,
        negative_slope=0.2,
    ))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    isolated = np.diff(g.row_ptr) == 0
    assert (got[isolated] == 0).all()


def _configs(num_layers, heads, out_dims, variant, g):
    kw = dict(num_layers=num_layers, heads=heads, out_dims=out_dims,
              variant=variant, num_classes=g.num_classes,
              in_dim=g.feature_dim)
    return jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)


@pytest.mark.parametrize("variant,num_layers,heads,out_dims", [
    ("edge", 2, (2, 1), (8, 6)),
    ("node", 2, (2, 1), (8, 6)),
    ("edge", 3, (4, 1, 1), (8, 4, 4)),
    ("node", 3, (3, 2, 1), (4, 4, 6)),
])
def test_model_forward_matches_jax(variant, num_layers, heads, out_dims):
    g = powerlaw_graph(400, 3000, 12, 4, seed=3) if num_layers == 3 \
        else random_graph(300, 1400, 12, 4, seed=5)
    jcfg, tcfg = _configs(num_layers, heads, out_dims, variant, g)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(num_layers))
    params = tpio.params_from_numpy(_np_tree(jparams))
    n = g.num_nodes

    # the JAX xla path takes 128-padded edges (padding dst = n is dropped)
    src_pad = np.zeros(-(-g.num_edges // 128) * 128, np.int32)
    dst_pad = np.full_like(src_pad, n)
    src_pad[: g.num_edges], dst_pad[: g.num_edges] = g.src, g.dst
    j_xla = np.asarray(jmodel.model_forward(
        jparams, jnp.asarray(g.features), jnp.asarray(src_pad),
        jnp.asarray(dst_pad), jcfg, impl="xla"))
    j_st, j_feats, _, _ = jsa.setup_full_graph_sell(g, heads, out_dims)
    j_sell = np.asarray(jmodel.model_forward(
        jparams, jnp.asarray(j_feats), None, None, jcfg, impl="sell",
        edge_tiles=j_st))[:n]

    t_torch = tmodel.model_forward(
        params, g.features, g.src, g.dst, tcfg, impl="torch", device="cpu"
    ).detach().numpy()
    st, feats, _, _ = tsa.setup_full_graph_sell(g, heads, out_dims,
                                                device="cpu")
    with torch.inference_mode():
        t_sell = tmodel.model_forward(
            params, feats, None, None, tcfg, impl="sell", edge_tiles=st,
            device="cpu",
        )[:n].numpy()
    np.testing.assert_allclose(t_torch, j_xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_sell, j_sell, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_sell, j_xla, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_valid", [None, 90])
def test_loss_and_accuracy_matches_jax(num_valid):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(100, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 100).astype(np.int32)
    if num_valid is not None:
        labels[num_valid:] = -1
    got = tmodel.loss_and_accuracy(torch.from_numpy(logits), labels, num_valid)
    want = jmodel.loss_and_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                    num_valid)
    for x, y in zip(got, want):
        np.testing.assert_allclose(float(x), float(y), rtol=RTOL, atol=ATOL)


def test_init_params_shapes_limits_and_seed():
    cfg = tconfig.ModelConfig(num_layers=2, heads=(2, 1), out_dims=(8, 6),
                              num_classes=3, in_dim=12)
    m1 = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    m2 = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    m3 = tmodel.init_params(cfg, torch.Generator().manual_seed(1))
    assert m1.layers[0].w_src.shape == (2, 8, 12)
    assert m1.layers[1].w_dst.shape == (1, 6, 16)
    assert m1.layers[1].a.shape == (1, 6) and m1.w_o.shape == (3, 6)
    lim0 = np.sqrt(6.0 / (2 * 12 + 8))
    assert float(m1.layers[0].w_src.detach().abs().max()) <= lim0
    assert float(m1.w_o.detach().abs().max()) <= np.sqrt(6.0 / (3 + 6))
    for p, q, r in zip(m1.parameters(), m2.parameters(), m3.parameters()):
        assert torch.equal(p, q) and not torch.equal(p, r)


def test_params_txt_round_trips_both_ways(tmp_path):
    cfg_kw = dict(num_layers=2, heads=(2, 1), out_dims=(8, 6), num_classes=3,
                  in_dim=12)
    jcfg = jconfig.ModelConfig(**cfg_kw)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    jpio.save_params_txt(tmp_path / "jax", jparams)
    port = tpio.load_params_txt(tmp_path / "jax", tconfig.ModelConfig(**cfg_kw))
    want = _np_tree(jparams)
    for layer, lp in zip(port.layers, want["layers"]):
        for k in ("w_src", "w_dst", "a"):
            assert np.array_equal(getattr(layer, k).detach().numpy(), lp[k])
    assert np.array_equal(port.w_o.detach().numpy(), want["w_o"])

    tpio.save_params_txt(tmp_path / "port", port)
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes()
    back = _np_tree(jpio.load_params_txt(tmp_path / "port", jcfg))
    assert np.array_equal(back["w_o"], want["w_o"])


def test_fused_split_round_trip_matches_jax():
    jcfg = jconfig.ModelConfig(num_layers=2, heads=(2, 1), out_dims=(8, 6),
                               num_classes=3, in_dim=12)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(5))
    port = tpio.params_from_numpy(_np_tree(jparams))
    fused = tpio.params_to_fused(port)
    jfused = _np_tree(jpio.params_to_fused(jparams))
    for lp, jlp in zip(fused["layers"], jfused["layers"]):
        assert np.array_equal(lp["w"].detach().numpy(), jlp["w"])
    back = tpio.params_from_fused(fused)
    for p, q in zip(back.parameters(), port.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="even"):
        tpio.fused_to_split(torch.zeros(1, 2, 3))


def test_precision_tiers():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(20, 7)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    assert torch.equal(tmodel.dense(x, w, "highest"), x @ w.T)
    want = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
    assert torch.equal(tmodel.dense(x, w, "default"), want)
    tmodel.dense(x, w, "high")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    cfg = dataclasses.replace(tconfig.ModelConfig(), matmul_precision="high")
    assert cfg.precision == "high"
