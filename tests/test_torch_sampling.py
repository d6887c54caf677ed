"""The port's neighbour sampler (data/sampling.py) and native library
(utils/native_loader.py) against the JAX package's: the python engine's
batches byte-identical to the JAX python engine's for the same seed and
budget policy (tiles included); the native engine through the port's own
build of native/*.cpp byte-identical to the JAX native engine; the
sampler's guards; prefetch; and the native text parser against numpy."""

import dataclasses
import shutil

import numpy as np
import pytest

from gatv2_tpu.data import sampling as jsampling
from gatv2_tpu.data.synthetic import random_graph as jrandom_graph
from gatv2_tpu.utils import native_loader as jnative
from gatv2_tpu_torch.data import io as tio
from gatv2_tpu_torch.data import sampling as tsampling
from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.utils import native_loader as tnative
from test_torch_predict import DATA

GRAPH = dict(num_nodes=200, num_edges=800, feature_dim=32, num_classes=4,
             seed=0, planted_signal=2.0)


def _graphs():
    return random_graph(**GRAPH), jrandom_graph(**GRAPH)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native library cannot be built")


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native wrapper, pointed at the port's build of the
    same native/*.cpp sources (so the test writes nothing into native/)."""
    _need_gxx()
    monkeypatch.setattr(jnative, "_LIB_PATH", tnative.build())
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_attempted", False)
    assert jnative.available()


def _assert_batches_equal(tb, jb):
    for f in dataclasses.fields(jsampling.MiniBatch):
        t, j = getattr(tb, f.name), getattr(jb, f.name)
        if f.name == "tiles":
            continue
        if isinstance(j, np.ndarray) or isinstance(t, np.ndarray):
            assert t.dtype == j.dtype and t.shape == j.shape, f.name
            assert np.array_equal(t, j), f.name
        else:
            assert t == j, f.name
    if jb.tiles is None:
        assert tb.tiles is None
        return
    if isinstance(tb.tiles, tsa.SellTiles):
        from test_torch_sell import assert_same_sell_layout

        assert_same_sell_layout(tb.tiles, jb.tiles)
        return
    from test_torch_edge_tiles import _assert_same_layout

    _assert_same_layout(tb.tiles, jb.tiles)


def _epochs(sampler, n=2):
    return [b for _ in range(n) for b in sampler]


@pytest.mark.parametrize("budget", ["auto", "worst", "probe"])
@pytest.mark.parametrize("emit_tiles,gather", [(False, True), (True, False)])
def test_python_engine_byte_identical(budget, emit_tiles, gather):
    tg, jg = _graphs()
    kw = dict(batch_size=48, fanouts=(4, 3), seed=5, engine="python",
              budget=budget, emit_tiles=emit_tiles, gather_features=gather)
    ts = tsampling.NeighborSampler(tg, **kw)
    js = jsampling.NeighborSampler(jg, **kw)
    assert (ts.max_nodes, ts.max_edges, ts._tile_budget) == \
        (js.max_nodes, js.max_edges, js._tile_budget)
    tbs, jbs = _epochs(ts), _epochs(js)
    assert len(tbs) == len(jbs) == 2 * ts.batches_per_epoch()
    for tb, jb in zip(tbs, jbs):
        _assert_batches_equal(tb, jb)


@pytest.mark.parametrize("budget", ["auto", "probe"])
def test_native_engine_byte_identical(jax_native, budget):
    tg, jg = _graphs()
    split = np.arange(200) % 3 != 0
    kw = dict(batch_size=40, fanouts=(5, 5), seed=3, engine="native",
              budget=budget, emit_tiles=True, gather_features=True,
              seed_nodes=np.nonzero(split)[0])
    ts = tsampling.NeighborSampler(tg, **kw)
    js = jsampling.NeighborSampler(jg, **kw)
    assert ts.engine == js.engine == "native"
    for tb, jb in zip(_epochs(ts), _epochs(js)):
        _assert_batches_equal(tb, jb)


def test_auto_engine_is_native():
    _need_gxx()
    s = tsampling.NeighborSampler(random_graph(**GRAPH), 16, (3,))
    assert s.engine == "native"


def test_sampler_guards():
    g = random_graph(**GRAPH)
    s = tsampling.NeighborSampler(g, 16, (3, 3), engine="python")
    with pytest.raises(ValueError, match="unique seed"):
        s.sample(np.array([1, 2, 2]))
    with pytest.raises(ValueError, match="engine"):
        tsampling.NeighborSampler(g, 16, (3,), engine="fast")
    with pytest.raises(ValueError, match="budget"):
        tsampling.NeighborSampler(g, 16, (3,), engine="python",
                                  budget="tight")
    with pytest.raises(ValueError, match="emit_tiles"):
        tsampling.NeighborSampler(g, 16, (3,), engine="python",
                                  emit_tiles="ell")
    # 'sell' attaches each batch's SellTiles in the stream's fixed geometry
    s = tsampling.NeighborSampler(g, 16, (3,), engine="python",
                                  emit_tiles="sell")
    b = s.sample(np.arange(16))
    assert isinstance(b.tiles, tsa.SellTiles)
    assert b.tiles.e_ell == s._sell_fixed[0] * tsa.TILE_N
    # every batch's tiles have one fixed shape, and the epoch covers every
    # node once as a seed
    s = tsampling.NeighborSampler(g, 64, (4, 4), engine="python",
                                  emit_tiles=True)
    shapes = {b.tiles.dst_side.ids_grp.shape for b in s}
    assert len(shapes) == 1
    assert sum(b.num_seeds for b in s) == g.num_nodes


def test_prefetch():
    g = random_graph(**GRAPH)
    direct = [(b.num_seeds, b.num_nodes, b.num_edges) for b in
              tsampling.NeighborSampler(g, 64, (3,), seed=0, engine="python")]
    fetched = [(b.num_seeds, b.num_nodes, b.num_edges) for b in
               tsampling.prefetch(tsampling.NeighborSampler(
                   g, 64, (3,), seed=0, engine="python"))]
    assert direct == fetched

    def boom():
        yield 1
        raise RuntimeError("worker failure")

    it = tsampling.prefetch(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="worker failure"):
        list(it)


@pytest.mark.parametrize("dataset", ["karate", "digits"])
def test_native_parser_matches_numpy(dataset):
    _need_gxx()
    a = tio.load_dataset(dataset, DATA)
    b = tio.load_dataset(dataset, DATA, parser="native")
    for f in ("features", "row_ptr", "col_idx", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f
    with pytest.raises(ValueError, match="parser"):
        tio.load_dataset(dataset, DATA, parser="auto")


def test_native_gather_rows():
    _need_gxx()
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, size=20).astype(np.int32)
    out = tnative.gather_rows(table, idx, 32)
    assert out.shape == (32, 7)
    assert np.array_equal(out[:20], table[idx])
    assert not out[20:].any()


def test_native_build_is_keyed_by_sources():
    """The library lives in gatv2_tpu_torch/_build under a key of the
    sources and flags, never in native/."""
    _need_gxx()
    so = tnative.build()
    assert so.parent == tnative.BUILD_DIR and so.exists()
    assert so.name.startswith("libgatv2_loader-")
    assert so == tnative.library_path()
