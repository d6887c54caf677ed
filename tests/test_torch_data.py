"""The port's data layer (gatv2_tpu_torch.data) against the JAX package's:
generators byte-equal from the same seed, the text loader equal on the
committed datasets, CSR construction equal."""

import pathlib

import jax  # noqa: F401  (the JAX package under comparison; conftest pins CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from gatv2_tpu.data import graph as jgraph
from gatv2_tpu.data import io as jio
from gatv2_tpu.data import synthetic as jsyn
from gatv2_tpu_torch.data import graph as tgraph
from gatv2_tpu_torch.data import io as tio
from gatv2_tpu_torch.data import synthetic as tsyn

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def _assert_graphs_equal(g_port, g_jax):
    for f in ("features", "row_ptr", "col_idx", "labels"):
        a, b = getattr(g_port, f), getattr(g_jax, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert np.array_equal(g_port.dst, g_jax.dst)
    assert g_port.num_classes == g_jax.num_classes


@pytest.mark.parametrize(
    "gen,args,kw",
    [
        ("random_graph", (300, 1400, 8, 3), dict(seed=3)),
        ("random_graph", (200, 800, 32, 4), dict(seed=0, planted_signal=2.0)),
        ("powerlaw_graph", (800, 9000, 8, 3), dict(seed=17, alpha=1.2)),
        ("chain_graph", (50, 6, 3), dict(seed=2)),
    ],
)
def test_generators_byte_equal(gen, args, kw):
    _assert_graphs_equal(
        getattr(tsyn, gen)(*args, **kw), getattr(jsyn, gen)(*args, **kw)
    )


@pytest.mark.parametrize("dataset", ["karate", "digits"])
def test_load_dataset_matches_jax(dataset):
    _assert_graphs_equal(
        tio.load_dataset(dataset, str(DATA)), jio.load_dataset(dataset, str(DATA))
    )


@pytest.mark.parametrize("undirected,dedup", [(False, False), (True, True)])
def test_edges_to_csr_matches_jax(undirected, dedup):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 60, 400)
    dst = rng.integers(0, 60, 400)
    got = tgraph.edges_to_csr(src, dst, 60, make_undirected=undirected, dedup=dedup)
    want = jgraph.edges_to_csr(src, dst, 60, make_undirected=undirected, dedup=dedup)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_graph_validation_rejects_bad_ids():
    with pytest.raises(ValueError, match="outside"):
        tgraph.Graph(
            features=np.zeros((3, 2), np.float32),
            row_ptr=np.array([0, 1, 2, 3]),
            col_idx=np.array([0, 1, 3]),
            labels=np.zeros(3, np.int32),
        )


def test_missing_dataset_is_reported(tmp_path):
    with pytest.raises(FileNotFoundError, match="Dataset directory not found"):
        tio.load_dataset("nope", str(tmp_path))
