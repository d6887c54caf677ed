"""The benchmark's inputs: one seed gives the same graph and weights,
and the graph is a CSR over destinations with uniform endpoints."""

import pytest
import torch

from benchmark import graphgen


def test_graph_is_a_seeded_csr():
    kw = dict(endpoints="uniform", device="cpu")
    g = graphgen.make_graph(500, 4000, 8, 5, seed=2**31 + 3, **kw)
    again = graphgen.make_graph(500, 4000, 8, 5, seed=2**31 + 3, **kw)
    other = graphgen.make_graph(500, 4000, 8, 5, seed=2**31 + 4, **kw)
    for k in ("features", "src", "dst", "row_ptr", "labels"):
        assert torch.equal(g[k], again[k])
    assert not torch.equal(g["src"], other["src"])
    assert torch.all(g["dst"][1:] >= g["dst"][:-1])
    assert g["row_ptr"][-1] == 4000
    assert torch.equal(torch.repeat_interleave(
        torch.arange(500), g["row_ptr"].diff()), g["dst"])
    assert int(g["src"].max()) < 500 and int(g["labels"].max()) < 5
    top = int(torch.bincount(g["dst"], minlength=500).max())
    assert top < 100
    with pytest.raises(ValueError):
        graphgen.make_graph(500, 4000, 8, 5, seed=1, endpoints="zipf",
                            device="cpu")


def test_weights_are_seeded_glorot():
    w = graphgen.make_weights(16, 5, (4, 1), (8, 4), seed=7, device="cpu")
    assert [tuple(x.shape) for x in w] == [
        (4, 8), (4, 8, 16), (4, 8, 16), (1, 4), (1, 4, 32), (1, 4, 32),
        (5, 4)]
    limit = (6.0 / (2 * 16 + 8)) ** 0.5
    assert float(w[1].abs().max()) <= limit
    again = graphgen.make_weights(16, 5, (4, 1), (8, 4), seed=7,
                                  device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(w, again))
