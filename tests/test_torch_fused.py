"""The fused op's shared contract (ops/fused.py) on both kernel families,
through their plain CPU twins: per call, the forward kernel launches once
per chunk and head group; under a remat holder the first call fills it
and the second empties it, launches no forward kernel and counts one
`fused.attention.reused` step per head group; outputs and gradients equal
the plain call's bit for bit."""

import pytest
import torch

from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.ops import fused
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.attention import edge_attention, family

N, HEADS, DIM = 300, 40, 4


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One CPU thread: the test's many small ops slow down by orders of
    magnitude when parallel test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("holder", ["plain", "kept"])
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("impl", ["sell", "pallas"])
def test_fused_op_contract(impl, chunks, holder, monkeypatch):
    g = random_graph(N, 2400, 4, 2, seed=5)
    if impl == "sell":
        lay = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, N,
                                     num_chunks=chunks)
        mod, name = tsa, "sell_fwd"
    else:
        lay = tpa.prepare_edge_tiles(g.row_ptr, g.col_idx, N,
                                     num_chunks=chunks)
        mod, name = tpa, "pallas_fwd"
    assert lay.num_chunks == chunks
    groups = len(fused.head_groups(family(impl), HEADS, DIM))
    assert groups == (2 if impl == "sell" else 3)
    kernel, calls = getattr(mod, name), [0]

    def counted(*args, **kw):
        calls[0] += 1
        return kernel(*args, **kw)

    monkeypatch.setattr(mod, name, counted)
    gen = torch.Generator().manual_seed(1)
    zs, zd, up = (torch.randn(N, HEADS * DIM, generator=gen)
                  for _ in range(3))
    a = torch.randn(HEADS, DIM, generator=gen) / DIM ** 0.5

    def call(kept):
        leaves = [x.clone().requires_grad_(True) for x in (zs, zd, a)]
        calls[0], reused = 0, fused.attention.reused
        out = edge_attention(*leaves[:3], None, None, N, negative_slope=0.2,
                             impl=impl, edge_tiles=lay, kept=kept)
        grads = torch.autograd.grad((out * up).sum(), leaves)
        return (out.detach(), *grads), calls[0], (fused.attention.reused
                                                  - reused)

    want, launched, reused = call(None)
    assert (launched, reused) == (chunks * groups, 0)
    kept = {} if holder == "kept" else None
    runs = []
    for _ in range(2):
        runs.append(call(kept))
        if kept is not None:
            assert len(kept) == len(runs) % 2  # filled, then emptied
    if kept is None:
        assert [r[1:] for r in runs] == [(chunks * groups, 0)] * 2
    else:
        assert [r[1:] for r in runs] == [(chunks * groups, 0), (0, groups)]
    for got, _, _ in runs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)
