"""Card-only tests of the port: the CUDA kernel K1 against its plain twin,
and a model forward that goes through it. They carry the `gpu` marker and
skip without a CUDA device. Run them on the machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

The kernel is held against the port's twin, which the CPU tests hold
against JAX.
"""

import jax  # noqa: F401  (test files import both packages)
import numpy as np
import pytest
import torch

from gatv2_tpu_torch.config import ModelConfig
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models.gatv2 import init_params, model_forward
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.sell_fwd import sell_fwd, sell_fwd_plain

SLOPE = 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _hub_and_isolated(n=260):
    rng = np.random.default_rng(7)
    deg = np.zeros(n, np.int64)
    deg[0] = 200
    deg[51:] = rng.integers(0, 4, size=n - 51)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return row_ptr, rng.integers(0, n, size=int(row_ptr[-1])), n


def _layout(case):
    if case == "uniform":
        g = random_graph(2000, 14000, 8, 3, seed=11)
    elif case == "zipf-split":
        g = powerlaw_graph(3000, 40000, 8, 3, seed=17)
    elif case == "isolated":
        return _hub_and_isolated()
    else:  # zero-edge
        return np.zeros(11, np.int64), np.zeros(0, np.int32), 10
    return g.row_ptr, g.col_idx, g.num_nodes


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", [
    ("uniform", 4, 64), ("uniform", 1, 32), ("uniform", 1, 16),
    ("uniform", 20, 8), ("zipf-split", 4, 64), ("zipf-split", 3, 24),
    ("isolated", 2, 16), ("zero-edge", 3, 24),
])
def test_k1_kernel_matches_twin(cuda, case, h, d):
    row_ptr, col_idx, n = _layout(case)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n).to(cuda)
    rng = np.random.default_rng(4)
    zs, zd = (torch.from_numpy(rng.normal(size=(n, h * d)).astype(np.float32))
              .to(cuda) for _ in range(2))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    side = st.dst
    args = (zs, zd, a, side.perm, side.gather_ids, side.cnt, side.col_off)
    kw = dict(negative_slope=SLOPE, normalize=not side.split)
    before = sell_fwd.launches
    got = sell_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert sell_fwd.launches == before + 1
    for x, y in zip(got, sell_fwd_plain(*args, **kw)):
        # rounding relative to each row's largest value (see chip_smoke)
        scale = y.abs().amax(dim=-1, keepdim=True)
        assert bool(((x - y).abs() <= 1e-5 + 1e-5 * scale).all())
    empty = torch.as_tensor(np.diff(row_ptr) == 0, device=cuda)
    out, _ = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                              sell_tiles=st)
    assert bool((out[empty] == 0).all())


@pytest.mark.gpu
def test_model_forward_uses_kernel(cuda):
    g = random_graph(1000, 6000, 16, 4, seed=1)
    config = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                         num_classes=4, in_dim=16)
    model = init_params(config, torch.Generator().manual_seed(0))
    st, feats, _, _ = tsa.setup_full_graph_sell(g, (4, 1), (16, 8),
                                                device=cuda)
    before = sell_fwd.launches
    with torch.inference_mode():
        got = model_forward(model, feats, None, None, config, impl="sell",
                            edge_tiles=st, device=cuda)[: g.num_nodes]
        want = model_forward(model, g.features, g.src, g.dst, config,
                             impl="torch", device=cuda)
    assert sell_fwd.launches - before == 2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
