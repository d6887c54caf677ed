"""The benchmark's inputs, made from the seed: a synthetic graph at a
configuration's published sizes and the model's starting weights.

The graph follows the recipe of gatv2_tpu_torch/data/synthetic.py
(random_graph), frozen here and drawn on the device with a
torch.Generator: random labels, standard-normal features, E edges with
uniform endpoints, sorted by destination (CSR over destinations). The
weights are Glorot-uniform with the reference's limits, drawn in one
call.

The same tensors go to the program and to the plain reference.
"""

from __future__ import annotations

import math

import torch


def _generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 2 + salt) % (1 << 63))


def make_graph(num_nodes: int, num_edges: int, feature_dim: int,
               num_classes: int, *, endpoints: str, seed: int,
               device) -> dict:
    """{features [N, F] f32, src [E] int64, dst [E] int64 (sorted),
    row_ptr [N+1] int64, labels [N] int64} on `device`."""
    if endpoints != "uniform":
        raise ValueError(f"endpoints must be 'uniform', got {endpoints!r}")
    g = _generator(seed, 0, device)
    n, e = num_nodes, num_edges
    labels = torch.randint(0, num_classes, (n,), generator=g, device=device)
    features = torch.randn(n, feature_dim, generator=g, device=device)
    src = torch.randint(0, n, (e,), generator=g, device=device)
    dst = torch.randint(0, n, (e,), generator=g, device=device)
    dst, order = torch.sort(dst, stable=True)
    src = src[order]
    del order
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(dst, minlength=n), 0, out=row_ptr[1:])
    return dict(features=features, src=src, dst=dst, row_ptr=row_ptr,
                labels=labels, num_nodes=n, num_edges=e)


def weight_shapes(in_dim: int, num_classes: int, heads, out_dims):
    """[(shape, glorot limit)] of the leaves in the program's order: per
    layer a [H, D], w_dst [H, D, F], w_src [H, D, F]; then w_o [C, D_L]."""
    shapes = []
    f = in_dim
    for h, d in zip(heads, out_dims):
        limit = math.sqrt(6.0 / (2 * f + d))  # the fused W [H, D, 2F]
        shapes += [((h, d), limit), ((h, d, f), limit), ((h, d, f), limit)]
        f = h * d
    c, d_last = num_classes, out_dims[-1]
    shapes.append(((c, d_last), math.sqrt(6.0 / (c + d_last))))
    return shapes


def make_weights(in_dim: int, num_classes: int, heads, out_dims, *,
                 seed: int, device) -> list[torch.Tensor]:
    """The starting weights, U(-limit, limit) per leaf, from one draw."""
    shapes = weight_shapes(in_dim, num_classes, heads, out_dims)
    sizes = [math.prod(s) for s, _ in shapes]
    u = torch.rand(sum(sizes), generator=_generator(seed, 1, device),
                   device=device)
    return [(2.0 * part - 1.0).mul_(limit).view(shape)
            for part, (shape, limit) in zip(u.split(sizes), shapes)]
