"""The plain reference against a hand-worked 5-node graph, its blocked
backward against finite differences, one Adam step by hand, and the
switches it runs under."""

import math

import torch

from benchmark.reference import gatv2 as reference


def leaky(x):
    return x if x > 0 else 0.01 * x


# edges (src, dst), sorted by dst; node 3 has no in-edge
EDGES = [(1, 0), (2, 0), (0, 1), (4, 2), (1, 2), (2, 2), (0, 4)]
ZS = [[1.0, -2.0], [0.5, 0.0], [-1.0, 3.0], [2.0, 2.0], [0.0, -1.0]]
ZD = [[0.0, 1.0], [1.0, 1.0], [-2.0, 0.5], [3.0, 3.0], [0.25, -0.5]]
A = [0.7, -1.3]


def by_hand():
    """h_j = sum_i softmax_j(a . LeakyReLU(zs_i + zd_j)) zs_i, loops."""
    out = [[0.0, 0.0] for _ in range(5)]
    for j in range(5):
        ins = [s for s, t in EDGES if t == j]
        if not ins:
            continue
        e = [sum(A[k] * leaky(ZS[i][k] + ZD[j][k]) for k in range(2))
             for i in ins]
        top = max(e)
        w = [math.exp(x - top) for x in e]
        for i, wi in zip(ins, w):
            for k in range(2):
                out[j][k] += wi / sum(w) * ZS[i][k]
    return out


def test_attention_matches_the_hand_worked_graph():
    zs = torch.tensor(ZS).view(5, 1, 2)
    zd = torch.tensor(ZD).view(5, 1, 2)
    a = torch.tensor([A])
    src = torch.tensor([s for s, _ in EDGES])
    dst = torch.tensor([t for _, t in EDGES])
    got = reference.BlockedAttention.apply(zs, zd, a, src, dst)
    want = torch.tensor(by_hand()).view(5, 1, 2)
    assert torch.allclose(got, want, atol=1e-6)
    assert torch.equal(got[3], torch.zeros(1, 2))


def test_blocked_backward_matches_finite_differences(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 6)  # 3 edges a block
    g = torch.Generator().manual_seed(0)
    n, h, d, e = 6, 2, 3, 14
    src = torch.randint(0, n, (e,), generator=g)
    dst = torch.sort(torch.randint(0, n - 1, (e,), generator=g)).values
    zs, zd = (torch.randn(n, h, d, generator=g, dtype=torch.float64,
                          requires_grad=True) for _ in range(2))
    a = torch.randn(h, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda zs, zd, a: reference.BlockedAttention.apply(zs, zd, a, src,
                                                           dst),
        (zs, zd, a))


def test_one_adam_step_by_hand():
    """Step 1 of Adam moves each weight by lr against its gradient's
    sign (m_hat / sqrt(v_hat) = g / |g|); the loss is the mean
    cross-entropy of the labelled nodes."""
    g = torch.Generator().manual_seed(1)
    heads, dims, n, f, c = (2, 1), (3, 2), 5, 4, 3
    leaves = []
    fin = f
    for h, d in zip(heads, dims):
        leaves += [torch.randn(h, d, generator=g),
                   torch.randn(h, d, fin, generator=g),
                   torch.randn(h, d, fin, generator=g)]
        fin = h * d
    leaves.append(torch.randn(c, dims[-1], generator=g))
    x = torch.randn(n, f, generator=g)
    src, dst = torch.tensor([1, 2, 0, 4, 1]), torch.tensor([0, 0, 1, 2, 4])
    labels = torch.tensor([0, 2, 1, 1, 0])
    labelled = torch.tensor([True, True, False, True, False])
    out = reference.train(leaves, [(x, src, dst, labels, labelled)],
                          heads, dims, lr=0.01)
    ps = [p.clone().requires_grad_(True) for p in leaves]
    logits = reference.forward(ps, x, src, dst, heads, dims)
    logp = torch.log_softmax(logits, -1)
    loss = -(logp[0, 0] + logp[1, 2] + logp[3, 1]) / 3
    assert math.isclose(out["losses"][0], float(loss.detach()), rel_tol=1e-6)
    grads = torch.autograd.grad(loss, ps)
    for p0, p1, gr in zip(leaves, out["params"], grads):
        step = 0.01 * gr / (gr.abs() + 1e-8)
        assert torch.allclose(p1, p0 - step, atol=1e-7)


def test_fp32_exact_fixes_the_order_and_restores_the_flags():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cuda.matmul.allow_tf32)
    with reference.fp32_exact():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cuda.matmul.allow_tf32) == before
