"""Optimizers with the reference's semantics (port of
gatv2_tpu/train/optim.py).

- Adam: bias correction with t = epoch (1-indexed), computed in fp32 as the
  JAX package does, eps = 1e-8. t, the betas and their powers live on the
  parameters' device as 0-d fp32 tensors written by fill kernels
  (`step_count`), so a step copies nothing from the host and does not
  wait for the device.
- SGD: p -= lr * g.
- Optional clipping at a fixed threshold (5.0) PER PARAMETER GROUP:
  W_src + W_dst of every layer together (the fused-W norm), the attention
  vectors a, and W_o; scale = clip / (norm + 1e-9) when norm > clip.

Parameters are handled as a flat list of leaves in the JAX package's
flatten order (`param_leaves`), which is also the checkpoint's key order.
The update is written into the parameters in place (the JAX package
returns new arrays); the arithmetic is the same, in fp32.
"""

from __future__ import annotations

import torch

from gatv2_tpu_torch.models.gatv2 import GATv2

CLIP_EPS = 1e-9
ADAM_EPS = 1e-8


def param_leaves(params: GATv2) -> list[torch.Tensor]:
    """The parameters in JAX's flatten order of the tree
    {"layers": ({"a", "w_dst", "w_src"}, ...), "w_o"} (dict keys sorted):
    per layer a, w_dst, w_src; then w_o. The edge-conditioned block's
    leaves sit among them by name (GATv2Layer.leaves: a, bn_b, bn_g,
    w_dst, w_e, w_res, w_src)."""
    leaves = [p for layer in params.layers for _, p in layer.named_leaves()]
    leaves.append(params.w_o)
    return leaves


def param_names(params: GATv2) -> list[str]:
    """The names of param_leaves(params), in the same order."""
    return [f"layers.{l}.{k}" for l, layer in enumerate(params.layers)
            for k, _ in layer.named_leaves()] + ["w_o"]


def _check_finite(what: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"--debug-nans: non-finite value in {what}")


def gradients(loss: torch.Tensor, params: GATv2, *,
              debug_nans: bool = False) -> list[torch.Tensor]:
    """d loss / d param_leaves(params).

    debug_nans=True (the CLI's --debug-nans, the counterpart of the JAX
    package's jax_debug_nans) raises FloatingPointError at the first
    non-finite value: in the loss, inside the backward (autograd's anomaly
    mode names the function that returned NaN) or in a parameter's
    gradient, naming which. It syncs with the device for each check; with
    debug_nans=False nothing is checked and nothing waits."""
    leaves = param_leaves(params)
    if not debug_nans:
        return list(torch.autograd.grad(loss, leaves))
    _check_finite("the loss", loss)
    try:
        with torch.autograd.set_detect_anomaly(True):
            grads = torch.autograd.grad(loss, leaves)
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"--debug-nans: {e}") from e
    for name, g in zip(param_names(params), grads):
        _check_finite(f"the gradient of {name}", g)
    return list(grads)


def init_opt_state(params: GATv2, optimizer: str) -> dict:
    """{"m": [...], "v": [...]} zeros per leaf for Adam; {} for SGD."""
    if optimizer == "adam":
        return {k: [torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for p in param_leaves(params)] for k in ("m", "v")}
    if optimizer == "sgd":
        return {}
    raise ValueError(f"unknown optimizer {optimizer!r}")


# the clip groups of a layer's leaves: the weights, and the attention
# vectors (with BatchNorm's affine pair); the JAX package sums w_src then
# w_dst per layer, and the block's w_e and w_res follow
_W_ORDER = ("w_src", "w_dst", "w_e", "w_res")
_A_ORDER = ("a", "bn_g", "bn_b")


def clip_by_group_norm(grads: list[torch.Tensor], clip_norm: float,
                       names: list[str] | None = None
                       ) -> list[torch.Tensor]:
    """Global-L2-norm clip per parameter group (reference semantics);
    grads in param_leaves order, `names` their param_names (default: the
    plain model's a, w_dst, w_src per layer, then w_o)."""
    if names is None:
        names = [f"layers.{l}.{k}" for l in range((len(grads) - 1) // 3)
                 for k in ("a", "w_dst", "w_src")] + ["w_o"]

    def scale_of(leaves):
        sq = sum(torch.sum(torch.square(g)) for g in leaves)
        norm = torch.sqrt(sq) + CLIP_EPS
        return torch.where(norm > clip_norm, clip_norm / norm,
                           torch.ones_like(norm))

    index = {n: i for i, n in enumerate(names)}
    layers = sorted({int(n.split(".")[1]) for n in names if "." in n})

    def group(order):
        return [index[f"layers.{l}.{k}"] for l in layers for k in order
                if f"layers.{l}.{k}" in index]

    w_idx, a_idx = group(_W_ORDER), group(_A_ORDER)
    w_scale = scale_of([grads[i] for i in w_idx])
    a_scale = scale_of([grads[i] for i in a_idx])
    o_scale = scale_of([grads[-1]])
    scales = [o_scale] * len(grads)
    for i in w_idx:
        scales[i] = w_scale
    for i in a_idx:
        scales[i] = a_scale
    return [g * s for g, s in zip(grads, scales)]


def step_count(t: int, device: str | torch.device) -> torch.Tensor:
    """Adam's step counter t as a 0-d fp32 tensor on `device`. torch.full
    writes it with a fill kernel; torch.tensor(t, device=...) would copy it
    from pageable host memory, which waits for the device."""
    return torch.full((), float(t), dtype=torch.float32, device=device)


@torch.no_grad()
def apply_updates(leaves: list[torch.Tensor], grads: list[torch.Tensor],
                  opt_state: dict, t: int | torch.Tensor, config,
                  names: list[str] | None = None) -> None:
    """One optimizer step, written into `leaves` (and the Adam moments in
    `opt_state`) in place. t: the 1-indexed epoch, Adam's bias-correction
    step, as an int or as a 0-d fp32 tensor on the leaves' device
    (step_count; the runners keep it there). names: the leaves'
    param_names, for the clip groups (default: the plain model's)."""
    if config.clip:
        grads = clip_by_group_norm(grads, config.clip_norm, names)
    if config.optimizer == "sgd":
        for p, g in zip(leaves, grads):
            p.sub_(config.lr * g)
        return
    b1, b2, lr = config.beta1, config.beta2, config.lr
    if not isinstance(t, torch.Tensor):
        t = step_count(t, leaves[0].device)
    # 1 - b**t in fp32, as the JAX package computes it
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    for p, g, m, v in zip(leaves, grads, opt_state["m"], opt_state["v"]):
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + (1.0 - b2) * torch.square(g))
        m_hat = m / bc1
        v_hat = v / bc2
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
