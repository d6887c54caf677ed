"""Parameter layout conversions, text weight dump/restore and the numpy
weight bridge (port of gatv2_tpu/models/params_io.py).

The edge variant stores one fused W [H, D, 2F] per layer (left half
multiplies x_src, right half x_dst); the node variant stores split W_src,
W_dst [H, D, F]. The math is identical; the port stores split.

The text dump writes the same file names in the same `%.9g` one-value-per-
line format as the JAX package, so a dump from either package loads in the
other.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from gatv2_tpu_torch.config import ModelConfig
from gatv2_tpu_torch.models.gatv2 import GATv2, GATv2Layer


def split_to_fused(layer: GATv2Layer) -> torch.Tensor:
    """(w_src, w_dst) [H, D, F] each -> fused W [H, D, 2F] (edge layout)."""
    return torch.cat([layer.w_src, layer.w_dst], dim=-1)


def fused_to_split(w_fused: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused W [H, D, 2F] -> (w_src, w_dst) [H, D, F] each."""
    f2 = w_fused.shape[-1]
    if f2 % 2:
        raise ValueError(f"fused W last dim must be even, got {f2}")
    return w_fused[..., : f2 // 2], w_fused[..., f2 // 2 :]


def init_params_fused(config: ModelConfig, generator: torch.Generator) -> GATv2:
    """Xavier init drawing each layer's W as ONE fused [H, D, 2F] tensor,
    U(-l, l) with l = sqrt(6 / (2*in + out)) — the edge variant's draw
    layout — then a [H, D] from the same limit; W_o last. Draws come from
    `generator` in that order, on the CPU. Returns the split layout."""
    model = GATv2(config)
    with torch.no_grad():
        for layer in model.layers:
            h, d, f = layer.w_src.shape
            limit = math.sqrt(6.0 / (2 * f + d))
            w = torch.empty(h, d, 2 * f).uniform_(-limit, limit,
                                                 generator=generator)
            w_src, w_dst = fused_to_split(w)
            layer.w_src.copy_(w_src)
            layer.w_dst.copy_(w_dst)
            layer.a.uniform_(-limit, limit, generator=generator)
        c, d_last = model.w_o.shape
        limit_o = math.sqrt(6.0 / (c + d_last))
        model.w_o.uniform_(-limit_o, limit_o, generator=generator)
    return model


def params_to_fused(params: GATv2) -> dict:
    """Whole-model split params -> fused-layout tree
    {'layers': ({'w': [H,D,2F], 'a': [H,D]}, ...), 'w_o': [C, D_L]}."""
    layers = tuple(
        {"w": split_to_fused(lp), "a": lp.a} for lp in params.layers
    )
    return {"layers": layers, "w_o": params.w_o}


def params_from_fused(fused: dict) -> GATv2:
    """Inverse of params_to_fused."""
    layers = []
    for lp in fused["layers"]:
        w_src, w_dst = fused_to_split(lp["w"])
        layers.append({"w_src": w_src, "w_dst": w_dst, "a": lp["a"]})
    return params_from_numpy({"layers": tuple(layers), "w_o": fused["w_o"]})


def params_from_numpy(tree: dict) -> GATv2:
    """The weight bridge: the JAX package's parameter tree
    {"layers": ({"w_src", "w_dst", "a"}, ...), "w_o"} (numpy arrays or
    tensors) -> the port's GATv2 on the CPU, with the same values."""
    def cpu_f32(x):
        t = x.detach() if torch.is_tensor(x) else torch.tensor(np.asarray(x))
        return t.to("cpu", torch.float32)

    arrs = [
        {k: cpu_f32(lp[k]) for k in ("w_src", "w_dst", "a")}
        for lp in tree["layers"]
    ]
    w_o = cpu_f32(tree["w_o"])
    config = ModelConfig(
        num_layers=len(arrs),
        heads=tuple(lp["a"].shape[0] for lp in arrs),
        out_dims=tuple(lp["a"].shape[1] for lp in arrs),
        num_classes=w_o.shape[0],
        in_dim=arrs[0]["w_src"].shape[2],
    )
    model = GATv2(config)
    with torch.no_grad():
        for layer, lp in zip(model.layers, arrs):
            for k in ("w_src", "w_dst", "a"):
                getattr(layer, k).copy_(lp[k])
        model.w_o.copy_(w_o)
    return model


# ---- text dump/restore (reference debug-hook format) -----------------------


def save_array_txt(path: str | pathlib.Path, arr) -> None:
    """Whitespace-float dump, one value per line, `%.9g`."""
    flat = np.asarray(arr, np.float32).reshape(-1)
    with open(path, "w") as f:
        for v in flat:
            f.write(f"{float(v):.9g}\n")


def load_array_txt(path: str | pathlib.Path, shape=None) -> np.ndarray:
    flat = np.loadtxt(path, dtype=np.float32).reshape(-1)
    return flat.reshape(shape) if shape is not None else flat


def save_params_txt(directory: str | pathlib.Path, params: GATv2) -> None:
    """Dump every tensor as text: layer{L}_{w_src,w_dst,a}.txt + w_o.txt,
    plus fused layer{L}_w_fused.txt for the edge variant's layout."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)

    def np_(t):
        return t.detach().cpu().numpy()

    for l, lp in enumerate(params.layers):
        save_array_txt(d / f"layer{l}_w_src.txt", np_(lp.w_src))
        save_array_txt(d / f"layer{l}_w_dst.txt", np_(lp.w_dst))
        save_array_txt(d / f"layer{l}_a.txt", np_(lp.a))
        save_array_txt(d / f"layer{l}_w_fused.txt", np_(split_to_fused(lp)))
    save_array_txt(d / "w_o.txt", np_(params.w_o))


def load_params_txt(directory: str | pathlib.Path, config: ModelConfig) -> GATv2:
    """Restore params dumped by save_params_txt (split tensors), on the CPU."""
    d = pathlib.Path(directory)
    layers = []
    for l, (h, dd, f) in enumerate(
        zip(config.heads, config.out_dims, config.layer_in_dims)
    ):
        layers.append({
            "w_src": load_array_txt(d / f"layer{l}_w_src.txt", (h, dd, f)),
            "w_dst": load_array_txt(d / f"layer{l}_w_dst.txt", (h, dd, f)),
            "a": load_array_txt(d / f"layer{l}_a.txt", (h, dd)),
        })
    w_o = load_array_txt(
        d / "w_o.txt", (config.num_classes, config.out_dims[-1])
    )
    return params_from_numpy({"layers": tuple(layers), "w_o": w_o})
