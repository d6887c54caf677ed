"""K5 — the streamed-operand forward kernel over destination-sorted edge
tiles: its wrapper, its plain PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/pallas_attention.py:_attention_kernel (launched by
_forward_chunk), with normalize=True for the single-pass op and
normalize=False for each pass of the merged-softmax op
(edge_attention_pallas_merge). The CUDA source is csrc/pallas_fwd.cu,
whose header note says what bounds the kernel on the card and what its
design does about that.

Both versions take one chunk's inputs and give the same outputs, so they
can be compared element for element:

  zs           [Ns, H*D] fp32 — src projections, node order (global ids)
  zd           [>= nodes with an edge, H*D] fp32 — dst projections from
               the chunk's first node on
  a            [H, D] fp32, H <= 16
  dst_ids      [Ec] int32 — chunk-relative dst node per edge slot, sorted
               within each tile; padding slots carry rows (or more)
  src_ids      [Ec] int32 — global src node per edge slot (0 on padding)
  rel_offsets  [T+1] int32 — each 128-node tile's edge-tile range
  te           edges per edge tile
  -> out [T*128, H*D], m [T*128, H], l [T*128, H], fp32, in node order:
     out = acc / (l + 1e-8) if normalize else the raw accumulator acc;
     a node without an in-edge gets out = 0, m = -1e30, l = 0.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.segment import (
    EXP_CLAMP,
    SOFTMAX_EPS,
    segment_max,
    segment_sum,
)

TILE_N = 128
NEG_INF = -1e30
MAX_HD = 512  # H*D one launch takes (csrc/pallas_*.cu kMaxHd)
STATS_L = 16  # heads one launch takes (csrc/pallas_*.cu kMaxHeads)

_P, _I = ctypes.c_void_p, ctypes.c_int


def real_edges(dst_ids: torch.Tensor, rel_offsets: torch.Tensor, te: int):
    """(positions, ids) of the real edge slots of a tiled layout: the slots
    inside its tiles' edge ranges (the first rel_offsets[-1] * te; the
    kernels read no slot past them) whose id names one of its nodes
    (padding carries the node count or more)."""
    rows = (rel_offsets.numel() - 1) * TILE_N
    ids = dst_ids.long()[: int(rel_offsets[-1]) * te]
    pos = torch.nonzero(ids < rows).squeeze(1)
    return pos, ids[pos]


def pallas_fwd_plain(zs, zd, a, dst_ids, src_ids, rel_offsets, te, *,
                     negative_slope: float, normalize: bool = True):
    """K5's plain PyTorch twin: gathers, a two-pass segment softmax and a
    segment sum over the real edge slots. Runs on any device."""
    num_heads, head_dim = a.shape
    rows = (rel_offsets.numel() - 1) * TILE_N
    pos, d = real_edges(dst_ids, rel_offsets, te)
    z = zs[src_ids.long()[pos]]
    s = z + zd[d]
    s = torch.where(s > 0, s, negative_slope * s)
    sc = (s.view(-1, num_heads, head_dim) * a).sum(-1)
    m = segment_max(sc, d, rows).clamp(min=NEG_INF)  # no edge -> -1e30
    p = torch.exp(torch.clamp(sc - m[d], EXP_CLAMP, 0.0))
    l = segment_sum(p, d, rows)
    acc = segment_sum(p.repeat_interleave(head_dim, 1) * z, d, rows)
    if not normalize:
        return acc, m, l
    return acc / (l.repeat_interleave(head_dim, 1) + SOFTMAX_EPS), m, l


def check_inputs(kernel, floats, ints, a, rel_offsets, te):
    """The checks every pallas kernel wrapper makes before a launch: one
    device, fp32 / int32, contiguous, H <= 16 heads and H*D <= 512 lanes."""
    dev = floats[0][1].device
    for (name, t), dt in ([(f, torch.float32) for f in floats]
                          + [(i, torch.int32) for i in ints]):
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {dev}")
        if t.dtype != dt:
            raise ValueError(f"{kernel}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if a is not None:
        num_heads, head_dim = a.shape
        if num_heads > STATS_L or num_heads * head_dim > MAX_HD:
            raise ValueError(
                f"{kernel}: H={num_heads}, H*D={num_heads * head_dim} exceed "
                f"{STATS_L} heads or {MAX_HD} lanes per launch; split heads"
            )
    if rel_offsets.dim() != 1 or rel_offsets.numel() < 2 or te < 1:
        raise ValueError(
            f"{kernel}: rel_offsets {tuple(rel_offsets.shape)} must be [T+1] "
            f"with T >= 1, te={te} >= 1"
        )


def raise_on_error(lib, err: int, kernel: str) -> None:
    if err != 0:
        lib.gatv2_cuda_error_string.restype = ctypes.c_char_p
        lib.gatv2_cuda_error_string.argtypes = [_I]
        msg = lib.gatv2_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def pallas_fwd(zs, zd, a, dst_ids, src_ids, rel_offsets, te, *,
               negative_slope: float, normalize: bool = True):
    """K5. On CUDA tensors it launches csrc/pallas_fwd.cu (building it at
    the first call) or raises; on CPU tensors it runs pallas_fwd_plain.
    Returns (out, m, l) as described in the module docstring."""
    if zs.device.type == "cpu":
        return pallas_fwd_plain(zs, zd, a, dst_ids, src_ids, rel_offsets, te,
                                negative_slope=negative_slope,
                                normalize=normalize)
    if zs.device.type != "cuda":
        raise ValueError(f"pallas_fwd: unsupported device {zs.device}")
    check_inputs("pallas_fwd", [("zs", zs), ("zd", zd), ("a", a)],
                 [("dst_ids", dst_ids), ("src_ids", src_ids),
                  ("rel_offsets", rel_offsets)], a, rel_offsets, te)
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    if zs.dim() != 2 or zs.shape[1] != hd or zd.dim() != 2 or zd.shape[1] != hd:
        raise ValueError(
            f"pallas_fwd: zs {tuple(zs.shape)} / zd {tuple(zd.shape)} must be "
            f"[N, {hd}]")
    if src_ids.numel() != dst_ids.numel():
        raise ValueError("pallas_fwd: dst_ids and src_ids differ in length")
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("pallas_fwd")
    fn = lib.gatv2_pallas_fwd
    fn.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float, _I] + [_P] * 4
    fn.restype = _I
    rows = (rel_offsets.numel() - 1) * TILE_N
    out = zs.new_empty((rows, hd))
    m = zs.new_empty((rows, num_heads))
    l = zs.new_empty((rows, num_heads))
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            zs.data_ptr(), zd.data_ptr(), a.data_ptr(), dst_ids.data_ptr(),
            src_ids.data_ptr(), rel_offsets.data_ptr(), int(te), rows,
            num_heads, head_dim, float(negative_slope), int(normalize),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), stream,
        )
    raise_on_error(lib, err, "pallas_fwd")
    pallas_fwd.launches += 1
    if not normalize:
        pallas_fwd.raw_launches += 1
    return out, m, l


pallas_fwd.launches = 0  # K5 launches since the last reset
pallas_fwd.raw_launches = 0  # of those, with normalize=False
