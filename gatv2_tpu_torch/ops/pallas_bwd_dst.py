"""K6 — the streamed-operand backward kernel over destination rows: its
wrapper, its plain PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/pallas_attention.py:_bwd_dst_kernel (launched by
_bwd_dst_chunk, math in _edge_backward_core), with emit_c1=True on the
unchunked layout and emit_c1=False once per chunk of a chunked one. The
CUDA source is csrc/pallas_bwd_dst.cu, whose header note says what bounds
the kernel on the card and what its design does about that.

Both versions take the same inputs and give the same outputs:

  zs           [Ns, H*D] fp32 — src projections, node order
  zd, g        [>= nodes with an edge, H*D] fp32 — dst projections and the
               upstream gradient of the op's output, node order from the
               chunk's first node on
  sr           [>= nodes with an edge, 32] fp32 — the _sigma_r_table rows
               from the chunk's first node on:
               sigma = m + log(l + 1e-8) in lanes [0, H), r = <g, out> per
               head in lanes [16, 16 + H)
  a            [H, D] fp32, H <= 16
  dst_ids, src_ids, rel_offsets, te — the dst side's layout (as for K5)
  -> dzd [T*128, H*D] fp32 in node order,
     da [H, D] fp32,
     c1 [Ec, H*D] fp32 packets in edge-slot order, or None with
     emit_c1=False. Only the real slots are defined: the kernel leaves
     padding slots unwritten. dzd and da do not depend on emit_c1.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.pallas_fwd import (
    STATS_L,
    TILE_N,
    check_inputs,
    raise_on_error,
    real_edges,
)
from gatv2_tpu_torch.ops.segment import EXP_CLAMP, segment_sum

# tile blocks per launch at most (one per 128-node tile up to it; they
# stride over the tiles), and segment blocks (csrc/edge_tiles.cuh: rows of
# more than SEG edges are split over the segments of SEG slots they meet);
# the d_a partials, one per block, stay at most
# (MAX_BLOCKS + MAX_SEG_BLOCKS) x H*D
MAX_BLOCKS = 4096
SEG = 1024  # slots per segment (csrc/edge_tiles.cuh kSeg)
MAX_SEG_BLOCKS = 512

_P, _I = ctypes.c_void_p, ctypes.c_int


def pallas_bwd_dst_plain(zs, zd, g, sr, a, dst_ids, src_ids, rel_offsets, te,
                         *, negative_slope: float, emit_c1: bool = True):
    """K6's plain PyTorch twin: the per-edge algebra of _edge_backward_core
    over the real edge slots, gathers and a segment sum. Padding slots of
    c1 are zero here. Runs on any device."""
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    rows = (rel_offsets.numel() - 1) * TILE_N
    pos, d = real_edges(dst_ids, rel_offsets, te)
    z = zs[src_ids.long()[pos]]
    s = z + zd[d]
    s_act = torch.where(s > 0, s, negative_slope * s)
    sc = (s_act.view(-1, num_heads, head_dim) * a).sum(-1)
    stats = sr[d]
    alpha = torch.exp(torch.clamp(sc - stats[:, :num_heads], EXP_CLAMP, 0.0))
    gg = g[d]
    dalpha = (gg * z).view(-1, num_heads, head_dim).sum(-1)
    de = alpha * (dalpha - stats[:, STATS_L:STATS_L + num_heads])
    de_rep = de.repeat_interleave(head_dim, 1)
    ds = de_rep * a.reshape(hd) * torch.where(s > 0, 1.0, negative_slope)
    dzd = segment_sum(ds, d, rows)
    da = (de_rep * s_act).sum(0).view(num_heads, head_dim)
    if not emit_c1:
        return dzd, da, None
    c1 = zs.new_zeros((dst_ids.numel(), hd))
    c1[pos] = alpha.repeat_interleave(head_dim, 1) * gg + ds
    return dzd, da, c1


def segment_scratch(slots: int, hd: int, like: torch.Tensor):
    """(segment blocks, partials [2 * segments, hd] fp32, run ids [2 *
    segments] int32) of a K6 or K8 launch over `slots` edge slots, on
    like's device: two partial rows and a (row, end) pair per segment of
    SEG slots, which the kernel fills before its merge launch reads
    them."""
    nseg = -(-slots // SEG)
    return (min(nseg, MAX_SEG_BLOCKS), like.new_empty((2 * nseg, hd)),
            torch.empty(2 * nseg, dtype=torch.int32, device=like.device))


def pallas_bwd_dst(zs, zd, g, sr, a, dst_ids, src_ids, rel_offsets, te, *,
                   negative_slope: float, emit_c1: bool = True):
    """K6. On CUDA tensors it launches csrc/pallas_bwd_dst.cu (building it
    at the first call) or raises; on CPU tensors it runs
    pallas_bwd_dst_plain. Returns (dzd, da, c1) as described in the module
    docstring."""
    if zs.device.type == "cpu":
        return pallas_bwd_dst_plain(
            zs, zd, g, sr, a, dst_ids, src_ids, rel_offsets, te,
            negative_slope=negative_slope, emit_c1=emit_c1)
    if zs.device.type != "cuda":
        raise ValueError(f"pallas_bwd_dst: unsupported device {zs.device}")
    check_inputs(
        "pallas_bwd_dst",
        [("zs", zs), ("zd", zd), ("g", g), ("sr", sr), ("a", a)],
        [("dst_ids", dst_ids), ("src_ids", src_ids),
         ("rel_offsets", rel_offsets)], a, rel_offsets, te)
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    for name, t in (("zs", zs), ("zd", zd), ("g", g)):
        if t.dim() != 2 or t.shape[1] != hd:
            raise ValueError(
                f"pallas_bwd_dst: {name} {tuple(t.shape)} must be [N, {hd}]")
    if sr.dim() != 2 or sr.shape[1] != 2 * STATS_L:
        raise ValueError(
            f"pallas_bwd_dst: sr {tuple(sr.shape)} must be [N, {2 * STATS_L}]")
    if src_ids.numel() != dst_ids.numel():
        raise ValueError("pallas_bwd_dst: dst_ids and src_ids differ in length")
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("pallas_bwd_dst")
    fn = lib.gatv2_pallas_bwd_dst
    fn.argtypes = ([_P] * 8 + [_I] * 5 + [ctypes.c_float, _I, _I]
                   + [_P] * 6)
    fn.restype = _I
    rows = (rel_offsets.numel() - 1) * TILE_N
    slots = dst_ids.numel()
    blocks = min(rows // TILE_N, MAX_BLOCKS)
    seg_blocks, seg_part, seg_meta = segment_scratch(slots, hd, zs)
    dzd = zs.new_empty((rows, hd))
    da_part = zs.new_empty((blocks + seg_blocks, hd))
    c1 = zs.new_empty((slots, hd)) if emit_c1 else None
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            zs.data_ptr(), zd.data_ptr(), g.data_ptr(), sr.data_ptr(),
            a.data_ptr(), dst_ids.data_ptr(), src_ids.data_ptr(),
            rel_offsets.data_ptr(), int(te), rows, slots, num_heads,
            head_dim, float(negative_slope), blocks, seg_blocks,
            dzd.data_ptr(), da_part.data_ptr(),
            c1.data_ptr() if emit_c1 else None, seg_part.data_ptr(),
            seg_meta.data_ptr(), stream,
        )
    raise_on_error(lib, err, "pallas_bwd_dst")
    pallas_bwd_dst.launches += 1
    # the per-block partials summed in a fixed order: deterministic
    return dzd, da_part.sum(0).view(num_heads, head_dim), c1


pallas_bwd_dst.launches = 0  # K6 launches since the last reset
