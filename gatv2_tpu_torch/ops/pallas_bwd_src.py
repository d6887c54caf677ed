"""K8 — the streamed-operand backward kernel over source rows on a chunked
layout (phase 2b, d_zs by per-edge recompute): its wrapper, its plain
PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/pallas_attention.py:_bwd_src_kernel (launched by
_bwd_src_chunk, math in _edge_backward_core), the chunked path's d_zs. The
CUDA source is csrc/pallas_bwd_src.cu, whose header note says what bounds
the kernel on the card and what its design does about that.

Both versions take one source chunk's inputs and give the same output:

  zs           [>= chunk nodes with an edge, H*D] fp32 — src projections,
               node order from the chunk's first node on
  zd, g        [Nd, H*D] fp32 — dst projections and the upstream gradient
               of the op's output, node order (global ids)
  sr           [Nd, 32] fp32 — the _sigma_r_table rows (global ids)
  a            [H, D] fp32, H <= 16
  src_ids      [Ec] int32 — the src side's ids_grp row: chunk-relative src
               node per edge slot, sorted within each tile; padding slots
               carry the chunk's row count (or more)
  dst_ids      [Ec] int32 — the src side's other_grp row: the edge's GLOBAL
               dst id (0 on padding)
  rel_offsets  [T+1] int32 — each 128-node src tile's edge-tile range
  te           edges per edge tile
  -> dzs [T*128, H*D] fp32 in node order: per src node, the sum over its
     edges of the packet c1 = alpha * g[dst] + ds (K6's packet, rebuilt
     from the dst side instead of read from a packet buffer).
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.pallas_bwd_dst import segment_scratch
from gatv2_tpu_torch.ops.pallas_fwd import (
    STATS_L,
    TILE_N,
    check_inputs,
    raise_on_error,
    real_edges,
)
from gatv2_tpu_torch.ops.segment import EXP_CLAMP

# edges per step of the twin: its per-edge temporaries stay a few hundred MB
# at 512 lanes in float64
PLAIN_EDGE_BLOCK = 1 << 18

_P, _I = ctypes.c_void_p, ctypes.c_int


def pallas_bwd_src_plain(zs, zd, g, sr, a, src_ids, dst_ids, rel_offsets, te,
                         *, negative_slope: float):
    """K8's plain PyTorch twin: _edge_backward_core's per-edge packet over
    the real edge slots, block by block, summed per src node with
    index_add_. Runs on any device."""
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    rows = (rel_offsets.numel() - 1) * TILE_N
    pos, sid = real_edges(src_ids, rel_offsets, te)
    did = dst_ids.long()[pos]
    a_flat = a.reshape(hd)
    dzs = zs.new_zeros((rows, hd))
    for b0 in range(0, pos.numel(), PLAIN_EDGE_BLOCK):
        s_e, d_e = (x[b0: b0 + PLAIN_EDGE_BLOCK] for x in (sid, did))
        z, gg, stats = zs[s_e], g[d_e], sr[d_e]
        s = z + zd[d_e]
        s_act = torch.where(s > 0, s, negative_slope * s)
        sc = (s_act.view(-1, num_heads, head_dim) * a).sum(-1)
        alpha = torch.exp(torch.clamp(sc - stats[:, :num_heads], EXP_CLAMP,
                                      0.0))
        dalpha = (gg * z).view(-1, num_heads, head_dim).sum(-1)
        de = alpha * (dalpha - stats[:, STATS_L:STATS_L + num_heads])
        ds = (de.repeat_interleave(head_dim, 1) * a_flat
              * torch.where(s > 0, 1.0, negative_slope))
        dzs.index_add_(0, s_e, alpha.repeat_interleave(head_dim, 1) * gg + ds)
    return dzs


def pallas_bwd_src(zs, zd, g, sr, a, src_ids, dst_ids, rel_offsets, te, *,
                   negative_slope: float):
    """K8. On CUDA tensors it launches csrc/pallas_bwd_src.cu (building it
    at the first call) or raises; on CPU tensors it runs
    pallas_bwd_src_plain. Returns dzs as described in the module
    docstring."""
    if zs.device.type == "cpu":
        return pallas_bwd_src_plain(
            zs, zd, g, sr, a, src_ids, dst_ids, rel_offsets, te,
            negative_slope=negative_slope)
    if zs.device.type != "cuda":
        raise ValueError(f"pallas_bwd_src: unsupported device {zs.device}")
    check_inputs(
        "pallas_bwd_src",
        [("zs", zs), ("zd", zd), ("g", g), ("sr", sr), ("a", a)],
        [("src_ids", src_ids), ("dst_ids", dst_ids),
         ("rel_offsets", rel_offsets)], a, rel_offsets, te)
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    for name, t in (("zs", zs), ("zd", zd), ("g", g)):
        if t.dim() != 2 or t.shape[1] != hd:
            raise ValueError(
                f"pallas_bwd_src: {name} {tuple(t.shape)} must be [N, {hd}]")
    if sr.dim() != 2 or sr.shape != (g.shape[0], 2 * STATS_L):
        raise ValueError(
            f"pallas_bwd_src: sr {tuple(sr.shape)} must be [{g.shape[0]}, "
            f"{2 * STATS_L}] (g's nodes)")
    if src_ids.numel() != dst_ids.numel():
        raise ValueError("pallas_bwd_src: src_ids and dst_ids differ in length")
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("pallas_bwd_src")
    fn = lib.gatv2_pallas_bwd_src
    fn.argtypes = [_P] * 8 + [_I] * 5 + [ctypes.c_float, _I] + [_P] * 4
    fn.restype = _I
    rows = (rel_offsets.numel() - 1) * TILE_N
    slots = src_ids.numel()
    seg_blocks, seg_part, seg_meta = segment_scratch(slots, hd, zs)
    dzs = zs.new_empty((rows, hd))
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            zs.data_ptr(), zd.data_ptr(), g.data_ptr(), sr.data_ptr(),
            a.data_ptr(), src_ids.data_ptr(), dst_ids.data_ptr(),
            rel_offsets.data_ptr(), int(te), rows, slots, num_heads,
            head_dim, float(negative_slope), seg_blocks, dzs.data_ptr(),
            seg_part.data_ptr(), seg_meta.data_ptr(), stream,
        )
    raise_on_error(lib, err, "pallas_bwd_src")
    pallas_bwd_src.launches += 1
    return dzs


pallas_bwd_src.launches = 0  # K8 launches since the last reset
