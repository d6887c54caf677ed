"""K7 — the streamed-operand backward kernel over source rows (the packet
sum): its wrapper, its plain PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/pallas_attention.py:_segsum_src_kernel (launched by
_segsum_src), the unchunked path's d_zs. The CUDA source is
csrc/pallas_segsum.cu, whose header note says what bounds the kernel on the
card and what its design does about that.

Both versions take the same inputs and give the same outputs:

  c1           [Ec, H*D] fp32 — K6's packets in dst-sorted edge order (only
               the real slots need be defined)
  gather_perm  [Ec2] int32 — src-sorted entry -> its edge's dst-sorted slot
  src_ids      [Ec2] int32 — src node per src-sorted entry, sorted within
               each tile; padding entries carry the padded node count
  rel_offsets  [T2+1] int32 — each 128-node src tile's edge-tile range
  te           edges per edge tile
  -> dzs [T2*128, H*D] fp32 in node order: each node's sum of the packets
     of its edges.

Padding entries are skipped by their id, never multiplied by a zero mask: a
packet slot K6 did not write may hold NaN. The kernel sums each node's
packets in entry order; a node of more than 32 entries in parts (over the
block's lane groups, past 1,024 entries over segment blocks), whose sums
it adds in part order (csrc/edge_tiles.cuh), with no atomics.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.pallas_bwd_dst import segment_scratch
from gatv2_tpu_torch.ops.pallas_fwd import (
    MAX_HD,
    TILE_N,
    check_inputs,
    raise_on_error,
    real_edges,
)
from gatv2_tpu_torch.ops.segment import segment_sum

_P, _I = ctypes.c_void_p, ctypes.c_int


def pallas_segsum_plain(c1, gather_perm, src_ids, rel_offsets, te):
    """K7's plain PyTorch twin: the real entries' packets gathered through
    gather_perm and summed per src node. Runs on any device."""
    rows = (rel_offsets.numel() - 1) * TILE_N
    pos, s = real_edges(src_ids, rel_offsets, te)
    return segment_sum(c1[gather_perm.long()[pos]], s, rows)


def pallas_segsum(c1, gather_perm, src_ids, rel_offsets, te):
    """K7. On CUDA tensors it launches csrc/pallas_segsum.cu (building it at
    the first call) or raises; on CPU tensors it runs pallas_segsum_plain.
    Returns dzs as described in the module docstring."""
    if c1.device.type == "cpu":
        return pallas_segsum_plain(c1, gather_perm, src_ids, rel_offsets, te)
    if c1.device.type != "cuda":
        raise ValueError(f"pallas_segsum: unsupported device {c1.device}")
    check_inputs("pallas_segsum", [("c1", c1)],
                 [("gather_perm", gather_perm), ("src_ids", src_ids),
                  ("rel_offsets", rel_offsets)], None, rel_offsets, te)
    if c1.dim() != 2 or c1.shape[1] > MAX_HD:
        raise ValueError(
            f"pallas_segsum: c1 {tuple(c1.shape)} must be [E, H*D <= {MAX_HD}]")
    if gather_perm.numel() != src_ids.numel():
        raise ValueError(
            "pallas_segsum: gather_perm and src_ids differ in length")
    rows = (rel_offsets.numel() - 1) * TILE_N
    hd = c1.shape[1]
    dzs = c1.new_empty((rows, hd))
    if hd == 0:  # a launch with no feature lane has nothing to write
        return dzs
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("pallas_segsum")
    fn = lib.gatv2_pallas_segsum
    fn.argtypes = [_P] * 4 + [_I] * 5 + [_P] * 4
    fn.restype = _I
    slots = src_ids.numel()
    seg_blocks, seg_part, seg_meta = segment_scratch(slots, hd, c1)
    with torch.cuda.device(c1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            c1.data_ptr(), gather_perm.data_ptr(), src_ids.data_ptr(),
            rel_offsets.data_ptr(), int(te), rows, slots, hd, seg_blocks,
            dzs.data_ptr(), seg_part.data_ptr(), seg_meta.data_ptr(), stream,
        )
    raise_on_error(lib, err, "pallas_segsum")
    pallas_segsum.launches += 1
    return dzs


pallas_segsum.launches = 0  # K7 launches since the last reset
