"""K4 — the SELL backward kernel over source rows on a chunked layout (phase
2b, d_zs by per-edge recompute, or from K2's compact packets): its wrapper,
its plain PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/sell_attention.py:_sell_bwd_src_kernel (launched by
_sell_bwd_src), the chunked path's d_zs. The CUDA source is
csrc/sell_bwd_src.cu, whose header note says what bounds the kernel on the
card and what its design does about that.

Both versions take one source chunk's inputs and give the same output, so
they can be compared element for element:

  zs          [Ns, H*D] fp32 — src projections, node order
  zd, g       [Nd, H*D] fp32 — dst projections and the upstream gradient of
              the op's output, node order
  sigma, r    [Nd, H] fp32 — the forward's m + log(l + 1e-8) and <g, out>
              per dst node and head
  a           [H, D] fp32
  perm        [spc*128] int32 — the chunk's rows of the src side's perm: row
              j holds (a virtual row of) src node perm[j]
  gather_ids  [Ec] int32 — the chunk's ids_grp: each slot's GLOBAL dst id
              (padding slots carry the dst side's padded node count)
  cnt         [Ec/128] int32 — the chunk's cnt_grp
  col_off     [spc+1] int32 — the chunk's rel_off
  compact, ell_perm — optional, together (the compact variant, which the
              edge-feature backward launches): K2's compact packets of the
              whole layer [slots, words] (ops/sell_bwd_dst.py
              compact_buffer) and the chunk's ell_perm [Ec] int32, each
              slot's packet row; alpha, de and the sign of the
              pre-activation (which held W_e f) then come from the packet
              and zs, zd, sigma and r are not read
  -> dzs [spc*128, H*D] fp32 in row order: per row, the sum over its real
     slots of the edge's packet c1 = alpha * g[dst] + ds, rebuilt from the
     dst side's node-order tables (K2's packet, without a packet buffer),
     or from the compact packet and the g row.

Node-order tables are read only through real slots (dst) and rows that have
an edge (src), so the ids of padding slots and rows are never read.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.segment import EXP_CLAMP
from gatv2_tpu_torch.ops.sell_bwd_dst import (
    _check,
    check_compact,
    unpack_compact,
)
from gatv2_tpu_torch.ops.sell_fwd import TILE_N

_P, _I = ctypes.c_void_p, ctypes.c_int


def sell_bwd_src_plain(zs, zd, g, sigma, r, a, perm, gather_ids, cnt,
                       col_off, *, negative_slope: float, compact=None,
                       ell_perm=None):
    """K4's plain PyTorch twin: the TPU kernel's column-by-column algebra,
    every slice of the chunk at once, padding slots masked out (in the TPU
    kernel they gather the tables' appended zero row, g = r = 0, and add
    exactly 0); with compact and ell_perm, alpha, de and the signs read
    from the compact packets. Runs on any device."""
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    col_off, cnt, ids = col_off.long(), cnt.long(), gather_ids.long()
    rows = (col_off.numel() - 1) * TILE_N
    dzs = g.new_zeros((rows, hd))
    widths = col_off[1:] - col_off[:-1]
    lane = torch.arange(TILE_N, device=g.device)
    nd = g.shape[0]

    def with_zero_row(t):
        return torch.cat([t, t.new_zeros((1, t.shape[1]))])

    if compact is None:
        # a padding row's node id lies past zs and reads the appended zero
        # row
        zs_p = with_zero_row(zs)[perm.long().clamp(max=zs.shape[0])]
        zd_z, sig_z, r_z = (with_zero_row(t) for t in (zd, sigma, r))
    else:
        pks = ell_perm.long()
    g_z = with_zero_row(g)
    a_flat = a.reshape(hd)
    for k in range(int(widths.max()) if widths.numel() else 0):
        act = torch.nonzero(widths > k).squeeze(1)  # slices with column k
        col = col_off[act] + k
        rr = (act[:, None] * TILE_N + lane).reshape(-1)
        slot = (col[:, None] * TILE_N + lane).reshape(-1)
        valid = (lane[None, :] < cnt[col][:, None]).reshape(-1)
        d = torch.where(valid, ids[slot], nd)
        gg = g_z[d]
        if compact is None:
            z = zs_p[rr]
            s = z + zd_z[d]
            s_act = torch.where(s > 0, s, negative_slope * s)
            sc = (s_act.view(-1, num_heads, head_dim) * a).sum(-1)
            alpha = torch.exp(torch.clamp(sc - sig_z[d], EXP_CLAMP, 0.0))
            dalpha = (gg * z).view(-1, num_heads, head_dim).sum(-1)
            de = alpha * (dalpha - r_z[d])
            pos = s > 0
        else:
            alpha, de, pos = unpack_compact(
                compact[torch.where(valid, pks[slot], 0)], num_heads,
                head_dim)
        de = de.repeat_interleave(head_dim, 1)
        ds = de * a_flat * torch.where(pos, 1.0, negative_slope)
        c1 = alpha.repeat_interleave(head_dim, 1) * gg + ds
        dzs[rr] = dzs[rr] + torch.where(valid[:, None], c1, 0.0)
    return dzs


def sell_bwd_src(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, *,
                 negative_slope: float, compact=None, ell_perm=None):
    """K4. On CUDA tensors it launches csrc/sell_bwd_src.cu (building it at
    the first call) or raises; on CPU tensors it runs sell_bwd_src_plain.
    Returns dzs as described in the module docstring; with compact and
    ell_perm it launches the kernel's compact variant."""
    if (compact is None) != (ell_perm is None):
        raise ValueError("sell_bwd_src: compact and ell_perm go together")
    if ell_perm is not None and ell_perm.shape != gather_ids.shape:
        raise ValueError(
            f"sell_bwd_src: ell_perm {tuple(ell_perm.shape)} must give each "
            f"of the chunk's {gather_ids.numel()} slots its packet row")
    if zs.device.type == "cpu":
        return sell_bwd_src_plain(
            zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
            negative_slope=negative_slope, compact=compact,
            ell_perm=ell_perm,
        )
    if zs.device.type != "cuda":
        raise ValueError(f"sell_bwd_src: unsupported device {zs.device}")
    _check(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
           kernel="sell_bwd_src")
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    rows = perm.numel()
    dzs = zs.new_empty((rows, hd))
    if compact is not None:
        check_compact(compact, a, "sell_bwd_src", g, a, dzs)
        if ell_perm.dtype != torch.int32 or not ell_perm.is_contiguous() \
                or ell_perm.device != zs.device:
            raise ValueError(
                f"sell_bwd_src: ell_perm must be contiguous int32 on "
                f"{zs.device}")
    if rows == 0:  # a grid of zero blocks is an invalid launch
        return dzs
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("sell_bwd_src")
    fn = lib.gatv2_sell_bwd_src
    fn.argtypes = [_P] * 10 + [_I] * 3 + [ctypes.c_float] + [_P] * 4
    fn.restype = _I
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            zs.data_ptr(), zd.data_ptr(), g.data_ptr(), sigma.data_ptr(),
            r.data_ptr(), a.data_ptr(), perm.data_ptr(), gather_ids.data_ptr(),
            cnt.data_ptr(), col_off.data_ptr(), rows, num_heads, head_dim,
            float(negative_slope),
            None if compact is None else compact.data_ptr(),
            None if ell_perm is None else ell_perm.data_ptr(),
            dzs.data_ptr(), stream,
        )
    if err != 0:
        lib.gatv2_cuda_error_string.restype = ctypes.c_char_p
        lib.gatv2_cuda_error_string.argtypes = [_I]
        msg = lib.gatv2_cuda_error_string(err).decode()
        raise RuntimeError(
            f"sell_bwd_src launch failed: CUDA error {err} ({msg})")
    sell_bwd_src.launches += 1
    if compact is not None:
        sell_bwd_src.packet_launches += 1
    return dzs


sell_bwd_src.launches = 0  # K4 launches since the last reset
# of those, the compact variant's, which read K2's compact packets
sell_bwd_src.packet_launches = 0
