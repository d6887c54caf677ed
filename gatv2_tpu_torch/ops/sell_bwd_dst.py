"""K2 — the SELL backward kernel over destination rows: its wrapper, its
plain PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/sell_attention.py:_sell_bwd_dst_kernel (launched by
_sell_bwd_dst), with emit_c1=True on the unchunked layout and emit_c1=False
once per chunk of a chunked one. The CUDA source is csrc/sell_bwd_dst.cu,
whose header note says what bounds the kernel on the card and what its
design does about that.

Both versions take the same inputs and give the same outputs, so they can
be compared element for element:

  zs          [Ns, H*D] fp32 — src projections, node order
  zd          [Nd, H*D] fp32 — dst projections, node order
  g           [Nd, H*D] fp32 — upstream gradient of the op's output
  sigma       [Nd, H] fp32 — the forward's m + log(l + 1e-8), per node
  r           [Nd, H] fp32 — <g, out> per node and head
  a           [H, D] fp32
  perm, gather_ids, cnt, col_off — the dst side's layout (as for K1), or
              one chunk's: its perm rows, ids_grp, cnt_grp and rel_off
  -> dzd [T*128, H*D] fp32 in row order,
     da [H, D] fp32,
     c1 [Ec, H*D] fp32 packets in ELL slot order, or None with
     emit_c1=False. Only the real slots are defined: the kernel leaves
     padding slots unwritten. dzd and da do not depend on emit_c1.
  With edge_feat [Ec, k] and w_e [H, D, k] (the edge-feature variant) the
  scores read LeakyReLU(zs + zd + W_e f), and a fourth output is dW_e's
  partials [P, k, H*D]: their sum over P, plus what `dwe_part` held, is
  sum over the real slots of ds (x) f, transposed. The kernel adds each
  block's partial into row P = block of `dwe_part` (zeros when None), so
  launches over the chunks of one layout accumulate in launch order; the
  twin adds its whole sum into row 0.

Node-order tables are read through perm only on rows that have an edge, and
zs only on real slots, so the ids of padding rows and slots (the padded
node counts) are never read.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.segment import EXP_CLAMP
from gatv2_tpu_torch.ops.sell_fwd import (
    MAX_HD,
    MAX_HEADS,
    NEG_INF,
    TILE_N,
    check_edge,
    edge_args,
    edge_term,
)

BLOCK = 256  # threads per block (csrc/sell_bwd_dst.cu kBlock)
# thread blocks per launch at most; blocks stride over the rows, so the d_a
# partials (one per block) stay at most MAX_BLOCKS x H*D
MAX_BLOCKS = 4096


def rows_per_block(num_heads: int, head_dim: int, *tables) -> int:
    """The rows one kernel block takes at a time: BLOCK threads over lane
    groups of csrc/lane_groups.cuh's geometry() (vectors of 4 floats when
    D is a multiple of 4 and every row table is 16-byte aligned, else 1; a
    power of two of lanes per head, at most 32 lanes a row). The wrapper
    sizes the grid by it; the kernel's grid-stride loop covers the rows
    whatever the block count."""
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in tables)
    qph = head_dim // 4 if head_dim % 4 == 0 and aligned else head_dim
    cap = 1
    while cap * 2 * num_heads <= 32:
        cap *= 2
    lph = 1
    while lph < qph and lph < cap:
        lph *= 2
    lanes = 1
    while lanes < num_heads * lph:
        lanes *= 2
    return BLOCK // lanes


_P, _I = ctypes.c_void_p, ctypes.c_int


def sell_bwd_dst_plain(zs, zd, g, sigma, r, a, perm, gather_ids, cnt,
                       col_off, *, negative_slope: float, emit_c1: bool = True,
                       edge_feat=None, w_e=None, dwe_part=None):
    """K2's plain PyTorch twin: the masked column-by-column algebra of the
    TPU kernel, every slice at once. Padding slots keep their masked terms
    (alpha = exp(-80) on rows with edges). Runs on any device."""
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    col_off, cnt, ids = col_off.long(), cnt.long(), gather_ids.long()
    rows = (col_off.numel() - 1) * TILE_N
    dzd = zs.new_zeros((rows, hd))
    da = zs.new_zeros(hd)
    c1 = zs.new_zeros((ids.numel(), hd)) if emit_c1 else None
    widths = col_off[1:] - col_off[:-1]
    lane = torch.arange(TILE_N, device=zs.device)
    rows_idx = perm.long()

    def by_row(t):
        # node-order table -> row order; a padding row's node id lies past
        # the table and reads an appended zero row, as in the TPU path
        t_z = torch.cat([t, t.new_zeros((1, t.shape[1]))])
        return t_z[rows_idx.clamp(max=t.shape[0])]

    zd_p, g_p, sig_p, r_p = by_row(zd), by_row(g), by_row(sigma), by_row(r)
    zs_z = torch.cat([zs, zs.new_zeros((1, hd))])  # pad slots -> 0
    a_flat = a.reshape(hd)
    dwe = None
    if edge_feat is not None:
        dwe = zs.new_zeros((edge_feat.shape[1], hd))
    for k in range(int(widths.max()) if widths.numel() else 0):
        act = torch.nonzero(widths > k).squeeze(1)  # slices with column k
        col = col_off[act] + k
        rr = (act[:, None] * TILE_N + lane).reshape(-1)
        slot = (col[:, None] * TILE_N + lane).reshape(-1)
        valid = (lane[None, :] < cnt[col][:, None]).reshape(-1)
        z = zs_z[torch.where(valid, ids[slot], zs.shape[0])]
        gg = g_p[rr]
        s = z + zd_p[rr]
        if edge_feat is not None:
            s = s + edge_term(edge_feat, w_e, slot)
        s_act = torch.where(s > 0, s, negative_slope * s)
        sc = (s_act.view(-1, num_heads, head_dim) * a).sum(-1)
        sc = sc + torch.where(valid, 0.0, NEG_INF)[:, None]
        alpha = torch.exp(torch.clamp(sc - sig_p[rr], EXP_CLAMP, 0.0))
        dalpha = (gg * z).view(-1, num_heads, head_dim).sum(-1)
        de = (alpha * (dalpha - r_p[rr])).repeat_interleave(head_dim, 1)
        ds = de * a_flat * torch.where(s > 0, 1.0, negative_slope)
        dzd[rr] = dzd[rr] + ds
        da = da + (de * s_act).sum(0)
        if emit_c1:
            c1[slot] = alpha.repeat_interleave(head_dim, 1) * gg + ds
        if dwe is not None:
            # real slots only: a padding slot's features are zeros anyway
            dwe = dwe + (edge_feat[slot] * valid[:, None]).T @ ds
    if dwe is None:
        return dzd, da.view(num_heads, head_dim), c1
    if dwe_part is None:
        dwe_part = dwe[None]
    else:
        dwe_part[0] += dwe
    return dzd, da.view(num_heads, head_dim), c1, dwe_part


def _check(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, *,
           kernel="sell_bwd_dst"):
    """The checks K2's and K4's wrappers make before a launch: one device,
    fp32 / int32, contiguous, at most 32 heads and 512 lanes, node-order
    tables that agree, a layout whose sizes agree."""
    dev = zs.device
    for name, t, dt in (
        ("zs", zs, torch.float32), ("zd", zd, torch.float32),
        ("g", g, torch.float32), ("sigma", sigma, torch.float32),
        ("r", r, torch.float32), ("a", a, torch.float32),
        ("perm", perm, torch.int32), ("gather_ids", gather_ids, torch.int32),
        ("cnt", cnt, torch.int32), ("col_off", col_off, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(
                f"{kernel}: {name} is on {t.device}, zs on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{kernel}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    if hd > MAX_HD or num_heads > MAX_HEADS:
        raise ValueError(
            f"{kernel}: H={num_heads}, H*D={hd} exceed {MAX_HEADS} heads "
            f"or {MAX_HD} lanes per launch; split heads (heads_per_launch)"
        )
    for name, t in (("zs", zs), ("zd", zd), ("g", g)):
        if t.dim() != 2 or t.shape[1] != hd:
            raise ValueError(
                f"{kernel}: {name} {tuple(t.shape)} must be [N, {hd}]")
    if g.shape[0] != zd.shape[0] or sigma.shape != (zd.shape[0], num_heads) \
            or r.shape != sigma.shape:
        raise ValueError(
            f"{kernel}: g {tuple(g.shape)}, sigma {tuple(sigma.shape)} "
            f"and r {tuple(r.shape)} must cover zd's {zd.shape[0]} nodes "
            f"and {num_heads} heads"
        )
    rows = (col_off.numel() - 1) * TILE_N
    if perm.numel() != rows or gather_ids.numel() != cnt.numel() * TILE_N:
        raise ValueError(
            f"{kernel}: layout sizes disagree: perm {perm.numel()} vs "
            f"{rows} rows, gather_ids {gather_ids.numel()} vs "
            f"{cnt.numel()} columns"
        )


def sell_bwd_dst(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, *,
                 negative_slope: float, emit_c1: bool = True, edge_feat=None,
                 w_e=None, dwe_part=None):
    """K2. On CUDA tensors it launches csrc/sell_bwd_dst.cu (building it at
    the first call) or raises; on CPU tensors it runs sell_bwd_dst_plain.
    Returns (dzd, da, c1), and with edge_feat and w_e (the kernel's
    edge-feature variant) (dzd, da, c1, dwe_part), as described in the
    module docstring."""
    check_edge(edge_feat, w_e, a, gather_ids, "sell_bwd_dst")
    if zs.device.type == "cpu":
        return sell_bwd_dst_plain(
            zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
            negative_slope=negative_slope, emit_c1=emit_c1,
            edge_feat=edge_feat, w_e=w_e, dwe_part=dwe_part,
        )
    if zs.device.type != "cuda":
        raise ValueError(f"sell_bwd_dst: unsupported device {zs.device}")
    _check(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off)
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    rows = perm.numel()
    dzd = zs.new_empty((rows, hd))
    c1 = zs.new_empty((gather_ids.numel(), hd)) if emit_c1 else None
    ef, wt, k = edge_args(edge_feat, w_e)
    if rows == 0:  # a grid of zero blocks is an invalid launch
        out = (dzd, a.new_zeros(a.shape), c1)
        if ef is not None:
            out += (dwe_part if dwe_part is not None
                    else zs.new_zeros((1, k, hd)),)
        return out
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("sell_bwd_dst")
    fn = lib.gatv2_sell_bwd_dst
    fn.argtypes = ([_P] * 10 + [_I] * 3 + [ctypes.c_float, _I] + [_P] * 2
                   + [_I] + [_P] * 5)
    fn.restype = _I
    per_block = rows_per_block(num_heads, head_dim, zs, zd, g, a, dzd, c1)
    blocks = min(-(-rows // per_block), MAX_BLOCKS)
    da_part = zs.new_empty((blocks, hd))
    if ef is not None:
        if dwe_part is None:
            dwe_part = zs.new_zeros((blocks, k, hd))
        elif dwe_part.shape != (blocks, k, hd) or \
                not dwe_part.is_contiguous():
            raise ValueError(
                f"sell_bwd_dst: dwe_part {tuple(dwe_part.shape)} must be a "
                f"contiguous [{blocks}, {k}, {hd}] (the launch's blocks)")
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            zs.data_ptr(), zd.data_ptr(), g.data_ptr(), sigma.data_ptr(),
            r.data_ptr(), a.data_ptr(), perm.data_ptr(), gather_ids.data_ptr(),
            cnt.data_ptr(), col_off.data_ptr(), rows, num_heads, head_dim,
            float(negative_slope), blocks, ef,
            None if wt is None else wt.data_ptr(), k, dzd.data_ptr(),
            da_part.data_ptr(), c1.data_ptr() if emit_c1 else None,
            None if ef is None else dwe_part.data_ptr(), stream,
        )
    if err != 0:
        lib.gatv2_cuda_error_string.restype = ctypes.c_char_p
        lib.gatv2_cuda_error_string.argtypes = [_I]
        msg = lib.gatv2_cuda_error_string(err).decode()
        raise RuntimeError(
            f"sell_bwd_dst launch failed: CUDA error {err} ({msg})")
    sell_bwd_dst.launches += 1
    # the per-block partials summed in a fixed order: deterministic
    out = (dzd, da_part.sum(0).view(num_heads, head_dim), c1)
    return out if ef is None else out + (dwe_part,)


sell_bwd_dst.launches = 0  # K2 launches since the last reset
