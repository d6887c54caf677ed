"""K1 — the SELL forward kernel: its wrapper, its plain PyTorch twin and its
ctypes binding.

Replaces gatv2_tpu/ops/sell_attention.py:_sell_fwd_kernel (launched by
_sell_forward). The CUDA source is csrc/sell_fwd.cu, whose header note says
what bounds the kernel on the card and what its design does about that.

Both versions take the same inputs and give the same outputs, so they can
be compared element for element:

  zs          [Ns, H*D] fp32 — src projections, node order
  zd          [Nd, H*D] fp32 — dst projections, node order
  a           [H, D] fp32
  perm        [T*128] int32 — row -> node (rows with edges only are read)
  gather_ids  [Ec] int32 — src node per ELL slot (padding slots unread)
  cnt         [Ec/128] int32 — real rows per 128-edge column
  col_off     [T+1] int32 — column offsets of the T slices
  edge_feat   [Ec, k] fp32, optional — each slot's edge features (the
              side's edge_feat of this chunk); with w_e [H, D, k] each
              score reads LeakyReLU(zs + zd + W_e f) (the edge-feature
              variant of the kernel)
  -> out [T*128, H*D], m [T*128, H], l [T*128, H], all fp32, in row order:
     out = acc / (l + 1e-8) if normalize else the raw accumulator.

The layout arrays come from prepare_sell_tiles (one chunk's slice of them
when chunked); their ids index within zs and zd by construction.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.segment import EXP_CLAMP, SOFTMAX_EPS

TILE_N = 128
NEG_INF = -1e30
MAX_HD = 512  # H*D one launch takes (csrc/sell_fwd.cu kMaxHd)
MAX_HEADS = 32  # heads one launch takes (csrc/sell_fwd.cu kMaxHeads)
# edge-feature width the kernels take (csrc/lane_groups.cuh kMaxEdgeDim)
MAX_EDGE_DIM = 16


def heads_per_launch(head_dim: int) -> int:
    """How many heads of width head_dim one K1 launch takes."""
    return min(MAX_HEADS, max(1, MAX_HD // head_dim))


_P, _I = ctypes.c_void_p, ctypes.c_int


def edge_term(edge_feat, w_e, slot):
    """W_e f of the slots `slot`: [n, H*D] from edge_feat [Ec, k] and w_e
    [H, D, k]."""
    return edge_feat[slot] @ w_e.reshape(-1, w_e.shape[-1]).T


def check_edge(edge_feat, w_e, a, gather_ids, kernel):
    """ValueError unless edge_feat and w_e are both None, or both given and
    agree with a [H, D] and the layout's slots."""
    if (edge_feat is None) != (w_e is None):
        raise ValueError(f"{kernel}: edge_feat and w_e go together")
    if edge_feat is None:
        return
    k = w_e.shape[-1]
    if w_e.shape != (*a.shape, k) or edge_feat.shape != (
            gather_ids.numel(), k):
        raise ValueError(
            f"{kernel}: w_e {tuple(w_e.shape)} must be [H, D, k] of a "
            f"{tuple(a.shape)} and edge_feat {tuple(edge_feat.shape)} "
            f"[{gather_ids.numel()} slots, k]")
    for name, t in (("edge_feat", edge_feat), ("w_e", w_e)):
        if t.device != a.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be contiguous fp32 on {a.device}")
    if k > MAX_EDGE_DIM:
        raise ValueError(
            f"{kernel}: edge features of width {k} exceed {MAX_EDGE_DIM}")


def sell_fwd_plain(zs, zd, a, perm, gather_ids, cnt, col_off, *,
                   negative_slope: float, normalize: bool, edge_feat=None,
                   w_e=None):
    """K1's plain PyTorch twin: the masked column-by-column online softmax
    of the TPU kernel, every slice at once. Runs on any device."""
    num_heads, head_dim = a.shape
    col_off, cnt, ids = col_off.long(), cnt.long(), gather_ids.long()
    rows = (col_off.numel() - 1) * TILE_N
    m = zs.new_full((rows, num_heads), NEG_INF)
    l = zs.new_zeros((rows, num_heads))
    acc = zs.new_zeros((rows, num_heads * head_dim))
    widths = col_off[1:] - col_off[:-1]
    lane = torch.arange(TILE_N, device=zs.device)
    # padding rows (node id past zd) have no edge; any finite zd will do
    zd_p = zd[perm.long().clamp(max=zd.shape[0] - 1)]
    zs_z = torch.cat([zs, zs.new_zeros((1, zs.shape[1]))])  # pad slots -> 0
    for k in range(int(widths.max()) if widths.numel() else 0):
        act = torch.nonzero(widths > k).squeeze(1)  # slices with column k
        col = col_off[act] + k
        r = (act[:, None] * TILE_N + lane).reshape(-1)
        valid = (lane[None, :] < cnt[col][:, None]).reshape(-1)
        slot = (col[:, None] * TILE_N + lane).reshape(-1)
        z = zs_z[torch.where(valid, ids[slot], zs.shape[0])]
        s = z + zd_p[r]
        if edge_feat is not None:
            s = s + edge_term(edge_feat, w_e, slot)
        s = torch.where(s > 0, s, negative_slope * s)
        sc = (s.view(-1, num_heads, head_dim) * a).sum(-1)
        sc = sc + torch.where(valid, 0.0, NEG_INF)[:, None]
        m_old = m[r]
        new_m = torch.maximum(m_old, sc)
        c = torch.exp(m_old - new_m)
        p = torch.exp(torch.clamp(sc - new_m, EXP_CLAMP, 0.0))
        l[r] = c * l[r] + p
        acc[r] = (c.repeat_interleave(head_dim, 1) * acc[r]
                  + p.repeat_interleave(head_dim, 1) * z)
        m[r] = new_m
    if normalize:
        acc = acc / (l.repeat_interleave(head_dim, 1) + SOFTMAX_EPS)
    return acc, m, l


def edge_args(edge_feat, w_e):
    """The kernels' edge arguments: the edge_feat pointer, W_e as a [k,
    H*D] tensor (the caller holds it over the launch) and k; nulls and 0
    without edge features."""
    if edge_feat is None:
        return None, None, 0
    k = w_e.shape[-1]
    return edge_feat.data_ptr(), w_e.reshape(-1, k).t().contiguous(), k


def _check(zs, zd, a, perm, gather_ids, cnt, col_off):
    dev = zs.device
    for name, t, dt in (
        ("zs", zs, torch.float32), ("zd", zd, torch.float32),
        ("a", a, torch.float32), ("perm", perm, torch.int32),
        ("gather_ids", gather_ids, torch.int32), ("cnt", cnt, torch.int32),
        ("col_off", col_off, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(f"sell_fwd: {name} is on {t.device}, zs on {dev}")
        if t.dtype != dt:
            raise ValueError(f"sell_fwd: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sell_fwd: {name} must be contiguous")
    num_heads, head_dim = a.shape
    hd = num_heads * head_dim
    if hd > MAX_HD or num_heads > MAX_HEADS:
        raise ValueError(
            f"sell_fwd: H={num_heads}, H*D={hd} exceed {MAX_HEADS} heads or "
            f"{MAX_HD} lanes per launch; split heads (heads_per_launch)"
        )
    if zs.dim() != 2 or zs.shape[1] != hd or zd.dim() != 2 or zd.shape[1] != hd:
        raise ValueError(
            f"sell_fwd: zs {tuple(zs.shape)} / zd {tuple(zd.shape)} must be "
            f"[N, {hd}]"
        )
    rows = (col_off.numel() - 1) * TILE_N
    if perm.numel() != rows or gather_ids.numel() != cnt.numel() * TILE_N:
        raise ValueError(
            f"sell_fwd: layout sizes disagree: perm {perm.numel()} vs "
            f"{rows} rows, gather_ids {gather_ids.numel()} vs "
            f"{cnt.numel()} columns"
        )


def sell_fwd(zs, zd, a, perm, gather_ids, cnt, col_off, *,
             negative_slope: float, normalize: bool, edge_feat=None,
             w_e=None):
    """K1. On CUDA tensors it launches csrc/sell_fwd.cu (building it at the
    first call) or raises; on CPU tensors it runs sell_fwd_plain. Returns
    (out, m, l) as described in the module docstring. With edge_feat and
    w_e it launches the kernel's edge-feature variant."""
    check_edge(edge_feat, w_e, a, gather_ids, "sell_fwd")
    if zs.device.type == "cpu":
        return sell_fwd_plain(
            zs, zd, a, perm, gather_ids, cnt, col_off,
            negative_slope=negative_slope, normalize=normalize,
            edge_feat=edge_feat, w_e=w_e,
        )
    if zs.device.type != "cuda":
        raise ValueError(f"sell_fwd: unsupported device {zs.device}")
    _check(zs, zd, a, perm, gather_ids, cnt, col_off)
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("sell_fwd")
    fn = lib.gatv2_sell_fwd
    fn.argtypes = ([_P] * 7 + [_I] * 3 + [ctypes.c_float, _I] + [_P] * 2
                   + [_I] + [_P] * 4)
    fn.restype = _I
    ef, wt, k = edge_args(edge_feat, w_e)
    num_heads, head_dim = a.shape
    rows = perm.numel()
    out = zs.new_empty((rows, num_heads * head_dim))
    m = zs.new_empty((rows, num_heads))
    l = zs.new_empty((rows, num_heads))
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            zs.data_ptr(), zd.data_ptr(), a.data_ptr(), perm.data_ptr(),
            gather_ids.data_ptr(), cnt.data_ptr(), col_off.data_ptr(),
            rows, num_heads, head_dim, float(negative_slope), int(normalize),
            ef, None if wt is None else wt.data_ptr(), k, out.data_ptr(),
            m.data_ptr(), l.data_ptr(), stream,
        )
    if err != 0:
        lib.gatv2_cuda_error_string.restype = ctypes.c_char_p
        lib.gatv2_cuda_error_string.argtypes = [_I]
        msg = lib.gatv2_cuda_error_string(err).decode()
        raise RuntimeError(f"sell_fwd launch failed: CUDA error {err} ({msg})")
    sell_fwd.launches += 1
    if not normalize:
        sell_fwd.raw_launches += 1
    return out, m, l


sell_fwd.launches = 0  # K1 launches since the last reset (chip_smoke reads it)
sell_fwd.raw_launches = 0  # of those, with normalize=False
