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


def heads_per_launch(head_dim: int) -> int:
    """How many heads of width head_dim one K1 launch takes."""
    return min(MAX_HEADS, max(1, MAX_HD // head_dim))


_P, _I = ctypes.c_void_p, ctypes.c_int


def sell_fwd_plain(zs, zd, a, perm, gather_ids, cnt, col_off, *,
                   negative_slope: float, normalize: bool):
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
        src = ids[(col[:, None] * TILE_N + lane).reshape(-1)]
        z = zs_z[torch.where(valid, src, zs.shape[0])]
        s = z + zd_p[r]
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
             negative_slope: float, normalize: bool):
    """K1. On CUDA tensors it launches csrc/sell_fwd.cu (building it at the
    first call) or raises; on CPU tensors it runs sell_fwd_plain. Returns
    (out, m, l) as described in the module docstring."""
    if zs.device.type == "cpu":
        return sell_fwd_plain(
            zs, zd, a, perm, gather_ids, cnt, col_off,
            negative_slope=negative_slope, normalize=normalize,
        )
    if zs.device.type != "cuda":
        raise ValueError(f"sell_fwd: unsupported device {zs.device}")
    _check(zs, zd, a, perm, gather_ids, cnt, col_off)
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("sell_fwd")
    fn = lib.gatv2_sell_fwd
    fn.argtypes = [_P] * 7 + [_I] * 3 + [ctypes.c_float, _I] + [_P] * 4
    fn.restype = _I
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
            out.data_ptr(), m.data_ptr(), l.data_ptr(), stream,
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
