"""K3 — the SELL backward kernel over source rows (the packet sum): its
wrapper, its plain PyTorch twin and its ctypes binding.

Replaces gatv2_tpu/ops/sell_attention.py:_sell_segsum_kernel (launched by
_sell_segsum), the unchunked path's d_zs. The CUDA source is
csrc/sell_segsum.cu, whose header note says what bounds the kernel on the
card and what its design does about that.

Both versions take the same inputs and give the same outputs:

  c1          [Ec, H*D] fp32 — K2's packets in dst-ELL slot order (only
              the real slots need be defined)
  ell_perm    [Ec2] int32 — src-ELL slot -> dst-ELL slot of the same edge
  cnt         [Ec2/128] int32 — real rows per 128-edge column (src side)
  col_off     [T2+1] int32 — column offsets of the src side's T2 slices
  -> dzs [T2*128, H*D] fp32 in src row order: each row's sum of the packets
     of its real slots, column by column.

Padding slots are skipped by their column count, never multiplied by a
zero mask: a packet slot K2 did not write may hold NaN.
"""

from __future__ import annotations

import ctypes

import torch

from gatv2_tpu_torch.ops.sell_fwd import MAX_HD, TILE_N

_P, _I = ctypes.c_void_p, ctypes.c_int


def sell_segsum_plain(c1, ell_perm, cnt, col_off):
    """K3's plain PyTorch twin: the masked column-by-column sum of the TPU
    kernel over the packets read through ell_perm, every slice at once.
    Runs on any device."""
    col_off, cnt = col_off.long(), cnt.long()
    perm = ell_perm.long()
    rows = (col_off.numel() - 1) * TILE_N
    dzs = c1.new_zeros((rows, c1.shape[1]))
    widths = col_off[1:] - col_off[:-1]
    lane = torch.arange(TILE_N, device=c1.device)
    for k in range(int(widths.max()) if widths.numel() else 0):
        act = torch.nonzero(widths > k).squeeze(1)  # slices with column k
        col = col_off[act] + k
        rr = (act[:, None] * TILE_N + lane).reshape(-1)
        slot = (col[:, None] * TILE_N + lane).reshape(-1)
        valid = (lane[None, :] < cnt[col][:, None]).reshape(-1)
        # a padding slot's id (the dst side's slot count) is clamped onto
        # some packet and then dropped by the select
        p = perm[slot].clamp(max=c1.shape[0] - 1)
        dzs[rr] = dzs[rr] + torch.where(valid[:, None], c1[p], 0.0)
    return dzs


def _check(c1, ell_perm, cnt, col_off):
    dev = c1.device
    for name, t, dt in (
        ("c1", c1, torch.float32), ("ell_perm", ell_perm, torch.int32),
        ("cnt", cnt, torch.int32), ("col_off", col_off, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(f"sell_segsum: {name} is on {t.device}, c1 on {dev}")
        if t.dtype != dt:
            raise ValueError(f"sell_segsum: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sell_segsum: {name} must be contiguous")
    if c1.dim() != 2 or c1.shape[1] > MAX_HD:
        raise ValueError(
            f"sell_segsum: c1 {tuple(c1.shape)} must be [E, H*D <= {MAX_HD}]")
    if ell_perm.numel() != cnt.numel() * TILE_N:
        raise ValueError(
            f"sell_segsum: ell_perm {ell_perm.numel()} vs {cnt.numel()} "
            f"columns of {TILE_N}"
        )


def sell_segsum(c1, ell_perm, cnt, col_off):
    """K3. On CUDA tensors it launches csrc/sell_segsum.cu (building it at
    the first call) or raises; on CPU tensors it runs sell_segsum_plain.
    Returns dzs as described in the module docstring."""
    if c1.device.type == "cpu":
        return sell_segsum_plain(c1, ell_perm, cnt, col_off)
    if c1.device.type != "cuda":
        raise ValueError(f"sell_segsum: unsupported device {c1.device}")
    _check(c1, ell_perm, cnt, col_off)
    rows = (col_off.numel() - 1) * TILE_N
    hd = c1.shape[1]
    dzs = c1.new_empty((rows, hd))
    if rows == 0 or hd == 0:  # a grid of zero blocks is an invalid launch
        return dzs
    from gatv2_tpu_torch.ops.build import load_library

    lib = load_library("sell_segsum")
    fn = lib.gatv2_sell_segsum
    fn.argtypes = [_P] * 4 + [_I] * 2 + [_P] * 2
    fn.restype = _I
    with torch.cuda.device(c1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            c1.data_ptr(), ell_perm.data_ptr(), cnt.data_ptr(),
            col_off.data_ptr(), rows, hd, dzs.data_ptr(), stream,
        )
    if err != 0:
        lib.gatv2_cuda_error_string.restype = ctypes.c_char_p
        lib.gatv2_cuda_error_string.argtypes = [_I]
        msg = lib.gatv2_cuda_error_string(err).decode()
        raise RuntimeError(
            f"sell_segsum launch failed: CUDA error {err} ({msg})")
    sell_segsum.launches += 1
    return dzs


sell_segsum.launches = 0  # K3 launches since the last reset
