"""Time the port's K4 (csrc/sell_bwd_src.cu) and K5 (csrc/pallas_fwd.cu)
on the card against variants of their own sources and against a bare
gather of the rows they read, to show what bounds them.

The variants are built from copies of the sources with one constant
changed (the ring of edges in flight, the blocks per SM the register budget
is cut for, the block size, evict-first or ordinary loads of K4's zd and g
rows); the kernels in the package are not changed. The bare gathers read
exactly the rows the kernel reads (K4: a zd row, a g row, sigma and r per
real slot, in the layout's slot order; K5: a zs row per real edge) and add
them up, with no other work: the time the memory system needs for that
access pattern.

Inputs are synthetic, shaped like chip_smoke.py's main paths:
products-full chunk 0 for K4 (489,856 source rows of Poisson(25.25)
out-degree over 2,449,029 nodes, each row's destinations ascending, as the
SELL source side lays them out) and a products-sub batch for K5 (985,000
edges into the first 111,000 of 500,096 nodes, as a 1024-seed 10,10,10
batch fills them). Needs the card and nvcc:

    python tools/torch_kernel_variants.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gatv2_tpu_torch.ops import build  # noqa: E402
from gatv2_tpu_torch.ops import pallas_attention as tpa  # noqa: E402

OUT = build.BUILD_DIR / "variants"
PEAK_BYTES_PER_S = 3.35e12

GATHER_SRC = r"""
#include <cuda_runtime.h>
// One thread per (edge, 16-byte part of a row): read part of each table's
// row for the edge's id (and its 4-byte per-node values), add them up and
// store one float per thread, so no load is dead.
extern "C" __global__ void gather(const int* __restrict__ ids, long n,
                                  int hd4, int heads,
                                  const float4* __restrict__ t0,
                                  const float4* __restrict__ t1,
                                  const float* __restrict__ s0,
                                  const float* __restrict__ s1,
                                  float* __restrict__ out) {
  long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (; t < n * hd4; t += (long)gridDim.x * blockDim.x) {
    const long e = t / hd4;
    const int part = (int)(t % hd4);
    const long id = __ldg(ids + e);
    float4 v = __ldcs(t0 + id * hd4 + part);
    acc += v.x + v.y + v.z + v.w;
    if (t1) {
      v = __ldcs(t1 + id * hd4 + part);
      acc += v.x + v.y + v.z + v.w;
    }
    if (s0 && part == 0)
      acc += __ldg(s0 + id * heads) + __ldg(s1 + id * heads);
  }
  out[blockIdx.x * (long)blockDim.x + threadIdx.x] = acc;
}
extern "C" int launch_gather(const int* ids, long n, int hd4, int heads,
                             const float4* t0, const float4* t1,
                             const float* s0, const float* s1, float* out,
                             int blocks, cudaStream_t stream) {
  gather<<<blocks, 256, 0, stream>>>(ids, n, hd4, heads, t0, t1, s0, s1,
                                     out);
  return (int)cudaGetLastError();
}
"""

# (name, {constant: replacement}) per kernel; "" keeps the source as it is
K4_VARIANTS = [
    ("as built", {}),
    ("ring 8, no register cut", {"kRing": "8", "kMinBlocks": "1"}),
    ("ring 8, 2 blocks", {"kRing": "8", "kMinBlocks": "2"}),
    ("ring 2, 4 blocks", {"kRing": "2", "kMinBlocks": "4"}),
    ("ordinary zd/g loads", {"once": "false"}),
]
K5_VARIANTS = [
    ("as built", {}),
    ("256 threads, ring 4-8, 2 blocks",
     {"kBlock": "256", "kRing": "(F <= 4 ? 8 : 4)", "kMinBlocks": "1"}),
    ("ring 2, 10 blocks", {"kRing": "2", "kMinBlocks": "10"}),
]


def variant_source(text: str, changes: dict) -> str:
    for const, value in changes.items():
        if const == "once":
            text, n = re.subn(r"(ln\.load\([^;]*base), true\)",
                              r"\g<1>, false)", text)
            assert n == 2, n
            continue
        pat = (rf"(constexpr int {const} = )[^;]*;" if const == "kBlock"
               else rf"(template <int F>\nconstexpr int {const} = )[^;]*;")
        text, n = re.subn(pat, rf"\g<1>{value};", text)
        assert n == 1, (const, n)
    return text


def compile_lib(name: str, text: str) -> ctypes.CDLL:
    src = OUT / f"{name}.cu"
    src.write_text(text)
    so = OUT / f"{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(so), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def event_ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def k4_layout(dev):
    rng = np.random.default_rng(0)
    slices, nd = 3827, 2_449_029
    rows = slices * 128
    deg = np.sort(rng.poisson(25.25, size=(slices, 128)), axis=1)[:, ::-1]
    maxd = int(deg.max())
    ncols = deg[:, 0]
    col_off = np.zeros(slices + 1, np.int64)
    np.cumsum(ncols, out=col_off[1:])
    cnt = (deg[:, :, None] > np.arange(maxd)).sum(1)
    cnt = cnt[np.arange(maxd)[None, :] < ncols[:, None]].astype(np.int32)
    deg_t = torch.as_tensor(deg.reshape(-1).copy(), device=dev)
    k = torch.arange(maxd, device=dev)
    r = torch.arange(rows, device=dev)
    c0 = torch.as_tensor(col_off[:-1], device=dev)[r // 128]
    slot = (c0[:, None] + k) * 128 + (r % 128)[:, None]
    real = k < deg_t[:, None]
    dsts = torch.sort(torch.where(
        real, torch.randint(0, nd, (rows, maxd), device=dev), nd), 1).values
    ids = torch.full((int(col_off[-1]) * 128,), nd, dtype=torch.int32,
                     device=dev)
    ids[slot[real]] = dsts[real].int()
    slot_order = torch.sort(slot[real]).values  # column-major, as K4 reads
    return dict(rows=rows, nd=nd, ids=ids, real_ids=ids[slot_order],
                perm=torch.arange(rows, dtype=torch.int32, device=dev),
                cnt=torch.as_tensor(cnt, device=dev),
                col_off=torch.as_tensor(col_off.astype(np.int32),
                                        device=dev))


def k5_layout(dev):
    rng = np.random.default_rng(0)
    n, e = 500_096, 985_000
    dst = np.sort(rng.integers(0, 111_000, size=e))
    src = rng.integers(0, 500_000, size=e).astype(np.int32)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    et = tpa.prepare_edge_tiles(row_ptr, src, n, tile_e=128,
                                fixed_edge_tiles=12787).to(dev)
    side = et.dst_side
    real = side.ids_grp[0] < n
    return dict(n=n, e=e, ids=side.ids_grp[0], src=side.other_grp[0],
                rel=side.rel_offsets[0], te=et.tile_e,
                real_src=side.other_grp[0][real].contiguous())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    jobs = {"gather": GATHER_SRC}
    for kern, file, variants in (("k4", "sell_bwd_src", K4_VARIANTS),
                                 ("k5", "pallas_fwd", K5_VARIANTS)):
        text = (build.CSRC / f"{file}.cu").read_text()
        for i, (_, changes) in enumerate(variants):
            jobs[f"{kern}_{i}"] = variant_source(text, changes)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda kv: compile_lib(*kv),
                                     jobs.items())))
    gather = libs["gather"].launch_gather
    gather.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                       ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    gather.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty(132 * 16 * 256, device=dev)

    def bare(ids, hd, t0, t1=None, s0=None, s1=None):
        heads = s0.shape[1] if s0 is not None else 1
        ptr = [x.data_ptr() if x is not None else None
               for x in (t0, t1, s0, s1)]
        err = gather(ids.data_ptr(), ids.numel(), hd // 4, heads, *ptr,
                     scratch.data_ptr(), 132 * 16, stream)
        assert err == 0, err

    lay = k4_layout(dev)
    e = lay["real_ids"].numel()
    print(f"K4 synthetic products-full chunk 0: {lay['rows']} rows, {e} "
          f"real slots [{card}]")
    for heads, d in ((2, 64), (1, 32), (1, 16)):
        hd = heads * d
        zd, g, zs = (torch.randn(lay["nd"] + 1, hd, device=dev)
                     for _ in range(3))
        sig = torch.randn(lay["nd"] + 1, heads, device=dev).abs() + 2
        r = torch.randn(lay["nd"] + 1, heads, device=dev)
        a = torch.randn(heads, d, device=dev)
        out = torch.empty(lay["rows"], hd, device=dev)
        floor = 4 * (e * (2 * hd + 2 * heads + 1) + 2 * lay["rows"] * hd) \
            / PEAK_BYTES_PER_S * 1e3
        ms = event_ms(lambda: bare(lay["real_ids"], hd, zd, g, sig, r))
        print(f"  H*D={hd}: bare gather of zd, g, sigma, r per slot "
              f"{ms:.4f} ms; per-edge gather floor {floor:.4f} ms")
        for i, (name, _) in enumerate(K4_VARIANTS):
            fn = libs[f"k4_{i}"].gatv2_sell_bwd_src
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
                ctypes.c_float] + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            args = (zs.data_ptr(), zd.data_ptr(), g.data_ptr(),
                    sig.data_ptr(), r.data_ptr(), a.data_ptr(),
                    lay["perm"].data_ptr(), lay["ids"].data_ptr(),
                    lay["cnt"].data_ptr(), lay["col_off"].data_ptr(),
                    lay["rows"], heads, d, 0.01, out.data_ptr(), stream)
            ms = event_ms(lambda: fn(*args))
            print(f"  H*D={hd}: K4 {name}: {ms:.4f} ms")
        del zd, g, zs
        torch.cuda.empty_cache()

    lay = k5_layout(dev)
    rows = (lay["rel"].numel() - 1) * 128
    print(f"K5 synthetic products-sub batch: {rows} rows, {lay['e']} real "
          f"edges [{card}]")
    for heads, d in ((4, 64), (1, 32), (1, 16)):
        hd = heads * d
        zs, zd = (torch.randn(lay["n"], hd, device=dev) for _ in range(2))
        a = torch.randn(heads, d, device=dev)
        out = torch.empty(rows, hd, device=dev)
        m, l_ = (torch.empty(rows, heads, device=dev) for _ in range(2))
        ms = event_ms(lambda: bare(lay["real_src"], hd, zs))
        print(f"  H*D={hd}: bare gather of a zs row per edge {ms:.4f} ms")
        for i, (name, _) in enumerate(K5_VARIANTS):
            fn = libs[f"k5_{i}"].gatv2_pallas_fwd
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_float] + [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
            args = (zs.data_ptr(), zd.data_ptr(), a.data_ptr(),
                    lay["ids"].data_ptr(), lay["src"].data_ptr(),
                    lay["rel"].data_ptr(), lay["te"], rows, heads, d, 0.01,
                    out.data_ptr(), m.data_ptr(), l_.data_ptr(), stream)
            ms = event_ms(lambda: fn(*args))
            print(f"  H*D={hd}: K5 {name}: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
