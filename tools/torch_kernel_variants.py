"""Time the port's K1 (csrc/sell_fwd.cu), K2 (csrc/sell_bwd_dst.cu), K4
(csrc/sell_bwd_src.cu), K5 (csrc/pallas_fwd.cu), K6 (csrc/pallas_bwd_dst.cu),
K7 (csrc/pallas_segsum.cu) and K8 (csrc/pallas_bwd_src.cu) on the card
against variants of their own sources and against a bare gather of the rows
they read, to show what bounds them.

The variants are built from copies of the sources with one constant
changed (the ring of edges in flight, the blocks per SM the register budget
is cut for, the block size, evict-first or ordinary loads of the gathered
rows) or, for K7, one piece of code taken out of its source or of the
shared csrc/edge_tiles.cuh; the kernels in the package are not changed.
The bare gathers read
exactly the rows the kernel reads per real slot or edge, in the layout's
order (K1, K2 and K5: a zs row; K6: a zs row, and it writes a c1 row; K4
and K8: a zd row, a g row, sigma and r; K7: a c1 row through gather_perm)
and add them up, with no other work: the time the memory system needs for
that access pattern.

Inputs are synthetic, shaped like chip_smoke.py's main paths:
products-full chunk 0 for K1, K2 and K4 (489,856 rows of Poisson(25.25)
degree over 2,449,029 nodes: the destination side's rows with their
sources in random order for K1 and K2, the source side's rows with their
destinations ascending, as the SELL source side lays them out, for K4), a
products-sub batch for K5 and K6 (985,000 edges into the first 111,000 of
500,096 nodes, as a 1024-seed 10,10,10 batch fills them; K7 on its
source-sorted entries, about 2 a source), products-sub's full-graph source
chunk 0 for K8 (250,048 source rows of Poisson(16) out-degree,
destinations ascending over 500,000 nodes, tile_e 256), and for K7 also
arxiv-pl's unchunked layout (chip_smoke.py's powerlaw_graph: 169,343
nodes, 1,166,243 edges, a source of 226,772 of them and 89 more of over
1,024). K2 runs without packets, as the chunked backward launches it, K6
with them, as the minibatch backward does.

`k2e` times K2's edge-feature variant on one chunk's worth of the
ogbn-proteins cell's destination rows (6 heads of 80, 8 features a slot,
in-degree ~597 split into virtual rows of at most 256 edges, so rows of odd
and even degree, and rows of 1, 2 and 3 edges), without packets as the
chunked backward launches it, beside a bare gather of one zs row per real
slot; it prints ptxas's registers and spills of each variant's
edge-feature instantiations at VEC 4, NV 5, and whether each variant's dzd,
d_a partials and dW_e partials (and, launched with packets, its packets)
equal the first variant's to the bit; each variant whose source writes
compact packets is also timed writing them, and its dzd, d_a and dW_e
partials then must equal its own without them.

`k4e` times K4's compact variant on one chunk's worth of the cell's
source rows (7,363 sources of Poisson(597) out-degree, three of them of 1,
2 and 3 edges, destinations uniform over 132,534 nodes, rows split at 256
edges), reading the compact packets that K2 as built writes over the
destination side of the same edges, beside a bare gather of one g row per
real slot and the floor of a g row and a packet per slot at peak; it
prints the ring and block count of each variant with ptxas's registers and
spills at VEC 4, NV 5, and whether each variant's dzs equals the first's
to the bit.

`--against DIR` adds, as the first variant of k2e and k4e, K2 and K4 as
built from another tree's sources (DIR/gatv2_tpu_torch/csrc, for instance
an unpacked `git archive` of a parent commit); a K4 whose source takes no
compact packets is launched as its edge-feature variant, which rebuilds
each score from the edge features (laid out in the source side's slot
order) and W_e. Needs the card and nvcc; the arguments pick kernels
(default all but k2e and k4e):

    python tools/torch_kernel_variants.py [k1 k2 k2e k4 k4e k5 k6 k7 k8]
        [--against DIR]
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

from gatv2_tpu_torch.data.synthetic import powerlaw_graph  # noqa: E402
from gatv2_tpu_torch.ops import build  # noqa: E402
from gatv2_tpu_torch.ops import pallas_attention as tpa  # noqa: E402
from gatv2_tpu_torch.ops import pallas_bwd_dst as k6  # noqa: E402
from gatv2_tpu_torch.ops import sell_bwd_dst as k2  # noqa: E402

OUT = build.BUILD_DIR / "variants"
PEAK_BYTES_PER_S = 3.35e12

GATHER_SRC = r"""
#include <cuda_runtime.h>
// One thread per (edge, 16-byte part of a row): read part of each table's
// row for the edge's id (and its 4-byte per-node values, `stride` floats
// apart), add them up and store one float per thread, so no load is dead;
// with `rows`, also write the part of t0's row to the edge's row there.
extern "C" __global__ void gather(const int* __restrict__ ids, long n,
                                  int hd4, int stride,
                                  const float4* __restrict__ t0,
                                  const float4* __restrict__ t1,
                                  const float* __restrict__ s0,
                                  const float* __restrict__ s1,
                                  float* __restrict__ out,
                                  float4* __restrict__ rows) {
  long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (; t < n * hd4; t += (long)gridDim.x * blockDim.x) {
    const long e = t / hd4;
    const int part = (int)(t % hd4);
    const long id = __ldg(ids + e);
    float4 v = __ldcs(t0 + id * hd4 + part);
    if (rows) rows[t] = v;
    acc += v.x + v.y + v.z + v.w;
    if (t1) {
      v = __ldcs(t1 + id * hd4 + part);
      acc += v.x + v.y + v.z + v.w;
    }
    if (s0 && part == 0)
      acc += __ldg(s0 + id * stride) + __ldg(s1 + id * stride);
  }
  out[blockIdx.x * (long)blockDim.x + threadIdx.x] = acc;
}
extern "C" int launch_gather(const int* ids, long n, int hd4, int stride,
                             const float4* t0, const float4* t1,
                             const float* s0, const float* s1, float* out,
                             float4* rows, int blocks, cudaStream_t stream) {
  gather<<<blocks, 256, 0, stream>>>(ids, n, hd4, stride, t0, t1, s0, s1,
                                     out, rows);
  return (int)cudaGetLastError();
}
"""

# (name, {constant: replacement}) per kernel; {} keeps the source as it is
K1_VARIANTS = [
    ("as built", {}),
    ("ring 4, 3 blocks", {"kRing": "4", "kMinBlocks": "3"}),
    ("ring 2, 4 blocks", {"kRing": "2", "kMinBlocks": "4"}),
    ("ring 2, 6 blocks", {"kRing": "2", "kMinBlocks": "6"}),
    ("ring 1, 6 blocks", {"kRing": "1", "kMinBlocks": "6"}),
    ("ring 1, 8 blocks", {"kRing": "1", "kMinBlocks": "8"}),
    ("evict-first zs loads", {"kZsEvictFirst": "true"}),
]
K2_VARIANTS = [
    ("as built", {}),
    ("ring 4, 3 blocks", {"kRing": "4", "kMinBlocks": "3"}),
    ("ring 2, 2 blocks", {"kRing": "2", "kMinBlocks": "2"}),
    ("ring 2, 3 blocks", {"kRing": "2", "kMinBlocks": "3"}),
    ("ring 2, 4 blocks", {"kRing": "2", "kMinBlocks": "4"}),
    ("ring 1, 4 blocks", {"kRing": "1", "kMinBlocks": "4"}),
    ("ring 1, 6 blocks", {"kRing": "1", "kMinBlocks": "6"}),
    ("evict-first zs loads", {"kZsEvictFirst": "true"}),
]
K2E_VARIANTS = [
    ("as built", {}),
    ("one edge a step", {"kEdgeStep": "1"}),
    ("three edges a step", {"kEdgeStep": "3"}),
    ("16 features held a slot", {"kNarrowEdgeDim": "16"}),
    # the loop that turns the pre-activations into ds run from the last
    # feature (the features are independent: the same bits)
    ("ds loop from the last feature",
     {"code": (r"(#pragma unroll\n            )for \(int f = 0; f < F; \+\+f\) "
               r"\{\n              const bool pos = x\[f\] > 0.f;\n"
               r"              const float ds = de",
               r"\g<1>for (int f = F - 1; f >= 0; --f) {\n"
               r"              const bool pos = x[f] > 0.f;\n"
               r"              const float ds = de")}),
    # the packet stored before that loop, as soon as its signs are taken
    ("packet stored before the ds loop",
     {"code": (r"(            unsigned sign = 0u;\n#pragma unroll\n"
               r"            for \(int f = 0; f < F; \+\+f\) sign \|= "
               r"[^\n]*\n)(.*?\n            \}\n)"
               r"(            if \(compact != nullptr && own_head\) \{.*?"
               r"\n            \}\n)",
               r"\g<1>\g<3>\g<2>")}),
]
# (ring of slots in flight, blocks per SM the register budget is cut for)
K4E_VARIANTS = [
    ("as built", {}),
    ("ring 1, 3 blocks", {"kRingCompact": "1", "kMinBlocksCompact": "3"}),
    ("ring 1, 4 blocks", {"kRingCompact": "1", "kMinBlocksCompact": "4"}),
    ("ring 2, 3 blocks", {"kRingCompact": "2", "kMinBlocksCompact": "3"}),
    ("ring 3, 2 blocks", {"kRingCompact": "3", "kMinBlocksCompact": "2"}),
    ("ring 4, 2 blocks", {"kRingCompact": "4", "kMinBlocksCompact": "2"}),
    ("ring 4, 1 block", {"kRingCompact": "4", "kMinBlocksCompact": "1"}),
]
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
K6_VARIANTS = [
    ("as built", {}),
    ("ring 1", {"kRing": "1"}),
    ("ring 3 (F 8)", {"kRing": "(F <= 4 ? 2 : F <= 8 ? 3 : 1)"}),
    ("ring 4, 6 blocks (F 4) / 3 (F 8)",
     {"kRing": "(F <= 8 ? 4 : 1)",
      "kMinBlocks": "(F <= 4 ? 6 : F <= 8 ? 3 : 2)"}),
    ("ring 2, 5 blocks (F 8)",
     {"kMinBlocks": "(F <= 4 ? 8 : F <= 8 ? 5 : F <= 16 ? 2 : 1)"}),
    ("evict-first zs loads", {"kZsEvictFirst": "true"}),
]
K8_VARIANTS = [
    ("as built", {}),
    ("ring 4 (F 4) / 2 (F 8), 6 blocks",
     {"kRing": "(F <= 4 ? 4 : F <= 8 ? 2 : 1)",
      "kMinBlocks": "(F <= 8 ? 6 : F <= 16 ? 3 : 1)"}),
    ("ring 4, 3 blocks (F 8)",
     {"kMinBlocks": "(F <= 4 ? 8 : F <= 8 ? 3 : F <= 16 ? 3 : 1)"}),
    ("ring 1 (F 4)", {"kRing": "(F <= 4 ? 1 : F <= 8 ? 4 : 1)"}),
    ("ring 4, 5 blocks (F 4)",
     {"kRing": "(F <= 8 ? 4 : 1)",
      "kMinBlocks": "(F <= 4 ? 5 : F <= 8 ? 4 : F <= 16 ? 3 : 1)"}),
    ("ordinary zd/g loads", {"kEvictFirst": "false"}),
]
K7_VARIANTS = [
    ("as built", {}),
    ("ring 2, 16 blocks (F 4)",
     {"kRing": "(F <= 16 ? (F <= 4 ? 2 : 4) : 2)"}),
    ("ring 1, 12 blocks (F 8)",
     {"kRing": "(F <= 8 ? 1 : F <= 16 ? 4 : 2)",
      "kMinBlocks": "(F <= 4 ? 16 : F <= 8 ? 12 : F <= 16 ? 4 : 2)"}),
    ("ring 4, 12 blocks (F 4)",
     {"kRing": "(F <= 16 ? 4 : 2)",
      "kMinBlocks": "(F <= 4 ? 12 : F <= 8 ? 8 : F <= 16 ? 4 : 2)"}),
    ("ring 8, 8 blocks (F 4) / 4 (F 8)",
     {"kRing": "(F <= 8 ? 8 : 2)",
      "kMinBlocks": "(F <= 4 ? 8 : F <= 16 ? 4 : 2)"}),
    ("evict-first c1 loads at every width", {"kEvictFirst": "true"}),
    ("ordinary c1 loads at every width", {"kEvictFirst": "false"}),
    ("merge one partial at a time", {"kMergeBatch": "1"}),
    ("merge 64 partials a round", {"kMergeBatch": "64"}),
    ("rows of > 16 entries split", {"kSplitLen": "16"}),
    ("rows of > 64 entries split", {"kSplitLen": "64"}),
    ("rows of > 256 entries split (K6, K8)", {"kSplitLen": "256"}),
    ("every slot of a tile read (K6, K8)",
     {"code": (r"tile_ranges<true>", "tile_ranges")}),
    ("segments inside a run searched too",
     {"edge_tiles.cuh": (r"  if constexpr \(kBlockWide\) \{\n    if \(p0 > 0"
                         r".*?\n  \}\n", "")}),
]


def variant_source(text: str, changes: dict) -> tuple[str, dict]:
    """(the kernel's source, {header name: text} of the headers it includes
    in place of csrc's) with `changes` made: a constant's new value, or
    under "code" / "edge_tiles.cuh" a (pattern, replacement) that must
    match once in the source / the header."""
    headers = {}
    for const, value in changes.items():
        if const in ("code", "edge_tiles.cuh"):
            target = text if const == "code" else (
                build.CSRC / const).read_text()
            target, n = re.subn(value[0], value[1], target, flags=re.S)
            assert n == 1, (const, n)
            if const == "code":
                text = target
            else:
                headers[const] = target
            continue
        if const == "once":
            text, n = re.subn(r"(ln\.load\([^;]*base), true\)",
                              r"\g<1>, false)", text)
            assert n == 2, n
            continue
        pat = (rf"((?:template <int F>\n)?constexpr (?:int|bool) {const} = )"
               r"[^;]*;")
        text, n = re.subn(pat, rf"\g<1>{value};", text)
        assert n == 1, (const, n)
    return text, headers


def tree_source(tree: pathlib.Path, file: str) -> tuple[str, dict]:
    """(csrc/<file>.cu, every csrc/*.cuh) of another tree, as
    variant_source returns them."""
    csrc = tree / "gatv2_tpu_torch" / "csrc"
    return ((csrc / f"{file}.cu").read_text(),
            {h.name: h.read_text() for h in csrc.glob("*.cuh")})


# ptxas's report on each variant's <VEC = 4, NV, ...> instantiations (NV = 1
# at H*D = 16, 32 and 128, the products-full layers; NV = 2 at H*D = 256;
# NV = 5 at 6 heads of 80): (name, NV, third template argument: 0 for a
# kernel without one, EF's false / true as 0 / 1, K2's KE) -> "<registers>
# regs, <bytes> B spilled" (spill stores, and loads where they differ)
REGS: dict[tuple[str, int, int], str] = {}


def compile_lib(name: str, text: str, headers: dict | None = None
                ) -> ctypes.CDLL:
    """Builds one source (with `headers` beside it, which the quoted
    includes find before csrc's)."""
    src = OUT / name / f"{name}.cu"
    src.parent.mkdir(exist_ok=True)
    src.write_text(text)
    for header, body in (headers or {}).items():
        (src.parent / header).write_text(body)
    so = OUT / f"{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(so), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    report = (proc.stdout + proc.stderr).split("Compiling entry function")
    for part in report:
        inst = re.search(r"ILi4ELi(\d+)E(?:L[ib](\d+)E)?",
                         part.split("\n", 1)[0])
        if inst:
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", part)
            spilled = "?" if not spill else spill.group(1) if \
                spill.group(1) == spill.group(2) else \
                f"{spill.group(1)} / {spill.group(2)}"
            REGS[name, int(inst.group(1)), int(inst.group(2) or 0)] = (
                f"{regs.group(1) if regs else '?'} regs, {spilled} B "
                f"spilled")
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


def sell_layout(dev, ascending):
    """One products-full-shaped SELL chunk: 3,827 slices of 128 rows of
    Poisson(25.25) degree, length-descending, each row's opposite ids
    random over 2,449,029 nodes (ascending along the row if `ascending`)."""
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
    opp = torch.where(real, torch.randint(0, nd, (rows, maxd), device=dev),
                      nd)
    if ascending:
        opp = torch.sort(opp, 1).values
    ids = torch.full((int(col_off[-1]) * 128,), nd, dtype=torch.int32,
                     device=dev)
    ids[slot[real]] = opp[real].int()
    slot_order = torch.sort(slot[real]).values  # column-major, as read
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
                real_src=side.other_grp[0][real].contiguous(), et=et)


def arxiv_pl_layout(dev):
    """arxiv-pl's unchunked edge tiles (chip_smoke.py's graph): source
    hubs of up to 226,772 edges."""
    g = powerlaw_graph(169_343, 1_166_243, 128, 40, seed=0, alpha=1.2)
    return dict(e=g.num_edges, et=tpa.prepare_edge_tiles(
        g.row_ptr, g.col_idx, g.num_nodes).to(dev))


def device_rows(fn, reps=10):
    """{kernel name: device ms per call} of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(anonymous namespace\)::", "", ev.key
                   ).split("(")[0]: ev.self_device_time_total / 1e3 / reps
            for ev in prof.key_averages()
            if getattr(ev, "self_device_time_total", 0)}


def k8_layout(dev):
    """products-sub's full-graph source chunk 0: 250,048 source rows of
    Poisson(16) out-degree, each row's destinations ascending over 500,000
    nodes (the source side's order), as K8 reads it (ids: chunk-relative
    source rows, other: global destinations)."""
    rng = np.random.default_rng(1)
    rows, nd = 250_048, 500_000
    deg = rng.poisson(16, size=rows)
    row = np.repeat(np.arange(rows), deg)
    dst = rng.integers(0, nd, size=row.size)
    dst = dst[np.lexsort((dst, row))].astype(np.int32)
    row_ptr = np.zeros(rows + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    et = tpa.prepare_edge_tiles(row_ptr, dst, rows, tile_e=256,
                                num_src_nodes=nd).to(dev)
    side = et.dst_side
    real = side.ids_grp[0] < et.padded_num_nodes
    return dict(nd=nd, e=int(row.size), ids=side.ids_grp[0],
                dst=side.other_grp[0], rel=side.rel_offsets[0], te=et.tile_e,
                real_dst=side.other_grp[0][real].contiguous())


def proteins_layout(dev):
    """One chunk's worth of the ogbn-proteins cell's destination rows:
    7,363 nodes (132,534 / 18 chunks) of Poisson(597) in-degree, three of
    them of 1, 2 and 3 edges, sources uniform over 132,534 nodes, 8
    standard-normal features a slot, laid out by prepare_sell_tiles as the
    cell's layout is (rows split into virtual rows of at most 256 edges)."""
    from gatv2_tpu_torch.ops import sell_attention as tsa

    rng = np.random.default_rng(2)
    n_dst, n_src, k = 7_363, 132_534, 8
    deg = rng.poisson(597, n_dst)
    deg[:3] = (1, 2, 3)
    row_ptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    e = int(row_ptr[-1])
    st = tsa.prepare_sell_tiles(
        row_ptr, rng.integers(0, n_src, size=e).astype(np.int32), n_dst,
        num_src_nodes=n_src,
        edge_features=rng.standard_normal((e, k), dtype=np.float32))
    side = st.dst
    real = side.ids_grp[0] < n_src
    return dict(n_dst=n_dst, n_src=n_src, e=e, k=k, split=side.split,
                perm=torch.as_tensor(side.perm[:st.spc_dst * 128],
                                     device=dev),
                ids=torch.as_tensor(side.ids_grp[0], device=dev),
                cnt=torch.as_tensor(side.cnt_grp[0], device=dev),
                col_off=torch.as_tensor(side.rel_off[0], device=dev),
                ef=torch.as_tensor(side.edge_feat[0], device=dev),
                real=torch.as_tensor(real, device=dev),
                real_ids=torch.as_tensor(side.ids_grp[0][real], device=dev))


def proteins_src_layout(dev):
    """One chunk's worth of the ogbn-proteins cell's source rows: 7,363
    sources (132,534 / 18 chunks) of Poisson(597) out-degree, three of
    them of 1, 2 and 3 edges, each edge's destination uniform over 132,534
    nodes and 8 standard-normal features, laid out unchunked by
    prepare_sell_tiles (rows split into virtual rows of at most 256
    edges), so that ell_perm gives each source slot its destination slot,
    the row of that edge's compact packet."""
    from gatv2_tpu_torch.ops import sell_attention as tsa

    rng = np.random.default_rng(3)
    n_src, n_dst, k = 7_363, 132_534, 8
    deg = rng.poisson(597, n_src)
    deg[:3] = (1, 2, 3)
    src = np.repeat(np.arange(n_src, dtype=np.int32), deg)
    dst = rng.integers(0, n_dst, size=src.size)
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_dst), out=row_ptr[1:])
    st = tsa.prepare_sell_tiles(
        row_ptr, src[order], n_dst, num_src_nodes=n_src,
        edge_features=rng.standard_normal((src.size, k), dtype=np.float32))
    ef_dst = torch.as_tensor(st.dst.edge_feat[0], device=dev)
    ell_perm = torch.as_tensor(st.ell_perm, device=dev)
    srcs = st.srcs
    real = srcs.gather_ids < n_dst
    # the source side's features in its slot order, for a K4 that rebuilds
    # the scores; zeros in padding slots
    ef_src = torch.cat([ef_dst, ef_dst.new_zeros(1, k)])[
        ell_perm.long().clamp(max=ef_dst.shape[0])]
    ef_src[~torch.as_tensor(real, device=dev)] = 0
    return dict(n_dst=n_dst, n_src=n_src, e=int(src.size), k=k,
                dst=tuple(torch.as_tensor(x, device=dev) for x in (
                    st.dst.perm, st.dst.gather_ids, st.dst.cnt,
                    st.dst.col_off)),
                src=tuple(torch.as_tensor(x, device=dev) for x in (
                    srcs.perm, srcs.gather_ids, srcs.cnt, srcs.col_off)),
                ef_dst=ef_dst, ef_src=ef_src.contiguous(), ell_perm=ell_perm,
                real_ids=torch.as_tensor(srcs.gather_ids[real], device=dev))


ALL = ("k1", "k2", "k2e", "k4", "k4e", "k5", "k6", "k7", "k8")
SOURCES = {"k1": ("sell_fwd", K1_VARIANTS), "k2": ("sell_bwd_dst", K2_VARIANTS),
           "k2e": ("sell_bwd_dst", K2E_VARIANTS),
           "k4": ("sell_bwd_src", K4_VARIANTS),
           "k4e": ("sell_bwd_src", K4E_VARIANTS),
           "k5": ("pallas_fwd", K5_VARIANTS),
           "k6": ("pallas_bwd_dst", K6_VARIANTS),
           "k7": ("pallas_segsum", K7_VARIANTS),
           "k8": ("pallas_bwd_src", K8_VARIANTS)}


# the sources that take compact packets (K2 writes them, K4 reads them),
# by library name; the others have the C interface from before them
COMPACT: dict[str, bool] = {}


def k2_fn(lib, compact=True):
    """gatv2_sell_bwd_dst of a built K2, its argument types set; compact:
    whether its source takes the compact packets' buffer (its C interface
    has one more pointer before the stream)."""
    fn = lib.gatv2_sell_bwd_dst
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * (6 if compact
                                                           else 5))
    fn.restype = ctypes.c_int
    fn.compact = compact
    return fn


def k2_variant(name, changes):
    """K2 (k2_fn) built from csrc/sell_bwd_dst.cu with `changes` made
    (variant_source)."""
    OUT.mkdir(parents=True, exist_ok=True)
    return k2_fn(compile_lib(name, *variant_source(
        (build.CSRC / "sell_bwd_dst.cu").read_text(), changes)))


def k2_edge_launch(fn, tables, layout, edge_feat, w_e, slope, c1=None,
                   compact=None):
    """(launch, dzd, d_a partials, dW_e partials) of a built K2 (k2_fn)
    with edge features on a layout's rows (perm, gather ids, cnt, column
    offsets), sized as the wrapper sizes it, writing c1 packets into c1 and
    compact packets into compact where given: launch() runs it and
    returns its error; each run adds into the dW_e partials, zeros before
    the first."""
    zs, zd, g, sigma, r, a = tables
    heads, d = a.shape
    hd, k = heads * d, w_e.shape[-1]
    rows = layout[0].numel()
    blocks = min(-(-rows // k2.rows_per_block(heads, d, zs)), k2.MAX_BLOCKS)
    we = w_e.reshape(-1, k).t().contiguous()
    dzd = zs.new_empty((rows, hd))
    da_part = zs.new_empty((blocks, hd))
    dwe_part = zs.new_zeros((blocks, k, hd))
    args = (zs.data_ptr(), zd.data_ptr(), g.data_ptr(), sigma.data_ptr(),
            r.data_ptr(), a.data_ptr(), *(t.data_ptr() for t in layout),
            rows, heads, d, slope, blocks, edge_feat.data_ptr(),
            we.data_ptr(), k, dzd.data_ptr(), da_part.data_ptr(),
            None if c1 is None else c1.data_ptr(), dwe_part.data_ptr(),
            *((None if compact is None else compact.data_ptr(),)
              if fn.compact else ()),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        we.data_ptr()  # held with the launch
        return fn(*args)

    return launch, dzd, da_part, dwe_part


def bit_reading(got, want):
    """Each of got's (name, tensor) against want's: "equal" to the bit, or
    the largest difference beside the largest |value|."""
    out = []
    for (what, x), (_, y) in zip(got, want):
        if torch.equal(x, y):
            out.append(f"{what} equal")
        else:
            out.append(f"{what} differ by {float((x - y).abs().max()):.3e} "
                       f"(largest |value| {float(y.abs().max()):.3e})")
    return out


def k2e(libs, names, bare, card, dev):
    """K2's edge-feature variants on proteins_layout: ms without packets,
    ptxas's report, and each variant's outputs against the first's."""
    lay = proteins_layout(dev)
    heads, d, k = 6, 80, lay["k"]
    hd = heads * d
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    tables = (randn(lay["n_src"] + 1, hd), randn(lay["n_dst"], hd),
              randn(lay["n_dst"], hd), randn(lay["n_dst"], heads).abs() + 2,
              randn(lay["n_dst"], heads), randn(heads, d) / d ** 0.5)
    w_e = 0.3 * randn(heads, d, k)
    layout = (lay["perm"], lay["ids"], lay["cnt"], lay["col_off"])
    slots = lay["ids"].numel()
    print(f"K2 with edge features, one chunk's worth of ogbn-proteins "
          f"destination rows: {lay['perm'].numel()} virtual rows (split "
          f"{lay['split']}), {lay['e']} real slots of {slots}, {heads} x {d} "
          f"heads, k = {k} [{card}]")
    sector_floats = -(-hd * 4 // 32) * 8
    floor = 4 * lay["e"] * sector_floats / PEAK_BYTES_PER_S * 1e3
    ms = event_ms(lambda: bare(lay["real_ids"], hd, tables[0]))
    print(f"  bare gather of a zs row per real slot {ms:.4f} ms; zs rows per "
          f"slot in 32-byte sectors at peak {floor:.4f} ms")
    first = None
    c1 = torch.empty(slots, hd, device=dev)
    compact = k2.compact_buffer(slots, heads, d, device=dev)
    for i, name in enumerate(names):
        fn = k2_fn(libs[f"k2e_{i}"], COMPACT[f"k2e_{i}"])
        outs = []
        for packets in (None, c1):
            launch, *res = k2_edge_launch(fn, tables, layout, lay["ef"], w_e,
                                          0.2, c1=packets)
            err = launch()
            torch.cuda.synchronize()
            assert err == 0, (name, err)
            tag = "" if packets is None else "with packets: "
            outs += [(f"{tag}dzd", res[0]), (f"{tag}d_a partials", res[1]),
                     (f"{tag}dW_e partials", res[2].clone())]
            if packets is None:
                ms = event_ms(launch)
            else:
                outs.append(("packets", c1[lay["real"]].clone()))
        reports = "; ".join(
            f"{'EF' if t == 1 else f'KE {t}'}: {v}"
            for (n, nv, t), v in sorted(REGS.items())
            if n == f"k2e_{i}" and nv == 5 and t > 0)
        print(f"  K2 {name}: {ms:.4f} ms without packets ({reports})")
        if fn.compact:
            launch, *res = k2_edge_launch(fn, tables, layout, lay["ef"], w_e,
                                          0.2, compact=compact)
            assert launch() == 0, name
            torch.cuda.synchronize()
            same = bit_reading(
                [("dzd", res[0]), ("d_a partials", res[1]),
                 ("dW_e partials", res[2])], outs[:3])
            print(f"    with compact packets {event_ms(launch):.4f} ms; "
                  f"against itself without them: {', '.join(same)}")
        if first is None:
            first = outs
            continue
        print(f"    against {names[0]}: "
              + ", ".join(bit_reading(outs, first)))
        del outs
    del tables, c1
    torch.cuda.empty_cache()


def k4_fn(lib, compact=True):
    """gatv2_sell_bwd_src of a built K4, its argument types set; compact:
    whether its source reads compact packets (else its edge-feature
    arguments are the features, W_e and k)."""
    fn = lib.gatv2_sell_bwd_src
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + ([ctypes.c_void_p] * 4 if compact
                                         else [ctypes.c_void_p] * 2
                                         + [ctypes.c_int]
                                         + [ctypes.c_void_p] * 2))
    fn.restype = ctypes.c_int
    return fn


def k4e(libs, names, bare, card, dev):
    """K4's compact variants (and a K4 that rebuilds the scores, where
    --against names one) on proteins_src_layout, reading the packets K2 as
    built writes: ms, ptxas's report, and dzs against the first's."""
    lay = proteins_src_layout(dev)
    heads, d, k = 6, 80, lay["k"]
    hd = heads * d
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    tables = (randn(lay["n_src"], hd), randn(lay["n_dst"] + 1, hd),
              randn(lay["n_dst"] + 1, hd),
              randn(lay["n_dst"] + 1, heads).abs() + 2,
              randn(lay["n_dst"] + 1, heads), randn(heads, d) / d ** 0.5)
    w_e = 0.3 * randn(heads, d, k)
    slots_d = lay["dst"][1].numel()
    compact = k2.compact_buffer(slots_d, heads, d, device=dev)
    launch, *_ = k2_edge_launch(
        k2_fn(build.load_library("sell_bwd_dst")), tables, lay["dst"],
        lay["ef_dst"], w_e, 0.2, compact=compact)
    assert launch() == 0
    torch.cuda.synchronize()
    rows = lay["src"][0].numel()
    e = lay["e"]
    words = compact.shape[1]
    print(f"K4 with edge features, one chunk's worth of ogbn-proteins source "
          f"rows: {rows} virtual rows, {e} real slots of "
          f"{lay['src'][1].numel()}, {heads} x {d} heads, k = {k}, compact "
          f"packets of {4 * words} bytes [{card}]")
    sector_floats = -(-hd * 4 // 32) * 8
    ms = event_ms(lambda: bare(lay["real_ids"], hd, tables[2]))
    floor = 4 * e * (sector_floats + -(-words // 8) * 8) \
        / PEAK_BYTES_PER_S * 1e3
    print(f"  bare gather of a g row per real slot {ms:.4f} ms; a g row and "
          f"a packet per slot in 32-byte sectors at peak {floor:.4f} ms")
    we = w_e.reshape(-1, k).t().contiguous()
    dzs = torch.empty(rows, hd, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    first = None
    for i, name in enumerate(names):
        packets = COMPACT[f"k4e_{i}"]
        fn = k4_fn(libs[f"k4e_{i}"], packets)
        edge = ((compact.data_ptr(), lay["ell_perm"].data_ptr()) if packets
                else (lay["ef_src"].data_ptr(), we.data_ptr(), k))
        args = (*(t.data_ptr() for t in tables),
                *(t.data_ptr() for t in lay["src"]), rows, heads, d, 0.2,
                *edge, dzs.data_ptr(), stream)
        assert fn(*args) == 0, name
        torch.cuda.synchronize()
        out = [("dzs", dzs.clone())]
        ms = event_ms(lambda: fn(*args))
        reports = "; ".join(v for (n, nv, t), v in sorted(REGS.items())
                            if n == f"k4e_{i}" and nv == 5 and t == 1)
        kind = "compact packets" if packets else "rebuilt from W_e f"
        print(f"  K4 {name} ({kind}): {ms:.4f} ms ({reports})")
        if first is None:
            first = out
            continue
        print(f"    against {names[0]}: " + ", ".join(bit_reading(out,
                                                                 first)))
    del tables, compact, dzs
    torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    against = None
    if "--against" in argv:
        i = argv.index("--against")
        against = pathlib.Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    wanted = argv or [k for k in ALL if k not in ("k2e", "k4e")]
    if set(wanted) - set(ALL):
        print(f"kernels are among {ALL}, got {wanted}", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    jobs = {"gather": (GATHER_SRC, None)}
    names = {kern: [name for name, _ in SOURCES[kern][1]]
             for kern in ("k2e", "k4e")}
    for kern in wanted:
        file, variants = SOURCES[kern]
        text = (build.CSRC / f"{file}.cu").read_text()
        sources = [variant_source(text, changes) for _, changes in variants]
        if kern in names and against is not None:
            sources.insert(0, tree_source(against, file))
            names[kern].insert(0, f"as built from {against}")
        for i, source in enumerate(sources):
            jobs[f"{kern}_{i}"] = source
            COMPACT[f"{kern}_{i}"] = "compact" in source[0]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda kv: compile_lib(kv[0], *kv[1]),
                                     jobs.items())))
    gather = libs["gather"].launch_gather
    gather.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                       ctypes.c_int] + [
        ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    gather.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty(132 * 16 * 256, device=dev)

    def bare(ids, hd, t0, t1=None, s0=None, s1=None, stride=1, rows=None):
        ptr = [x.data_ptr() if x is not None else None
               for x in (t0, t1, s0, s1)]
        err = gather(ids.data_ptr(), ids.numel(), hd // 4, stride, *ptr,
                     scratch.data_ptr(),
                     rows.data_ptr() if rows is not None else None,
                     132 * 16, stream)
        assert err == 0, err

    def regs(kern, i, hd):
        return REGS.get((f"{kern}_{i}", max(1, hd // 128), 0), "")

    if "k1" in wanted or "k2" in wanted:
        lay = sell_layout(dev, ascending=False)
        e = lay["real_ids"].numel()
        print(f"K1, K2 synthetic products-full dst chunk 0: {lay['rows']} "
              f"rows, {e} real slots [{card}]")
        for heads, d in ((4, 64), (2, 64), (1, 32), (1, 16)):
            hd = heads * d
            zs, zd, g = (torch.randn(lay["nd"] + 1, hd, device=dev)
                         for _ in range(3))
            sig = torch.randn(lay["nd"] + 1, heads, device=dev).abs() + 2
            r = torch.randn(lay["nd"] + 1, heads, device=dev)
            a = torch.randn(heads, d, device=dev)
            out, dzd = (torch.empty(lay["rows"], hd, device=dev)
                        for _ in range(2))
            m, l_ = (torch.empty(lay["rows"], heads, device=dev)
                     for _ in range(2))
            blocks = min(-(-lay["rows"] // k2.rows_per_block(heads, d, zs)),
                         k2.MAX_BLOCKS)
            da_part = torch.empty(blocks, hd, device=dev)
            sector_floats = -(-hd * 4 // 32) * 8
            floor = 4 * e * sector_floats / PEAK_BYTES_PER_S * 1e3
            ms = event_ms(lambda: bare(lay["real_ids"], hd, zs))
            print(f"  H*D={hd}: bare gather of a zs row per slot {ms:.4f} "
                  f"ms; zs rows per slot in 32-byte sectors at peak "
                  f"{floor:.4f} ms")
            lay_args = (lay["perm"].data_ptr(), lay["ids"].data_ptr(),
                        lay["cnt"].data_ptr(), lay["col_off"].data_ptr(),
                        lay["rows"], heads, d, 0.01)
            for i, (name, _) in enumerate(
                    K1_VARIANTS if "k1" in wanted else []):
                fn = libs[f"k1_{i}"].gatv2_sell_fwd
                fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
                    ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2 + [
                    ctypes.c_int] + [ctypes.c_void_p] * 4
                fn.restype = ctypes.c_int
                args = (zs.data_ptr(), zd.data_ptr(), a.data_ptr(),
                        *lay_args, 1, None, None, 0, out.data_ptr(),
                        m.data_ptr(), l_.data_ptr(), stream)
                ms = event_ms(lambda: fn(*args))
                print(f"  H*D={hd}: K1 {name}: {ms:.4f} ms "
                      f"({regs('k1', i, hd)})")
            for i, (name, _) in enumerate(
                    K2_VARIANTS if "k2" in wanted else []):
                fn = k2_fn(libs[f"k2_{i}"])
                args = (zs.data_ptr(), zd.data_ptr(), g.data_ptr(),
                        sig.data_ptr(), r.data_ptr(), a.data_ptr(),
                        *lay_args, blocks, None, None, 0, dzd.data_ptr(),
                        da_part.data_ptr(), None, None, stream)
                ms = event_ms(lambda: fn(*args))
                print(f"  H*D={hd}: K2 without packets {name}: {ms:.4f} ms "
                      f"({regs('k2', i, hd)})")
            del zs, zd, g
            torch.cuda.empty_cache()

    if "k2e" in wanted:
        k2e(libs, names["k2e"], bare, card, dev)

    if "k4e" in wanted:
        k4e(libs, names["k4e"], bare, card, dev)

    if "k4" in wanted:
        lay = sell_layout(dev, ascending=True)
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
            floor = 4 * (e * (2 * hd + 2 * heads + 1)
                         + 2 * lay["rows"] * hd) / PEAK_BYTES_PER_S * 1e3
            ms = event_ms(lambda: bare(lay["real_ids"], hd, zd, g, sig, r,
                                       stride=heads))
            print(f"  H*D={hd}: bare gather of zd, g, sigma, r per slot "
                  f"{ms:.4f} ms; per-edge gather floor {floor:.4f} ms")
            for i, (name, _) in enumerate(K4_VARIANTS):
                fn = k4_fn(libs[f"k4_{i}"])
                args = (zs.data_ptr(), zd.data_ptr(), g.data_ptr(),
                        sig.data_ptr(), r.data_ptr(), a.data_ptr(),
                        lay["perm"].data_ptr(), lay["ids"].data_ptr(),
                        lay["cnt"].data_ptr(), lay["col_off"].data_ptr(),
                        lay["rows"], heads, d, 0.01, None, None,
                        out.data_ptr(), stream)
                ms = event_ms(lambda: fn(*args))
                print(f"  H*D={hd}: K4 {name}: {ms:.4f} ms")
            del zd, g, zs
            torch.cuda.empty_cache()

    if "k5" in wanted or "k6" in wanted:
        lay = k5_layout(dev)
        rows = (lay["rel"].numel() - 1) * 128
        slots = lay["ids"].numel()
        n_dst = int(torch.unique(lay["ids"][lay["ids"] < rows]).numel())
        print(f"K5, K6 synthetic products-sub batch: {rows} rows, "
              f"{lay['e']} real edges, {slots} slots [{card}]")
        for heads, d in ((4, 64), (1, 32), (1, 16)):
            hd = heads * d
            zs, zd, g = (torch.randn(lay["n"], hd, device=dev)
                         for _ in range(3))
            a = torch.randn(heads, d, device=dev)
            out = torch.empty(rows, hd, device=dev)
            m, l_ = (torch.empty(rows, heads, device=dev) for _ in range(2))
            ms = event_ms(lambda: bare(lay["real_src"], hd, zs))
            print(f"  H*D={hd}: bare gather of a zs row per edge {ms:.4f} ms")
            for i, (name, _) in enumerate(
                    K5_VARIANTS if "k5" in wanted else []):
                fn = libs[f"k5_{i}"].gatv2_pallas_fwd
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                    ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4
                fn.restype = ctypes.c_int
                args = (zs.data_ptr(), zd.data_ptr(), a.data_ptr(),
                        lay["ids"].data_ptr(), lay["src"].data_ptr(),
                        lay["rel"].data_ptr(), lay["te"], rows, heads, d,
                        0.01, 1, out.data_ptr(), m.data_ptr(),
                        l_.data_ptr(), stream)
                ms = event_ms(lambda: fn(*args))
                print(f"  H*D={hd}: K5 {name}: {ms:.4f} ms "
                      f"({regs('k5', i, hd)})")
            if "k6" not in wanted:
                continue
            # K6 with packets: sr rows of sigma = m + log(l) >= the scores
            # and random r, c1 one row per slot
            sr = torch.zeros(lay["n"], 32, device=dev)
            sr[:, :heads] = torch.randn(lay["n"], heads, device=dev).abs() + 2
            sr[:, 16:16 + heads] = torch.randn(lay["n"], heads, device=dev)
            dzd = torch.empty(rows, hd, device=dev)
            c1 = torch.empty(slots, hd, device=dev)
            blocks = min(rows // 128, k6.MAX_BLOCKS)
            seg_blocks, seg_part, seg_meta = k6.segment_scratch(slots, hd, zs)
            da_part = torch.empty(blocks + seg_blocks, hd, device=dev)
            c1_rows = torch.empty(lay["e"], hd, device=dev)
            floor = 4 * (2 * lay["e"] * hd + n_dst * (2 * hd + 32)
                         + rows * hd + 2 * lay["e"]) / PEAK_BYTES_PER_S * 1e3
            ms = event_ms(lambda: bare(lay["real_src"], hd, zs, rows=c1_rows))
            print(f"  H*D={hd}: bare gather of a zs row and store of a c1 row "
                  f"per edge {ms:.4f} ms; per-edge gather floor {floor:.4f} "
                  f"ms")
            for i, (name, _) in enumerate(K6_VARIANTS):
                fn = libs[f"k6_{i}"].gatv2_pallas_bwd_dst
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_float] + [ctypes.c_int] * 2
                               + [ctypes.c_void_p] * 6)
                fn.restype = ctypes.c_int
                for packets in ((True, False) if i == 0 else (True,)):
                    args = (zs.data_ptr(), zd.data_ptr(), g.data_ptr(),
                            sr.data_ptr(), a.data_ptr(),
                            lay["ids"].data_ptr(), lay["src"].data_ptr(),
                            lay["rel"].data_ptr(), lay["te"], rows, slots,
                            heads, d, 0.01, blocks, seg_blocks,
                            dzd.data_ptr(), da_part.data_ptr(),
                            c1.data_ptr() if packets else None,
                            seg_part.data_ptr(), seg_meta.data_ptr(), stream)
                    ms = event_ms(lambda: fn(*args))
                    print(f"  H*D={hd}: K6 {name}"
                          f"{'' if packets else ' without packets'}: "
                          f"{ms:.4f} ms ({regs('k6', i, hd)})")
            del zs, zd, g, c1, c1_rows
            torch.cuda.empty_cache()

    if "k7" in wanted:
        for what, lay in (("products-sub batch", k5_layout(dev)),
                          ("arxiv-pl layout", arxiv_pl_layout(dev))):
            et = lay["et"]
            rows = (et.src_tile_offsets.numel() - 1) * 128
            slots = et.src_sorted_ids.numel()
            c1_rows = et.dst_side.ids_grp[0].numel()
            real_perm = et.gather_perm[et.src_sorted_ids < rows].contiguous()
            print(f"K7 synthetic {what}: {rows} source rows, {lay['e']} real "
                  f"entries, {slots} slots [{card}]")
            for hd in (256, 32, 16):
                c1 = torch.randn(c1_rows, hd, device=dev)
                dzs = torch.empty(rows, hd, device=dev)
                seg_blocks, seg_part, seg_meta = k6.segment_scratch(
                    slots, hd, c1)
                bound = 4 * (lay["e"] * (hd + 2) + rows * hd) \
                    / PEAK_BYTES_PER_S * 1e3
                ms = event_ms(lambda: bare(real_perm, hd, c1))
                print(f"  H*D={hd}: bare gather of a c1 row per entry through "
                      f"gather_perm {ms:.4f} ms; bound {bound:.4f} ms")
                for i, (name, _) in enumerate(K7_VARIANTS):
                    fn = libs[f"k7_{i}"].gatv2_pallas_segsum
                    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p] * 4)
                    fn.restype = ctypes.c_int
                    args = (c1.data_ptr(), et.gather_perm.data_ptr(),
                            et.src_sorted_ids.data_ptr(),
                            et.src_tile_offsets.data_ptr(), et.tile_e, rows,
                            slots, hd, seg_blocks, dzs.data_ptr(),
                            seg_part.data_ptr(), seg_meta.data_ptr(), stream)
                    ms = event_ms(lambda: fn(*args))
                    print(f"  H*D={hd}: K7 {name}: {ms:.4f} ms "
                          f"({regs('k7', i, hd)})")
                    if i:
                        continue
                    rows_ms = device_rows(lambda: fn(*args))
                    print("    device ms by kernel: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in rows_ms.items()))
                    # every segment its own block, instead of at most
                    # k6.MAX_SEG_BLOCKS striding over them
                    nseg = seg_part.shape[0] // 2
                    if nseg > seg_blocks:
                        all_args = args[:8] + (nseg,) + args[9:]
                        ms = event_ms(lambda: fn(*all_args))
                        print(f"  H*D={hd}: K7 {name}, {nseg} segment blocks "
                              f"instead of {seg_blocks}: {ms:.4f} ms")
                del c1, dzs
                torch.cuda.empty_cache()

    if "k8" in wanted:
        lay = k8_layout(dev)
        rows = (lay["rel"].numel() - 1) * 128
        slots = lay["ids"].numel()
        print(f"K8 synthetic products-sub full-graph src chunk 0: {rows} "
              f"rows, {lay['e']} real edges, {slots} slots [{card}]")
        for heads, d in ((4, 64), (1, 32), (1, 16)):
            hd = heads * d
            zd, g = (torch.randn(lay["nd"], hd, device=dev) for _ in range(2))
            zs = torch.randn(rows, hd, device=dev)
            sr = torch.zeros(lay["nd"], 32, device=dev)
            sr[:, :heads] = torch.randn(lay["nd"], heads,
                                        device=dev).abs() + 2
            sr[:, 16:16 + heads] = torch.randn(lay["nd"], heads, device=dev)
            a = torch.randn(heads, d, device=dev)
            dzs = torch.empty(rows, hd, device=dev)
            seg_blocks, seg_part, seg_meta = k6.segment_scratch(slots, hd, zs)
            floor = 4 * (lay["e"] * (2 * hd + 16 + 1) + 2 * rows * hd) \
                / PEAK_BYTES_PER_S * 1e3
            ms = event_ms(lambda: bare(lay["real_dst"], hd, zd, g, sr,
                                       sr[:, 16:], stride=32))
            print(f"  H*D={hd}: bare gather of zd, g, sigma, r per edge "
                  f"{ms:.4f} ms; per-edge gather floor {floor:.4f} ms")
            for i, (name, _) in enumerate(K8_VARIANTS):
                fn = libs[f"k8_{i}"].gatv2_pallas_bwd_src
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_int]
                               + [ctypes.c_void_p] * 4)
                fn.restype = ctypes.c_int
                args = (zs.data_ptr(), zd.data_ptr(), g.data_ptr(),
                        sr.data_ptr(), a.data_ptr(), lay["ids"].data_ptr(),
                        lay["dst"].data_ptr(), lay["rel"].data_ptr(),
                        lay["te"], rows, slots, heads, d, 0.01, seg_blocks,
                        dzs.data_ptr(), seg_part.data_ptr(),
                        seg_meta.data_ptr(), stream)
                ms = event_ms(lambda: fn(*args))
                print(f"  H*D={hd}: K8 {name}: {ms:.4f} ms "
                      f"({regs('k8', i, hd)})")
            del zd, g, zs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
