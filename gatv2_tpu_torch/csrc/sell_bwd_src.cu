// K4 — the SELL-128 GATv2 attention backward, phase 2b (source rows of a
// chunked layout): d_zs by per-edge recompute, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/sell_attention.py:_sell_bwd_src_kernel
// (launched by _sell_bwd_src). It computes the same function: for every
// virtual row j of one chunk of the source-sorted SELL-128 layout, with
// source node n = perm[j] and, for each real slot of the row, dst = the
// slot's global destination id,
//     s      = zs[n] + zd[dst]
//     s_act  = LeakyReLU(s)
//     sc_h   = <s_act_h, a_h>
//     alpha  = exp(clip(sc_h - sigma[dst,h], -80, 0))
//     dalpha = <g[dst]_h, zs[n]_h>
//     de     = alpha * (dalpha - r[dst,h])
//     ds     = de * a_h * (s > 0 ? 1 : slope)
//     dzs[j] += alpha * g[dst] + ds
// i.e. the sum of K2's packets c1 over the row's edges, rebuilt from the
// destination side instead of read from a packet buffer. A row's slots are
// summed in column order, as the TPU kernel does, so the output is the same
// from run to run (no atomics).
//
// What bounds it on this card: memory, and on a random graph not the
// kernel's byte bound (each destination row read once) but the per-edge
// gather floor: the zd and g tables (2.5 GB at H*D = 128 on products-full)
// are far larger than the 50 MB L2 and a random graph's destinations have
// no locality, so each real edge reads one zd row, one g row, sigma, r and
// its id from device memory (4 * (2*H*D + 2*H + 1) bytes), plus the rows'
// zs reads and dzs writes. Every edge's gathers are independent, so what
// the design has to do is keep enough of them in flight.
//
// The design (a first version gave one warp to each row, loaded one edge
// ahead with 4-byte loads and summed heads over shared memory: 5.51 / 2.29
// / 2.29 ms at H*D = 128 / 32 / 16 on the same chunk):
//  - lane groups sized to the width (lane_groups.cuh): a row gets
//    ceil(H*D/4) lanes rounded to a power of two (4 lanes at H*D = 16, 8 at
//    32, 32 at 128), so a warp works on 32 / LG rows at once and no lane
//    idles at the narrow widths; every row read is 16-byte vectors; the
//    score and dalpha head sums are the lane's own sums plus
//    __shfl_xor_sync rounds inside the head's lanes, and every lane of a
//    head computes alpha and de itself: no shared memory, no __syncwarp and
//    no broadcast per edge;
//  - a register ring of R = kRing<F> slots (4 at H*D <= 128): a group
//    issues the id, zd, g, sigma and r loads of R slots before it computes
//    the first of them, and loads the next R ids before it computes, so R
//    gathers per row (R * 32 / LG per warp) are in flight; the register
//    budget is cut so that 3 blocks (24 warps) share an SM, which measured
//    faster than deeper rings at lower occupancy;
//  - the zd and g rows are read with evict-first loads: they stream through
//    L2 once, and the tables that are read again (sigma and r, 20-40 MB on
//    products-full; the slot ids a slice's rows share; zs) stay there;
//  - a row's real slots are a prefix of its slice's columns (column-major,
//    length-descending: slot (k, r) is real iff r < cnt[k]), so the row's
//    slot count is one binary search over the slice's cnt, which the slice's
//    128 rows share in L1. Padding slots are never read; a row without
//    edges writes 0.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W): 5.154 / 1.333 / 0.930 ms at
// H*D = 128 / 32 / 16 on products-full chunk 0 (chip_smoke.py; per-edge
// gather floor 4.005 / 1.027 / 0.536 ms), where a bare gather of the same
// rows in the same order takes 4.58 / 1.17 / 0.84 ms on a synthetic chunk
// of that shape (tools/torch_kernel_variants.py): the kernel is within
// 1.10-1.14x of what the memory system delivers for its access pattern.

#include <cuda_runtime.h>

#include <cstddef>

#include "lane_groups.cuh"

namespace {

using namespace lane_groups;

constexpr int kTileN = 128;    // rows per SELL slice
constexpr int kBlock = 256;    // threads per block
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 32;  // heads per launch
constexpr float kExpClamp = -80.0f;

// Slots a group keeps in flight (the register ring), and the blocks per SM
// the register budget is cut for, by F = floats per lane. At F = 4
// (H*D = 128 / 32 / 16) tools/torch_kernel_variants.py measured 4 slots at
// 3 blocks (80 registers, 24 warps an SM) at 5.16 / 1.33 / 0.93 ms, 8
// slots with no register cut (1-2 blocks) at 9.04 / 2.39 / 1.32 ms, 8 at 2
// blocks at 5.59 / 1.47 / 0.95 ms and 2 at 4 blocks at 5.13 / 1.32 / 0.93
// ms (NVIDIA H100 80GB HBM3, 700.00 W).
template <int F>
constexpr int kRing = F <= 4 ? 4 : F <= 8 ? 2 : 1;
template <int F>
constexpr int kMinBlocks = F <= 8 ? 3 : F <= 16 ? 2 : 1;

template <int VEC, int NV>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
sell_bwd_src_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                    const float* __restrict__ g,
                    const float* __restrict__ sigma,
                    const float* __restrict__ rr, const float* __restrict__ a,
                    const int* __restrict__ perm,
                    const int* __restrict__ gather_ids,
                    const int* __restrict__ cnt,
                    const int* __restrict__ col_off, int rows, int heads,
                    int head_dim, int lg, int lph, int qph, float slope,
                    float* __restrict__ dzs) {
  constexpr int F = NV * VEC;
  constexpr int R = kRing<F>;
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lg;
  const int row = ((blockIdx.x * kBlock + threadIdx.x) >> 5) * rows_per_warp +
                  lane / lg;
  if (row >= rows) return;  // group-uniform; the kernel syncs groups only
  const int hd = heads * head_dim;
  const int gl = lane & (lg - 1);
  const unsigned mask = group_mask(lane, lg);
  const int h = gl / lph;
  const bool own_head = h < heads;
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, heads, head_dim);

  // the row's real slots: the first `deg` columns of its slice
  const int r = row % kTileN;
  const int c0 = col_off[row / kTileN];
  const int deg = sell_row_slots(cnt, c0, col_off[row / kTileN + 1] - c0, r);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  if (deg > 0) {
    float z[F], av[F];  // the row's resident zs, and a
    ln.load(z, zs + (size_t)perm[row] * hd);
    ln.load(av, a);
    const int* ids = gather_ids + (size_t)c0 * kTileN + r;  // column k: k*128
    int id[R];
#pragma unroll
    for (int i = 0; i < R; ++i) id[i] = i < deg ? __ldg(ids + i * kTileN) : 0;
    for (int k0 = 0; k0 < deg; k0 += R) {
      float zdv[R][F], gv[R][F], sg[R], rv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool real = k0 + i < deg;
        const size_t base = (size_t)id[i] * hd;
        if (real) {
          ln.load(zdv[i], zd + base, true);  // read once: evict-first
          ln.load(gv[i], g + base, true);
        }
        sg[i] = real && own_head ? __ldg(sigma + (size_t)id[i] * heads + h)
                                 : 0.f;
        rv[i] = real && own_head ? __ldg(rr + (size_t)id[i] * heads + h)
                                 : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = k0 + R + i;
        id[i] = k < deg ? __ldg(ids + (size_t)k * kTileN) : 0;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (k0 + i >= deg) break;  // group-uniform
        float sc = 0.f, dal = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float s = z[f] + zdv[i][f];
          sc += av[f] * (s > 0.f ? s : slope * s);
          dal += gv[i][f] * z[f];
        }
        sc = head_sum(sc, lph, mask);
        dal = head_sum(dal, lph, mask);
        const float alpha = expf(fminf(fmaxf(sc - sg[i], kExpClamp), 0.f));
        const float de = alpha * (dal - rv[i]);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float s = z[f] + zdv[i][f];
          acc[f] += alpha * gv[i][f] + de * av[f] * (s > 0.f ? 1.f : slope);
        }
      }
    }
  }
  ln.store(dzs + (size_t)row * hd, acc);
}

}  // namespace

extern "C" {

// Launches K4 on `stream` for `rows` virtual source rows of one chunk (a
// multiple of 128). Returns the cudaError_t of the launch (0 on success).
int gatv2_sell_bwd_src(const float* zs, const float* zd, const float* g,
                       const float* sigma, const float* r, const float* a,
                       const int* perm, const int* gather_ids, const int* cnt,
                       const int* col_off, int rows, int heads, int head_dim,
                       float slope, float* dzs, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || heads <= 0 || heads > kMaxHeads || head_dim <= 0 ||
      hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(g) && aligned16(a) &&
          aligned16(dzs));
  const int rows_per_block = kBlock / 32 * (32 / geo.lg);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  return dispatch(geo, [&](auto vec, auto nv) {
    sell_bwd_src_kernel<decltype(vec)::value, decltype(nv)::value>
        <<<blocks, kBlock, 0, stream>>>(
            zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows,
            heads, head_dim, geo.lg, geo.lph, geo.qph, slope, dzs);
    return (int)cudaGetLastError();
  });
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
