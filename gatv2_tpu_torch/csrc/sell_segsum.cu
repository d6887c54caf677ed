// K3 — the SELL-128 GATv2 attention backward, phase 2 (source rows): the
// per-source-row sum of the c1 packets, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/sell_attention.py:_sell_segsum_kernel
// (launched by _sell_segsum). It computes the same function: for every
// virtual row i of the source-sorted SELL-128 layout,
//     dzs[i] = sum over the real slots of row i of c1[ell_perm[slot]]
// where c1 holds K2's packets in destination-ELL slot order and ell_perm
// maps each source-ELL slot to the destination-ELL slot of the same edge.
// The columns are summed in order, as the TPU kernel does.
//
// What bounds it on this card: memory. Each real edge reads one c1 row of
// H*D fp32 (1 KB at H*D = 256) and does one add per feature.
//
// What this simple design does about it:
//  - the packets are read straight through ell_perm: the TPU path first
//    writes the permuted copy take(c1, ell_perm) to device memory and reads
//    it back (one more E x H*D write and read);
//  - one warp per source row; lane t holds features t, t+32, ..., so every
//    packet read is coalesced, and the next packet is loaded while the
//    current one is added;
//  - only the row's real slots are read (slot (column k, row r) is real iff
//    r < cnt[k], a prefix of the row's columns). Padding slots are skipped by
//    that count, never multiplied by a zero mask: K2 does not write the
//    padding slots of c1, and uninitialised memory may hold NaN.
// Faster variants (several rows per warp, TMA) come later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;   // rows per SELL slice
constexpr int kWarps = 8;     // rows per thread block
constexpr int kMaxHd = 512;   // H*D per launch (the op splits heads)
constexpr unsigned kFull = 0xffffffffu;

template <int NF>
__device__ __forceinline__ void load_row(float (&z)[NF],
                                         const float* __restrict__ row,
                                         int lane, int hd) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    z[j] = f < hd ? __ldg(row + f) : 0.f;
  }
}

template <int NF>  // features per lane: H*D <= 32 * NF
__global__ void __launch_bounds__(kWarps * 32)
sell_segsum_kernel(const float* __restrict__ c1,
                   const int* __restrict__ ell_perm,
                   const int* __restrict__ cnt,
                   const int* __restrict__ col_off, int rows, int hd,
                   float* __restrict__ dzs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // warp-uniform; the kernel syncs warps only
  const int r = row % kTileN;
  const int c0 = col_off[row / kTileN];
  const int ncols = col_off[row / kTileN + 1] - c0;
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = 0.f;

  if (ncols > 0 && r < cnt[c0]) {
    for (int k0 = 0; k0 < ncols; k0 += 32) {
      const int k = k0 + lane;
      const bool real = k < ncols && r < cnt[c0 + k];
      // real slots are a prefix, so the count is the first non-real lane
      const int nb = __popc(__ballot_sync(kFull, real));
      const int my_p = real ? ell_perm[(size_t)(c0 + k) * kTileN + r] : 0;
      float zn[NF];
      load_row<NF>(zn, c1 + (size_t)__shfl_sync(kFull, my_p, 0) * hd, lane,
                   hd);
      for (int t = 0; t < nb; ++t) {
        float z[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) z[j] = zn[j];
        const int next = __shfl_sync(kFull, my_p, (t + 1) & 31);
        if (t + 1 < nb) load_row<NF>(zn, c1 + (size_t)next * hd, lane, hd);
#pragma unroll
        for (int j = 0; j < NF; ++j) acc[j] += z[j];
      }
      if (nb < 32) break;
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    if (f < hd) dzs[(size_t)row * hd + f] = acc[j];
  }
}

template <int NF>
int launch(const float* c1, const int* ell_perm, const int* cnt,
           const int* col_off, int rows, int hd, float* dzs,
           cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  sell_segsum_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      c1, ell_perm, cnt, col_off, rows, hd, dzs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream` for `rows` virtual source rows (a multiple of
// 128). Returns the cudaError_t of the launch (0 on success).
int gatv2_sell_segsum(const float* c1, const int* ell_perm, const int* cnt,
                      const int* col_off, int rows, int hd, float* dzs,
                      cudaStream_t stream) {
  if (rows <= 0 || hd <= 0 || hd > kMaxHd) return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1) return launch<1>(c1, ell_perm, cnt, col_off, rows, hd, dzs, stream);
  if (nf <= 2) return launch<2>(c1, ell_perm, cnt, col_off, rows, hd, dzs, stream);
  if (nf <= 4) return launch<4>(c1, ell_perm, cnt, col_off, rows, hd, dzs, stream);
  if (nf <= 8) return launch<8>(c1, ell_perm, cnt, col_off, rows, hd, dzs, stream);
  return launch<16>(c1, ell_perm, cnt, col_off, rows, hd, dzs, stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
