// K7 — the streamed-operand GATv2 attention backward, phase 2 (source
// rows): the per-source-row sum of the c1 packets, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/pallas_attention.py:_segsum_src_kernel
// (launched by _segsum_src). It computes the same function: for every source
// node i of the source-sorted edge tiles (the CSC mirror of the layout),
//     dzs[i] = sum over the entries p with src_sorted_ids[p] == i
//              of c1[gather_perm[p]]
// where c1 holds K6's packets in destination-sorted edge order and
// gather_perm maps each source-sorted entry to its edge's position there.
// The entries are summed in source-sorted order, as the TPU kernel does.
//
// What bounds it on this card: memory. Each real edge reads one c1 row of
// H*D fp32 (1 KB at H*D = 256) and does one add per feature.
//
// What this simple design does about it:
//  - the packets are read straight through gather_perm: the TPU path first
//    writes the permuted copy take(c1, gather_perm) to device memory and
//    reads it back (one more E x H*D write and read), then reduces it with
//    one-hot matmuls;
//  - one warp per source row; it finds the row's entries by binary search
//    over the tile's sorted source ids (padding entries carry the padded
//    node count and sort last), so padding entries are skipped by their id
//    and never read: K6 leaves the padding slots of c1 unwritten, and
//    uninitialised memory may hold NaN;
//  - lane t holds features t, t+32, ..., so every packet read is coalesced,
//    and the next packet is loaded while the current one is added.
// Faster variants (several rows per warp, TMA) come later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;  // source nodes per tile
constexpr int kWarps = 8;    // rows per thread block
constexpr int kMaxHd = 512;  // H*D per launch (the op splits heads)
constexpr unsigned kFull = 0xffffffffu;

// The first position p in [lo, hi) with ids[p] >= key; ids ascend there.
__device__ __forceinline__ int lower_bound(const int* __restrict__ ids,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

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
pallas_segsum_kernel(const float* __restrict__ c1,
                     const int* __restrict__ gather_perm,
                     const int* __restrict__ src_ids,
                     const int* __restrict__ rel_off, int te, int rows,
                     int hd, float* __restrict__ dzs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // warp-uniform; the kernel syncs warps only
  const int tile = row / kTileN;
  const int t_hi = rel_off[tile + 1] * te;
  const int e_lo = lower_bound(src_ids, rel_off[tile] * te, t_hi, row);
  const int e_hi = lower_bound(src_ids, e_lo, t_hi, row + 1);
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = 0.f;

  for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
    const int nb = min(32, e_hi - e0);
    const int my_p = lane < nb ? gather_perm[e0 + lane] : 0;
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
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    if (f < hd) dzs[(size_t)row * hd + f] = acc[j];
  }
}

template <int NF>
int launch(const float* c1, const int* gather_perm, const int* src_ids,
           const int* rel_off, int te, int rows, int hd, float* dzs,
           cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  pallas_segsum_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      c1, gather_perm, src_ids, rel_off, te, rows, hd, dzs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K7 on `stream` for `rows` source rows (a multiple of 128).
// Returns the cudaError_t of the launch (0 on success).
int gatv2_pallas_segsum(const float* c1, const int* gather_perm,
                        const int* src_ids, const int* rel_off, int te,
                        int rows, int hd, float* dzs, cudaStream_t stream) {
  if (rows <= 0 || te <= 0 || hd <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1)
    return launch<1>(c1, gather_perm, src_ids, rel_off, te, rows, hd, dzs,
                     stream);
  if (nf <= 2)
    return launch<2>(c1, gather_perm, src_ids, rel_off, te, rows, hd, dzs,
                     stream);
  if (nf <= 4)
    return launch<4>(c1, gather_perm, src_ids, rel_off, te, rows, hd, dzs,
                     stream);
  if (nf <= 8)
    return launch<8>(c1, gather_perm, src_ids, rel_off, te, rows, hd, dzs,
                     stream);
  return launch<16>(c1, gather_perm, src_ids, rel_off, te, rows, hd, dzs,
                    stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
