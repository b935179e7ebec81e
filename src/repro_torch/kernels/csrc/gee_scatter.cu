// GEE edge scatter for Hopper: one thread block per destination tile.
//
// Replaces the TPU kernel repro/kernels/gee_scatter.py:gee_scatter_pallas
// (body _kernel), which turns each packed edge block into one-hot
// matrices R (rows) and C (class x value) and adds R^T C into a Z tile
// held in VMEM.
//
// What bounds it on the H100: bytes.  Each packed contribution is 12
// bytes (tile-local row, class, value) read once, against one add; the
// tile of Z is written once.  At the default tile (256 rows x K=16 f32,
// 16 KiB) the work is a stream of contributions through shared memory.
//
// Design:
//   * the block keeps its Z tile in shared memory, zeroes it, and writes
//     it to device memory once, coalesced;
//   * the packing (repro_torch/kernels/ops.py:pack_edges) sorts the
//     contributions stably by destination ROW, and pads each tile's slot
//     range after its real entries.  The block walks its tile's `count`
//     real contributions in chunks of blockDim; inside a chunk each run of
//     equal rows is added, in packed order, by the one thread that sits at
//     the run's start.  Runs of one chunk are distinct rows, so no two
//     threads touch the same shared-memory row and no atomics are needed:
//     the sum for every (row, class) is taken in packed order, the same
//     bits on every run;
//   * padding slots past `count` are never read.
// A later version can spread long runs (high-degree rows) over a warp and
// stage contributions with cp.async; this one is simple and deterministic.
#include "common.cuh"

namespace {

__global__ void gee_scatter_kernel(const int* __restrict__ rows,
                                   const int* __restrict__ cls,
                                   const float* __restrict__ val,
                                   const int* __restrict__ counts,
                                   float* __restrict__ Z,
                                   long long slots_per_tile, int tile_n,
                                   int kdim) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  float* zt = smem;                                  // tile_n * kdim
  int* srow = reinterpret_cast<int*>(zt + tile_n * kdim);
  int* scls = srow + nt;
  float* sval = reinterpret_cast<float*>(scls + nt);

  const long long t = blockIdx.x;
  for (int e = threadIdx.x; e < tile_n * kdim; e += nt) zt[e] = 0.f;

  const long long base = t * slots_per_tile;
  const int cnt = counts[t];
  for (int c0 = 0; c0 < cnt; c0 += nt) {
    const int len = min(nt, cnt - c0);
    __syncthreads();               // tile zeroed / previous chunk walked
    const int i = threadIdx.x;
    if (i < len) {
      srow[i] = rows[base + c0 + i];
      scls[i] = cls[base + c0 + i];
      sval[i] = val[base + c0 + i];
    }
    __syncthreads();
    if (i < len && (i == 0 || srow[i] != srow[i - 1])) {
      const int r = srow[i];
      float* z = zt + r * kdim;
      for (int j = i; j < len && srow[j] == r; ++j)
        z[scls[j]] = __fadd_rn(z[scls[j]], sval[j]);
    }
  }
  __syncthreads();
  float* out = Z + t * tile_n * kdim;
  for (int e = threadIdx.x; e < tile_n * kdim; e += nt) out[e] = zt[e];
}

}  // namespace

extern "C" int gee_scatter_launch(const int* rows, const int* cls,
                                  const float* val, const int* counts,
                                  float* Z, int num_tiles,
                                  long long slots_per_tile, int tile_n,
                                  int kdim, void* stream) {
  if (num_tiles == 0) return 0;
  const int threads = 256;
  const size_t smem = sizeof(float) * (size_t)tile_n * kdim +
                      (size_t)threads * (2 * sizeof(int) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gee_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gee_scatter_kernel<<<num_tiles, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, cls, val, counts, Z, slots_per_tile, tile_n, kdim);
  return (int)cudaGetLastError();
}
