// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body _kernel), which walks KV blocks in grid order with the running
// max, denominator and accumulator in VMEM scratch and skips blocks above
// the diagonal.
//
// What it computes, for q (B, H, S, D) and k, v (B, KV, S, D), KV | H:
// s = (q . k) * D^-0.5 in float32 for k_pos <= q_pos (else -1e30), an
// online softmax with running max m and denominator l, and
// out = acc / max(l, 1e-30) cast to q's type.  Query head h reads KV head
// h / (H / KV): the contiguous grouping of the reference's
// reshape(B, S, KV, G, D).
//
// What bounds it on the H100: operations.  Causal attention does
// 4 D flops per (query, key) pair on or below the diagonal, about
// 2 B H S^2 D; at bf16 that is bounded by the tensor cores (989 TFLOP/s),
// against a few hundred MB of q, k, v and out.
//
// flash_attention_launch picks one of two bodies by dtype, for D in
// {16, 32, 64, 128}; flash_attention_wide_launch runs a third, simple body
// for any D > 128 (widebody, below).
//
// bfloat16 (bf16body): both products on the tensor cores.  One block per
// (batch x head, 128-row query tile), the heaviest tiles first; along the
// grid's fast dimension consecutive blocks are consecutive heads, so the
// query heads of a GQA group read their KV head's tiles from L2.  Three
// warpgroups:
//   - a producer warp (warpgroup 0, 40 registers after setmaxnreg) loads
//     the Q tile once and then each 128-row K and V tile with TMA
//     (cp.async.bulk.tensor, 3-D maps over (D, S, B x heads), so rows past
//     S in a ragged last tile are zero-filled inside their own head) into
//     a ring of STAGES slots, each tile completing on an mbarrier;
//   - two consumer warpgroups (232 registers) own 64 query rows each.
//     S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (the K tile as it lies is the K-major B operand).  The softmax runs
//     on the float32 accumulator fragment in registers (row max and sum
//     over the 4 lanes of a quad), in the log2 domain; only the diagonal
//     tile is masked, and tiles above it are never loaded.  P is rounded
//     to bf16 pairs that are directly the A fragments of O += P V
//     (wgmma m64nDk16, A from registers, V as the MN-major B operand), so
//     P never touches shared memory.
// The consumers take turns on the tensor cores (two named barriers): in
// its turn a consumer starts S of tile t and P V of tile t - 1 as two
// batches, then computes tile t's softmax while P V of tile t - 1 still
// runs and the other consumer starts its products.  A K slot is released
// as soon as S has been computed from it, a V slot once P V has.
// Tiles are stored as D / AW column chunks of 128 rows x AW elements, one
// swizzle atom per row (AW * 2 = 32, 64 or 128 bytes, TMA swizzle and
// wgmma layout type alike), 1024-byte aligned.  No atomics and no split
// over KV: every row is reduced in one fixed order, the same bits on
// every run.
//
// float32 (f32body): CUDA cores (TF32 tensor cores would miss the float32
// contract).  The block stages its Q tile and then one 64-row K and V tile
// at a time in shared memory as float32, and never loads a KV tile wholly
// above the diagonal.  256 threads as 16 x 16: thread (ty, tx) holds rows
// ty + 16 i (i < 4) and score columns tx + 16 j (j < 4), so the 16 lanes
// that share a row sit in one half-warp and reduce its max and sum with
// shuffles.  Scores, the softmax and the P.V product run in float32
// (fmaf); P goes through shared memory to the P.V product, where each
// thread owns output columns tx + 16 c.  Rows and keys past S (a ragged
// last tile) are zero-filled and masked.
//
// any D > 128, float32 or bfloat16 (widebody): CUDA cores, float32
// arithmetic, no tensor cores; correctness first, not speed.  One block
// of 256 threads per (batch x head, 16-row query tile), the heaviest
// tiles first.  For each 32-key tile: the scores take the dot over D in
// chunks of 128 columns staged in shared memory (fmaf in column order,
// each thread two (row, key) pairs); a warp per two rows runs the online
// softmax (max and sum over the 32 keys by xor shuffles); then the
// P.V update runs chunk by chunk over D, each thread owning eight
// (row, column) accumulators of a chunk, kept in a float32 workspace in
// device memory (B, H, S, D) that the caller allocates, since a row's D
// accumulators need not fit in registers.  The last pass writes
// acc / max(l, 1e-30) in q's type.  No atomics: the same bits every run.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

namespace f32body {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RI = BQ / 16;     // rows per thread
constexpr int RJ = BK / 16;     // score columns per thread
constexpr int PS = BK + 1;      // row stride of the P tile
constexpr float NEG = -1e30f;   // the reference's mask value

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles with an odd row stride (D + 1), V tile, P tile
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * PS);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int KV, int S, float scale) {
  constexpr int DS = D + 1;
  constexpr int RD = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x DS
  float* Ks = Qs + BQ * DS;      // BK x DS
  float* Vs = Ks + BK * DS;      // BK x D
  float* Ps = Vs + BK * D;       // BQ x PS

  // the last query tiles see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = b * KV + h / (H / KV);
  const float* qp = q + (size_t)bh * S * D;
  const float* kp = k + (size_t)kvh * S * D;
  const float* vp = v + (size_t)kvh * S * D;
  float* op = o + (size_t)bh * S * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    Qs[r * DS + c] = q0 + r < S ? qp[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[RI], l[RI], acc[RI][RD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  // causal skip: keys past the tile's last row are never loaded
  const int kv_end = min(S, q0 + BQ);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();             // Q staged; last tile's K, V, P consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < S;
      Ks[r * DS + c] = in ? kp[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[r * D + c] = in ? vp[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = Ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        s[i][j] = (kpos <= qpos && kpos < S) ? x : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[RD];
#pragma unroll
      for (int c = 0; c < RD; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < RD; ++c)
        op[(size_t)r * D + tx + 16 * c] = acc[i][c] / den;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32body

namespace bf16body {

constexpr int BQ = 128;            // query rows per block, 64 per consumer
constexpr int BK = 128;            // keys per KV tile
constexpr int STAGES = 2;          // depth of the K / V ring
constexpr int THREADS = 384;       // producer + two consumer warpgroups
constexpr float NEG = -1e30f;      // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory for head dim D: tiles Q, K[STAGES], V[STAGES] of 128 rows,
// each as NC chunks of 128 rows x AW elements (one swizzle atom a row),
// then the mbarriers.
template <int D>
struct Geo {
  static constexpr int AW = D < 64 ? D : 64;
  static constexpr int NC = D / AW;
  static constexpr uint32_t ROW = AW * 2;          // bytes in a chunk row
  static constexpr uint32_t CHUNK = 128 * ROW;
  static constexpr uint32_t TILE = NC * CHUNK;     // 128 * D * 2 bytes
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t K_OFF = TILE;
  static constexpr uint32_t V_OFF = TILE * (1 + STAGES);
  static constexpr uint32_t BAR_OFF = TILE * (1 + 2 * STAGES);
  // + the barriers, + room to align the base to 1024 bytes
  static constexpr size_t SMEM = BAR_OFF + 8 + 32 * STAGES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box {AW, 128, 1} at (c0, c1, c2) of a 3-D map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed batches are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving register work on wgmma operands across
// the fence before a batch or the wait after it
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other (barrier 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], both operands in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, int H, int KV, int S,
                      float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + G::BAR_OFF;
  // mbarriers: Q full, then for each stage K full, V full, K empty and
  // V empty (K is released as soon as S is computed, V after P V)
  const uint32_t full_q = bar;
  const uint32_t full_k = bar + 8, full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = empty_k + 8 * STAGES;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * BQ;
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  const int n_kv = qt + 1;                     // KV tiles up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 256);         // every consumer thread
      mbar_init(empty_v + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, G::TILE);
      for (int c = 0; c < G::NC; ++c)
        tma_load(base + c * G::CHUNK, &tq, full_q, c * G::AW, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % STAGES;
        const uint32_t parity = ((t / STAGES) & 1) ^ 1;
        const uint32_t ks = base + G::K_OFF + s * G::TILE;
        const uint32_t vs = base + G::V_OFF + s * G::TILE;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, G::TILE);
        for (int c = 0; c < G::NC; ++c)
          tma_load(ks + c * G::CHUNK, &tk, full_k + 8 * s, c * G::AW,
                   t * BK, kvh);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, G::TILE);
        for (int c = 0; c < G::NC; ++c)
          tma_load(vs + c * G::CHUNK, &tv, full_v + 8 * s, c * G::AW,
                   t * BK, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;       // which 64 rows of the tile
    const int tid = threadIdx.x % 128;
    // accumulator fragment: this thread holds rows r0 and r0 + 8 (h = 0, 1)
    // at columns 8 j + c0 + {0, 1}: element [4 j + 2 h + {0, 1}]
    const int r0 = 64 * w + 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    const uint32_t qa = base + w * 64 * G::ROW;

    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[64];
    uint32_t p[32];

    // S = Q K^T of tile t into s (one batch, not committed)
    auto qk = [&](int t) {
      const uint32_t ks = base + G::K_OFF + (t % STAGES) * G::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off =
            (kk * 16 / G::AW) * G::CHUNK + (kk * 16 % G::AW) * 2;
        wgmma_ss_n128(s, sdesc(qa + off, 16, G::SBO, G::LAYOUT),
                      sdesc(ks + off, 16, G::SBO, G::LAYOUT), kk > 0);
      }
    };
    // O += P V of tile t (one batch, not committed)
    auto pv = [&](int t) {
      const uint32_t vs = base + G::V_OFF + (t % STAGES) * G::TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<D>(acc, a,
                    sdesc(vs + kk * 16 * G::ROW, G::CHUNK, G::SBO,
                          G::LAYOUT));
      }
    };
    // online softmax of tile t's scores: m (log2 domain) and l updated,
    // s holds exp2(s * scale - m), alpha the rescale of earlier tiles
    auto softmax = [&](int t) {
      if (t == n_kv - 1) {       // the diagonal tile: mask keys > query
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + c0 + (e & 1) > r0 + 8 * (e >> 1)) s[4 * j + e] = NEG;
      }
      float mt[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * j + e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        const float m_new = fmaxf(m[h], mt[h] * scale_log2);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
          l[e >> 1] += s[4 * j + e];
        }
    };
    // rescale O by alpha and round P to the bf16 A fragments of P V:
    // p[4 kk .. 4 kk + 3] holds keys 16 kk .. 16 kk + 15
    auto rescale_pack = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          p[2 * j + h] = pack_bf16(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
    };

    // The consumers take turns on the tensor cores (named barriers
    // 1 + w): each starts S of tile t and P V of tile t - 1 together, then
    // runs tile t's softmax while the other starts its products, and P V
    // of tile t - 1 runs under this softmax.
    if (w == 1) bar_arrive(1);                 // consumer 0 goes first
    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    bar_sync(1 + w);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    bar_arrive(2 - w);
    wgmma_wait<0>();
    pin(s);
    mbar_arrive(empty_k);
    softmax(0);
    rescale_pack();
    for (int t = 1; t < n_kv; ++t) {
      const int st = t % STAGES, pst = (t - 1) % STAGES;
      mbar_wait(full_k + 8 * st, (t / STAGES) & 1);
      mbar_wait(full_v + 8 * pst, ((t - 1) / STAGES) & 1);
      pin(acc);
      pin(p);
      bar_sync(1 + w);
      wgmma_fence();
      qk(t);
      wgmma_commit();
      pv(t - 1);
      wgmma_commit();
      bar_arrive(2 - w);
      wgmma_wait<1>();                         // S of tile t
      pin(s);
      mbar_arrive(empty_k + 8 * st);
      softmax(t);
      wgmma_wait<0>();                         // P V of tile t - 1
      pin(acc);
      mbar_arrive(empty_v + 8 * pst);
      rescale_pack();
    }
    const int last = n_kv - 1;
    mbar_wait(full_v + 8 * (last % STAGES), (last / STAGES) & 1);
    pin(acc);
    pin(p);
    bar_sync(1 + w);
    wgmma_fence();
    pv(last);
    wgmma_commit();
    if (w == 0) bar_arrive(2);                 // consumer 1's last turn
    wgmma_wait<0>();
    pin(acc);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = q0 + r0 + 8 * h;
      if (row < S) {
        const float den = fmaxf(l[h], 1e-30f);
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
            o + ((size_t)bh * S + row) * D + c0);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          op[4 * j] = __floats2bfloat162_rn(acc[4 * j + 2 * h] / den,
                                            acc[4 * j + 2 * h + 1] / den);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 3-D map over a contiguous (n, S, D) bfloat16 tensor, boxes of
// {AW, 128, 1}: rows past S read as zeros, never the next head's
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int S, int n) {
  using G = Geo<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::AW, 128, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, G::SWIZZLE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map<D>(&mq, q, S, B * H);
  if (err == 0) err = make_map<D>(&mk, k, S, B * KV);
  if (err == 0) err = make_map<D>(&mv, v, S, B * KV);
  if (err != 0) return err;
  constexpr size_t smem = Geo<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, KV, S,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace bf16body

namespace widebody {

constexpr int BQ = 16;          // query rows per block
constexpr int BK = 32;          // keys per KV tile (one per lane)
constexpr int DC = 128;         // head-dim columns staged at a time
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;   // the reference's mask value

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ acc, int H, int KV, int S, int D,
                      float scale) {
  __shared__ float Qs[BQ * DC];
  __shared__ float KVs[BK * (DC + 1)];    // a K chunk, then a V chunk
  __shared__ float Ps[BQ * (BK + 1)];     // scores, then probabilities
  __shared__ float ms[BQ], ls[BQ], as[BQ];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = b * KV + h / (H / KV);
  const T* qp = q + (size_t)bh * S * D;
  const T* kp = k + (size_t)kvh * S * D;
  const T* vp = v + (size_t)kvh * S * D;
  T* op = o + (size_t)bh * S * D;
  float* ap = acc + (size_t)bh * S * D;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = min(BQ, S - q0);       // query rows of this tile

  if (tid < BQ) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }
  for (size_t e = tid; e < (size_t)rows * D; e += THREADS)
    ap[(size_t)q0 * D + e] = 0.f;

  const int kv_end = min(S, q0 + BQ);     // causal: later keys never read
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    // scores: two (row, key) pairs a thread, the dot in column order
    float s[2] = {0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dc = min(DC, D - d0);
      __syncthreads();                    // Qs, KVs, Ps free
      for (int e = tid; e < BQ * dc; e += THREADS) {
        const int r = e / dc, c = e % dc;
        Qs[r * DC + c] =
            r < rows ? ld(qp + (size_t)(q0 + r) * D + d0 + c) : 0.f;
      }
      for (int e = tid; e < BK * dc; e += THREADS) {
        const int r = e / dc, c = e % dc;
        KVs[r * (DC + 1) + c] =
            k0 + r < S ? ld(kp + (size_t)(k0 + r) * D + d0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int pr = tid + t * THREADS;
        const int i = pr / BK, j = pr % BK;
        float x = s[t];
        for (int c = 0; c < dc; ++c)
          x = fmaf(Qs[i * DC + c], KVs[j * (DC + 1) + c], x);
        s[t] = x;
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pr = tid + t * THREADS;
      const int i = pr / BK, j = pr % BK;
      const int kpos = k0 + j;
      Ps[i * (BK + 1) + j] =
          (kpos <= q0 + i && kpos < S) ? s[t] * scale : NEG;
    }
    __syncthreads();
    // online softmax: warp w owns rows 2w and 2w + 1, lane j key j
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = warp * 2 + rr;
      const float x = Ps[i * (BK + 1) + lane];
      float mt = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = ms[i];
      const float m_new = fmaxf(m_old, mt);
      const float p = expf(x - m_new);
      float rs = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      Ps[i * (BK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[i] = alpha;
        ls[i] = ls[i] * alpha + rs;
        ms[i] = m_new;
      }
    }
    // acc = acc * alpha + P V, a chunk of D at a time
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dc = min(DC, D - d0);
      __syncthreads();                    // Ps, as ready; KVs free
      for (int e = tid; e < BK * dc; e += THREADS) {
        const int r = e / dc, c = e % dc;
        KVs[r * (DC + 1) + c] =
            k0 + r < S ? ld(vp + (size_t)(k0 + r) * D + d0 + c) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < rows * dc; e += THREADS) {
        const int i = e / dc, c = e % dc;
        float* a = ap + (size_t)(q0 + i) * D + d0 + c;
        float x = *a * as[i];
        for (int j = 0; j < BK; ++j)
          x = fmaf(Ps[i * (BK + 1) + j], KVs[j * (DC + 1) + c], x);
        *a = x;
      }
    }
  }
  __syncthreads();
  for (size_t e = tid; e < (size_t)rows * D; e += THREADS) {
    const size_t g = (size_t)q0 * D + e;
    st(op + g, ap[g] / fmaxf(ls[e / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* ws, int B, int H, int KV, int S, int D, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws, H, KV, S, D,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace widebody

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); all contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The caller checks KV | H,
// D in {16, 32, 64, 128} and the grid's y dimension: B * H <= 65535 at
// float32, ceil(S / 128) <= 65535 at bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int S, int D, int is_bf16,
                                      float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (D) {
      case 16: return bf16body::launch<16>(q, k, v, o, B, H, KV, S, scale,
                                           st);
      case 32: return bf16body::launch<32>(q, k, v, o, B, H, KV, S, scale,
                                           st);
      case 64: return bf16body::launch<64>(q, k, v, o, B, H, KV, S, scale,
                                           st);
      case 128: return bf16body::launch<128>(q, k, v, o, B, H, KV, S, scale,
                                             st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return f32body::launch<16>(q, k, v, o, B, H, KV, S, scale, st);
    case 32: return f32body::launch<32>(q, k, v, o, B, H, KV, S, scale, st);
    case 64: return f32body::launch<64>(q, k, v, o, B, H, KV, S, scale, st);
    case 128: return f32body::launch<128>(q, k, v, o, B, H, KV, S, scale,
                                          st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The body for any D > 128: q, o (B, H, S, D); k, v (B, KV, S, D);
// ws a float32 workspace of B * H * S * D; all contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The caller checks KV | H and
// B * H <= 65535.
extern "C" int flash_attention_wide_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* ws, int B, int H, int KV,
                                           int S, int D, int is_bf16,
                                           float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(ws);
  if (is_bf16)
    return widebody::launch<__nv_bfloat16>(q, k, v, o, acc, B, H, KV, S, D,
                                           scale, st);
  return widebody::launch<float>(q, k, v, o, acc, B, H, KV, S, D, scale,
                                 st);
}
