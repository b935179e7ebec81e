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
//
// Every body can also write lse = m + ln(l) per row (float32, natural
// log), the input of the backward; with a null lse pointer (every serving
// call) nothing else changes.
//
// The backward (flash_attention_bwd_launch) has no TPU counterpart: the
// reference differentiates its jnp twin attn_flash
// (repro/models/attention.py) with XLA, and its Pallas kernel is forward
// only.  It computes the gradient of the forward above from q, k, v, o,
// lse and dO:
//   P = exp(s D^-0.5 - lse) on and below the diagonal (else 0),
//   Delta = rowsum(dO o), dP = dO V^T, dS = P (dP - Delta),
//   dv = sum over the group of P^T dO, dq = D^-0.5 dS K,
//   dk = D^-0.5 sum over the group of dS^T Q.
// What bounds it on the H100: operations, as the forward.  The least work
// is FA2's five products (S, dP, dv, dk, dq) over the causal pairs; this
// design does seven (S and dP twice, once in each pass), 1.4 x that, so
// that every gradient is summed by one thread in one fixed order: no
// atomics, the same bits on every run (a sharded step is held bit-equal
// to the unsharded one).  Three launches on the stream:
//   - the Delta pass, one warp a row;
//   - the dk/dv pass: one block per (batch x KV head, key tile);
//   - the dq pass: one block per (batch x head, query tile).
//
// bfloat16, D in {16, 32, 64, 128} (bf16bwd): every product on the tensor
// cores with wgmma, through the forward's helpers (TMA maps, swizzled
// tiles, shared-memory descriptors, A fragments from registers).  Each
// pass has the forward's three warpgroups: a producer warp feeding a
// two-slot ring (TMA for the tiles; in the dk/dv pass the warp's lanes
// also copy each tile's lse and Delta with cp.async, arriving on the same
// mbarrier), and two consumer warpgroups of 64 rows each.
//   dk/dv pass, 128 keys a block, K and V loaded once: for each of the
//   G = H / KV query heads of the group in order, for each 64-query tile
//   from the diagonal to S, S^T = K Q^T and dP^T = V dO^T (wgmma m64n64,
//   both operands in shared memory), then P^T and dS^T in registers,
//   rounded to bfloat16 as the A fragments of dv += P^T dO and
//   dk += dS^T Q (wgmma m64nD, the Q and dO tiles as MN-major B).  dk and
//   dv stay in float32 registers and are written once.
//   dq pass, 128 queries a block, Q and dO loaded once: for each 64-key
//   tile up to the diagonal, S = Q K^T and dP = dO V^T (m64n64), then dS
//   in registers as the A fragment of dq += dS K (m64nD, K as MN-major B).
// Both passes mask only where a tile crosses the diagonal or S.
//
// float32 at any D, and bfloat16 at D > 128 (simplebwd): CUDA cores,
// float32 arithmetic, written for correctness as the wide forward body.
// 16-query x 32-key tiles, D staged in chunks of 128 columns in shared
// memory; the accumulators live in float32 rows in device memory (the
// outputs themselves at float32, a scratch the caller allocates at
// bfloat16), each element read and written by one thread in a fixed order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

// element loads and stores in float32 arithmetic, for the CUDA-core bodies
// that take either dtype
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int S, float scale) {
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
      if (lse != nullptr && tx == 0) lse[(size_t)bh * S + r] = m[i] + logf(den);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, S,
      scale);
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
constexpr float LN2 = 0.6931471805599453f;

// A tile of R rows x D bfloat16 as NC chunks of R rows x AW elements (one
// swizzle atom a row); the forward's shared memory for head dim D: tiles
// Q, K[STAGES], V[STAGES] of 128 rows, then the mbarriers.
template <int D, int R = 128>
struct Geo {
  static constexpr int AW = D < 64 ? D : 64;
  static constexpr int NC = D / AW;
  static constexpr uint32_t ROW = AW * 2;          // bytes in a chunk row
  static constexpr uint32_t CHUNK = R * ROW;
  static constexpr uint32_t TILE = NC * CHUNK;     // R * D * 2 bytes
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
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int KV, int S,
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
        // m is in the log2 domain: lse = ln(2^m l)
        if (lse != nullptr && c0 == 0)
          lse[(size_t)bh * S + row] = (m[h] + log2f(den)) * LN2;
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
// {AW, rows, 1}: rows past S read as zeros, never the next head's
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int S, int n,
             int rows = 128) {
  using G = Geo<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::AW, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, G::SWIZZLE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int S, float scale, cudaStream_t stream) {
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
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, KV, S,
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ acc, float* __restrict__ lse, int H,
                      int KV, int S, int D, float scale) {
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
  if (lse != nullptr && tid < rows)
    lse[(size_t)bh * S + q0 + tid] = ms[tid] + logf(fmaxf(ls[tid], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* ws, float* lse, int B, int H, int KV, int S, int D,
           float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws, lse, H, KV, S, D,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace widebody

// ---------------------------------------------------------------------------
// The backward (see the note at the top of the file)
// ---------------------------------------------------------------------------

// Delta = rowsum(dO * o) in float32: one warp a row, the lanes' partial
// sums over D added by xor shuffles (a fixed order: the same bits on every
// run)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int D) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* op = o + r * D;
  const T* dp = dout + r * D;
  float x = 0.f;
  for (int c = lane; c < D; c += 32) x = fmaf(ld(op + c), ld(dp + c), x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) delta[r] = x;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, long long rows,
                 int D, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  flash_bwd_delta_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  return (int)cudaGetLastError();
}

namespace bf16bwd {

using namespace bf16body;   // mbarriers, TMA, wgmma helpers, Geo, make_map

constexpr int KT = 128;     // keys per dk/dv block, 64 per consumer
constexpr int QT = 64;      // queries per step of the dk/dv pass
constexpr int QB = 128;     // queries per dq block, 64 per consumer
constexpr int KB = 64;      // keys per step of the dq pass
constexpr int NSTAGE = 2;   // depth of each pass's ring
constexpr int NTHREADS = 384;

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], both operands in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// 4 bytes global -> shared, zero-filled where !in (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies landed
// (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// S = A B^T of a warpgroup's 64 rows against a 64-row tile: A the rows
// of a 128-row tile from `a` (K-major), B a 64-row tile at `b` (K-major)
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a,
                                       uint32_t b) {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 16 % G1::AW) * 2;
    wgmma_ss_n64(s,
                 sdesc(a + (kk * 16 / G1::AW) * G1::CHUNK + col, 16, G1::SBO,
                       G1::LAYOUT),
                 sdesc(b + (kk * 16 / G2::AW) * G2::CHUNK + col, 16, G2::SBO,
                       G2::LAYOUT),
                 kk > 0);
  }
}

// acc[64 x D] += A[64 x 64] . T, A from registers (a[4 kk .. 4 kk + 3]
// holds columns 16 kk .. 16 kk + 15), T a 64-row tile at `t` (MN-major)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&a)[16],
                                           uint32_t t) {
  using G2 = Geo<D, 64>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_rs<D>(acc, f,
                sdesc(t + kk * 16 * G2::ROW, G2::CHUNK, G2::SBO, G2::LAYOUT));
  }
}

// dk/dv pass, shared memory: K, V (128 rows each, loaded once), then
// NSTAGE slots of Q and of dO (64 rows each), of lse and of Delta (64
// floats each), then the mbarriers
template <int D>
struct KvSmem {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = G1::TILE;
  static constexpr uint32_t Q_OFF = 2 * G1::TILE;
  static constexpr uint32_t DO_OFF = Q_OFF + NSTAGE * G2::TILE;
  static constexpr uint32_t LSE_OFF = DO_OFF + NSTAGE * G2::TILE;
  static constexpr uint32_t DL_OFF = LSE_OFF + NSTAGE * QT * 4;
  static constexpr uint32_t BAR_OFF = DL_OFF + NSTAGE * QT * 4;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * NSTAGE) + 1024;
};

// One block per (batch x KV head, 128-key tile), key tile 0 (the most
// queries) first.  Consumer w owns keys k0 + 64 w .. + 63 and computes
// the transposed products: S^T = K Q^T and dP^T = V dO^T, so that P^T and
// dS^T are the A fragments of dv += P^T dO and dk += dS^T Q.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int H, int KV, int S,
                    float scale, float scale_log2) {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
  using L = KvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const float* lse_s =
      reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                     L::LSE_OFF);
  const float* dl_s = lse_s + (L::DL_OFF - L::LSE_OFF) / 4;
  const uint32_t bar = base + L::BAR_OFF;
  // mbarriers: K and V full; per slot full (TMA bytes, plus the producer
  // warp's 32 cp.async arrivals) and empty (every consumer thread)
  const uint32_t full_kv = bar, full = bar + 8, empty = full + 8 * NSTAGE;

  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV, G = H / KV;
  const int k0 = blockIdx.y * KT;
  const int nq = (S - k0 + QT - 1) / QT;     // query tiles from the diagonal
  const int steps = G * nq;                  // group heads in order

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {                  // the producer warp
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * G1::TILE);
        for (int c = 0; c < G1::NC; ++c) {
          tma_load(base + L::K_OFF + c * G1::CHUNK, &tk, full_kv, c * G1::AW,
                   k0, bkv);
          tma_load(base + L::V_OFF + c * G1::CHUNK, &tv, full_kv, c * G1::AW,
                   k0, bkv);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int s = t % NSTAGE;
        const int q0 = k0 + (t % nq) * QT;
        const int bh = b * H + kvh * G + t / nq;
        mbar_wait(empty + 8 * s, ((t / NSTAGE) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * G2::TILE);
          for (int c = 0; c < G2::NC; ++c) {
            tma_load(base + L::Q_OFF + s * G2::TILE + c * G2::CHUNK, &tq,
                     full + 8 * s, c * G2::AW, q0, bh);
            tma_load(base + L::DO_OFF + s * G2::TILE + c * G2::CHUNK, &tdo,
                     full + 8 * s, c * G2::AW, q0, bh);
          }
        }
        for (int i = lane; i < QT; i += 32) {
          const bool in = q0 + i < S;
          const size_t g = (size_t)bh * S + (in ? q0 + i : 0);
          cp_async4(base + L::LSE_OFF + (s * QT + i) * 4, lse + g, in);
          cp_async4(base + L::DL_OFF + (s * QT + i) * 4, delta + g, in);
        }
        cp_async_arrive(full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    // accumulator fragment: rows (keys) r0 and r0 + 8 (h = 0, 1) of this
    // consumer's 64, columns 8 j + c0 + {0, 1}: element [4 j + 2 h + e]
    const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    const int kw = k0 + 64 * w;
    const uint32_t ka = base + L::K_OFF + w * 64 * G1::ROW;
    const uint32_t va = base + L::V_OFF + w * 64 * G1::ROW;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[32], dp[32];
    uint32_t pa[16], da[16];

    mbar_wait(full_kv, 0);
    for (int t = 0; t < steps; ++t) {
      const int s = t % NSTAGE;
      const int q0 = k0 + (t % nq) * QT;
      const uint32_t qs = base + L::Q_OFF + s * G2::TILE;
      const uint32_t dos = base + L::DO_OFF + s * G2::TILE;
      mbar_wait(full + 8 * s, (t / NSTAGE) & 1);
      pin(dk_acc);
      pin(dv_acc);
      wgmma_fence();
      scores<D>(st, ka, qs);                 // S^T = K Q^T
      scores<D>(dp, va, dos);                // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      pin(dp);
      // keys above a query, and queries past S, get P = dS = 0
      const bool edge = q0 < kw + 64 || q0 + QT > S;
      const float* ls = lse_s + s * QT;
      const float* dl = dl_s + s * QT;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + c0 + e;
          const float l2 = ls[col] * LOG2E;
          const float dlt = dl[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            float p = ex2(fmaf(st[i], scale_log2, -l2));
            if (edge && (kw + r0 + 8 * h > q0 + col || q0 + col >= S))
              p = 0.f;
            st[i] = p;
            dp[i] = p * (dp[i] - dlt);
          }
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[2 * j + h] = pack_bf16(st[4 * j + 2 * h], st[4 * j + 2 * h + 1]);
          da[2 * j + h] = pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
        }
      pin(pa);
      pin(da);
      pin(dk_acc);
      pin(dv_acc);
      wgmma_fence();
      accumulate<D>(dv_acc, pa, dos);        // dv += P^T dO
      accumulate<D>(dk_acc, da, qs);         // dk += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      pin(dk_acc);
      pin(dv_acc);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw + r0 + 8 * h;
      if (key < S) {
        const size_t g = ((size_t)bkv * S + key) * D + c0;
        __nv_bfloat162* kp = reinterpret_cast<__nv_bfloat162*>(dk + g);
        __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(dv + g);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          kp[4 * j] = __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                            dk_acc[4 * j + 2 * h + 1] * scale);
          vp[4 * j] = __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                            dv_acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// dq pass, shared memory: Q, dO (128 rows each, loaded once), then NSTAGE
// slots of K and of V (64 rows each), then the mbarriers
template <int D>
struct QSmem {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t DO_OFF = G1::TILE;
  static constexpr uint32_t K_OFF = 2 * G1::TILE;
  static constexpr uint32_t V_OFF = K_OFF + NSTAGE * G2::TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + NSTAGE * G2::TILE;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * NSTAGE) + 1024;
};

// One block per (batch x head, 128-query tile), the heaviest tiles first.
// Consumer w owns queries q0 + 64 w .. + 63 and walks the 64-key tiles up
// to the diagonal: S = Q K^T, dP = dO V^T, dS = P (dP - Delta), and
// dq += dS K with dS as the A fragment.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_q_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int H, int KV, int S,
                   float scale, float scale_log2) {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
  using L = QSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t full_q = bar, full = bar + 8, empty = full + 8 * NSTAGE;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QB;
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  const int n_kv = (min(S, q0 + QB) + KB - 1) / KB;   // up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * G1::TILE);
      for (int c = 0; c < G1::NC; ++c) {
        tma_load(base + L::Q_OFF + c * G1::CHUNK, &tq, full_q, c * G1::AW,
                 q0, bh);
        tma_load(base + L::DO_OFF + c * G1::CHUNK, &tdo, full_q, c * G1::AW,
                 q0, bh);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % NSTAGE;
        mbar_wait(empty + 8 * s, ((t / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G2::TILE);
        for (int c = 0; c < G2::NC; ++c) {
          tma_load(base + L::K_OFF + s * G2::TILE + c * G2::CHUNK, &tk,
                   full + 8 * s, c * G2::AW, t * KB, kvh);
          tma_load(base + L::V_OFF + s * G2::TILE + c * G2::CHUNK, &tv,
                   full + 8 * s, c * G2::AW, t * KB, kvh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    // rows (queries) r0 and r0 + 8 of this consumer's 64, columns (keys)
    // 8 j + c0 + {0, 1}
    const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    const int qw = q0 + 64 * w;
    const uint32_t qa = base + L::Q_OFF + w * 64 * G1::ROW;
    const uint32_t doa = base + L::DO_OFF + w * 64 * G1::ROW;
    float l2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qw + r0 + 8 * h;
      l2[h] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
      dl[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float sc[32], dp[32];
    uint32_t da[16];

    mbar_wait(full_q, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % NSTAGE;
      const int k0 = t * KB;
      const uint32_t ks = base + L::K_OFF + s * G2::TILE;
      const uint32_t vs = base + L::V_OFF + s * G2::TILE;
      mbar_wait(full + 8 * s, (t / NSTAGE) & 1);
      pin(dq_acc);
      wgmma_fence();
      scores<D>(sc, qa, ks);                 // S = Q K^T
      scores<D>(dp, doa, vs);                // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(dp);
      // keys above a query (and so every key past S) get P = dS = 0
      const bool edge = k0 + KB - 1 > qw;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = ex2(fmaf(sc[i], scale_log2, -l2[h]));
            if (edge && k0 + 8 * j + c0 + e > qw + r0 + 8 * h) p = 0.f;
            dp[i] = p * (dp[i] - dl[h]);
          }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          da[2 * j + h] = pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
      pin(da);
      pin(dq_acc);
      wgmma_fence();
      accumulate<D>(dq_acc, da, ks);         // dq += dS K
      wgmma_commit();
      wgmma_wait<0>();
      pin(dq_acc);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qw + r0 + 8 * h;
      if (row < S) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            dq + ((size_t)bh * S + row) * D + c0);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          p[4 * j] = __floats2bfloat162_rn(dq_acc[4 * j + 2 * h] * scale,
                                           dq_acc[4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int H, int KV, int S, float scale,
           cudaStream_t stream) {
  // 64-row boxes for the tiles a pass streams, 128-row for those it holds
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  int err = make_map<D>(&q64, q, S, B * H, 64);
  if (err == 0) err = make_map<D>(&do64, dout, S, B * H, 64);
  if (err == 0) err = make_map<D>(&k128, k, S, B * KV, 128);
  if (err == 0) err = make_map<D>(&v128, v, S, B * KV, 128);
  if (err == 0) err = make_map<D>(&q128, q, S, B * H, 128);
  if (err == 0) err = make_map<D>(&do128, dout, S, B * H, 128);
  if (err == 0) err = make_map<D>(&k64, k, S, B * KV, 64);
  if (err == 0) err = make_map<D>(&v64, v, S, B * KV, 64);
  if (err != 0) return err;
  const float scale_log2 = scale * LOG2E;

  constexpr size_t kv_smem = KvSmem<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kv_smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_kv_kernel<D><<<dim3(B * KV, (S + KT - 1) / KT), NTHREADS,
                           kv_smem, stream>>>(
      q64, k128, v128, do64, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, KV, S, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t q_smem = QSmem<D>::SMEM;
  e = cudaFuncSetAttribute(flash_bwd_q_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)q_smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_q_kernel<D><<<dim3(B * H, (S + QB - 1) / QB), NTHREADS, q_smem,
                          stream>>>(q128, k64, v64, do128, lse, delta,
                                    static_cast<__nv_bfloat16*>(dq), H, KV,
                                    S, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace bf16bwd

namespace simplebwd {

constexpr int BQ = 16;          // query rows per tile
constexpr int BK = 32;          // keys per tile
constexpr int DC = 128;         // head-dim columns staged at a time
constexpr int PS = BK + 1;      // row stride of the P and dS tiles
constexpr int THREADS = 256;    // each thread two (query, key) pairs

struct Smem {
  float Qs[BQ * DC];            // a Q or dO chunk
  float KVs[BK * (DC + 1)];     // a K or V chunk
  float Ps[BQ * PS], dSs[BQ * PS];
  float lse[BQ], dl[BQ];
};

// x[t] += a-row . b-row over all of D for this thread's two pairs (query
// pr / BK, key pr % BK), the dot in column order; rows past S read zeros
template <typename T>
__device__ void dots(const T* a, const T* bm, int q0, int k0, int S, int D,
                     Smem& sm, float (&x)[2]) {
  const int tid = threadIdx.x;
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    __syncthreads();                    // Qs, KVs free
    for (int e = tid; e < BQ * dc; e += THREADS) {
      const int r = e / dc, c = e % dc;
      sm.Qs[r * DC + c] = q0 + r < S ? ld(a + (size_t)(q0 + r) * D + d0 + c)
                                     : 0.f;
    }
    for (int e = tid; e < BK * dc; e += THREADS) {
      const int r = e / dc, c = e % dc;
      sm.KVs[r * (DC + 1) + c] =
          k0 + r < S ? ld(bm + (size_t)(k0 + r) * D + d0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pr = tid + t * THREADS;
      const int i = pr / BK, j = pr % BK;
      float y = x[t];
      for (int c = 0; c < dc; ++c)
        y = fmaf(sm.Qs[i * DC + c], sm.KVs[j * (DC + 1) + c], y);
      x[t] = y;
    }
  }
}

// P and dS of queries q0 .. q0 + 15 against keys k0 .. k0 + 31 into
// sm.Ps, sm.dSs (sm.lse, sm.dl hold the rows' lse and Delta); keys above
// the query and rows past S get 0
template <typename T>
__device__ void p_ds(const T* qp, const T* dop, const T* kp, const T* vp,
                     int q0, int k0, int S, int D, float scale, Smem& sm) {
  float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
  dots(qp, kp, q0, k0, S, D, sm, s);
  dots(dop, vp, q0, k0, S, D, sm, dp);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int pr = threadIdx.x + t * THREADS;
    const int i = pr / BK, j = pr % BK;
    const int qpos = q0 + i, kpos = k0 + j;
    const float p = (qpos < S && kpos <= qpos)
                        ? expf(s[t] * scale - sm.lse[i]) : 0.f;
    sm.Ps[i * PS + j] = p;
    sm.dSs[i * PS + j] = p * (dp[t] - sm.dl[i]);
  }
  __syncthreads();
}

// stage rows r0 .. r0 + n - 1 (zeros past S) of columns d0 .. d0 + dc - 1
// into dst with row stride `ld_`
template <typename T>
__device__ void stage(float* dst, int ld_, const T* src, int r0, int n,
                      int S, int D, int d0, int dc) {
  for (int e = threadIdx.x; e < n * dc; e += THREADS) {
    const int r = e / dc, c = e % dc;
    dst[r * ld_ + c] = r0 + r < S ? ld(src + (size_t)(r0 + r) * D + d0 + c)
                                  : 0.f;
  }
}

// dk, dv: one block per (batch x KV head, 32-key tile), key tile 0 first;
// the accumulators are float32 rows of dk_acc, dv_acc (B, KV, S, D),
// each element owned by one thread
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kv_simple(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* dk, T* dv,
                    float* dk_acc, float* dv_acc, int H, int KV, int S,
                    int D, float scale) {
  __shared__ Smem sm;
  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV, G = H / KV;
  const int k0 = blockIdx.y * BK;
  const int keys = min(BK, S - k0);
  const int tid = threadIdx.x;
  const size_t off = (size_t)bkv * S * D;
  float* akp = dk_acc + off;
  float* avp = dv_acc + off;
  for (size_t e = tid; e < (size_t)keys * D; e += THREADS) {
    akp[(size_t)k0 * D + e] = 0.f;
    avp[(size_t)k0 * D + e] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kvh * G + g;
    const T* qp = q + (size_t)bh * S * D;
    const T* dop = dout + (size_t)bh * S * D;
    for (int q0 = k0 / BQ * BQ; q0 < S; q0 += BQ) {
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        sm.lse[tid] = in ? lse[(size_t)bh * S + q0 + tid] : 0.f;
        sm.dl[tid] = in ? delta[(size_t)bh * S + q0 + tid] : 0.f;
      }
      p_ds(qp, dop, k + off, v + off, q0, k0, S, D, scale, sm);
      for (int d0 = 0; d0 < D; d0 += DC) {
        const int dc = min(DC, D - d0);
        // dv += P^T dO, then dk += dS^T Q
        for (int pass = 0; pass < 2; ++pass) {
          __syncthreads();              // Qs free
          stage(sm.Qs, DC, pass ? qp : dop, q0, BQ, S, D, d0, dc);
          __syncthreads();
          const float* w = pass ? sm.dSs : sm.Ps;
          float* acc = pass ? akp : avp;
          for (int e = tid; e < keys * dc; e += THREADS) {
            const int j = e / dc, c = e % dc;
            float* a = acc + (size_t)(k0 + j) * D + d0 + c;
            float x = *a;
            for (int i = 0; i < BQ; ++i)
              x = fmaf(w[i * PS + j], sm.Qs[i * DC + c], x);
            *a = x;
          }
        }
      }
    }
  }
  __syncthreads();
  for (size_t e = tid; e < (size_t)keys * D; e += THREADS) {
    const size_t g = off + (size_t)k0 * D + e;
    st(dk + g, dk_acc[g] * scale);
    st(dv + g, dv_acc[g]);
  }
}

// dq: one block per (batch x head, 16-query tile), the heaviest first;
// the accumulators are float32 rows of dq_acc (B, H, S, D)
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_q_simple(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* dq, float* dq_acc,
                   int H, int KV, int S, int D, float scale) {
  __shared__ Smem sm;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  const int rows = min(BQ, S - q0);
  const int tid = threadIdx.x;
  const size_t off = (size_t)bh * S * D;
  const T* kp = k + (size_t)kvh * S * D;
  const T* vp = v + (size_t)kvh * S * D;
  float* ap = dq_acc + off;
  for (size_t e = tid; e < (size_t)rows * D; e += THREADS)
    ap[(size_t)q0 * D + e] = 0.f;
  if (tid < BQ) {
    const bool in = tid < rows;
    sm.lse[tid] = in ? lse[(size_t)bh * S + q0 + tid] : 0.f;
    sm.dl[tid] = in ? delta[(size_t)bh * S + q0 + tid] : 0.f;
  }
  const int kv_end = min(S, q0 + BQ);   // causal: later keys never read
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    p_ds(q + off, dout + off, kp, vp, q0, k0, S, D, scale, sm);
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dc = min(DC, D - d0);
      __syncthreads();                  // KVs free
      stage(sm.KVs, DC + 1, kp, k0, BK, S, D, d0, dc);
      __syncthreads();
      for (int e = tid; e < rows * dc; e += THREADS) {
        const int i = e / dc, c = e % dc;
        float* a = ap + (size_t)(q0 + i) * D + d0 + c;
        float x = *a;
        for (int j = 0; j < BK; ++j)
          x = fmaf(sm.dSs[i * PS + j], sm.KVs[j * (DC + 1) + c], x);
        *a = x;
      }
    }
  }
  __syncthreads();
  for (size_t e = tid; e < (size_t)rows * D; e += THREADS) {
    const size_t g = off + (size_t)q0 * D + e;
    st(dq + g, dq_acc[g] * scale);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, float* ws, int B, int H, int KV, int S, int D,
           float scale, cudaStream_t stream) {
  // float32 accumulates in the outputs themselves, bfloat16 in ws
  float* dq_acc = ws != nullptr ? ws : static_cast<float*>(dq);
  float* dk_acc = ws != nullptr ? ws + (size_t)B * H * S * D
                                : static_cast<float*>(dk);
  float* dv_acc = ws != nullptr ? dk_acc + (size_t)B * KV * S * D
                                : static_cast<float*>(dv);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_kv_simple<T><<<dim3(B * KV, (S + BK - 1) / BK), THREADS, 0,
                           stream>>>(qt, kt, vt, dot, lse, delta,
                                     static_cast<T*>(dk), static_cast<T*>(dv),
                                     dk_acc, dv_acc, H, KV, S, D, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_q_simple<T><<<dim3(B * H, (S + BQ - 1) / BQ), THREADS, 0,
                          stream>>>(qt, kt, vt, dot, lse, delta,
                                    static_cast<T*>(dq), dq_acc, H, KV, S, D,
                                    scale);
  return (int)cudaGetLastError();
}

}  // namespace simplebwd

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); all contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse null or a float32 (B, H, S)
// that receives each row's natural log-sum-exp.  The caller checks KV | H,
// D in {16, 32, 64, 128} and the grid's y dimension: B * H <= 65535 at
// float32, ceil(S / 128) <= 65535 at bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int H, int KV, int S, int D,
                                      int is_bf16, float scale,
                                      void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
    switch (D) {
      case 16: return bf16body::launch<16>(q, k, v, o, l, B, H, KV, S, scale,
                                           st);
      case 32: return bf16body::launch<32>(q, k, v, o, l, B, H, KV, S, scale,
                                           st);
      case 64: return bf16body::launch<64>(q, k, v, o, l, B, H, KV, S, scale,
                                           st);
      case 128: return bf16body::launch<128>(q, k, v, o, l, B, H, KV, S,
                                             scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return f32body::launch<16>(q, k, v, o, l, B, H, KV, S, scale,
                                        st);
    case 32: return f32body::launch<32>(q, k, v, o, l, B, H, KV, S, scale,
                                        st);
    case 64: return f32body::launch<64>(q, k, v, o, l, B, H, KV, S, scale,
                                        st);
    case 128: return f32body::launch<128>(q, k, v, o, l, B, H, KV, S, scale,
                                          st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The body for any D > 128: q, o (B, H, S, D); k, v (B, KV, S, D);
// ws a float32 workspace of B * H * S * D; lse null or float32 (B, H, S);
// all contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The
// caller checks KV | H and B * H <= 65535.
extern "C" int flash_attention_wide_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* ws, void* lse, int B, int H,
                                           int KV, int S, int D, int is_bf16,
                                           float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(ws);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return widebody::launch<__nv_bfloat16>(q, k, v, o, acc, l, B, H, KV, S,
                                           D, scale, st);
  return widebody::launch<float>(q, k, v, o, acc, l, B, H, KV, S, D, scale,
                                 st);
}

// The backward: dq, dk, dv of causal GQA attention from q, o, dout (B, H,
// S, D), k, v (B, KV, S, D), lse (B, H, S) float32 (the forward's), all
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); dq (B, H,
// S, D), dk, dv (B, KV, S, D) in that dtype; delta a float32 (B, H, S)
// scratch; ws null, or for bfloat16 at D outside {16, 32, 64, 128} a
// float32 scratch of (B H + 2 B KV) S D.  Launches the Delta pass, then
// the dk/dv pass, then the dq pass, and returns the first launch error.
// The caller checks KV | H and ceil(S / 16) <= 65535.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* ws, int B, int H, int KV, int S, int D, int is_bf16,
    float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long rows = (long long)B * H * S;
  int err = is_bf16 ? launch_delta<__nv_bfloat16>(o, dout, dl, rows, D, st)
                    : launch_delta<float>(o, dout, dl, rows, D, st);
  if (err != 0) return err;
  if (is_bf16) {
    switch (D) {
      case 16: return bf16bwd::launch<16>(q, k, v, dout, l, dl, dq, dk, dv, B,
                                          H, KV, S, scale, st);
      case 32: return bf16bwd::launch<32>(q, k, v, dout, l, dl, dq, dk, dv, B,
                                          H, KV, S, scale, st);
      case 64: return bf16bwd::launch<64>(q, k, v, dout, l, dl, dq, dk, dv, B,
                                          H, KV, S, scale, st);
      case 128: return bf16bwd::launch<128>(q, k, v, dout, l, dl, dq, dk, dv,
                                            B, H, KV, S, scale, st);
      default:
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        return simplebwd::launch<__nv_bfloat16>(
            q, k, v, dout, l, dl, dq, dk, dv, static_cast<float*>(ws), B, H,
            KV, S, D, scale, st);
    }
  }
  return simplebwd::launch<float>(q, k, v, dout, l, dl, dq, dk, dv, nullptr,
                                  B, H, KV, S, D, scale, st);
}
