// Causal GQA flash-attention forward for Hopper: one block per
// (batch x head, 64-row query tile).
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
// Design (simple first; wgmma, TMA and warp specialisation are later
// work): the block stages its Q tile and then one 64-row K and V tile at a
// time in shared memory as float32, and never loads a KV tile wholly above
// the diagonal.  256 threads as 16 x 16: thread (ty, tx) holds rows
// ty + 16 i (i < 4) and score columns tx + 16 j (j < 4), so the 16 lanes
// that share a row sit in one half-warp and reduce its max and sum with
// shuffles.  Scores, the softmax and the P.V product run on the CUDA cores
// in float32 (fmaf); P goes through shared memory to the P.V product, where
// each thread owns output columns tx + 16 c.  Rows and keys past S (a
// ragged last tile) are zero-filled and masked.  No atomics: the same bits
// on every run.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RI = BQ / 16;     // rows per thread
constexpr int RJ = BK / 16;     // score columns per thread
constexpr int PS = BK + 1;      // row stride of the P tile
constexpr float NEG = -1e30f;   // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles with an odd row stride (D + 1), V tile, P tile
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int S, float scale) {
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
  const T* qp = q + (size_t)bh * S * D;
  const T* kp = k + (size_t)kvh * S * D;
  const T* vp = v + (size_t)kvh * S * D;
  T* op = o + (size_t)bh * S * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    Qs[r * DS + c] = q0 + r < S ? to_f32(qp[(size_t)(q0 + r) * D + c]) : 0.f;
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
      Ks[r * DS + c] = in ? to_f32(kp[(size_t)(k0 + r) * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vp[(size_t)(k0 + r) * D + c]) : 0.f;
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
        store(op + (size_t)r * D + tx + 16 * c, acc[i][c] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int S, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, S, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, S, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, S, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); all contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The caller checks KV | H,
// D in {16, 32, 64, 128} and B * H <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int S, int D, int is_bf16,
                                      float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D,
                                           scale, st)
                 : launch_d<float>(q, k, v, o, B, H, KV, S, D, scale, st);
}
