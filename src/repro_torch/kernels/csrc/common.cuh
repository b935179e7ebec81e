// Shared device helpers for the GEE kernels.
//
// Row norms and cosine scores are computed in ONE fixed order with
// explicitly rounded operations (no FMA contraction): a row's norm and a
// (query, row) score have the same bits whichever kernel, chunk or shard
// computes them, and the same bits as the plain PyTorch versions, which
// spell out the same elementwise loop (repro_torch/kernels/query_fused.py:
// normalize_rows, row_scores).
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

// max(||z||_2, eps) over exactly K columns: ((z0*z0 + z1*z1) + ...), then
// a correctly rounded sqrt.
__device__ __forceinline__ float row_norm_denom(const float* z, int K,
                                                float eps) {
  float ss = __fmul_rn(z[0], z[0]);
  for (int c = 1; c < K; ++c) ss = __fadd_rn(ss, __fmul_rn(z[c], z[c]));
  return fmaxf(__fsqrt_rn(ss), eps);
}

// q . z over exactly K columns, same order and rounding as row_norm_denom.
__device__ __forceinline__ float row_dot(const float* q, const float* z,
                                         int K) {
  float acc = __fmul_rn(q[0], z[0]);
  for (int c = 1; c < K; ++c) acc = __fadd_rn(acc, __fmul_rn(q[c], z[c]));
  return acc;
}

// Shared-memory row stride: K rounded up to an odd count, so that 32
// threads reading 32 consecutive rows hit 32 different banks.
__host__ __device__ __forceinline__ int odd_stride(int K) { return K | 1; }

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
