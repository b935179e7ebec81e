// Fused query-side kernels for Hopper: cosine top-k and delta+renormalize.
//
// topk_fused replaces repro/kernels/query_fused.py:topk_fused (body
// _topk_kernel): optional row-normalize (emitting Zn), scores q . z, mask
// of the query's own row, and a running top-k ordered by (-score,
// ascending global id).
//   Bound on the H100: bytes for small query batches (m x K f32 read
//   once, plus Zn written once when normalizing); 2 nq m K fp32
//   operations grow past the bytes only from a few hundred queries on.
//   Design: the TPU walks row blocks in order and carries the running
//   top-k across grid steps; here blocks run in parallel.  Pass 1 gives
//   each thread block a chunk of rows: it stages the chunk in shared
//   memory (normalizing each row exactly once, and writing it to Zn),
//   then each warp takes queries in turn, each lane keeps a sorted list
//   of its best k rows, and the warp merges the 32 lists into the chunk's
//   top-k for that query.  Pass 2 merges the chunks' lists per query, one
//   warp per query.  Every comparison is the explicit (score desc, id asc)
//   order, and every score is the fixed-order K-term dot of common.cuh,
//   so the answer is the exact lexicographic top-k with the same bits for
//   any chunking or shard split.  Unfilled slots come out as (-inf, -1).
//
// gee_delta_renorm replaces repro/kernels/query_fused.py:gee_delta_renorm
// (body _delta_kernel): Z_new = Z + delta contributions, Zn =
// normalize_rows(Z_new), for the whole owned slice.
//   Bound on the H100: bytes, 3 x n_local x K x 4 (read Z, write Z_new and
//   Zn); the delta itself is a few hundred contributions.
//   Design: the TPU packs the delta over every destination tile of the
//   slice (mostly padding); here the delta comes as one short list sorted
//   by local row.  Each block stages 256 rows of Z in shared memory, each
//   thread binary-searches its row's run in the list and adds it in list
//   order, then the block writes Z_new and Zn once, coalesced.
#include "common.cuh"

namespace {

constexpr int KMAX = 64;       // largest k a lane list holds
constexpr int THREADS = 256;

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Insert (s, i) into a list sorted best-first holding n of at most k.
__device__ __forceinline__ void list_insert(float* ls, int* li, int& n,
                                            int k, float s, int i) {
  if (n == k && !better(s, i, ls[k - 1], li[k - 1])) return;
  int p = n < k ? n : k - 1;
  while (p > 0 && better(s, i, ls[p - 1], li[p - 1])) {
    ls[p] = ls[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ls[p] = s;
  li[p] = i;
  if (n < k) ++n;
}

// Merge the 32 lane lists of a warp into the warp's best k; lane 0 writes
// them to out (unfilled slots: -inf, -1).  Ids are distinct across lanes.
__device__ __forceinline__ void warp_merge_write(const float* ls,
                                                 const int* li, int n, int k,
                                                 float* out_s, int* out_i) {
  const int lane = threadIdx.x & 31;
  int head = 0;
  for (int t = 0; t < k; ++t) {
    const float s = head < n ? ls[head] : -CUDART_INF_F;
    const int i = head < n ? li[head] : INT_MAX;
    float bs = s;
    int bi = i;
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (head < n && i == bi) ++head;
    if (lane == 0) {
      out_s[t] = bi == INT_MAX ? -CUDART_INF_F : bs;
      out_i[t] = bi == INT_MAX ? -1 : bi;
    }
  }
}

__global__ void topk_chunk_kernel(const float* __restrict__ Z,
                                  const float* __restrict__ q,
                                  const int* __restrict__ qnodes,
                                  float* __restrict__ zn,
                                  float* __restrict__ cand_s,
                                  int* __restrict__ cand_i, int m, int K,
                                  int nq, int k, int chunk, int row_offset,
                                  int exclude_self, float eps) {
  extern __shared__ float smem[];
  const int KP = odd_stride(K);
  float* zs = smem;                                  // chunk x KP
  float* qs = smem + (size_t)chunk * KP;             // warps x K
  const int c0 = blockIdx.x * chunk;
  const int rows = min(chunk, m - c0);
  const float* src = Z + (size_t)c0 * K;
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x)
    zs[(e / K) * KP + e % K] = src[e];
  __syncthreads();
  if (zn != nullptr) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float* z = zs + r * KP;
      const float d = row_norm_denom(z, K, eps);
      for (int c = 0; c < K; ++c) z[c] = __fdiv_rn(z[c], d);
    }
    __syncthreads();
    float* dst = zn + (size_t)c0 * K;
    for (int e = threadIdx.x; e < rows * K; e += blockDim.x)
      dst[e] = zs[(e / K) * KP + e % K];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* qw = qs + warp * K;
  float ls[KMAX];
  int li[KMAX];
  for (int j = warp; j < nq; j += nw) {
    __syncwarp();
    for (int c = lane; c < K; c += 32) qw[c] = q[(size_t)j * K + c];
    __syncwarp();
    const int self = qnodes[j];
    int n = 0;
    for (int r = lane; r < rows; r += 32) {
      const int gid = row_offset + c0 + r;
      if (exclude_self && gid == self) continue;
      list_insert(ls, li, n, k, row_dot(qw, zs + r * KP, K), gid);
    }
    const size_t base = ((size_t)blockIdx.x * nq + j) * k;
    warp_merge_write(ls, li, n, k, cand_s + base, cand_i + base);
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ cand_s,
                                  const int* __restrict__ cand_i,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i, int nchunks,
                                  int nq, int k) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= nq) return;                   // whole warps leave together
  float ls[KMAX];
  int li[KMAX];
  int n = 0;
  const long long total = (long long)nchunks * k;
  for (long long e = lane; e < total; e += 32) {
    const long long c = e / k, t = e % k;
    const size_t off = ((size_t)c * nq + j) * k + t;
    const int id = cand_i[off];
    if (id >= 0) list_insert(ls, li, n, k, cand_s[off], id);
  }
  warp_merge_write(ls, li, n, k, out_s + (size_t)j * k,
                   out_i + (size_t)j * k);
}

__global__ void delta_renorm_kernel(const float* __restrict__ Z,
                                    const int* __restrict__ rows,
                                    const int* __restrict__ cls,
                                    const float* __restrict__ val, int m,
                                    float* __restrict__ Znew,
                                    float* __restrict__ Zn, int n_local,
                                    int K, float eps) {
  extern __shared__ float smem[];
  const int KP = odd_stride(K);
  float* zs = smem;                                  // THREADS x KP
  float* dn = smem + (size_t)THREADS * KP;           // THREADS
  const int r0 = blockIdx.x * THREADS;
  const int nr = min(THREADS, n_local - r0);
  const float* src = Z + (size_t)r0 * K;
  for (int e = threadIdx.x; e < nr * K; e += THREADS)
    zs[(e / K) * KP + e % K] = src[e];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nr) {
    const int r = r0 + t;
    int lo = 0, hi = m;                  // first contribution with row >= r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rows[mid] < r) lo = mid + 1; else hi = mid;
    }
    float* z = zs + t * KP;
    for (int j = lo; j < m && rows[j] == r; ++j)
      z[cls[j]] = __fadd_rn(z[cls[j]], val[j]);
    dn[t] = row_norm_denom(z, K, eps);
  }
  __syncthreads();
  float* o1 = Znew + (size_t)r0 * K;
  float* o2 = Zn + (size_t)r0 * K;
  for (int e = threadIdx.x; e < nr * K; e += THREADS) {
    const float x = zs[(e / K) * KP + e % K];
    o1[e] = x;
    o2[e] = __fdiv_rn(x, dn[e / K]);
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int topk_fused_launch(const float* Z, const float* q,
                                 const int* qnodes, float* zn, float* cand_s,
                                 int* cand_i, float* out_s, int* out_i,
                                 int m, int K, int nq, int k, int chunk,
                                 int row_offset, int exclude_self, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (m + chunk - 1) / chunk;
  if (nchunks > 0) {               // no rows: every slot stays (-inf, -1)
    const size_t smem = sizeof(float) * ((size_t)chunk * odd_stride(K) +
                                         (THREADS / 32) * K);
    int err = set_smem((const void*)topk_chunk_kernel, smem);
    if (err) return err;
    topk_chunk_kernel<<<nchunks, THREADS, smem, st>>>(
        Z, q, qnodes, zn, cand_s, cand_i, m, K, nq, k, chunk, row_offset,
        exclude_self, eps);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (nq > 0) {
    const int warps_per_block = THREADS / 32;
    topk_merge_kernel<<<(nq + warps_per_block - 1) / warps_per_block,
                        THREADS, 0, st>>>(cand_s, cand_i, out_s, out_i,
                                          nchunks, nq, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int delta_renorm_launch(const float* Z, const int* rows,
                                   const int* cls, const float* val, int m,
                                   float* Znew, float* Zn, int n_local, int K,
                                   float eps, void* stream) {
  if (n_local == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)THREADS * odd_stride(K) +
                                       THREADS);
  int err = set_smem((const void*)delta_renorm_kernel, smem);
  if (err) return err;
  delta_renorm_kernel<<<(n_local + THREADS - 1) / THREADS, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      Z, rows, cls, val, m, Znew, Zn, n_local, K, eps);
  return (int)cudaGetLastError();
}
