// Fused query-side kernels for Hopper: cosine top-k and delta+renormalize.
//
// topk_fused replaces repro/kernels/query_fused.py:topk_fused (body
// _topk_kernel, pallas_call at :123): optional row-normalize (emitting
// Zn), scores q . z, mask of the query's own row, and the top-k ordered by
// (score desc, global id asc).  The TPU walks row blocks in order and
// carries one running top-k across grid steps; here two passes, each its
// own launch:
//   select  a grid of a few blocks per SM (from the occupancy API), each
//           walking a contiguous range of row tiles for one group of up to
//           64 queries (blockIdx.y; more queries are more groups).  The
//           group's queries sit in shared memory; each block keeps, per
//           query, its current top-k sorted in shared memory and a
//           threshold: the better of its own k-th slot and the best k-th
//           slot any block has published for the query (a 64-bit atomicMax
//           key in device memory), (-inf, INT_MAX) until there is one.  A
//           (row, query) goes on only if it beats the threshold under the
//           full (score, id) order; survivors go to the query's buffer
//           (CAP slots, one shared atomicAdd a warp, any order).  After a
//           pass over the tile one warp per non-empty query merges its
//           buffer into its list (all of a batch placed by rank in one
//           step) and renews the threshold; a query whose buffer
//           overflowed rescans the tile against it.  A block's first tile
//           seeds each list with the best of each lane's rows, so the
//           first pass does not keep every row.  At the end the block
//           writes its k candidates per query once.
//   merge   one block per query, a warp per slice of the grid x k
//           candidates, then one warp merges the 8 warp lists.
//   Rows: for K in {8, 16, 32} (16-byte aligned rows) each thread holds
//   R = 64 / K rows in registers and reads each query as broadcast 16-byte
//   shared loads, so one q element serves R rows; the body is templated on
//   K and sums exactly K terms.  Other K (up to 256) stage a tile of rows
//   in shared memory and score (row, query) pairs from there exactly, with
//   the same filter and merge.  Rows are read with plain vectorised loads
//   and the next tile is prefetched into L2 (no TMA ring: the pass is
//   bound by issue, not by loads).  normalize=True normalizes each row
//   once in flight and writes Zn once (query group 0 only).
//   Bound on the H100: the scores.  The contract below rounds each product
//   and each sum on its own (one FMUL and one FADD per term, no FFMA), so
//   scoring every (row, query) exactly issues 2 nq m K FP32 instructions:
//   4.96e9 at the main shape (m = 2.42 M, nq = 64, K = 16), about 0.15 ms
//   at 128 lanes x 132 SMs.  Zn's bytes (m K 4, read once) take a third of
//   that.  The register body first takes an FMA dot (K instructions), and
//   computes the exact score only where that dot plus a proven margin
//   reaches the threshold (margin_factor below), which once the threshold
//   has settled is a small share of the rows: the floor is then K FFMA per
//   (row, query), half the exact one.  A row is read once per query group,
//   each shared load of q feeds R rows, and the top-k bookkeeping is one
//   compare per (row, query).
//   Wide rows and long lists: the bodies above serve k <= 64 and K <= 256
//   (their lists, buffers and query group live in shared memory).  Any
//   other (K, k) takes the general path, which the launchers pick by
//   shape: every warp is a selector of its own for one query (blockIdx.x)
//   over a contiguous range of rows, a lane per row, scoring exactly from
//   device memory (row_dot of common.cuh, so the same bits) and keeping
//   its sorted list of k in its candidate slot in device memory; rows are
//   normalized first by a kernel of their own when normalize=True.  The
//   merge of k > 64 lists is one warp per query over its selectors'
//   candidates, the list again in device memory (merge_batch_any places a
//   batch by rank for lists of any length).  No shared thresholds and no
//   prefilter: a simple path, bound by the 2 nq m K exact-score
//   instructions and by reading the rows once per query.
//   Exact: every score that is kept is the fixed-order K-term dot of
//   common.cuh, so it has the same bits whichever block, tile or body
//   computes it and the same bits as the plain version.  The order (score
//   desc, id asc) is total because the ids are distinct, so the top k of
//   any set is one set, whatever order its members arrive in.  A threshold
//   is the k-th slot of some block's list: it and the k - 1 slots before
//   it are k rows, so a member of the final top-k (fewer than k rows ahead
//   of it) either beats it or is that row, held by the block that owns it;
//   and the prefilter skips only rows whose exact score is below the
//   threshold's.  So no member of the final top-k is ever dropped.  Block
//   lists and the merge are selections under the same order, so the
//   answer is the exact top-k with the plain scan's bits for any grid,
//   tile, arrival order or timing of the shared thresholds.  Unfilled
//   slots come out as (-inf, -1).
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
//   order, then the block writes Z_new and Zn once, coalesced.  Rows wider
//   than DELTA_SMEM_K do not fit 256 to a block in shared memory: there the
//   block copies its rows to Z_new first and each thread adds into and
//   takes the norm of its row in device memory, in the same order, so
//   Z_new and Zn have the same bits at every K.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int KMAX = 64;       // largest k
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 64;      // queries per group (blockIdx.y)
constexpr int CAP = 2 * KMAX;  // survivor slots per query and pass
constexpr int KSMEM_MAX = 256; // widest rows of the shared-memory body
constexpr int GEN_WARPS = THREADS / 32;  // selectors a block, general path
constexpr int DELTA_SMEM_K = 128;  // widest rows the delta body stages
constexpr unsigned FULL = 0xffffffffu;

// The select bodies above the general path take k <= KMAX, K <= KSMEM_MAX.
__host__ __device__ __forceinline__ bool general_path(int K, int k) {
  return k > KMAX || K > KSMEM_MAX;
}

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Merge one candidate per lane (valid lanes only) into a sorted top-k
// list (best first, k slots, unfilled slots (-inf, INT_MAX)) in shared
// memory; called by a whole warp.  Candidates that do not beat the k-th
// slot, and rows the list holds already (a rescanned tile offers them
// again), drop out.  The rest are placed by rank in one step: a
// candidate's new slot is the count of list entries and other candidates
// better than it, a list entry's its slot plus the candidates better than
// it.  The order is total over distinct ids, so the ranks are distinct:
// whatever lands below k is the top k of the union, sorted.
__device__ __forceinline__ void merge_batch(float* ls, int* li, int k,
                                            float s, int i, bool v) {
  const int lane = threadIdx.x & 31;
  v = v && better(s, i, ls[k - 1], li[k - 1]);
  if (!__any_sync(FULL, v)) return;
  int rank = 0;
#pragma unroll 4
  for (int t = 0; t < k; ++t) {
    const float es = ls[t];
    const int ei = li[t];
    rank += better(es, ei, s, i);
    v = v && ei != i;
  }
  const bool h0 = lane < k, h1 = lane + 32 < k;
  const float e0 = h0 ? ls[lane] : 0.f, e1 = h1 ? ls[lane + 32] : 0.f;
  const int f0 = h0 ? li[lane] : 0, f1 = h1 ? li[lane + 32] : 0;
  int p0 = lane, p1 = lane + 32;
  // the other candidates, four at a time so that their shuffles overlap
  for (unsigned b = __ballot_sync(FULL, v); b != 0;) {
    int src[4];
    bool has[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      has[u] = b != 0;
      src[u] = has[u] ? __ffs(b) - 1 : 0;
      b &= b - 1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float os = __shfl_sync(FULL, s, src[u]);
      const int oi = __shfl_sync(FULL, i, src[u]);
      if (has[u]) {
        rank += better(os, oi, s, i);
        p0 += better(os, oi, e0, f0);
        p1 += better(os, oi, e1, f1);
      }
    }
  }
  __syncwarp();
  if (h0 && p0 < k) {
    ls[p0] = e0;
    li[p0] = f0;
  }
  if (h1 && p1 < k) {
    ls[p1] = e1;
    li[p1] = f1;
  }
  if (v && rank < k) {
    ls[rank] = s;
    li[rank] = i;
  }
  __syncwarp();
}

// The select pass's shared memory, carved in this order (16-byte aligned
// pieces): the group's queries (GROUP x K), their own ids (-1 when
// exclude_self is off), their prefilter margins, their thresholds (scores,
// then ids), the lists (GROUP x k scores, then ids), the survivor counts
// and rescan flags (GROUP each),
// the survivor buffers (GROUP x CAP scores, then ids), and for the
// shared-memory body the row tile (tile x odd_stride(K)).
struct Smem {
  float* qs;
  int* qid;
  float* qe;
  float* ts;
  int* ti;
  float* ls;
  int* li;
  int* cnt;
  int* redo;
  float* bs;
  int* bi;
  float* zs;
};

__host__ __device__ __forceinline__ void take(char* base, size_t& off,
                                              size_t bytes, void** out) {
  if (base != nullptr) *out = base + off;
  off += (bytes + 15) & ~static_cast<size_t>(15);
}

// Carve `base` (nullptr: only size it); returns the bytes used.
__host__ __device__ __forceinline__ size_t carve(char* base, int K, int k,
                                                 int tile, bool smem_rows,
                                                 Smem* s) {
  size_t off = 0;
  void* p[12] = {};
  take(base, off, sizeof(float) * GROUP * K, &p[0]);
  take(base, off, sizeof(int) * GROUP, &p[1]);
  take(base, off, sizeof(float) * GROUP, &p[2]);
  take(base, off, sizeof(float) * GROUP, &p[3]);
  take(base, off, sizeof(int) * GROUP, &p[4]);
  take(base, off, sizeof(float) * GROUP * k, &p[5]);
  take(base, off, sizeof(int) * GROUP * k, &p[6]);
  take(base, off, sizeof(int) * GROUP, &p[7]);
  take(base, off, sizeof(int) * GROUP, &p[8]);
  take(base, off, sizeof(float) * GROUP * CAP, &p[9]);
  take(base, off, sizeof(int) * GROUP * CAP, &p[10]);
  if (smem_rows)
    take(base, off, sizeof(float) * tile * odd_stride(K), &p[11]);
  *s = Smem{static_cast<float*>(p[0]),  static_cast<int*>(p[1]),
            static_cast<float*>(p[2]),  static_cast<float*>(p[3]),
            static_cast<int*>(p[4]),    static_cast<float*>(p[5]),
            static_cast<int*>(p[6]),    static_cast<int*>(p[7]),
            static_cast<int*>(p[8]),    static_cast<float*>(p[9]),
            static_cast<int*>(p[10]),   static_cast<float*>(p[11])};
  return off;
}

// (score, id) as one 64-bit key that orders like `better`: the score's
// bits made monotone (-0 taken as +0), then INT_MAX - id.  0 is below
// every key: no threshold published yet.
__device__ __forceinline__ unsigned long long order_key(float s, int i) {
  unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(INT_MAX - i);
}

// Query j's threshold: the better of its list's k-th slot and the best
// k-th slot any block of the grid has published for it (gkey), which this
// call publishes its own to.  Any block's k-th slot is a valid threshold
// for every block: it and the k - 1 entries before it are rows of the
// matrix, so a row worse than it has k rows ahead of it and is not in the
// answer, and the row itself is held by the block that published it.
__device__ __forceinline__ void set_threshold(const Smem& S, int j, int k,
                                              unsigned long long* gkey) {
  const float s = S.ls[j * k + k - 1];
  const int i = S.li[j * k + k - 1];
  const unsigned long long mine = i == INT_MAX ? 0ull : order_key(s, i);
  const unsigned long long best = max(atomicMax(gkey, mine), mine);
  if (best == 0ull) return;                    // still (-inf, INT_MAX)
  unsigned u = static_cast<unsigned>(best >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  S.ts[j] = __uint_as_float(u);
  S.ti[j] = INT_MAX - static_cast<int>(best & 0xffffffffu);
}

// Append the lanes' survivors for query j (one atomicAdd a warp).  The
// count runs on past CAP; what does not fit is dropped, and the merge
// asks for a rescan of the tile.
__device__ __forceinline__ void append(const Smem& S, int j, bool pass,
                                       float s, int id) {
  const unsigned mask = __ballot_sync(FULL, pass);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&S.cnt[j], __popc(mask));
  base = __shfl_sync(FULL, base, leader);
  const int at = base + __popc(mask & ((1u << lane) - 1));
  if (pass && at < CAP) {
    S.bs[j * CAP + at] = s;
    S.bi[j * CAP + at] = id;
  }
}

// After a pass over a tile: if any thread kept a survivor, one warp per
// non-empty query merges its buffer into its list, then every query's
// threshold is renewed (its lane of the warp).  Returns, the same in
// every thread, whether a buffer overflowed: those queries (redo) rescan
// the tile against their new threshold.  Ends with the block synchronized.
__device__ __forceinline__ bool merge_tile(const Smem& S, int gq, int k,
                                           unsigned long long* gkey,
                                           bool any) {
  if (!__syncthreads_or(any)) return false;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool again = false;
  for (int j = warp; j < gq; j += WARPS) {
    const int n = S.cnt[j];
    again |= n > CAP;
    __syncwarp();
    if (lane == 0) {
      S.redo[j] = n > CAP;
      S.cnt[j] = 0;
    }
    for (int b = 0; b < min(n, CAP); b += 32) {
      const int e = b + lane;
      const bool v = e < min(n, CAP);
      merge_batch(S.ls + j * k, S.li + j * k, k, v ? S.bs[j * CAP + e] : 0.f,
                  v ? S.bi[j * CAP + e] : 0, v);
    }
  }
  __syncwarp();
  for (int j = warp + WARPS * lane; j < gq; j += WARPS * 32)
    set_threshold(S, j, k, gkey + j);
  return __syncthreads_or(again);
}

// Prefilter margin of query j: c_K ||q||, with c_K = (4K + 16) 2^-24.
// The fixed-order score s and an FMA evaluation a of the same dot differ
// by at most 2 gamma_K |q|.|z| <= 2 gamma_K ||q|| ||z|| (gamma_K = K u /
// (1 - K u), u = 2^-24), which c_K ||q||_f ||z||_f covers with room for
// the norms' own rounding; the norms are floored at 2^-60 so that
// underflow (at most K 2^-150 a dot) is covered too.
__device__ __forceinline__ float margin_factor(int K) {
  return (4.f * K + 16.f) * 5.9604645e-8f;
}

__device__ __forceinline__ float norm_floor(float ss) {
  return fmaxf(sqrtf(ss), 8.6736174e-19f);      // 2^-60
}

// q . z over exactly KR columns in common.cuh's order and rounding, q a
// query in shared memory, z a row in registers.
template <int KR>
__device__ __forceinline__ float exact_dot(const float4* qv,
                                           const float (&z)[KR]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < KR / 4; ++c) {
    const float4 v = qv[c];
    s = c == 0 ? __fmul_rn(v.x, z[0])
               : __fadd_rn(s, __fmul_rn(v.x, z[4 * c]));
    s = __fadd_rn(s, __fmul_rn(v.y, z[4 * c + 1]));
    s = __fadd_rn(s, __fmul_rn(v.z, z[4 * c + 2]));
    s = __fadd_rn(s, __fmul_rn(v.w, z[4 * c + 3]));
  }
  return s;
}

// One tile with the rows in registers: thread t holds rows r0 + r x
// THREADS + t, r < R, each exactly KR columns.  Each (row, query) first
// gets an FMA dot a (KR instructions); only if a + margin could reach the
// query's threshold is the exact fixed-order score s computed and held
// to the threshold under the full (score, id) order.
template <int KR>
__device__ __forceinline__ void tile_in_registers(
    const Smem& S, const float* __restrict__ Z, bool normalize,
    float* __restrict__ zn, int r0, int rows, int next_r0, int m, int gq,
    int k, int row_offset, float eps, bool seed,
    unsigned long long* __restrict__ gkey) {
  constexpr int R = 64 / KR;
  float z[R][KR];
  float nz[R];
  int gid[R];
  bool ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r * THREADS + threadIdx.x;
    ok[r] = row < rows;
    gid[r] = row_offset + r0 + row;
    const float4* src =
        reinterpret_cast<const float4*>(Z + (size_t)(r0 + row) * KR);
#pragma unroll
    for (int c = 0; c < KR / 4; ++c) {
      const float4 v = ok[r] ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f,
                                                            0.f);
      z[r][4 * c] = v.x;
      z[r][4 * c + 1] = v.y;
      z[r][4 * c + 2] = v.z;
      z[r][4 * c + 3] = v.w;
    }
  }
  // the next tile's rows into L2 while this one is scored
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = next_r0 + r * THREADS + threadIdx.x;
    if (row < m)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(Z + (size_t)row * KR));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (normalize) {
      float ss = __fmul_rn(z[r][0], z[r][0]);
#pragma unroll
      for (int c = 1; c < KR; ++c)
        ss = __fadd_rn(ss, __fmul_rn(z[r][c], z[r][c]));
      const float d = fmaxf(__fsqrt_rn(ss), eps);
#pragma unroll
      for (int c = 0; c < KR; ++c) z[r][c] = __fdiv_rn(z[r][c], d);
      if (zn != nullptr && ok[r]) {
        float4* dst = reinterpret_cast<float4*>(
            zn + (size_t)(r0 + r * THREADS + threadIdx.x) * KR);
#pragma unroll
        for (int c = 0; c < KR / 4; ++c)
          dst[c] = make_float4(z[r][4 * c], z[r][4 * c + 1], z[r][4 * c + 2],
                               z[r][4 * c + 3]);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < KR; ++c) ss = fmaf(z[r][c], z[r][c], ss);
    nz[r] = norm_floor(ss);
  }
  if (seed) {
    // The block's first tile: each warp seeds the lists of queries w, w +
    // WARPS, ... with the best of each lane's R rows, so that the tile's
    // first pass filters against a k-th best of those 32 rather than
    // (-inf, INT_MAX).  The pass offers these rows again; the merge skips
    // them as held.
    const int warp = threadIdx.x >> 5;
    for (int j = warp; j < gq; j += WARPS) {
      const float4* qv = reinterpret_cast<const float4*>(S.qs + j * KR);
      float bs = -CUDART_INF_F;
      int bi = INT_MAX;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sr = exact_dot<KR>(qv, z[r]);
        if (ok[r] && gid[r] != S.qid[j] && better(sr, gid[r], bs, bi)) {
          bs = sr;
          bi = gid[r];
        }
      }
      merge_batch(S.ls + j * k, S.li + j * k, k, bs, bi, bi != INT_MAX);
      if ((threadIdx.x & 31) == 0) set_threshold(S, j, k, gkey + j);
    }
    __syncthreads();
    // once more, now that the other blocks have seeded too
    for (int j = warp + WARPS * (threadIdx.x & 31); j < gq; j += WARPS * 32)
      set_threshold(S, j, k, gkey + j);
    __syncthreads();
  }
  for (bool first = true;; first = false) {
    bool any = false;
    for (int j = 0; j < gq; ++j) {
      if (!first && !S.redo[j]) continue;
      const float4* qv = reinterpret_cast<const float4*>(S.qs + j * KR);
      float a[R];
#pragma unroll
      for (int c = 0; c < KR / 4; ++c) {
        const float4 v = qv[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = c == 0 ? v.x * z[r][0] : fmaf(v.x, z[r][4 * c], a[r]);
          a[r] = fmaf(v.y, z[r][4 * c + 1], a[r]);
          a[r] = fmaf(v.z, z[r][4 * c + 2], a[r]);
          a[r] = fmaf(v.w, z[r][4 * c + 3], a[r]);
        }
      }
      const float ts = S.ts[j];
      const int ti = S.ti[j];
      const int self = S.qid[j];
      const float ce = S.qe[j];
      bool maybe[R];
      bool some = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // a + margin >= s, so a row whose a + margin is below the
        // threshold's score cannot beat it (NaN: not below, so kept)
        maybe[r] = ok[r] && gid[r] != self && !(fmaf(ce, nz[r], a[r]) < ts);
        some |= maybe[r];
      }
      if (!__any_sync(FULL, some)) continue;
      float s[R];
      bool pass[R];
      unsigned mask[R];
      int total = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = __any_sync(FULL, maybe[r]) ? exact_dot<KR>(qv, z[r]) : 0.f;
        pass[r] = maybe[r] && better(s[r], gid[r], ts, ti);
        mask[r] = __ballot_sync(FULL, pass[r]);
        total += __popc(mask[r]);
      }
      if (total == 0) continue;
      // the warp's survivors of all R rows, one atomicAdd
      const int lane = threadIdx.x & 31;
      int base = 0;
      if (lane == 0) base = atomicAdd(&S.cnt[j], total);
      base = __shfl_sync(FULL, base, 0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = base + __popc(mask[r] & ((1u << lane) - 1));
        if (pass[r] && at < CAP) {
          S.bs[j * CAP + at] = s[r];
          S.bi[j * CAP + at] = gid[r];
        }
        base += __popc(mask[r]);
      }
      any = true;
    }
    if (!merge_tile(S, gq, k, gkey, any)) break;
  }
}

// One tile with the rows staged in shared memory (any K): the threads
// take (row, query) pairs, consecutive threads consecutive rows of one
// query, and score each exactly.
__device__ __forceinline__ void tile_in_shared(
    const Smem& S, const float* __restrict__ Z, bool normalize,
    float* __restrict__ zn, int r0, int rows, int K, int gq, int k, int tile,
    int row_offset, float eps, unsigned long long* __restrict__ gkey) {
  const int KP = odd_stride(K);
  __syncthreads();                       // the last tile's rows are done
  const float* src = Z + (size_t)r0 * K;
  for (int e = threadIdx.x; e < rows * K; e += THREADS)
    S.zs[(e / K) * KP + e % K] = src[e];
  __syncthreads();
  if (normalize) {
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      float* zr = S.zs + r * KP;
      const float d = row_norm_denom(zr, K, eps);
      for (int c = 0; c < K; ++c) zr[c] = __fdiv_rn(zr[c], d);
    }
    __syncthreads();
    if (zn != nullptr) {
      float* dst = zn + (size_t)r0 * K;
      for (int e = threadIdx.x; e < rows * K; e += THREADS)
        dst[e] = S.zs[(e / K) * KP + e % K];
    }
  }
  for (bool first = true;; first = false) {
    bool any = false;
    const int pairs = gq * tile;
    for (int p0 = 0; p0 < pairs; p0 += THREADS) {
      const int p = p0 + threadIdx.x;
      const int j = min(p / tile, gq - 1), r = p % tile;
      bool pass = false;
      float s = 0.f;
      int id = 0;
      if (p < pairs && r < rows && (first || S.redo[j])) {
        s = row_dot(S.qs + j * K, S.zs + r * KP, K);
        id = row_offset + r0 + r;
        pass = id != S.qid[j] && better(s, id, S.ts[j], S.ti[j]);
      }
      // a warp's pairs belong to one query (tile is a multiple of 32)
      append(S, j, pass, s, id);
      any |= pass;
    }
    if (!merge_tile(S, gq, k, gkey, any)) break;
  }
}

// Select pass.  KR > 0: rows in registers, exactly KR columns; KR == 0:
// rows in shared memory.  Block (x, y) walks tiles [x nt / gx, (x + 1) nt
// / gx) for query group y and writes its lists to cand[(query, x, slot)].
template <int KR>
__global__ void __launch_bounds__(THREADS, 2)
    topk_select_kernel(const float* __restrict__ Z,
                       const float* __restrict__ q,
                       const int* __restrict__ qnodes,
                       float* __restrict__ zn, float* __restrict__ cand_s,
                       int* __restrict__ cand_i,
                       unsigned long long* __restrict__ gkey, int m, int K,
                       int nq, int k, int tile, int row_offset,
                       int exclude_self, float eps) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem S;
  carve(smem_raw, K, k, tile, KR == 0, &S);
  const int g0 = blockIdx.y * GROUP;
  const int gq = max(0, min(GROUP, nq - g0));
  for (int e = threadIdx.x; e < gq * K; e += THREADS)
    S.qs[e] = q[(size_t)g0 * K + e];
  for (int j = threadIdx.x; j < gq; j += THREADS) {
    S.qid[j] = exclude_self ? qnodes[g0 + j] : -1;
    const float* qj = q + (size_t)(g0 + j) * K;
    float ss = 0.f;
    for (int c = 0; c < K; ++c) ss = fmaf(qj[c], qj[c], ss);
    S.qe[j] = margin_factor(K) * norm_floor(ss);
    S.cnt[j] = 0;
    S.redo[j] = 0;
    S.ts[j] = -CUDART_INF_F;
    S.ti[j] = INT_MAX;
  }
  for (int e = threadIdx.x; e < gq * k; e += THREADS) {
    S.ls[e] = -CUDART_INF_F;
    S.li[e] = INT_MAX;
  }
  __syncthreads();
  // every group normalizes its rows; group 0 writes Zn
  const bool normalize = zn != nullptr;
  float* zout = blockIdx.y == 0 ? zn : nullptr;
  const int nt = (m + tile - 1) / tile;
  const int t0 = (int)((long long)blockIdx.x * nt / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * nt / gridDim.x);
  for (int t = t0; t < t1; ++t) {
    const int r0 = t * tile;
    const int rows = min(tile, m - r0);
    if constexpr (KR > 0)
      tile_in_registers<KR>(S, Z, normalize, zout, r0, rows,
                            t + 1 < t1 ? r0 + tile : m, m, gq, k,
                            row_offset, eps, t == t0, gkey + g0);
    else
      tile_in_shared(S, Z, normalize, zout, r0, rows, K, gq, k, tile,
                     row_offset, eps, gkey + g0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gq * k; e += THREADS) {
    const int j = e / k, slot = e % k;
    const size_t o = ((size_t)(g0 + j) * gridDim.x + blockIdx.x) * k + slot;
    cand_s[o] = S.ls[e];
    cand_i[o] = S.li[e];
  }
}

// Merge pass: block j selects query j's top-k from its nb x k candidates
// (contiguous): each warp a strided share into its own list, then warp 0
// merges the other warps' lists into its own.
__global__ void __launch_bounds__(THREADS)
    topk_merge_kernel(const float* __restrict__ cand_s,
                      const int* __restrict__ cand_i,
                      float* __restrict__ out_s, int* __restrict__ out_i,
                      int nb, int k) {
  __shared__ float ws[WARPS * KMAX];
  __shared__ int wi[WARPS * KMAX];
  const int j = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = nb * k;
  const float* cs = cand_s + (size_t)j * total;
  const int* ci = cand_i + (size_t)j * total;
  float* ls = ws + warp * k;
  int* li = wi + warp * k;
  for (int t = lane; t < k; t += 32) {
    ls[t] = -CUDART_INF_F;
    li[t] = INT_MAX;
  }
  __syncwarp();
  for (int b = warp * 32; b < total; b += THREADS) {
    const int e = b + lane;
    const bool v = e < total;
    merge_batch(ls, li, k, v ? cs[e] : 0.f, v ? ci[e] : 0, v);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int b = k; b < WARPS * k; b += 32) {
    const int e = b + lane;
    const bool v = e < WARPS * k;
    merge_batch(ls, li, k, v ? ws[e] : 0.f, v ? wi[e] : 0, v);
  }
  for (int t = lane; t < k; t += 32) {
    out_s[(size_t)j * k + t] = ls[t];
    out_i[(size_t)j * k + t] =
        li[t] == INT_MAX || !isfinite(ls[t]) ? -1 : li[t];
  }
}

// merge_batch for lists of any length k, in shared or device memory;
// called by a whole warp.  The list entries move down by the count of
// candidates better than them, 32 at a time from the end of the list, so
// that no entry is overwritten before it is read; then the candidates go
// to their ranks.  The same selection as merge_batch.
__device__ void merge_batch_any(float* ls, int* li, int k, float s, int i,
                                bool v) {
  const int lane = threadIdx.x & 31;
  v = v && better(s, i, ls[k - 1], li[k - 1]);
  if (!__any_sync(FULL, v)) return;
  int rank = 0;
  for (int t = 0; t < k; ++t) {
    const float es = ls[t];
    const int ei = li[t];
    rank += better(es, ei, s, i);
    v = v && ei != i;
  }
  const unsigned cand = __ballot_sync(FULL, v);
  for (int b = (k - 1) & ~31; b >= 0; b -= 32) {
    const int t = b + lane;
    const bool h = t < k;
    const float e = h ? ls[t] : 0.f;
    const int f = h ? li[t] : 0;
    int p = t;
    for (unsigned c = cand; c != 0; c &= c - 1) {
      const int src = __ffs(c) - 1;
      const float os = __shfl_sync(FULL, s, src);
      const int oi = __shfl_sync(FULL, i, src);
      p += better(os, oi, e, f);
    }
    __syncwarp();
    if (h && p < k) {
      ls[p] = e;
      li[p] = f;
    }
    __syncwarp();
  }
  for (unsigned c = cand; c != 0; c &= c - 1) {
    const int src = __ffs(c) - 1;
    const float os = __shfl_sync(FULL, s, src);
    const int oi = __shfl_sync(FULL, i, src);
    rank += better(os, oi, s, i);
  }
  if (v && rank < k) {
    ls[rank] = s;
    li[rank] = i;
  }
  __syncwarp();
}

// Zn = normalize_rows(Z), a thread a row (the general path's normalize).
__global__ void __launch_bounds__(THREADS)
    normalize_rows_kernel(const float* __restrict__ Z, float* __restrict__ zn,
                          int m, int K, float eps) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= m) return;
  const float* z = Z + (size_t)r * K;
  const float d = row_norm_denom(z, K, eps);
  float* o = zn + (size_t)r * K;
  for (int c = 0; c < K; ++c) o[c] = __fdiv_rn(z[c], d);
}

// General select pass: warp w of block (j, y) is selector y GEN_WARPS + w
// of query j, over rows [x m / nsel, (x + 1) m / nsel); its sorted list of
// k is its slot of cand, (query, selector, slot).
__global__ void __launch_bounds__(THREADS)
    topk_select_general_kernel(const float* __restrict__ Zn,
                               const float* __restrict__ q,
                               const int* __restrict__ qnodes,
                               float* cand_s, int* cand_i, int m, int K,
                               int k, int nsel, int row_offset,
                               int exclude_self) {
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.y * GEN_WARPS + (threadIdx.x >> 5);
  float* ls = cand_s + ((size_t)j * nsel + x) * k;
  int* li = cand_i + ((size_t)j * nsel + x) * k;
  for (int t = lane; t < k; t += 32) {
    ls[t] = -CUDART_INF_F;
    li[t] = INT_MAX;
  }
  __syncwarp();
  const int r_lo = (int)((long long)x * m / nsel);
  const int r_hi = (int)((long long)(x + 1) * m / nsel);
  const float* qj = q + (size_t)j * K;
  const int self = exclude_self ? qnodes[j] : -1;
  for (int b = r_lo; b < r_hi; b += 32) {
    const int r = b + lane;
    bool v = r < r_hi;
    float s = 0.f;
    int id = 0;
    if (v) {
      id = row_offset + r;
      s = row_dot(qj, Zn + (size_t)r * K, K);
      v = id != self;
    }
    merge_batch_any(ls, li, k, s, id, v);
  }
}

// General merge pass (k > KMAX): one warp per query, its list in out.
__global__ void __launch_bounds__(32)
    topk_merge_general_kernel(const float* __restrict__ cand_s,
                              const int* __restrict__ cand_i, float* out_s,
                              int* out_i, int nb, int k) {
  const int j = blockIdx.x, lane = threadIdx.x;
  const size_t total = (size_t)nb * k;
  const float* cs = cand_s + (size_t)j * total;
  const int* ci = cand_i + (size_t)j * total;
  float* ls = out_s + (size_t)j * k;
  int* li = out_i + (size_t)j * k;
  for (int t = lane; t < k; t += 32) {
    ls[t] = -CUDART_INF_F;
    li[t] = INT_MAX;
  }
  __syncwarp();
  for (size_t b = 0; b < total; b += 32) {
    const size_t e = b + lane;
    const bool v = e < total;
    merge_batch_any(ls, li, k, v ? cs[e] : 0.f, v ? ci[e] : 0, v);
  }
  for (int t = lane; t < k; t += 32)
    if (li[t] == INT_MAX || !isfinite(ls[t])) li[t] = -1;
}

// Rows wider than DELTA_SMEM_K: the block's rows are copied to Z_new, then
// each thread adds its row's run and takes its norm there, in the staged
// body's order.
__global__ void delta_renorm_wide_kernel(const float* __restrict__ Z,
                                         const int* __restrict__ rows,
                                         const int* __restrict__ cls,
                                         const float* __restrict__ val,
                                         int m, float* Znew,
                                         float* __restrict__ Zn, int n_local,
                                         int K, float eps) {
  __shared__ float dn[THREADS];
  const int r0 = blockIdx.x * THREADS;
  const int nr = min(THREADS, n_local - r0);
  const size_t tot = (size_t)nr * K;
  const float* src = Z + (size_t)r0 * K;
  float* o1 = Znew + (size_t)r0 * K;
  for (size_t e = threadIdx.x; e < tot; e += THREADS) o1[e] = src[e];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nr) {
    const int r = r0 + t;
    int lo = 0, hi = m;                  // first contribution with row >= r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rows[mid] < r) lo = mid + 1; else hi = mid;
    }
    float* z = o1 + (size_t)t * K;
    for (int j = lo; j < m && rows[j] == r; ++j)
      z[cls[j]] = __fadd_rn(z[cls[j]], val[j]);
    dn[t] = row_norm_denom(z, K, eps);
  }
  __syncthreads();
  float* o2 = Zn + (size_t)r0 * K;
  for (size_t e = threadIdx.x; e < tot; e += THREADS)
    o2[e] = __fdiv_rn(o1[e], dn[e / K]);
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

// How the select pass runs for (K, k, row alignment): which body, its
// tile, and its shared memory.
struct SelectPlan {
  const void* fn;
  int tile;
  size_t smem;
};

SelectPlan select_plan(const float* Z, int K, int k) {
  SelectPlan p;
  const bool vec = (reinterpret_cast<uintptr_t>(Z) & 15) == 0;
  bool smem_rows = false;
  if (vec && K == 8) {
    p.fn = (const void*)topk_select_kernel<8>;
  } else if (vec && K == 16) {
    p.fn = (const void*)topk_select_kernel<16>;
  } else if (vec && K == 32) {
    p.fn = (const void*)topk_select_kernel<32>;
  } else {
    p.fn = (const void*)topk_select_kernel<0>;
    smem_rows = true;
  }
  // register body: R = 64 / K rows a thread; shared body: about 32 KiB of
  // rows, 32 to 256 of them (a multiple of 32: a warp's pairs share a
  // query)
  p.tile = smem_rows ? max(32, min(THREADS, (8192 / K) / 32 * 32))
                     : THREADS * (64 / K);
  Smem unused;
  p.smem = carve(nullptr, K, k, p.tile, smem_rows, &unused);
  return p;
}

}  // namespace

// Candidate lists per query of the select pass for m rows, 0 for no rows;
// the wrapper sizes the candidate scratch (nq x grid x k) from it.  The
// bodies for k <= KMAX, K <= KSMEM_MAX: blocks along x, as many as fit on
// the card at once (occupancy API), at most one per tile.  The general
// path: selectors (warps), GEN_WARPS a block, about four blocks an SM in
// all over the nq queries, and at least 1,024 rows a block.
extern "C" int topk_select_grid(const float* Z, int m, int K, int k, int nq,
                                int* grid) {
  *grid = 0;
  if (m <= 0) return 0;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  if (general_path(K, k)) {
    const int want = (4 * sms + max(nq, 1) - 1) / max(nq, 1);
    const int most = (m + GEN_WARPS * 1024 - 1) / (GEN_WARPS * 1024);
    *grid = GEN_WARPS * max(1, min(want, min(most, 65535)));
    return 0;
  }
  const SelectPlan p = select_plan(Z, K, k);
  err = set_smem(p.fn, p.smem);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, p.fn, THREADS, p.smem);
  if (err) return err;
  const int tiles = (m + p.tile - 1) / p.tile;
  *grid = max(1, min(tiles, sms * max(per_sm, 1)));
  return 0;
}

// Select pass: every block's top-k per query into cand (nq x grid x k),
// and Zn when zn is not null.  gkey (nq, zeroed) carries the thresholds
// the blocks share.  Needs m > 0 and grid >= 1.
extern "C" int topk_select_launch(const float* Z, const float* q,
                                  const int* qnodes, float* zn,
                                  float* cand_s, int* cand_i,
                                  unsigned long long* gkey, int m, int K,
                                  int nq, int k, int grid, int row_offset,
                                  int exclude_self, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (general_path(K, k)) {
    if (zn != nullptr) {
      normalize_rows_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0, st>>>(
          Z, zn, m, K, eps);
      Z = zn;
    }
    if (nq > 0)
      topk_select_general_kernel<<<dim3(nq, grid / GEN_WARPS), THREADS, 0,
                                   st>>>(Z, q, qnodes, cand_s, cand_i, m, K,
                                         k, grid, row_offset, exclude_self);
    return (int)cudaGetLastError();
  }
  SelectPlan p = select_plan(Z, K, k);
  int err = set_smem(p.fn, p.smem);
  if (err) return err;
  const dim3 blocks(grid, max(1, (nq + GROUP - 1) / GROUP));
  void* args[] = {&Z,      &q,  &qnodes, &zn, &cand_s, &cand_i,
                  &gkey,   &m,  &K,      &nq, &k,      &p.tile,
                  &row_offset, &exclude_self, &eps};
  err = (int)cudaLaunchKernel(p.fn, blocks, dim3(THREADS), args, p.smem, st);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Merge pass: the top-k of each query's grid x k candidates into out
// (nq x k; unfilled slots -inf, -1).
extern "C" int topk_merge_launch(const float* cand_s, const int* cand_i,
                                 float* out_s, int* out_i, int grid, int nq,
                                 int k, void* stream) {
  if (nq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > KMAX)
    topk_merge_general_kernel<<<nq, 32, 0, st>>>(cand_s, cand_i, out_s,
                                                  out_i, grid, k);
  else
    topk_merge_kernel<<<nq, THREADS, 0, st>>>(cand_s, cand_i, out_s, out_i,
                                              grid, k);
  return (int)cudaGetLastError();
}

extern "C" int delta_renorm_launch(const float* Z, const int* rows,
                                   const int* cls, const float* val, int m,
                                   float* Znew, float* Zn, int n_local, int K,
                                   float eps, void* stream) {
  if (n_local == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K > DELTA_SMEM_K) {
    delta_renorm_wide_kernel<<<(n_local + THREADS - 1) / THREADS, THREADS, 0,
                               st>>>(Z, rows, cls, val, m, Znew, Zn, n_local,
                                     K, eps);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ((size_t)THREADS * odd_stride(K) +
                                       THREADS);
  int err = set_smem((const void*)delta_renorm_kernel, smem);
  if (err) return err;
  delta_renorm_kernel<<<(n_local + THREADS - 1) / THREADS, THREADS, smem,
                        st>>>(
      Z, rows, cls, val, m, Znew, Zn, n_local, K, eps);
  return (int)cudaGetLastError();
}
