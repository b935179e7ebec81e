// GEE edge scatter for Hopper: Z[r, c] = sum of val over the contributions
// of row r whose class is c.
//
// Replaces the TPU kernel repro/kernels/gee_scatter.py:gee_scatter_pallas
// (body _kernel, pallas_call at :95), which turns each uniform packed edge
// block into one-hot matrices R (rows) and C (class x value) and adds
// R^T C into a Z tile held in VMEM.  Nothing of that formulation is kept.
//
// Layout (repro_torch/kernels/ops.py:pack_edges): the contributions are
// sorted stably by destination row, with no padding and no gaps; row r's
// sit at [row_ptr[r], row_ptr[r + 1]) of `cls` and `val`, and tile t is
// rows [t tile_n, (t + 1) tile_n).  No buffer depends on the largest tile.
//
// What bounds it on the H100: bytes.  Each contribution is read once as 8
// bytes (class, value), each row offset once (8 bytes), and Z is written
// once; the arithmetic is one add per non-zero contribution.  At the main
// fit (138 M contributions, 4.85 M rows, K = 16) that is 1.45 GB, 0.43 ms
// at 3.35 TB/s.  What holds it back in practice is the work per
// contribution (finding its row, grouping equal keys, the chain of adds),
// so the design pays it only for contributions that add something and
// keeps enough warps resident to hide its latency:
//   * one block of 8 warps per tile.  The block holds a sub-tile of Z
//     (sub_rows x sub_cols, chosen by the wrapper so it fits in shared
//     memory: the whole tile at K = 16) and the sub-tile's row offsets in
//     shared memory.  A tile whose rows do not fit is processed in row
//     sub-ranges (each reads only its own rows' contributions), and a K
//     too wide for one row in column ranges, by the same block;
//   * the block splits the sub-range's rows among its warps so that each
//     warp's whole rows hold about the same number of contributions.  A
//     warp owns its rows: no two warps touch the same Z row, and no atomics
//     are needed;
//   * each warp streams its contiguous range of contributions through its
//     own ring of 2 shared-memory stages of 128 (one 16-byte cp.async per
//     lane for the classes and one for the values): the next stage is in
//     flight while the warp reduces the current one.  Two stages, not
//     more, leave room for 5 blocks (40 warps) a streaming multiprocessor,
//     8 KB in flight a block: deeper rings measured slower on the H100,
//     where the warps' latency, not the bytes in flight, held it back;
//   * a stage is walked 32 contributions at a time, one per lane, with
//     32-bit offsets inside the warp's range (a range longer than 2^30 is
//     walked in parts).  Lanes whose value is 0 (unlabelled donors: 90 %
//     at the main fit) or whose class lies outside the pass's columns sit
//     out.  A batch with more than 16 active lanes is reduced as it
//     stands; the active lanes of sparser batches are queued in shared
//     memory and reduced 32 at a time, so the work of a reduction is paid
//     once per 32 contributions that add something, not once per 32 read.
//     The queue is drained before a dense batch, so every contribution is
//     reduced in packed order;
//   * a reduction: each active lane finds its row from a window of 32 row
//     ends held one per lane (a 5-step shuffle search), equal (row, class)
//     keys are grouped with __match_any_sync, and each group's values are
//     added into the Z sub-tile in ascending lane order: by the group's
//     lowest lane with one load per member, or, where a batch with more
//     than 16 active lanes holds a group of more than 8 (a row whose donors
//     mostly share a class, as in a refine round), by every lane from the
//     batch's 32 values read into registers, so the chain of adds does not
//     wait on a load per member.  A long row is walked 32 wide like any
//     other; no run is walked by one thread;
//   * the sub-tile is written once with 16-byte coalesced stores (and
//     zeroed for the next pass).
// Deterministic: every (row, class) receives its values in packed order,
// one rounded add each, starting from +0.0: Z has the bits of a serial sum
// in packed order, whatever order the blocks run in.  Skipping a value of
// +-0.0, and adding +0.0 for a lane outside the group, change no bit,
// because a sum that starts at +0.0 is never -0.0 and z + 0 == z
// otherwise.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;
constexpr int STAGE = 128;            // contributions: 32 lanes x 16 bytes
constexpr unsigned FULL = 0xffffffffu;

struct Stage {
  int cls[STAGE];
  float val[STAGE];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lane's 16-byte vector `v` (elements [4v, 4v + 4)) of cls and val into a
// stage, if v < v1; bytes past S are zero-filled, never read.
__device__ __forceinline__ void issue(Stage* st, const int* cls,
                                      const float* val, long long v,
                                      long long v1, long long S, int lane) {
  if (v < v1) {
    const long long e = 4 * v;
    const int bytes = static_cast<int>(min(16LL, 4 * (S - e)));
    cp_async16(&st->cls[4 * lane], cls + e, bytes);
    cp_async16(&st->val[4 * lane], val + e, bytes);
  }
}

// Smallest r in [0, nr] with rp[r] >= target.
__device__ __forceinline__ int split_row(const long long* rp, int nr,
                                         long long target) {
  int lo = 0, hi = nr;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rp[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// z plus the values of the lanes in `grp` of a batch (v[l] is lane l's),
// one by one in lane order.
__device__ __forceinline__ float add_group(const float* v, unsigned grp,
                                           float z) {
  for (unsigned m = grp; m; m &= m - 1) z = __fadd_rn(z, v[__ffs(m) - 1]);
  return z;
}

// The same from the batch's 32 values read four at a time into registers
// (v 16-byte aligned): every lane folds its group's values in lane order
// and adds +0.0 for the other lanes, so the chain of adds does not wait on
// a load per member.
__device__ __forceinline__ float fold32(const float* v, unsigned grp,
                                       float z) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const float4 q = v4[i];
    const unsigned b = grp >> (4 * i);
    z = __fadd_rn(z, b & 1u ? q.x : 0.f);
    z = __fadd_rn(z, b & 2u ? q.y : 0.f);
    z = __fadd_rn(z, b & 4u ? q.z : 0.f);
    z = __fadd_rn(z, b & 8u ? q.w : 0.f);
  }
  return z;
}

// End of row r (local to the pass) relative to the warp's first
// contribution f0, for the row window; past the warp's rows, beyond any
// contribution of them.
__device__ __forceinline__ int row_end(const long long* rp, int r, int rb,
                                       long long f0, int n) {
  return r < rb ? static_cast<int>(min(max(rp[r + 1] - f0, -1LL),
                                       static_cast<long long>(n) + 64))
                : n + 64;
}

// The row window: lane i holds the end of row base + i (rows local to
// the pass, ends relative to the warp's first contribution f0).
struct Window {
  const long long* rp;
  int base, rb, n;
  long long f0;
  int end;

  __device__ __forceinline__ void load(int lane) {
    end = row_end(rp, base + lane, rb, f0, n);
  }
};

// One batch of up to 32 contributions into the Z sub-tile zt (row stride
// nc): lane l holds offset e (from f0, ascending over the active lanes),
// class c and whether it is active; v[l] is its value (v 16-byte
// aligned); am is the ballot of the active lanes.
__device__ __forceinline__ void reduce32(int e, int c, bool act,
                                         unsigned am, const float* v,
                                         Window& w, float* zt, int nc,
                                         int lane) {
  // row of each active lane: base + the number of window rows that end at
  // or before its contribution; slide the window by 32 rows while some
  // active lane lies past all of them
  int row = 0;
  unsigned need = am;
  while (true) {
    int cnt = 0;
#pragma unroll
    for (int step = 16; step; step >>= 1)
      if (__shfl_sync(FULL, w.end, cnt + step - 1) <= e) cnt += step;
    if (__shfl_sync(FULL, w.end, 31) <= e) cnt = 32;
    const bool mine = (need >> lane) & 1u;
    if (mine && cnt < 32) row = w.base + cnt;
    need = __ballot_sync(FULL, mine && cnt == 32);
    if (need == 0) break;
    w.base += 32;
    w.load(lane);
  }
  const int key = row * nc + c;
  if (__popc(am) <= 16) {
    // few active lanes: small groups, each leader adds its members'
    // values one by one in lane order
    if (act) {
      const unsigned grp = __match_any_sync(am, key);
      if (lane == __ffs(grp) - 1) zt[key] = add_group(v, grp, zt[key]);
    }
  } else {
    const unsigned grp = act ? __match_any_sync(am, key) : 0u;
    const bool lead = act && lane == __ffs(grp) - 1;
    if (__reduce_max_sync(FULL, __popc(grp)) <= 8) {
      if (lead) zt[key] = add_group(v, grp, zt[key]);
    } else {
      // large groups (a row whose donors mostly share one class)
      const float z = fold32(v, grp, lead ? zt[key] : 0.f);
      if (lead) zt[key] = z;
    }
  }
  __syncwarp();
}

// A warp's queue of sparse batches' active contributions, in order.
struct Queue {
  int e[64];
  int c[64];
  float x[64];
};

// The queue's first k entries as one batch, then the rest moved to the
// front; returns how many are left.
__device__ __forceinline__ int drain(Queue* q, int k, int qn, Window& w,
                                     float* zt, int nc, int lane) {
  __syncwarp();
  const bool act = lane < k;
  reduce32(q->e[lane], q->c[lane], act, __ballot_sync(FULL, act), q->x, w,
           zt, nc, lane);
  const int left = qn - k;
  if (lane < left) {
    const int e = q->e[k + lane], c = q->c[k + lane];
    const float x = q->x[k + lane];
    q->e[lane] = e;
    q->c[lane] = c;
    q->x[lane] = x;
  }
  __syncwarp();
  return left;
}

// A warp adds contributions [w.f0, w.f0 + w.n) (fewer than 2^31, of rows
// [w.base, w.rb) local to the pass) into the Z sub-tile zt (row stride
// nc, classes [c0, c0 + nc)).  A batch with more than 16 active lanes is
// reduced as it stands; the active lanes of sparser batches (unlabelled
// donors sit out) are queued and reduced 32 at a time.  Either way every
// contribution is reduced in packed order: the queue is drained before a
// dense batch.
__device__ void walk(Window& w, const int* cls, const float* val,
                     long long S, float* zt, int c0, int nc, Stage* ring,
                     Queue* q, int lane) {
  const int n = w.n;
  const long long v0 = w.f0 >> 2, v1 = (w.f0 + n + 3) >> 2;
  const int pre = static_cast<int>(w.f0 & 3);   // staged before f0
  const int nst = static_cast<int>((v1 - v0 + 31) >> 5);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue(ring + s, cls, val, v0 + 32LL * s + lane, v1, S, lane);
    cp_async_commit();
  }
  w.load(lane);
  int qn = 0;                      // queued entries
  for (int s = 0; s < nst; ++s) {
    issue(ring + (s + STAGES - 1) % STAGES, cls, val,
          v0 + 32LL * (s + STAGES - 1) + lane, v1, S, lane);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const Stage* st = ring + s % STAGES;
#pragma unroll
    for (int j = 0; j < STAGE / 32; ++j) {
      const int e0 = STAGE * s + 32 * j - pre;   // lane 0's, from f0
      if (e0 >= n) break;
      if (e0 + 32 <= 0) continue;
      const int e = e0 + lane;
      const float x = st->val[32 * j + lane];
      const int c = st->cls[32 * j + lane] - c0;
      const bool act = e >= 0 && e < n && x != 0.f &&
                       static_cast<unsigned>(c) < static_cast<unsigned>(nc);
      const unsigned am = __ballot_sync(FULL, act);
      if (am == 0) continue;
      if (__popc(am) > 16) {
        if (qn) qn = drain(q, qn, qn, w, zt, nc, lane);
        reduce32(e, c, act, am, st->val + 32 * j, w, zt, nc, lane);
      } else {
        if (act) {
          const int at = qn + __popc(am & ((1u << lane) - 1u));
          q->e[at] = e;
          q->c[at] = c;
          q->x[at] = x;
        }
        qn += __popc(am);
        if (qn >= 32) qn = drain(q, 32, qn, w, zt, nc, lane);
      }
    }
    __syncwarp();
  }
  if (qn) drain(q, qn, qn, w, zt, nc, lane);
  cp_async_wait<0>();
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
gee_scatter_kernel(const long long* __restrict__ row_ptr,
                   const int* __restrict__ cls,
                   const float* __restrict__ val, float* __restrict__ Z,
                   long long S, int tile_n, int kdim, int sub_rows,
                   int sub_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Stage* ring = reinterpret_cast<Stage*>(smem) + warp * STAGES;
  Queue* q = reinterpret_cast<Queue*>(
      reinterpret_cast<Stage*>(smem) + WARPS * STAGES) + warp;
  const int zn = sub_rows * sub_cols;
  float* zt = reinterpret_cast<float*>(
      reinterpret_cast<Queue*>(
          reinterpret_cast<Stage*>(smem) + WARPS * STAGES) + WARPS);
  long long* rp = reinterpret_cast<long long*>(zt + ((zn + 3) & ~3));
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_n;

  for (int i = threadIdx.x; i < zn; i += THREADS) zt[i] = 0.f;
  for (int r0 = 0; r0 < tile_n; r0 += sub_rows) {
    const int nr = min(sub_rows, tile_n - r0);
    for (int c0 = 0; c0 < kdim; c0 += sub_cols) {
      const int nc = min(sub_cols, kdim - c0);
      __syncthreads();        // zt zeroed, rp of the last pass read
      for (int i = threadIdx.x; i <= nr; i += THREADS)
        rp[i] = min(max(row_ptr[row0 + r0 + i], 0LL), S);
      __syncthreads();
      const long long p0 = rp[0], span = rp[nr] - p0;
      const int ra = split_row(rp, nr, p0 + span * warp / WARPS);
      const int rb = warp + 1 == WARPS
                         ? nr
                         : split_row(rp, nr, p0 + span * (warp + 1) / WARPS);
      // offsets inside a walk are 32-bit: a range longer than 2^30 (one
      // huge row) is walked in parts, the row window carried across
      Window w{rp, ra, rb, 0, 0, 0};
      for (w.f0 = rp[ra]; w.f0 < rp[rb]; w.f0 += 1LL << 30) {
        w.n = static_cast<int>(min(rp[rb] - w.f0, 1LL << 30));
        walk(w, cls, val, S, zt, c0, nc, ring, q, lane);
      }
      __syncthreads();
      // write the sub-tile once, and leave it zeroed for the next pass
      float* out = Z + (row0 + r0) * kdim + c0;
      const int m = nr * nc;
      if (nc == kdim && (m & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        float4* o4 = reinterpret_cast<float4*>(out);
        float4* z4 = reinterpret_cast<float4*>(zt);
        for (int i = threadIdx.x; i < m / 4; i += THREADS) {
          o4[i] = z4[i];
          z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int i = threadIdx.x; i < m; i += THREADS) {
          out[static_cast<long long>(i / nc) * kdim + i % nc] = zt[i];
          zt[i] = 0.f;
        }
      }
    }
  }
}

}  // namespace

extern "C" int gee_scatter_launch(const long long* row_ptr, const int* cls,
                                  const float* val, float* Z,
                                  int num_tiles, int tile_n, int kdim,
                                  int sub_rows, int sub_cols, long long S,
                                  void* stream) {
  const int zn = sub_rows * sub_cols;
  const int smem =
      static_cast<int>(sizeof(Stage) * STAGES + sizeof(Queue)) * WARPS +
      4 * ((zn + 3) & ~3) + 8 * (sub_rows + 1);
  cudaError_t err = cudaFuncSetAttribute(
      gee_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gee_scatter_kernel<<<num_tiles, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      row_ptr, cls, val, Z, S, tile_n, kdim, sub_rows, sub_cols);
  return (int)cudaGetLastError();
}
