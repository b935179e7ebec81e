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
//   Long lists and wide rows: the bodies above take any k up to
//   KLIST_MAX = 4096.  For k > 64 (the long-list bodies) the lists are
//   merged by merge_batch_long (a binary search gives each candidate its
//   rank, the entries move down in 32-wide chunks), each query keeps
//   cap = 2k survivor slots (at least 32), and the group shrinks from 64
//   queries (64, 32, ..., 1; never more than nq needs) until its lists,
//   buffers and rows fit in a block's shared memory, and once more where
//   that lets two blocks share an SM.  Rows wider than 256
//   take the chunked body (topk_select_chunked_kernel): the tile streams
//   through a ring of chunk slots in column chunks, rows and the group's
//   queries together (cp.async), and each thread carries its (row, query)
//   sums in registers across the chunks in column order, so every score
//   is row_dot's; the scores stay in registers for the filter and any
//   rescan, each tile's filter reads the threshold the grid has
//   published (gkey) besides the block's own, and survivors wait in the
//   buffers across tiles until one holds a warp's batch.  It scores every (row,
//   query) exactly: 2 nq m K FP32 instructions against m K 4 bytes of
//   rows read once per group.  (Two FMA prefilters with an exact rescore
//   from device memory, one with thresholds seeded from a sample of the
//   rows, measured slower: the rescores cost more than the FFMA saves.)
//   With normalize=True a first pass over the tile's chunks takes the row
//   norms, the second divides each element as it lands (no separate
//   kernel) and group 0 writes Zn.  The
//   merge of k > 64 lists is one block per query over the grid x k
//   candidates, the list in shared memory, 256 candidates placed by rank a
//   batch (topk_merge_long_kernel).  Lists longer than KLIST_MAX do not
//   fit in shared memory at one query a block: they take the general
//   path, chosen by k alone (general_path): every warp is a selector of
//   its own for one query over a contiguous range of rows, a lane per row,
//   scoring exactly from device memory (row_dot) and keeping its sorted
//   list in device memory (merge_batch_any), rows normalized first by a
//   kernel of their own, and one warp per query merges.
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
// (body _delta_kernel, pallas_call at :187): Z_new = Z + delta
// contributions, Zn = normalize_rows(Z_new), for the whole owned slice.
//   Bound on the H100: bytes, 3 x n_local x K x 4 (read Z, write Z_new and
//   Zn once) plus 12 m for the delta; 0.1389 ms at the main shape
//   (n_local = 2,423,786, K = 16).  A few instructions an element, so the
//   design is about keeping bytes in flight and every pass over shared
//   memory free of bank conflicts.
//   Design (delta_renorm_kernel, one body for every K): persistent blocks
//   (two an SM where the occupancy allows) walk tiles of R whole rows with
//   a static stride.  R is a multiple of 4 from K so that
//   a tile is about DELTA_TILE_FLOATS floats (16 KB; 4 rows at least,
//   fewer only where 4 do not fit), so a tile of Z is one contiguous span:
//   one 1-D bulk copy
//   (cp.async.bulk, completing on an mbarrier, no tensor map) brings it
//   into a ring of DELTA_STAGES stages, issued ahead by a producer warp.
//   Bulk copies and not 16-byte cp.async into a padded pitch: the copy
//   costs the threads nothing, takes any K (cp.async.16 needs K % 4 == 0),
//   and the stage it fills, at pitch K, is also the source of Z_new's bulk
//   store.  The producer finds each tile's range
//   [lo, hi) of the sorted delta list first (one warp: one coalesced read
//   of the 32 entries after the block's previous tile holds both ends for
//   most tiles; a 32-way search takes the rest), before the tile's copy,
//   so the range rides the full barrier's release.  The consumers
//   (DELTA_CONSUMERS threads) add each row's run in list order into the
//   staged rows (one thread a run, only on tiles whose range is not
//   empty), square every element once
//   (__fmul_rn) into a scratch of rows at a padded pitch KP >= K with
//   KP % 8 == 4, from which one thread a row takes its norm chain in
//   column order with 16-byte reads (KP / 4 odd: the 8 rows of a
//   quarter-warp hit 8 distinct 16-byte bank groups), then divide
//   (__fdiv_rn) and write Zn with 16-byte stores.  Z_new leaves the stage
//   by a bulk store (cp.async.bulk.global.shared::cta) as soon as the
//   consumers have added the tile's runs (an `added` mbarrier, before their
//   norms).  They hold their values in registers from the squares to Zn
//   (DELTA_GROUPS 16-byte groups a thread) and let the stage go after the
//   squares, so a stage is held for its copy and one pass, not for the
//   norms; it is loaded again once cp.async.bulk.wait_group.read says the
//   store has read it.
//   A row too wide for three stages (about 14,000 floats) streams through
//   the same ring in chunks of DELTA_CHUNK columns, twice: the first pass
//   adds the chunk's share of the row's run, bulk-stores Z_new and carries
//   the norm chain from chunk to chunk in column order; the second copies
//   the chunks again, adds the same entries in the same order (the same
//   bits) and divides by the finished norm.  Such rows pay one more read
//   of Z, and any K runs.
//   Stage reads are 16-byte and contiguous, dn reads at most 32
//   consecutive rows an instruction (16-byte pairs for K < 4): no read
//   conflicts at any K.  Z starts on 16 bytes (the wrapper copies a view
//   that does not), so a tile's 16-byte groups are Z's: the copy takes the
//   aligned span around the tile, the bulk store its whole groups, and
//   the consumers write the partial groups at its two ends.
//   Exact: the adds, the chain and the division are the plain version's
//   operations in its order, so Z_new and Zn have its bits at every K,
//   grid and ring depth.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int KMAX = 64;       // longest list of the short-list merge
constexpr int KLIST_MAX = 4096;  // longest list kept in shared memory
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 64;      // most queries per group (blockIdx.y)
constexpr int CAP = 2 * KMAX;  // survivor slots per query and pass, k <= KMAX
constexpr int CAP_MIN = 32;    // least survivor slots of the long-list bodies
constexpr int KSMEM_MAX = 256; // widest rows of the shared-memory body
constexpr int CQ = 8;          // chunked body: most queries a thread
constexpr int RC = 4;          // chunked body: rows a thread
constexpr int CHUNK_FLOATS = 4096;  // chunked body: floats of a row chunk
constexpr int KCH_MIN = 4, KCH_MAX = 32;  // chunked body: columns a chunk
constexpr int MERGE_AT = 32;   // chunked body: survivors that start a merge
constexpr int RING = 3;        // chunked body: chunk slots in flight
constexpr int GEN_WARPS = THREADS / 32;  // selectors a block, general path
constexpr int DELTA_CONSUMERS = 256;   // delta: consumer threads a block
constexpr int DELTA_THREADS = DELTA_CONSUMERS + 32;  // + the producer warp
constexpr int DELTA_TILE_FLOATS = 4096;  // delta: floats of rows a tile
// delta: a consumer's 16-byte groups of a tile of DELTA_TILE_FLOATS, held
// in registers from the squares to Zn
constexpr int DELTA_GROUPS = DELTA_TILE_FLOATS / (4 * DELTA_CONSUMERS);
constexpr int DELTA_STAGES = 4;        // delta: ring depth (3 if 4 do not fit)
constexpr int DELTA_MIN_STAGES = 3;    // delta: the least ring depth
constexpr int DELTA_BLOCKS_PER_SM = 2; // delta: most blocks an SM
// delta: columns a chunk of a row too wide for three stages (a multiple
// of 4 that a thread's DELTA_GROUPS groups hold at any offset)
constexpr int DELTA_CHUNK = 4092;
static_assert(DELTA_CHUNK % 4 == 0 &&
                  DELTA_CHUNK + 3 <= 4 * DELTA_GROUPS * DELTA_CONSUMERS,
              "a chunk's groups must fit a thread's registers");
constexpr unsigned FULL = 0xffffffffu;

// The select bodies: rows in registers (K in {8, 16, 32}, rows on 16
// bytes), rows in shared memory (other K <= KSMEM_MAX), rows streamed in
// column chunks (K > KSMEM_MAX), each for any k <= KLIST_MAX; the general
// path takes the lists too long for shared memory.
enum Body { BODY_REGISTERS = 0, BODY_SHARED = 1, BODY_CHUNKED = 2,
            BODY_GENERAL = 3 };

__host__ __device__ __forceinline__ bool general_path(int k) {
  return k > KLIST_MAX;
}

// The chunked body's geometry for a group of G queries (a power of two):
// each thread scores q queries x RC rows, wq warps side by side across
// the group, the other warps stacked along the rows; a tile is `tile`
// rows, streamed in chunks of kch columns.
struct Chunking {
  int q, wq, tile, kch;
};

__host__ __device__ __forceinline__ Chunking chunking(int G) {
  Chunking c;
  c.q = G < CQ ? G : CQ;
  c.wq = G / c.q;
  c.tile = 32 * RC * (WARPS / c.wq);
  const int w = CHUNK_FLOATS / c.tile;
  c.kch = w < KCH_MIN ? KCH_MIN : w > KCH_MAX ? KCH_MAX : w;
  return c;
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

// merge_batch for lists of any length k (the long-list bodies); called by
// a whole warp, the list in shared memory.  A candidate's rank in the list
// comes from a binary search (the list is sorted under the total order);
// a row held already sits at that rank and drops out.  Its new slot is
// its rank plus the other candidates better than it; a list entry moves
// down by the candidates whose rank is at most its slot.  Entries before
// the least rank stay; the others move 32 at a time from the end of the
// list, each chunk read whole before any of it is written, so that no
// entry is overwritten before it is read.  The same selection as
// merge_batch.
__device__ __forceinline__ void merge_batch_long(float* ls, int* li, int k,
                                                 float s, int i, bool v) {
  const int lane = threadIdx.x & 31;
  v = v && better(s, i, ls[k - 1], li[k - 1]);
  if (!__any_sync(FULL, v)) return;
  int rank = 0;                         // entries better than (s, i)
  for (int step = 1 << (31 - __clz(k)); step > 0; step >>= 1)
    if (rank + step <= k &&
        better(ls[rank + step - 1], li[rank + step - 1], s, i))
      rank += step;
  v = v && !(rank < k && li[rank] == i);
  const unsigned cand = __ballot_sync(FULL, v);
  if (cand == 0) return;
  int slot = rank;
  for (unsigned c = cand; c != 0; c &= c - 1) {
    const int src = __ffs(c) - 1;
    slot += better(__shfl_sync(FULL, s, src), __shfl_sync(FULL, i, src), s,
                   i);
  }
  const int lo = __reduce_min_sync(FULL, v ? rank : k);
  for (int b = (k - 1) & ~31; b >= (lo & ~31); b -= 32) {
    const int t = b + lane;
    const bool h = t >= lo && t < k;
    const float e = h ? ls[t] : 0.f;
    const int f = h ? li[t] : 0;
    int p = t;
    for (unsigned c = cand; c != 0; c &= c - 1)
      p += __shfl_sync(FULL, rank, __ffs(c) - 1) <= t;
    __syncwarp();
    if (h && p < k) {
      ls[p] = e;
      li[p] = f;
    }
    __syncwarp();
  }
  if (v && slot < k) {
    ls[slot] = s;
    li[slot] = i;
  }
  __syncwarp();
}

template <bool LONG>
__device__ __forceinline__ void merge_into(float* ls, int* li, int k, float s,
                                           int i, bool v) {
  if constexpr (LONG)
    merge_batch_long(ls, li, k, s, i, v);
  else
    merge_batch(ls, li, k, s, i, v);
}

// The select pass's shared memory for a group of G queries, carved in
// this order (16-byte aligned pieces): the group's queries (G x K; not
// for the chunked body, which streams them with the rows), their own ids
// (-1 when exclude_self is off), their prefilter margins, their
// thresholds (scores, then ids), the lists (G x k scores, then ids), the
// survivor counts and rescan flags (G each), the survivor buffers (G x cap
// scores, then ids); then for the shared-memory body the row tile (tile x
// odd_stride(K)), for the chunked body the tile's row norms (tile) and
// the ring of RING chunk slots (chunk_slot floats each).
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
  float* dn;
  float* ring;
};

// A chunk slot of the chunked body: the rows' kch columns, row-major in
// rows of kch + 4 floats or column-major in columns of tile + 1 floats
// (the larger of the two is the first), then the group's queries' kch
// columns, row-major.
__host__ __device__ __forceinline__ int chunk_slot(const Chunking& c, int G) {
  return c.tile * (c.kch + 4) + G * c.kch;
}

__host__ __device__ __forceinline__ void take(char* base, size_t& off,
                                              size_t bytes, void** out) {
  if (base != nullptr) *out = base + off;
  off += (bytes + 15) & ~static_cast<size_t>(15);
}

// Carve `base` (nullptr: only size it); returns the bytes used.
__host__ __device__ __forceinline__ size_t carve(char* base, int body, int K,
                                                 int k, int G, int cap,
                                                 int tile, Smem* s) {
  size_t off = 0;
  void* p[14] = {};
  if (body != BODY_CHUNKED) take(base, off, sizeof(float) * G * K, &p[0]);
  take(base, off, sizeof(int) * G, &p[1]);
  take(base, off, sizeof(float) * G, &p[2]);
  take(base, off, sizeof(float) * G, &p[3]);
  take(base, off, sizeof(int) * G, &p[4]);
  take(base, off, sizeof(float) * G * k, &p[5]);
  take(base, off, sizeof(int) * G * k, &p[6]);
  take(base, off, sizeof(int) * G, &p[7]);
  take(base, off, sizeof(int) * G, &p[8]);
  take(base, off, sizeof(float) * G * cap, &p[9]);
  take(base, off, sizeof(int) * G * cap, &p[10]);
  if (body == BODY_SHARED)
    take(base, off, sizeof(float) * tile * odd_stride(K), &p[11]);
  if (body == BODY_CHUNKED) {
    take(base, off, sizeof(float) * tile, &p[12]);
    take(base, off, sizeof(float) * RING * chunk_slot(chunking(G), G),
         &p[13]);
  }
  *s = Smem{static_cast<float*>(p[0]),  static_cast<int*>(p[1]),
            static_cast<float*>(p[2]),  static_cast<float*>(p[3]),
            static_cast<int*>(p[4]),    static_cast<float*>(p[5]),
            static_cast<int*>(p[6]),    static_cast<int*>(p[7]),
            static_cast<int*>(p[8]),    static_cast<float*>(p[9]),
            static_cast<int*>(p[10]),   static_cast<float*>(p[11]),
            static_cast<float*>(p[12]), static_cast<float*>(p[13])};
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
// count runs on past cap; what does not fit is dropped, and the merge
// asks for a rescan of the tile.
__device__ __forceinline__ void append(const Smem& S, int j, bool pass,
                                       float s, int id, int cap) {
  const unsigned mask = __ballot_sync(FULL, pass);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&S.cnt[j], __popc(mask));
  base = __shfl_sync(FULL, base, leader);
  const int at = base + __popc(mask & ((1u << lane) - 1));
  if (pass && at < cap) {
    S.bs[j * cap + at] = s;
    S.bi[j * cap + at] = id;
  }
}

// After a pass over a tile: if any thread kept a survivor, one warp per
// non-empty query merges its buffer into its list, then every query's
// threshold is renewed (its lane of the warp).  Returns, the same in
// every thread, whether a buffer overflowed: those queries (redo) rescan
// the tile against their new threshold.  Ends with the block synchronized.
// `reset` (a flag every thread has read before the call) is zeroed once
// all have.
template <bool LONG>
__device__ __forceinline__ bool merge_tile(const Smem& S, int gq, int k,
                                           unsigned long long* gkey,
                                           bool any, int cap,
                                           int* reset = nullptr) {
  if (!__syncthreads_or(any)) return false;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (reset != nullptr && threadIdx.x == 0) *reset = 0;  // read by all
  bool again = false;
  for (int j = warp; j < gq; j += WARPS) {
    const int n = S.cnt[j];
    again |= n > cap;
    __syncwarp();
    if (lane == 0) {
      S.redo[j] = n > cap;
      S.cnt[j] = 0;
    }
    for (int b = 0; b < min(n, cap); b += 32) {
      const int e = b + lane;
      const bool v = e < min(n, cap);
      merge_into<LONG>(S.ls + j * k, S.li + j * k, k,
                       v ? S.bs[j * cap + e] : 0.f,
                       v ? S.bi[j * cap + e] : 0, v);
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
template <int KR, bool LONG>
__device__ __forceinline__ void tile_in_registers(
    const Smem& S, const float* __restrict__ Z, bool normalize,
    float* __restrict__ zn, int r0, int rows, int next_r0, int m, int gq,
    int k, int cap, int row_offset, float eps, bool seed,
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
      merge_into<LONG>(S.ls + j * k, S.li + j * k, k, bs, bi, bi != INT_MAX);
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
        if (pass[r] && at < cap) {
          S.bs[j * cap + at] = s[r];
          S.bi[j * cap + at] = gid[r];
        }
        base += __popc(mask[r]);
      }
      any = true;
    }
    if (!merge_tile<LONG>(S, gq, k, gkey, any, cap)) break;
  }
}

// One tile with the rows staged in shared memory (any K): the threads
// take (row, query) pairs, consecutive threads consecutive rows of one
// query, and score each exactly.
template <bool LONG>
__device__ __forceinline__ void tile_in_shared(
    const Smem& S, const float* __restrict__ Z, bool normalize,
    float* __restrict__ zn, int r0, int rows, int K, int gq, int k, int cap,
    int tile, int row_offset, float eps,
    unsigned long long* __restrict__ gkey) {
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
      append(S, j, pass, s, id, cap);
      any |= pass;
    }
    if (!merge_tile<LONG>(S, gq, k, gkey, any, cap)) break;
  }
}

// A block's set-up for query group g0 (gq queries): ids, thresholds,
// survivor counts, empty lists, and for the register and shared bodies
// the queries and their prefilter margins.  Ends with the block
// synchronized.
__device__ __forceinline__ void init_group(const Smem& S,
                                           const float* __restrict__ q,
                                           const int* __restrict__ qnodes,
                                           int g0, int gq, int K, int k,
                                           int exclude_self, bool stage_q) {
  if (stage_q)
    for (int e = threadIdx.x; e < gq * K; e += THREADS)
      S.qs[e] = q[(size_t)g0 * K + e];
  for (int j = threadIdx.x; j < gq; j += THREADS) {
    S.qid[j] = exclude_self ? qnodes[g0 + j] : -1;
    if (stage_q) {
      const float* qj = q + (size_t)(g0 + j) * K;
      float ss = 0.f;
      for (int c = 0; c < K; ++c) ss = fmaf(qj[c], qj[c], ss);
      S.qe[j] = margin_factor(K) * norm_floor(ss);
    }
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
}

// The block's lists to cand[(query, blockIdx.x, slot)].
__device__ __forceinline__ void write_lists(const Smem& S, int g0, int gq,
                                            int k, float* __restrict__ cand_s,
                                            int* __restrict__ cand_i) {
  __syncthreads();
  for (int e = threadIdx.x; e < gq * k; e += THREADS) {
    const int j = e / k, slot = e % k;
    const size_t o = ((size_t)(g0 + j) * gridDim.x + blockIdx.x) * k + slot;
    cand_s[o] = S.ls[e];
    cand_i[o] = S.li[e];
  }
}

// Select pass.  KR > 0: rows in registers, exactly KR columns; KR == 0:
// rows in shared memory.  LONG: lists of any k <= KLIST_MAX (merged by
// merge_batch_long), G queries a group and cap survivor slots; else
// k <= KMAX, GROUP and CAP.  Block (x, y) walks tiles [x nt / gx, (x + 1)
// nt / gx) for query group y and writes its lists to cand[(query, x,
// slot)].
template <int KR, bool LONG>
__global__ void __launch_bounds__(THREADS, 2)
    topk_select_kernel(const float* __restrict__ Z,
                       const float* __restrict__ q,
                       const int* __restrict__ qnodes,
                       float* __restrict__ zn, float* __restrict__ cand_s,
                       int* __restrict__ cand_i,
                       unsigned long long* __restrict__ gkey, int m, int K,
                       int nq, int k, int tile, int row_offset,
                       int exclude_self, float eps, int G, int cap) {
  extern __shared__ __align__(16) char smem_raw[];
  if constexpr (!LONG) {
    G = GROUP;
    cap = CAP;
  }
  Smem S;
  carve(smem_raw, KR > 0 ? BODY_REGISTERS : BODY_SHARED, K, k, G, cap, tile,
        &S);
  const int g0 = blockIdx.y * G;
  const int gq = max(0, min(G, nq - g0));
  init_group(S, q, qnodes, g0, gq, K, k, exclude_self, true);
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
      tile_in_registers<KR, LONG>(S, Z, normalize, zout, r0, rows,
                                  t + 1 < t1 ? r0 + tile : m, m, gq, k, cap,
                                  row_offset, eps, t == t0, gkey + g0);
    else
      tile_in_shared<LONG>(S, Z, normalize, zout, r0, rows, K, gq, k, cap,
                           tile, row_offset, eps, gkey + g0);
  }
  write_lists(S, g0, gq, k, cand_s, cand_i);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Where the chunked body's stages stand: tile t, pass (0: the row norms,
// only with normalize; 1: the scores), chunk c of the pass.
struct Stage {
  int t, pass, c;
  __device__ __forceinline__ void next(int nc, bool normalize) {
    if (++c < nc) return;
    c = 0;
    if (normalize && pass == 0) {
      pass = 1;
      return;
    }
    pass = normalize ? 0 : 1;
    ++t;
  }
};

// Select pass for rows wider than KSMEM_MAX (any K), the chunked body: the
// block's tiles stream through a ring of RING chunk slots, each chunk
// kch columns of the tile's rows and of the group's queries (cp.async: 16
// bytes at a time when K % 4 == 0 and the rows and queries start on 16
// bytes (VEC), the rows then row-major in the slot with rows of kch + 4
// floats, so that 8 lanes reading 8 rows' 16 bytes hit 32 banks; else 4
// bytes at a time, any K and alignment, the rows column-major with a
// stride of tile + 1).  A stage is one chunk; with normalize=True each
// tile takes two passes over its chunks, the first for its row norms (in
// common.cuh's order), the second divides each element by its row's norm
// as it lands (group 0 writes Zn) and scores.  Thread (warp, lane) scores
// queries qbase .. qbase + Q - 1 against rows rbase + lane + 32 r (r <
// RC), each sum carried in a register across the chunks in column order
// from -0.0 (which adds to the first product without changing its bits),
// so the score is row_dot's: every (row, query) is scored exactly.  A
// block's first tile seeds the lists, as the register body does.  After
// each tile's last chunk the scores are filtered against each query's
// threshold, the better of the block's own and the one the grid has
// published (gkey, read as the last chunk began); survivors wait in the
// buffers until one holds MERGE_AT (or overflowed), are merged as in the
// other bodies, and an overflowed buffer rescans the tile's scores still
// in registers.
template <int Q, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    topk_select_chunked_kernel(const float* __restrict__ Z,
                               const float* __restrict__ q,
                               const int* __restrict__ qnodes,
                               float* __restrict__ zn,
                               float* __restrict__ cand_s,
                               int* __restrict__ cand_i,
                               unsigned long long* __restrict__ gkey, int m,
                               int K, int nq, int k, int tile, int row_offset,
                               int exclude_self, float eps, int G, int cap) {
  extern __shared__ __align__(16) char smem_raw[];
  const Chunking ch = chunking(G);       // its tile is `tile`
  const int TR = tile, KCH = ch.kch;
  // element (r, c) of a slot: row-major (VEC) or column-major
  const int ZP = VEC ? KCH + 4 : tile + 1;
  auto at = [&](int r, int c) { return VEC ? r * ZP + c : c * ZP + r; };
  Smem S;
  carve(smem_raw, BODY_CHUNKED, K, k, G, cap, TR, &S);
  const int g0 = blockIdx.y * G;
  const int gq = max(0, min(G, nq - g0));
  init_group(S, q, qnodes, g0, gq, K, k, exclude_self, false);
  const bool normalize = zn != nullptr;
  float* zout = blockIdx.y == 0 ? zn : nullptr;
  const int nt = (m + TR - 1) / TR;
  const int t0 = (int)((long long)blockIdx.x * nt / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * nt / gridDim.x);
  const int nc = (K + KCH - 1) / KCH;           // chunks a pass
  const int stages = (t1 - t0) * nc * (normalize ? 2 : 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qbase = (warp % ch.wq) * Q;
  const int rbase = (warp / ch.wq) * 32 * RC;
  const int slot = chunk_slot(ch, G);
  // copies: thread t takes unit t % U (4 columns for VEC, else 1) of rows
  // t / U, t / U + THREADS / U, ...
  const int U = VEC ? KCH / 4 : KCH, W = VEC ? 4 : 1;
  const int cu = threadIdx.x % U, rfirst = threadIdx.x / U,
            rstep = THREADS / U;
  const Stage first{t0, normalize ? 0 : 1, 0};
  Stage in = first;                     // the next stage to copy
  int issued = 0;
  auto issue = [&]() {
    if (issued < stages) {
      float* zs = S.ring + (issued % RING) * slot;
      const int r0 = in.t * TR, rows = min(TR, m - r0);
      const int c0 = in.c * KCH, kc = min(KCH, K - c0);
      if (W * cu < kc) {
        const float* src = Z + (size_t)r0 * K + c0 + W * cu;
        for (int r = rfirst; r < rows; r += rstep) {
          if constexpr (VEC)
            cp_async16(zs + at(r, 4 * cu), src + (size_t)r * K);
          else
            cp_async4(zs + at(r, cu), src + (size_t)r * K);
        }
        if (in.pass == 1) {
          const float* qsrc = q + (size_t)g0 * K + c0 + W * cu;
          float* qdst = zs + TR * (VEC ? ZP : 0) + (VEC ? 0 : KCH * ZP);
          for (int j = rfirst; j < gq; j += rstep) {
            if constexpr (VEC)
              cp_async16(qdst + j * KCH + 4 * cu, qsrc + (size_t)j * K);
            else
              cp_async4(qdst + j * KCH + cu, qsrc + (size_t)j * K);
          }
        }
      }
      in.next(nc, normalize);
    }
    ++issued;
    cp_async_commit();                  // empty past the end: counts match
  };

  float acc[Q][RC];
  unsigned long long gk = 0;      // lane i < Q: query qbase + i's gkey
  __shared__ int full;            // a buffer holds MERGE_AT survivors
  if (threadIdx.x == 0) full = 0;
  // Filter the whole tile at r0 (rows rows) whose scores are in acc: all
  // queries, or those to rescan (redo).  A pair goes on if it beats the
  // query's threshold: the better of the block's own and gkey's (read as
  // the tile's last chunk began).  One atomicAdd a warp and query; a
  // count that reaches MERGE_AT raises `full`.
  auto filter = [&](bool all, int r0, int rows) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int j = qbase + i;
      const unsigned long long key = __shfl_sync(FULL, gk, i);
      if (j >= gq || !(all || S.redo[j])) continue;
      float ts = S.ts[j];
      int ti = S.ti[j];
      if (key != 0ull) {
        unsigned u = static_cast<unsigned>(key >> 32);
        u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
        const float gs = __uint_as_float(u);
        const int gi = INT_MAX - static_cast<int>(key & 0xffffffffu);
        if (better(gs, gi, ts, ti)) {
          ts = gs;
          ti = gi;
        }
      }
      const int self = S.qid[j];
      bool pass[RC];
      unsigned mask[RC];
      int total = 0;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int row = rbase + 32 * r + lane;
        const int id = row_offset + r0 + row;
        pass[r] = row < rows && id != self && better(acc[i][r], id, ts, ti);
        mask[r] = __ballot_sync(FULL, pass[r]);
        total += __popc(mask[r]);
      }
      if (total == 0) continue;
      int base = 0;
      if (lane == 0) {
        base = atomicAdd(&S.cnt[j], total);
        if (base + total >= MERGE_AT) full = 1;
      }
      base = __shfl_sync(FULL, base, 0);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int pos = base + __popc(mask[r] & ((1u << lane) - 1));
        if (pass[r] && pos < cap) {
          S.bs[j * cap + pos] = acc[i][r];
          S.bi[j * cap + pos] = row_offset + r0 + rbase + 32 * r + lane;
        }
        base += __popc(mask[r]);
      }
    }
  };
  // With the block synchronized and `full` up (read by every thread):
  // merge every buffer, then rescan the tile's scores for the queries
  // whose buffer overflowed, until none does.
  auto merge = [&](int r0, int rows) {
    while (merge_tile<true>(S, gq, k, gkey + g0, true, cap, &full)) {
      filter(false, r0, rows);
      __syncthreads();
      if (!full) break;
    }
  };
  int pr0 = 0, prows = 0;         // the last whole tile, its scores in acc
  bool pending = false;           // filtered, its merge not yet decided
  for (int n = 0; n < RING - 1; ++n) issue();
  Stage now = first;
  for (int n = 0; n < stages; ++n, now.next(nc, normalize)) {
    cp_async_wait<RING - 2>();          // this thread's copies of stage n
    __syncthreads();                    // everyone's; slot n - 1 is free
    if (pending) {                      // the last tile's merge, if due
      pending = false;
      if (full) merge(pr0, prows);
    }
    issue();
    float* zs = S.ring + (n % RING) * slot;
    const float* qs = zs + (VEC ? TR * ZP : KCH * ZP);
    const int r0 = now.t * TR, rows = min(TR, m - r0);
    const int c0 = now.c * KCH, kc = min(KCH, K - c0);
    if (now.pass == 0) {                // row norms, column by column
      for (int r = threadIdx.x; r < rows; r += THREADS) {
        float ss = c0 == 0 ? -0.f : S.dn[r];
        for (int c = 0; c < kc; ++c) {
          const float v = zs[at(r, c)];
          ss = __fadd_rn(ss, __fmul_rn(v, v));
        }
        S.dn[r] = c0 + kc == K ? fmaxf(__fsqrt_rn(ss), eps) : ss;
      }
      continue;
    }
    if (normalize) {
      if (W * cu < kc)
        for (int r = rfirst; r < rows; r += rstep) {
          const float d = S.dn[r];
#pragma unroll
          for (int e = 0; e < W; ++e) {
            float* p = zs + at(r, W * cu + e);
            *p = __fdiv_rn(*p, d);
            if (zout != nullptr)
              zout[(size_t)(r0 + r) * K + c0 + W * cu + e] = *p;
          }
        }
      __syncthreads();
    }
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int r = 0; r < RC; ++r) acc[i][r] = -0.f;
    }
    if (c0 + kc == K && lane < Q && qbase + lane < gq)
      gk = *reinterpret_cast<volatile unsigned long long*>(gkey + g0 +
                                                            qbase + lane);
    if (qbase < gq) {
      const float* qb = qs + qbase * KCH;
      int c = 0;
      for (; c + 4 <= kc; c += 4) {
        float z[4][RC];
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const int row = rbase + 32 * r + lane;
          if constexpr (VEC) {
            const float4 v4 = *reinterpret_cast<const float4*>(zs + at(row, c));
            z[0][r] = v4.x;
            z[1][r] = v4.y;
            z[2][r] = v4.z;
            z[3][r] = v4.w;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) z[u][r] = zs[at(row, c + u)];
          }
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(qb + i * KCH + c);
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            float a = acc[i][r];
            a = __fadd_rn(a, __fmul_rn(v.x, z[0][r]));
            a = __fadd_rn(a, __fmul_rn(v.y, z[1][r]));
            a = __fadd_rn(a, __fmul_rn(v.z, z[2][r]));
            acc[i][r] = __fadd_rn(a, __fmul_rn(v.w, z[3][r]));
          }
        }
      }
      for (; c < kc; ++c) {           // a ragged last chunk (not VEC)
        float z[RC];
#pragma unroll
        for (int r = 0; r < RC; ++r) z[r] = zs[at(rbase + 32 * r + lane, c)];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const float v = qb[i * KCH + c];
#pragma unroll
          for (int r = 0; r < RC; ++r)
            acc[i][r] = __fadd_rn(acc[i][r], __fmul_rn(v, z[r]));
        }
      }
    }
    if (c0 + kc < K) continue;
    if (now.t == t0) {
      // The block's first tile: the warps of the first rows seed each of
      // their queries' lists with the best of each lane's RC rows, so
      // that the first pass filters against the k-th of those 32 and
      // not (-inf, INT_MAX).  The pass offers these rows again; the
      // merge skips them as held.
      if (rbase == 0 && qbase < gq) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const int j = qbase + i;
          if (j >= gq) break;
          float bs = -CUDART_INF_F;
          int bi = INT_MAX;
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            const int row = 32 * r + lane;
            const int id = row_offset + r0 + row;
            if (row < rows && id != S.qid[j] &&
                better(acc[i][r], id, bs, bi)) {
              bs = acc[i][r];
              bi = id;
            }
          }
          merge_batch_long(S.ls + j * k, S.li + j * k, k, bs, bi,
                           bi != INT_MAX);
          if (lane == 0) set_threshold(S, j, k, gkey + g0 + j);
        }
      }
      __syncthreads();
    }
    // the tile's scores are whole: filter them now, and let the next
    // stage's barrier decide whether a buffer is due for a merge
    filter(true, r0, rows);
    pending = true;
    pr0 = r0;
    prows = rows;
  }
  __syncthreads();
  if (pending && full) merge(pr0, prows);
  merge_tile<true>(S, gq, k, gkey + g0, true, cap);   // what still waits
  write_lists(S, g0, gq, k, cand_s, cand_i);
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

// Merge pass for k in (KMAX, KLIST_MAX]: block j selects query j's top-k
// from its nb x k candidates in batches of THREADS, the list in shared
// memory (two copies, the new one written from the old).  A candidate
// goes on only if it beats the list's k-th slot and is not held (binary
// search: its rank, and a held row sits at its rank); the survivors of
// the batch gather in shared memory (any order), and each then takes slot
// rank + the survivors better than it, while each list entry moves down
// by the survivors whose rank is at most its slot.  The same selection as
// merge_batch_long, for the whole block at once.
__global__ void __launch_bounds__(THREADS)
    topk_merge_long_kernel(const float* __restrict__ cand_s,
                           const int* __restrict__ cand_i,
                           float* __restrict__ out_s, int* __restrict__ out_i,
                           int nb, int k) {
  extern __shared__ __align__(16) char smem_raw[];
  float* ls[2] = {reinterpret_cast<float*>(smem_raw),
                  reinterpret_cast<float*>(smem_raw) + k};
  int* li[2] = {reinterpret_cast<int*>(smem_raw) + 2 * k,
                reinterpret_cast<int*>(smem_raw) + 3 * k};
  float* bs = reinterpret_cast<float*>(smem_raw) + 4 * k;
  int* bi = reinterpret_cast<int*>(bs + THREADS);
  int* br = bi + THREADS;
  __shared__ int nsurv;
  const int j = blockIdx.x;
  const size_t total = (size_t)nb * k;
  const float* cs = cand_s + (size_t)j * total;
  const int* ci = cand_i + (size_t)j * total;
  for (int t = threadIdx.x; t < k; t += THREADS) {
    ls[0][t] = -CUDART_INF_F;
    li[0][t] = INT_MAX;
  }
  __syncthreads();
  int cur = 0;
  for (size_t b = 0; b < total; b += THREADS) {
    const size_t e = b + threadIdx.x;
    bool v = e < total;
    const float s = v ? cs[e] : 0.f;
    const int i = v ? ci[e] : 0;
    const float* os = ls[cur];
    const int* oi = li[cur];
    v = v && better(s, i, os[k - 1], oi[k - 1]);
    if (threadIdx.x == 0) nsurv = 0;
    if (!__syncthreads_or(v)) continue;
    int rank = 0;
    for (int step = 1 << (31 - __clz(k)); step > 0; step >>= 1)
      if (rank + step <= k &&
          better(os[rank + step - 1], oi[rank + step - 1], s, i))
        rank += step;
    v = v && !(rank < k && oi[rank] == i);
    if (v) {
      const int at = atomicAdd(&nsurv, 1);
      bs[at] = s;
      bi[at] = i;
      br[at] = rank;
    }
    __syncthreads();
    const int n = nsurv;
    float* ns = ls[cur ^ 1];
    int* ni = li[cur ^ 1];
    if (v) {
      int slot = rank;
      for (int u = 0; u < n; ++u) slot += better(bs[u], bi[u], s, i);
      if (slot < k) {
        ns[slot] = s;
        ni[slot] = i;
      }
    }
    for (int t = threadIdx.x; t < k; t += THREADS) {
      int p = t;
      for (int u = 0; u < n; ++u) p += br[u] <= t;
      if (p < k) {
        ns[p] = os[t];
        ni[p] = oi[t];
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int t = threadIdx.x; t < k; t += THREADS) {
    out_s[(size_t)j * k + t] = ls[cur][t];
    out_i[(size_t)j * k + t] =
        li[cur][t] == INT_MAX || !isfinite(ls[cur][t]) ? -1 : li[cur][t];
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

// General merge pass (k > KLIST_MAX): one warp per query, its list in out.
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

// ---- gee_delta_renorm -----------------------------------------------------

// The delta body's geometry for width K: rows a tile, ring depth, floats a
// stage (the tile's span rounded up to 4, plus 4 for a copy that starts
// up to 3 floats early), the squares' row pitch, shared memory bytes;
// columns a tile and chunks a row (K and 1, or DELTA_CHUNK and more for a
// row too wide for three stages).
struct DeltaPlan {
  int rows, stages, stage_floats, kp;
  size_t smem;
  int cw, nch;
};

// the squares' row pitch: the least KP >= K with KP % 8 == 4, so KP / 4 is
// odd and 8 consecutive rows' 16-byte reads at one column hit 8 distinct
// 16-byte bank groups
__host__ __device__ __forceinline__ int delta_pitch(int K) {
  return K + (12 - K % 8) % 8;
}

// shared memory: S stages, R rows of squares, the rows' norms (16-byte
// pairs read past the last row), each stage's delta range and its full,
// added and empty mbarriers
__host__ __device__ __forceinline__ DeltaPlan delta_geometry(int K, int R,
                                                             int S) {
  DeltaPlan p;
  p.rows = R;
  p.stages = S;
  p.stage_floats = ((R * K + 3) & ~3) + 4;
  p.kp = delta_pitch(K);
  p.smem = sizeof(float) * ((size_t)S * p.stage_floats + (size_t)R * p.kp +
                            ((R + 3) & ~3) + 8) +
           (size_t)S * (sizeof(int2) + 3 * sizeof(uint64_t));
  p.cw = K;
  p.nch = 1;
  return p;
}

// R: a multiple of 4 near DELTA_TILE_FLOATS floats of rows, 4 at least;
// fewer than 4 only where 4 do not fit DELTA_MIN_STAGES stages; where one
// row does not, one row a tile in chunks of DELTA_CHUNK columns.
// DELTA_STAGES stages where they fit.  rows 0 for K < 1.
DeltaPlan delta_plan(int K, size_t max_smem) {
  DeltaPlan none{0, 0, 0, 0, 0, 0, 0};
  if (K < 1) return none;
  int R = DELTA_TILE_FLOATS / K;
  R = R >= 4 ? R & ~3 : 4;
  if ((size_t)K * sizeof(float) > max_smem) R = 0;  // no row fits whole
  for (; R >= 1; R = R > 4 ? 4 : R - 1)
    for (int S = DELTA_STAGES; S >= DELTA_MIN_STAGES; --S) {
      const DeltaPlan p = delta_geometry(K, R, S);
      if (p.smem <= max_smem) return p;
    }
  for (int S = DELTA_STAGES; S >= DELTA_MIN_STAGES; --S) {
    DeltaPlan p = delta_geometry(DELTA_CHUNK, 1, S);
    p.nch = (K - 1) / DELTA_CHUNK + 1;
    if (p.smem <= max_smem) return p;
  }
  return none;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
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
// `bytes` (a multiple of 16) from global src to shared dst, both on 16
// bytes, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// `bytes` from shared src to global dst as one bulk group of its own
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}
// this thread's bulk stores have read their shared sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// ... and written their global destinations
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// order this thread's generic shared-memory writes before later bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// the consumer threads' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(DELTA_CONSUMERS) : "memory");
}

// The first p in [lo, m] with p == m or rows[p] >= key, every entry before
// lo below key: the calling warp probes 32 entries a round (all lanes, the
// same answer).
__device__ __forceinline__ int lower_bound_warp(const int* __restrict__ rows,
                                                int m, int lo, int key,
                                                int lane) {
  int n = m - lo;                       // the answer is in [lo, lo + n]
  while (n > 32) {
    const int step = (n + 31) >> 5;
    const int p = lo + step * (lane + 1) - 1;
    const bool below = p < lo + n && __ldg(rows + p) < key;
    const int nlo = lo + step * __popc(__ballot_sync(FULL, below));
    n = min(step - 1, lo + n - nlo);
    lo = nlo;
  }
  const bool below = lane < n && __ldg(rows + lo + lane) < key;
  return lo + __popc(__ballot_sync(FULL, below));
}

// [lo, hi) of the entries with rows in [t0, t1), every entry before `from`
// below t0.  The 32 entries from `from` (one coalesced read) hold both ends
// for most tiles of a short delta: a block's next tile lies a grid of tiles
// further on, past the few entries of the tiles between; the 32-way search
// takes what lies beyond them.
__device__ __forceinline__ int2 tile_range(const int* __restrict__ rows,
                                           int m, int from, int t0, int t1,
                                           int lane) {
  const int p = from + lane;
  const int v = p < m ? __ldg(rows + p) : INT_MAX;
  const int n0 = __popc(__ballot_sync(FULL, v < t0));
  const int n1 = __popc(__ballot_sync(FULL, v < t1));
  const int lo =
      n0 < 32 ? from + n0 : lower_bound_warp(rows, m, from + 32, t0, lane);
  const int hi = n1 < 32 ? from + n1
                         : lower_bound_warp(rows, m, max(lo, from + 32), t1,
                                            lane);
  return make_int2(lo, hi);
}

// A tile: its first row and rows, its first column and columns (all K, or
// a chunk of one row), what it does (DELTA_PASS_NORM: Z_new's store, the
// squares and the norm chains; DELTA_PASS_ZN: Zn), the global flat index
// of its first element, its elements, and where that element sits in the
// stage (the copy starts on the 16 bytes at or before it).
constexpr int DELTA_PASS_NORM = 1, DELTA_PASS_ZN = 2;
struct DeltaTile {
  int t0, nr, c0, nc, ph;
  long long x0;
  int n_el, sh;
};

// tile i of this block: R whole rows (nch == 1), or, for a row too wide
// for three stages, chunk i % nch of the block's row i / (2 nch), first
// for the norm and then for Zn
__device__ __forceinline__ DeltaTile delta_tile(int i, int R, int K,
                                                int n_local, int cw,
                                                int nch) {
  DeltaTile t;
  if (nch == 1) {
    t.t0 = ((int)blockIdx.x + i * (int)gridDim.x) * R;
    t.nr = min(R, n_local - t.t0);
    t.c0 = 0;
    t.nc = K;
    t.ph = DELTA_PASS_NORM | DELTA_PASS_ZN;
  } else {
    const int w = i % (2 * nch);
    t.t0 = (int)blockIdx.x + (i / (2 * nch)) * (int)gridDim.x;
    t.nr = 1;
    t.c0 = (w % nch) * cw;
    t.nc = min(cw, K - t.c0);
    t.ph = w < nch ? DELTA_PASS_NORM : DELTA_PASS_ZN;
  }
  t.x0 = (long long)t.t0 * K + t.c0;
  t.n_el = t.nr * t.nc;
  t.sh = (int)(t.x0 & 3);
  return t;
}

// the tile's whole 16-byte groups of Z_new, from the stage by one bulk
// store (Z on 16 bytes, so the stage's groups are Z_new's)
__device__ __forceinline__ void store_groups(const DeltaTile& t,
                                             const float* st, float* dst) {
  const long long a0 = (t.x0 + 3) & ~3LL, a1 = (t.x0 + t.n_el) & ~3LL;
  if (a1 > a0) {
    fence_async_shared();
    bulk_store(dst + a0, smem_addr(st + (a0 - (t.x0 - t.sh))),
               (uint32_t)(a1 - a0) * 4u);
  }
}

// tile t's range into rng[s], then its copy into stage s: the
// 16-byte-aligned span around it, completing on full[s]
__device__ __forceinline__ void load_tile(const float* Z, const DeltaTile& t,
                                          int2 r2, float* stage,
                                          int stage_floats, int2* rng,
                                          uint64_t* full, int s) {
  rng[s] = r2;
  const uint32_t bytes = (uint32_t)((t.sh + t.n_el + 3) & ~3) * 4u;
  mbar_expect_tx(smem_addr(full + s), bytes);
  bulk_load(smem_addr(stage + (size_t)s * stage_floats), Z + (t.x0 - t.sh),
            bytes, smem_addr(full + s));
}

// Each row's run of the tile's entries [lo, hi), added in list order into
// the staged rows z (the tile's element 0), one thread a run; a chunk
// takes the entries of its columns [c0, c0 + nc).
__device__ __forceinline__ void add_runs(float* z,
                                         const int* __restrict__ rows,
                                         const int* __restrict__ cls,
                                         const float* __restrict__ val,
                                         int lo, int hi, int t0, int K,
                                         int c0, int nc, int tid) {
  for (int p = lo + tid; p < hi; p += DELTA_CONSUMERS) {
    const int r = __ldg(rows + p);
    if (p > lo && __ldg(rows + p - 1) == r) continue;  // not its run's first
    float* zr = z + (size_t)(r - t0) * K;
    for (int q = p; q < hi && __ldg(rows + q) == r; ++q) {
      const int c = __ldg(cls + q) - c0;
      if ((unsigned)c < (unsigned)nc)
        zr[c] = __fadd_rn(zr[c], __ldg(val + q));
    }
  }
}

// The global group of four elements at g (g % 4 == 0) that meets the tile:
// its elements [q0, q1) in the tile, their values from the stage (one
// 16-byte read), and the row and column of q0 in the tile.
struct DeltaGroup {
  float v[4];
  int q0, q1, r, c;
};

__device__ __forceinline__ DeltaGroup load_group(const float* st,
                                                 const DeltaTile& t,
                                                 long long g) {
  DeltaGroup a;
  a.q0 = (int)max(0LL, t.x0 - g);
  a.q1 = (int)min(4LL, t.x0 + t.n_el - g);
  const float4 x =                           // stage index of g: g - x0 + sh
      *reinterpret_cast<const float4*>(st + (int)(g - t.x0) + t.sh);
  a.v[0] = x.x;
  a.v[1] = x.y;
  a.v[2] = x.z;
  a.v[3] = x.w;
  const int e = (int)(g - t.x0) + a.q0;
  a.r = e / t.nc;
  a.c = e - a.r * t.nc;
  return a;
}

// the k-th of 8 consecutive floats held as two float4
__device__ __forceinline__ float pick8(const float4& a, const float4& b,
                                       int k) {
  const float4 h = k < 4 ? a : b;
  const int j = k & 3;
  return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
}

// a group's squares (__fmul_rn) into the scratch rows at pitch kp
__device__ __forceinline__ void square_group(float* sq, const DeltaGroup& a,
                                             int nc, int kp, bool rows4) {
  if (rows4) {
    *reinterpret_cast<float4*>(sq + a.r * kp + a.c) = make_float4(
        __fmul_rn(a.v[0], a.v[0]), __fmul_rn(a.v[1], a.v[1]),
        __fmul_rn(a.v[2], a.v[2]), __fmul_rn(a.v[3], a.v[3]));
    return;
  }
  int r = a.r, c = a.c;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q >= a.q0 && q < a.q1) {
      sq[r * kp + c] = __fmul_rn(a.v[q], a.v[q]);
      if (++c == nc) c = 0, ++r;
    }
}

// z / d rounded once (d > 0).  A zero z is its own quotient, with its
// sign; the division runs on 1 in its place, since a zero numerator sends
// __fdiv_rn down its slow path, and zeros fill a GEE row with few
// labelled neighbours.  The division is not branched around: every lane
// runs it, so a warp of nonzeros pays two selects.
__device__ __forceinline__ float quotient(float z, float d) {
  const float q = __fdiv_rn(z != 0.f ? z : 1.f, d);
  return z != 0.f ? q : z;
}

// a group's Zn (__fdiv_rn by its rows' norms), 16 bytes a store where the
// group is whole; the tile's first and last groups, which the bulk store
// leaves out, also write their Z_new
__device__ __forceinline__ void normalize_group(float* Zn, float* Znew,
                                                const float* dn,
                                                const float4* dn4,
                                                const DeltaGroup& a,
                                                long long g, int nc) {
  float z[4] = {0.f, 0.f, 0.f, 0.f};
  if (nc >= 4) {                             // at most rows r and r + 1
    const float d0 = dn[a.r], d1 = dn[a.r + 1];
    int c = a.c;
    bool next = false;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q >= a.q0 && q < a.q1) {
        z[q] = quotient(a.v[q], next ? d1 : d0);
        if (++c == nc) c = 0, next = true;
      }
  } else {                                   // rows r .. r + 3
    const int b = a.r & ~3;
    const float4 d0 = dn4[b >> 2], d1 = dn4[(b >> 2) + 1];
    int r = a.r, c = a.c;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q >= a.q0 && q < a.q1) {
        z[q] = quotient(a.v[q], pick8(d0, d1, r - b));
        if (++c == nc) c = 0, ++r;
      }
  }
  if (a.q0 == 0 && a.q1 == 4) {
    *reinterpret_cast<float4*>(Zn + g) = make_float4(z[0], z[1], z[2], z[3]);
  } else {                                   // the tile's first or last group
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q >= a.q0 && q < a.q1) {
        Zn[g + q] = z[q];
        Znew[g + q] = a.v[q];
      }
  }
}

// Z_new = Z + the delta's entries, Zn = normalize_rows(Z_new): persistent
// blocks over tiles (blockIdx.x + i gridDim.x of R rows, or a row's chunks
// twice), a ring of S stages filled by bulk copies from the producer warp
// (the block's last), DELTA_CONSUMERS consumer threads.  Z, Z_new and Zn
// on 16 bytes.  See the note at the top of the file.
__global__ void __launch_bounds__(DELTA_THREADS)
    delta_renorm_kernel(const float* __restrict__ Z,
                        const int* __restrict__ rows,
                        const int* __restrict__ cls,
                        const float* __restrict__ val, int m,
                        float* __restrict__ Znew, float* __restrict__ Zn,
                        int n_local, int K, float eps, int R, int S,
                        int stage_floats, int kp, int cw, int nch) {
  extern __shared__ __align__(128) float smem[];
  float* stage = smem;                               // S x stage_floats
  float* sq = stage + (size_t)S * stage_floats;      // R x kp squares
  float* dn = sq + (size_t)R * kp;                   // the rows' norms
  int2* rng = reinterpret_cast<int2*>(dn + ((R + 3) & ~3) + 8);
  uint64_t* full = reinterpret_cast<uint64_t*>(rng + S);   // copy landed
  uint64_t* added = full + S;       // the consumers have added the runs
  uint64_t* empty = added + S;      // the consumers are done with the stage
  const int tid = threadIdx.x, lane = tid & 31;
  // this block's tiles: its share of the row tiles, or of the rows (2 nch
  // tiles each)
  const int units = nch == 1 ? (n_local + R - 1) / R : n_local;
  const int n_mine =
      (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      (nch == 1 ? 1 : 2 * nch);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(added + s), DELTA_CONSUMERS / 32);
      mbar_init(smem_addr(empty + s), DELTA_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= DELTA_CONSUMERS) {
    // The producer.  First the ring's first S tiles: each tile's range,
    // then its copy.  Then step j: the range of tile j + S; once the
    // consumers have added tile j's runs, tile j's Z_new store (the norm
    // pass of a chunked row: its Zn pass adds the same runs again); once
    // they have let its stage go (after their squares, where the tile fits
    // their registers) and the store has read it, tile j + S's copy.  A
    // chunked row's tiles share a range, so the next search starts at its
    // first entry.
    int from = 0;
    for (int i = 0; i < min(S, n_mine); ++i) {
      const DeltaTile t = delta_tile(i, R, K, n_local, cw, nch);
      const int2 r2 = tile_range(rows, m, from, t.t0, t.t0 + t.nr, lane);
      from = nch == 1 ? r2.y : r2.x;
      if (lane == 0)
        load_tile(Z, t, r2, stage, stage_floats, rng, full, i % S);
      __syncwarp();
    }
    for (int j = 0; j < n_mine; ++j) {
      const int s = j % S, i = j + S;
      DeltaTile t{};
      int2 r2 = make_int2(0, 0);
      if (i < n_mine) {
        t = delta_tile(i, R, K, n_local, cw, nch);
        r2 = tile_range(rows, m, from, t.t0, t.t0 + t.nr, lane);
        from = nch == 1 ? r2.y : r2.x;
      }
      if (lane == 0) {
        mbar_wait(smem_addr(added + s), (j / S) & 1);
        const DeltaTile tj = delta_tile(j, R, K, n_local, cw, nch);
        if (tj.ph & DELTA_PASS_NORM)
          store_groups(tj, stage + (size_t)s * stage_floats, Znew);
        if (i < n_mine) {
          mbar_wait(smem_addr(empty + s), (j / S) & 1);
          bulk_wait_read();                  // the store has read the stage
          load_tile(Z, t, r2, stage, stage_floats, rng, full, s);
        }
      }
      __syncwarp();
    }
    if (lane == 0) bulk_wait_all();
    return;
  }

  // The consumers, tile by tile: the delta's runs, the squares, the norm
  // chains, Zn (and Z_new at the tile's two ends).  Where the tile fits
  // (DELTA_GROUPS groups a thread) its values stay in registers from the
  // squares to Zn and the stage is let go after the squares; wider tiles
  // (rows of more than 1,024 floats) read it again and let it go last.  A
  // chunked row's chain runs on in `carry` from chunk to chunk; its norm
  // waits in dn[0] for the row's Zn pass.
  const bool rows4 = K % 4 == 0;             // every group in one row
  const float4* dn4 = reinterpret_cast<const float4*>(dn);
  float carry = 0.f;
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % S;
    float* st = stage + (size_t)s * stage_floats;
    const DeltaTile t = delta_tile(i, R, K, n_local, cw, nch);
    const bool norm = t.ph & DELTA_PASS_NORM, zn = t.ph & DELTA_PASS_ZN;
    const long long g0 = t.x0 & ~3LL, end = t.x0 + t.n_el;
    const bool held = end - g0 <= 4LL * DELTA_GROUPS * DELTA_CONSUMERS;
    mbar_wait(smem_addr(full + s), (i / S) & 1);
    const int2 r2 = rng[s];
    if (r2.x < r2.y) {                       // the same for every consumer
      add_runs(st + t.sh, rows, cls, val, r2.x, r2.y, t.t0, K, t.c0, t.nc,
               tid);
      fence_async_shared();
      consumers_sync();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(added + s));   // Z_new is final
    DeltaGroup a[DELTA_GROUPS];
#pragma unroll
    for (int j = 0; j < DELTA_GROUPS; ++j) {
      const long long g = g0 + 4 * (tid + (long long)DELTA_CONSUMERS * j);
      if (held && g < end) {
        a[j] = load_group(st, t, g);
        if (norm) square_group(sq, a[j], t.nc, kp, rows4);
      }
    }
    for (long long g = g0 + 4 * tid; !held && norm && g < end;
         g += 4 * DELTA_CONSUMERS)
      square_group(sq, load_group(st, t, g), t.nc, kp, rows4);
    if (held) {                              // the stage is no longer read
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(empty + s));
    }
    consumers_sync();
    // each row's chain in column order (row_norm_denom's), 16 bytes a read
    for (int r = tid; norm && r < t.nr; r += DELTA_CONSUMERS) {
      const float4* p = reinterpret_cast<const float4*>(sq + r * kp);
      float4 x = p[0];
      float ss = t.c0 == 0 ? x.x : __fadd_rn(carry, x.x);
      if (t.nc > 1) ss = __fadd_rn(ss, x.y);
      if (t.nc > 2) ss = __fadd_rn(ss, x.z);
      if (t.nc > 3) ss = __fadd_rn(ss, x.w);
#pragma unroll 4
      for (int c = 4; c < t.nc; c += 4) {
        x = p[c >> 2];
        ss = __fadd_rn(ss, x.x);
        if (c + 1 < t.nc) ss = __fadd_rn(ss, x.y);
        if (c + 2 < t.nc) ss = __fadd_rn(ss, x.z);
        if (c + 3 < t.nc) ss = __fadd_rn(ss, x.w);
      }
      if (t.c0 + t.nc == K)
        dn[r] = fmaxf(__fsqrt_rn(ss), eps);
      else
        carry = ss;
    }
    consumers_sync();
#pragma unroll
    for (int j = 0; j < DELTA_GROUPS; ++j) {
      const long long g = g0 + 4 * (tid + (long long)DELTA_CONSUMERS * j);
      if (held && zn && g < end)
        normalize_group(Zn, Znew, dn, dn4, a[j], g, t.nc);
    }
    for (long long g = g0 + 4 * tid; !held && zn && g < end;
         g += 4 * DELTA_CONSUMERS)
      normalize_group(Zn, Znew, dn, dn4, load_group(st, t, g), g, t.nc);
    if (!held) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(empty + s));
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// How the select pass runs for (K, k, nq, row alignment): which body and
// kernel, its query group, tile, survivor slots and shared memory.
struct SelectPlan {
  const void* fn;
  int body, group, tile, cap;
  bool vec;               // rows on 16 bytes, K % 4 == 0 (chunked body)
  size_t smem;
};

// The register and shared bodies' tile: R = 64 / K rows a thread, or
// about 32 KiB of rows, 32 to 256 of them (a multiple of 32: a warp's
// pairs share a query)
int body_tile(int body, int K, int G) {
  if (body == BODY_CHUNKED) return chunking(G).tile;
  return body == BODY_SHARED ? max(32, min(THREADS, (8192 / K) / 32 * 32))
                             : THREADS * (64 / K);
}

template <bool VEC>
const void* chunked_fn(int G) {
  switch (chunking(G).q) {
    case 8: return (const void*)topk_select_chunked_kernel<8, VEC>;
    case 4: return (const void*)topk_select_chunked_kernel<4, VEC>;
    case 2: return (const void*)topk_select_chunked_kernel<2, VEC>;
    default: return (const void*)topk_select_chunked_kernel<1, VEC>;
  }
}

const void* select_fn(int body, int K, bool is_long, int G, bool vec) {
  if (body == BODY_CHUNKED)
    return vec ? chunked_fn<true>(G) : chunked_fn<false>(G);
  if (body == BODY_SHARED)
    return is_long ? (const void*)topk_select_kernel<0, true>
                   : (const void*)topk_select_kernel<0, false>;
  if (K == 8)
    return is_long ? (const void*)topk_select_kernel<8, true>
                   : (const void*)topk_select_kernel<8, false>;
  if (K == 16)
    return is_long ? (const void*)topk_select_kernel<16, true>
                   : (const void*)topk_select_kernel<16, false>;
  return is_long ? (const void*)topk_select_kernel<32, true>
                 : (const void*)topk_select_kernel<32, false>;
}

// The plan for k <= KLIST_MAX.  k <= KMAX on the register and shared
// bodies: GROUP queries, CAP slots, as always.  Otherwise (long lists, or
// the chunked body) cap = max(2k, CAP_MIN), and the group is the largest
// power of two, at most GROUP and no larger than nq needs, that fits one
// block in shared memory, halved once where that lets two blocks share
// an SM (each halving reads the rows once more); one query always fits
// (k <= KLIST_MAX).
int select_plan(const float* Z, int K, int k, int nq, SelectPlan* p) {
  const bool vec = (reinterpret_cast<uintptr_t>(Z) & 15) == 0;
  p->body = vec && (K == 8 || K == 16 || K == 32) ? BODY_REGISTERS
            : K <= KSMEM_MAX                      ? BODY_SHARED
                                                  : BODY_CHUNKED;
  const bool is_long = k > KMAX || p->body == BODY_CHUNKED;
  Smem unused;
  if (!is_long) {
    p->group = GROUP;
    p->cap = CAP;
  } else {
    int dev = 0, per_block = 0, per_sm = 0, reserved = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(
          &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(
          &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(
          &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err) return err;
    p->cap = max(2 * k, CAP_MIN);
    auto bytes = [&](int G) {
      return carve(nullptr, p->body, K, k, G, p->cap,
                   body_tile(p->body, K, G), &unused);
    };
    int top = 1;
    while (top < min(nq, GROUP)) top *= 2;
    int G = top;                        // the largest group one block fits
    while (G > 1 && bytes(G) > (size_t)per_block) G /= 2;
    if (bytes(G) > (size_t)per_block) return (int)cudaErrorInvalidValue;
    // half of it, where that lets two blocks share an SM
    if (G > 1 && 2 * (bytes(G) + reserved) > (size_t)per_sm &&
        2 * (bytes(G / 2) + reserved) <= (size_t)per_sm)
      G /= 2;
    p->group = G;
  }
  p->tile = body_tile(p->body, K, p->group);
  p->smem = carve(nullptr, p->body, K, k, p->group, p->cap, p->tile,
                  &unused);
  p->vec = p->body == BODY_CHUNKED && vec && K % 4 == 0;
  p->fn = select_fn(p->body, K, is_long, p->group, p->vec);
  return 0;
}

}  // namespace

// How the select pass runs for these arguments: info[0] the body (0
// registers, 1 shared, 2 chunked, 3 general), [1] queries a group, [2]
// rows a tile, [3] survivor slots a query, [4] shared memory bytes, [5]
// columns a chunk (chunked body; else 0), [6] 1 where the chunked body
// copies 16 bytes at a time (for queries on 16 bytes too).
extern "C" int topk_select_info(const float* Z, int K, int k, int nq,
                                int* info) {
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (general_path(k)) {
    info[0] = BODY_GENERAL;
    return 0;
  }
  SelectPlan p;
  const int err = select_plan(Z, K, k, nq, &p);
  if (err) return err;
  info[0] = p.body;
  info[1] = p.group;
  info[2] = p.tile;
  info[3] = p.cap;
  info[4] = (int)p.smem;
  info[5] = p.body == BODY_CHUNKED ? chunking(p.group).kch : 0;
  info[6] = p.vec;
  return 0;
}

// Candidate lists per query of the select pass for m rows, 0 for no rows;
// the wrapper sizes the candidate scratch (nq x grid x k) from it.  The
// shared-memory bodies (k <= KLIST_MAX): blocks along x, as many as fit
// on the card at once (occupancy API), shared among the query groups for
// long lists and the chunked body, at most one per tile.  The general path: selectors (warps), GEN_WARPS a
// block, about four blocks an SM in all over the nq queries, and at least
// 1,024 rows a block.  max_grid > 0 caps the grid (on the general path at
// whole blocks, at least one); 0 leaves it as chosen.  The answer has the
// same bits for any grid.
extern "C" int topk_select_grid(const float* Z, int m, int K, int k, int nq,
                                int max_grid, int* grid) {
  *grid = 0;
  if (m <= 0) return 0;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  if (general_path(k)) {
    const int want = (4 * sms + max(nq, 1) - 1) / max(nq, 1);
    const int most = (m + GEN_WARPS * 1024 - 1) / (GEN_WARPS * 1024);
    int blocks = max(1, min(want, min(most, 65535)));
    if (max_grid > 0) blocks = max(1, min(blocks, max_grid / GEN_WARPS));
    *grid = GEN_WARPS * blocks;
    return 0;
  }
  SelectPlan p;
  err = select_plan(Z, K, k, nq, &p);
  if (!err) err = set_smem(p.fn, p.smem);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, p.fn, THREADS, p.smem);
  if (err) return err;
  // long lists and the chunked body share one wave among their query
  // groups; the main bodies (k <= KMAX) give each group a wave, as before
  const bool is_long = k > KMAX || p.body == BODY_CHUNKED;
  const int groups = is_long ? max(1, (nq + p.group - 1) / p.group) : 1;
  const int tiles = (m + p.tile - 1) / p.tile;
  *grid = max(1, min(tiles, (sms * max(per_sm, 1) + groups - 1) / groups));
  if (max_grid > 0) *grid = min(*grid, max_grid);
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
  if (general_path(k)) {
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
  SelectPlan p;
  int err = select_plan(Z, K, k, nq, &p);
  // the chunked body copies the queries 16 bytes at a time too
  if (!err && p.vec && (reinterpret_cast<uintptr_t>(q) & 15) != 0) {
    p.vec = false;
    p.fn = select_fn(p.body, K, true, p.group, false);
  }
  if (!err) err = set_smem(p.fn, p.smem);
  if (err) return err;
  const dim3 blocks(grid, max(1, (nq + p.group - 1) / p.group));
  void* args[] = {&Z,      &q,  &qnodes, &zn, &cand_s, &cand_i,
                  &gkey,   &m,  &K,      &nq, &k,      &p.tile,
                  &row_offset, &exclude_self, &eps, &p.group, &p.cap};
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
  if (k <= KMAX) {
    topk_merge_kernel<<<nq, THREADS, 0, st>>>(cand_s, cand_i, out_s, out_i,
                                              grid, k);
  } else if (!general_path(k)) {
    const size_t smem = sizeof(float) * (4 * (size_t)k + 3 * THREADS);
    const int err = set_smem((const void*)topk_merge_long_kernel, smem);
    if (err) return err;
    topk_merge_long_kernel<<<nq, THREADS, smem, st>>>(cand_s, cand_i, out_s,
                                                      out_i, grid, k);
  } else {
    topk_merge_general_kernel<<<nq, 32, 0, st>>>(cand_s, cand_i, out_s,
                                                  out_i, grid, k);
  }
  return (int)cudaGetLastError();
}

// The delta body's plan on the current device for (K, n_local): rows a
// tile, ring depth, floats a stage, squares' pitch, shared memory bytes,
// columns a tile and chunks a row, blocks an SM and the grid;
// cudaErrorInvalidValue for K < 1.  The kernel may take the device's
// whole opt-in shared memory, so no plan's launch is refused.
static int delta_setup(int K, int n_local, DeltaPlan* p, int* per_sm,
                       int* grid) {
  int dev = 0, optin = 0, sms = 0, fit = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  *p = delta_plan(K, (size_t)optin);
  if (!p->rows) return (int)cudaErrorInvalidValue;
  err = set_smem((const void*)delta_renorm_kernel, (size_t)optin);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, delta_renorm_kernel, DELTA_THREADS, p->smem);
  if (err) return err;
  *per_sm = max(1, min(DELTA_BLOCKS_PER_SM, fit));
  const int units = p->nch == 1 ? (n_local + p->rows - 1) / p->rows
                                : n_local;
  *grid = max(1, min(units, sms * *per_sm));
  return 0;
}

// out: rows a tile, ring depth, bytes a stage, squares' pitch, shared
// memory bytes a block, blocks an SM, grid, tiles, chunks a row
extern "C" int delta_renorm_info(int K, int n_local, int* out) {
  DeltaPlan p;
  int per_sm = 0, grid = 0;
  const int err = delta_setup(K, n_local, &p, &per_sm, &grid);
  if (err) return err;
  out[0] = p.rows;
  out[1] = p.stages;
  out[2] = p.stage_floats * 4;
  out[3] = p.kp;
  out[4] = (int)p.smem;
  out[5] = per_sm;
  out[6] = grid;
  out[7] = p.nch == 1 ? (n_local + p.rows - 1) / p.rows
                      : n_local * 2 * p.nch;
  out[8] = p.nch;
  return 0;
}

extern "C" int delta_renorm_launch(const float* Z, const int* rows,
                                   const int* cls, const float* val, int m,
                                   float* Znew, float* Zn, int n_local, int K,
                                   float eps, void* stream) {
  if (n_local == 0 || K == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(Z) | reinterpret_cast<uintptr_t>(Znew) |
       reinterpret_cast<uintptr_t>(Zn)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  DeltaPlan p;
  int per_sm = 0, grid = 0;
  const int err = delta_setup(K, n_local, &p, &per_sm, &grid);
  if (err) return err;
  delta_renorm_kernel<<<grid, DELTA_THREADS, p.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      Z, rows, cls, val, m, Znew, Zn, n_local, K, eps, p.rows, p.stages,
      p.stage_floats, p.kp, p.cw, p.nch);
  return (int)cudaGetLastError();
}
