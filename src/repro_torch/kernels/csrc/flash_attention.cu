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
// {16, 32, 64, 128} (and at bfloat16 any narrower multiple of 8, read in
// place), and for 128 < D <= 256 one more a dtype: at bfloat16 the wide
// tensor-core body, at float32 the wide CUDA-core body f32wide (each
// reading a narrower width in place, below), and for every D > 256 the
// cluster forward (each dtype's D = 256 body on 256-column slices, in
// walks above 2048, below).
//
// bfloat16 (bf16body): both products on the tensor cores, in persistent
// blocks.  The grid is one block per SM (fewer if there are fewer work
// items).  A work item is (batch x head, query tile of BQ rows); the list
// holds the last query tiles (the most keys) first and, inside a tile, the
// heads in order, so the query heads of a GQA group run side by side and
// read their KV head's tiles from L2.  A block's producer takes the items
// in list order from a counter in device memory (atomicAdd; the ticket
// past the last item ends a block, and the launch's last ticket puts the
// counter back to zero for the next launch on the stream: unlike the
// backward's, no pass before it could zero it; see work_counter).  The
// launcher and flash_attention_fwd_info take the items and the grid from
// one place (`schedule`).  Per block:
//   - a producer warpgroup (one thread; 40 or 32 registers after
//     setmaxnreg) loads each item's Q tile into one of two Q slots and
//     then its 128-row K and V tiles into a ring of STAGES slots, all with
//     TMA (cp.async.bulk.tensor, 4-D maps over (D, heads, S, B), so rows
//     past S in a ragged last tile are zero-filled inside their own head),
//     each tile completing on an mbarrier.  The ring's positions and
//     phases run on across items, so the next item's Q and first K and V
//     land while the consumers finish the current one.  A head dim below
//     the body's that is a multiple of 8 (h2o-danube's 120 on the D = 128
//     body) is read in place the same way: the maps' innermost dimension
//     is the real width, so the columns past it land as zeros (exact zeros
//     in every score, zero P V columns), and the store map drops them;
//   - CONSUMERS warpgroups own 64 query rows each of an item.  S = Q K^T
//     is wgmma m64n128k16 with both operands in shared memory (the K tile
//     as it lies is the K-major B operand).  The softmax runs on the
//     float32 accumulator fragment in registers (row max and sum over the
//     4 lanes of a quad), in the log2 domain; only a consumer's last key
//     tile is masked, and tiles past it are never computed.  P is rounded
//     to bf16 pairs that are directly the A fragments of O += P V (wgmma
//     m64nDk16, A from registers, V as the MN-major B operand), so P never
//     touches shared memory.  The epilogue writes O / l as bf16 into the
//     consumer's staging tile in shared memory (the TMA swizzle) and one
//     thread stores it with TMA (cp.async.bulk.tensor, shared to global,
//     over a 4-D map of the output like the loads': rows past S and
//     columns past the width are not written).
// The consumers take turns on the tensor cores (a named barrier each,
// handed on in a cycle across items), n_kv turns an item each: in its
// turn a consumer starts S of tile t and P V of tile t - 1 as two
// batches, then computes tile t's softmax while P V of tile t - 1 still
// runs and the others start their products.  P V of an item's last tile
// goes out in the same turn as S of the consumer's next item's first
// tile, and the item's epilogue runs while that S does; its TMA store
// runs under the next turns.  A K slot is released as soon as S has been
// computed from it, a V slot once P V has, a Q slot after the item's last
// S.  A consumer whose rows end before the item's last key tile passes
// the remaining turns empty and releases those tiles unread.
// What bounds the body at D = 64 is the exponentials as much as the tensor
// cores: a 64 x 128 tile takes 2.1 MFLOP of wgmma (512 clocks of an SM's
// tensor cores) and 8,192 ex2 (512 clocks at 16 a clock).  So at D = 64 an
// item is 192 rows, three consumers (160 registers each, the producer
// 32): while one consumer's exponentials run, two others' products keep
// the tensor cores busy (`launch.fwd_ablate`'s two_consumers variant
// times D = 64 with two).  At D = 128 the products take twice as long as
// the exponentials, and two consumers of 64 rows suffice (232 registers).
// Tiles are stored as D / AW column chunks of R rows x AW elements, one
// swizzle atom per row (AW * 2 = 32, 64 or 128 bytes, TMA swizzle and
// wgmma layout type alike), 1024-byte aligned.  No atomics on data and no
// split over KV: every row is reduced over its keys in one order fixed by
// the shape, the same bits on every run, whichever block takes its item.
// Control values that steer wgmma (the warpgroup index, the item) are read
// through __shfl_sync so that ptxas sees them warp-uniform, and every
// wgmma sits in straight-line code or a loop: otherwise ptxas serializes
// all of them (C7520).
//
// bfloat16 at 128 < D <= 256 (bf16body: Fwd<256>,
// flash_fwd_bf16_kernel_d256): the bfloat16 body's schedule, work list,
// tickets, turns and arithmetic at D = 256 (a narrower width read in
// place, as above), retiled because the D = 128 layout needs 320 KB
// there: items of 128 query rows, two
// consumers, 80-key K and V tiles in a ring of two, one Q slot (64 KB).
// S = Q K^T is m64n80k16 over 16 k-steps of D, O += P V m64n256k16 with P
// from registers; a consumer's 64 x 256 float32 accumulator takes 128 of
// its 232 registers.  With 80-key tiles up to two tiles of a consumer's
// walk hold keys past its first row, and each such tile is masked.  No
// second Q slot fits, so the next item's Q lands once the item has
// released the slot (its first K and V tiles already land before): O is
// staged in the consumer's own 64 rows of the Q slot (its last S has read
// them) and leaves by TMA store, and the slot is released once both
// consumers' stores have read it.  (`launch.fwd_ablate` times 64-key
// tiles and O written from registers, the slot then released after the
// last S: both slower.)  The same rules as the
// other bodies: no atomics on data, every row reduced over its key tiles
// in one order fixed by the shape, control values through __shfl_sync.
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
// float32 at 128 < D <= 256 (f32wide, run at 256 with a narrower width
// that is a multiple of 4 read in place: the maps' columns past it land
// as zeros): f32body's arithmetic and contract (fmaf and expf, every row
// reduced over its key tiles in one order, no atomics, the optional lse)
// in the bfloat16 bodies' persistent schedule: one block an SM takes
// (batch x head, 64-row query tile) items heaviest first from the ticket
// counter.  One thread of a producer warpgroup (40 registers after
// setmaxnreg, the compute warps 232) loads the item's Q once (TMA, 64 KB,
// resident while the item runs) and 32-key K and V tiles (32 KB each,
// 128 B swizzled) into a ring of two stages, so that the next tiles land
// under the products; eight compute warps own 8 rows each.  On this card a
// warp's 16-byte shared load moves 512 bytes, 4 cycles of shared memory
// whatever it broadcasts, against 4 warp FFMAs a cycle: what bounds a
// CUDA-core product is 16-byte loads per FFMA, so both products are
// register tiles that need few.  S splits D four ways: each thread sums a
// quarter of the dots of 4 rows x 8 keys (12 loads a unit for 128 FFMA),
// and xor shuffles add the quarters and leave it one row x 8 keys for the
// softmax (a row's max and sum over its 4 lanes); P goes to a transposed
// shared tile, and P V gives each thread O for its warp's 8 rows x 8
// columns in registers (64 floats; 4 loads a key for 64 FFMA).  Shared
// memory: 207,456 bytes (f32body's layout, Q and K at pitch D + 1, would
// take 213,760 at D = 256 for one K and V tile and no ring).
//
// float32 and bfloat16 at D > 256 (the cluster forward: Fwd<256> and
// f32wide with CL = true, a narrower width than a whole number of slices
// read in place, D % 8 == 0 at bfloat16 and D % 4 == 0 at float32): no
// body's layout fits a block at D = 512, but only S = Q K^T needs a sum
// over all of D; the softmax's m and l come from S, and O += P V is
// column by column.  So D is cut into n = ceil(D / 256) slices of 256
// columns, and a cluster of C blocks takes each work item
// (clusterbwd::walks: G = ceil(n / 8) walks, C = ceil(n / G) <= 8, the
// portable cluster size; G = 1 and C = n up to D = 2048).  Each walk is
// a launch: in walk g block r runs its dtype's D = 256 body and owns
// slice r + C g (its V tiles, its output columns; a slice past the width
// is neither loaded as V nor stored).  Its S sums over its slices r, r +
// C, r + 2 C, .. below the width, in that order, each slice's Q and K
// tiles those columns (the maps over the whole width, their coordinates
// offset, the columns past D zero-filled) summed in the body's own order;
// at G = 1 that is the one slice and Q stays resident for the item, above
// it the slices' Q and K take turns (bfloat16: in the Q slot and the K
// stage; float32: in two Q slots, the second in the V stages' room, and
// one ring of two stages that carries each tile's K tiles, then its V
// tile): Q is reloaded for each slice of each key tile, S is recomputed
// once a walk, and O for two slices does not fit a consumer's registers.  Then,
// through distributed shared memory, each compute warp stores its lanes'
// partials, arrives on an mbarrier of every other rank and waits for
// theirs (clusterbwd's exchange, as the cluster backward's below), and
// each lane adds the C ranks' partials in ascending rank order: every
// block forms the same m, l and P bits, and computes O for its owned
// columns, which it stores (rank 0 of walk 0 also lse).  At bfloat16 a
// warp's partials go out while P V of the tile before is in flight and
// are summed once it is done (the sums take its A fragments' registers),
// outside the turns, and the exchange's two buffers (80 KB) take the
// second K and V stage's room: one stage.  Rank 0 draws each ticket and
// writes it into every rank's two slots; the launch's last ticket,
// n_items + clusters - 1, puts the counter back to zero.  A cluster
// barrier after the mbarriers are set and another before any block
// exits; the grid is C x min(items, the clusters the card holds at once)
// (cudaLaunchKernelEx).  No product is added, and no tile but the
// exchange buffers.  The walks' instantiations (WALKS = true) hold the
// loops over a block's slices; at G = 1 (WALKS = false) they fold away.
//
// Every body can also write lse = m + ln(l) per row (float32, natural
// log), the input of the backward; with a null lse pointer (every serving
// call) nothing else changes.
//
// Layout.  Every body reads q, k, v (and the backward o and dO) in
// place: the last axis contiguous, the batch, head and sequence strides
// any multiples of 16 bytes, passed by the caller (the model's (B, S, H,
// D) tensors seen as (B, H, S, D) views); o, dq, dk and dv are written
// through strides the caller passes too.  lse and Delta are contiguous
// float32 (B, H, S).  The bfloat16 bodies reach the inputs through 4-D
// TMA maps over (D, heads, S, B) with boxes {AW, 1, rows, 1}, so a tile
// lands in shared memory with the same bytes and swizzle as from a
// contiguous array.
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
// What bounds it on the H100: operations, as the forward: FA2's five
// products (S, dP, dv, dk, dq) over the causal pairs.  Every gradient is
// summed in one order fixed by the shape, so two runs give the same bits
// (a sharded step is held bit-equal to the unsharded one).  Two launches
// on the stream: the Delta pass (one warp a row; it also zeroes the
// counters below), then the main pass.
//
// bfloat16, D in {16, 32, 64, 128} (bf16bwd): the five products on the
// tensor cores with wgmma, through the forward's helpers (TMA maps,
// swizzled tiles, shared-memory descriptors, A fragments from registers).
// One persistent block per SM takes work items, (batch x KV head, 128-key
// tile), from a list fixed by the shape, in list order (an atomic counter
// hands them out, so an item is only ever taken by a running block).
// Three roles:
//   - a producer warp loads the item's K and V once and streams the
//     64-query steps' Q and dO tiles (TMA) and lse and Delta (cp.async by
//     its lanes, arriving on the same mbarrier) through a two-slot ring;
//   - two consumer warpgroups own 64 keys each.  A step (one query head
//     of the group, one 64-query tile) computes S^T = K Q^T and
//     dP^T = V dO^T (m64n64, both operands in shared memory), P^T and dS^T
//     in registers, rounded to bfloat16 as the A fragments of
//     dv += P^T dO and dk += dS^T Q (m64nD, Q and dO as MN-major B); dS^T
//     also goes to shared memory, and once both consumers' halves are in,
//     dq's share for the step's 64 queries is dS K over the 128 keys (dS
//     the MN-major A operand from shared memory, K the MN-major B; at
//     D = 128 the consumers split its columns, below that they take the
//     steps in turn).  The share is issued before dv and dk, and handed to
//     the writer while they run; the diagonal tile's last share is
//     finished after them.  The consumers take turns to issue S^T and dP^T
//     (named barriers, as the forward): one consumer's exponentials run
//     under the other's products;
//   - a writer thread adds each share to a float32 dq accumulator in
//     device memory with one bulk reduce-add (cp.reduce.async.bulk) of
//     its 64 x D floats, through two share buffers.
// The adds to one (batch x head, 64-query tile) come in ascending
// key-tile order, enforced by a counter per tile in device memory: key
// tile kt waits until the counter reads kt, adds, and bumps it.  Key tile
// 0 stores instead of adding (no memset); the last one, the diagonal
// tile, reads the sum, adds its own share in registers, scales by
// D^-0.5, rounds to bfloat16 and writes dq (no conversion pass).
// The walk: the list is key-tile-major, key tile 0 of every (batch, KV
// head) first (the heaviest items start first, and the tile a wait points
// at is BKV items earlier in the list, so taken earlier: no wait is on an
// item that is not running or done); inside an item the query tiles run
// from the last one down to the diagonal, the group's heads inner.  So
// every item of a KV head walks the same query tiles in the same order,
// an item only trails the one before it in the add order, and waits are
// those of the first steps (key tile kt starts about kt steps behind key
// tile 0) and of the diagonal tiles, which come last.
//
// bfloat16 at 128 < D <= 256 (widebwd, run at 256 with a narrower width
// that is a multiple of 8 read in place, as the wide forward): the same
// five products, roles, list order, walk and add order, retiled because
// the layout above needs about 416 KB of shared memory at D = 256 and a
// consumer's dk and dv 256 registers a thread.  An item is (batch x KV
// head, 64-key tile); the two consumers split D, not the keys: consumer w
// holds dk and dv of the item's 64 keys for columns 128 w .. + 127 (64 +
// 64 registers).  A step (one query head, 64 queries) has consumer w
// compute S^T and dP^T for queries 32 w .. + 31 (m64n32, 16 k-steps over
// D), P^T and dS^T in float32 registers, rounded to bfloat16 into two
// shared tiles (keys x queries, double-buffered across steps); once both
// halves are in, each consumer issues dq's share for its columns (dS K,
// m64n128), dv += P^T dO and dk += dS^T Q (m64n128, A the shared tile,
// K-major).  Shared memory holds K, V, two Q / dO slots and the four
// tiles: 226 KB, with no room for a buffer of dq's 64 KB share.  So once
// its dv and dk are done each consumer stages its half of the share, in
// float32, in the columns of the step's Q and dO tiles that only its own
// dv and dk read; the producer warp, before it loads that slot again,
// adds the share to the float32 accumulator in device memory with four
// bulk reduce-adds (a bulk store at key tile 0), under a counter per
// (batch x head, query tile): key tile kt waits until it reads kt, and
// bumps it.  The diagonal tile, the last, is not staged: its consumers
// wait for the counter, add the sum to their share in registers and
// round it into dq.  No turns: at D = 256 a step's products take an SM's
// tensor cores about 2,600 clocks, its 4,096 exponentials 256.
//
// float32, D in {16, 32, 64, 128} (f32bwd; a narrower D zero-padded by
// the caller): the five products on the CUDA cores in float32 (fmaf, expf;
// TF32 tensor cores would keep about three decimal digits), with the
// tensor-core bodies' list order, walk, tickets and dq add order.  What
// bounds it is the FFMA rate (67 TFLOP/s): the five products take 2.6
// MFMA a 64 x 64 step at D = 128, against 64 KB of Q and dO loaded.  An
// item is (batch x KV head, 64-key tile); three warpgroups, the compute
// ones at 232 registers a thread after setmaxnreg, the producer's at 40:
//   - a producer warp loads K and V once an item and each step's Q and dO
//     (TMA, float32 tiles of 32-float rows, 128 B swizzled; 64 B at D =
//     16) and lse and Delta (cp.async) into one slot, and adds the step
//     before's dq share (below) once the step's loads are issued;
//   - group 0 (128 threads) computes S = Q K^T, P = exp(S D^-0.5 - lse)
//     into a shared tile, then dv += P^T dO; group 1 (128 threads) dP =
//     dO V^T, then dS = P (dP - Delta) into a shared tile and its
//     transpose, then dk += dS^T Q; so each thread keeps one of dv, dk in
//     registers (64 floats at D = 128), and sums each step's 64 queries
//     into a tile of its own before adding it (a dv element of yi's shape
//     sums 16,384 terms: two short chains of roundings, not one long
//     one).  Every product is a register
//     micro-tile fed by 16-byte shared loads: S and dP 8 queries x 4 keys
//     a thread, dots over D unit by unit (a query row one address for 8
//     lanes, the 8 lanes' key rows on 8 different swizzled units); dv and
//     dk 8 keys x 8 columns at D = 128; then all 256 threads take dq's
//     share, dS K, 8 queries x 4 columns at D = 128, from the dS^T tile
//     and K.  The P, dS and dS^T tiles have padded rows (72 and 68 floats)
//     so that their scalar stores hit 32 banks.
// The slot is released once dv and dk have read it, so the next step's Q
// and dO land while the share is computed; the share goes to the
// producer through a float32 buffer in shared memory (64 x D, in the dq
// threads' order), and it adds it to dq's accumulator with one bulk
// reduce-add (a bulk store at key tile 0) under the counter per (batch x
// head, query tile), as above.  The diagonal tile's share is not staged:
// the compute threads wait for the counter, add the sum to the share in
// registers, scale and write dq.  Shared memory: 219,712 bytes at D = 128
// (two Q / dO slots would need 64 KB more).
//
// float32 at 128 < D <= 256 (f32widebwd, run at 256 with a narrower width
// that is a multiple of 4 read in place): f32bwd retiled, since its
// layout needs 256 KB of operand tiles and 64 KB of share at D = 256.
// Items of 32 keys and steps of 32 queries: K, V, Q and dO take 32 KB
// each, dq's share 32 KB, 179,008 bytes in all; each compute thread keeps
// dv or dk for 8 keys x 8 columns (64 floats, as f32bwd at D = 128).  The
// same roles, list order, walk, tickets, counters, dq add order and fmaf
// sums, but S and dP split D four ways as f32wide's S (a quarter of the
// dots of 4 queries x 8 keys a thread, the quarters added by xor
// shuffles); dq's share is 8 queries x 4 columns a thread.
//
// float32 and bfloat16 at D > 256 (the cluster backward: widebwd and
// f32widebwd with CL = true, a narrower width than a whole number of
// slices read in place, D % 8 == 0 at bfloat16 and D % 4 == 0 at
// float32): no body's layout fits a block at D = 512, but only S and dP
// need a sum over all of D; dv, dk and dq are column by column.  So D is
// cut into 256-column slices and a cluster of C blocks takes one item in
// each of G walks, as the forward (clusterbwd::walks): in walk g block r
// runs the D = 256 body and owns slice r + C g: its K and V tiles, loaded
// once an item, and each step's Q and dO tiles are that slice's columns
// (the maps over the whole width, their coordinates offset, the columns
// past D zero-filled).  Its S and dP sum first over its other slices r +
// C j below the width in ascending order (above 2048 only: each slice's K
// and Q, then V and dO, through the step's Q / dO slot, so S and dP are
// recomputed once a walk) and then over the owned one, in the body's own
// order, and then, through distributed shared memory, each compute warp
// stores its lanes' partials, arrives on an mbarrier of every other rank
// (release, cluster scope) and waits for theirs on its own, and each lane
// adds the C ranks' partials of its fragment in ascending rank order, so
// every block forms the same P and dS bits (a warp reads back exactly the
// units its counterparts wrote: a warp's wait is enough, and the
// producers, which never exchange, are not held; two buffers, since a
// rank writes one again only after every other rank's next arrival, made
// after its reads).  dv, dk and dq's share are then the owned slice's,
// dq's added to the slice's own accumulator under the slice's own
// counters (a region of each a slice, C G of them: a slice past the
// width adds nothing and stores nothing, and its counters still count),
// in key-tile order as at D = 256.  Rank 0 draws each ticket and writes
// it into every rank's shared memory (two slots), so the blocks of a
// cluster walk the same items and steps, and the same exchanges, to the
// end; each walk has its own ticket counter, zeroed with the others by
// the Delta pass, which runs once.  A cluster barrier after the mbarriers
// are set and another before any block exits.  The grid is C x min(items,
// the clusters the card holds at once) (cudaLaunchKernelEx with the
// cluster dimension: C is known at run time), so every item a counter
// wait points at has a resident cluster: a walk's waits are on its own
// earlier items.  At bfloat16 the exchange's two buffers (64 KB) take the
// second Q / dO slot's room: one slot.  No product is added, and no tile
// but the exchange buffers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <tuple>

#include "common.cuh"

namespace {

// Element strides of a (B, heads, S, D) operand whose last axis is
// contiguous: batch, head, row.
struct Lay {
  long long b, h, s;
};

// the start of head h of batch b
template <typename T>
__device__ __forceinline__ T* at(T* p, const Lay& l, int b, int h) {
  return p + b * l.b + h * l.h;
}

// element loads in float32 arithmetic, for the Delta pass, which takes
// either dtype
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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
                 float* __restrict__ lse, Lay lq, Lay lk, Lay lv, Lay lo,
                 int H, int KV, int S, float scale) {
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
  const int kvh = h / (H / KV);
  const float* qp = at(q, lq, b, h);
  const float* kp = at(k, lk, b, kvh);
  const float* vp = at(v, lv, b, kvh);
  float* op = at(o, lo, b, h);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    Qs[r * DS + c] = q0 + r < S ? qp[(q0 + r) * lq.s + c] : 0.f;
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
      Ks[r * DS + c] = in ? kp[(k0 + r) * lk.s + c] : 0.f;
      Vs[r * D + c] = in ? vp[(k0 + r) * lv.s + c] : 0.f;
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
        op[r * lo.s + tx + 16 * c] = acc[i][c] / den;
      if (lse != nullptr && tx == 0) lse[(size_t)bh * S + r] = m[i] + logf(den);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Lay* ly, int B, int H, int KV, int S, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, ly[0], ly[1],
      ly[2], ly[3], H, KV, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32body

namespace bf16body {

constexpr int BK = 128;            // keys per KV tile
constexpr float NEG = -1e30f;      // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A tile of R rows x D bfloat16 as NC chunks of R rows x AW elements (one
// swizzle atom a row), each chunk a multiple of 1024 bytes.
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
  // byte `off` of a chunk as TMA and wgmma swizzle it: the 16-byte unit
  // XOR the row's low bits (every 8 rows of 128 B, 4 of 64, 2 of 32)
  static __device__ __forceinline__ uint32_t swizzle(uint32_t off) {
    return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
  }
};

// The forward's tiling for head dim D: a work item is BQ query rows of one
// (batch x head), CONSUMERS warpgroups of 64 rows each, against key tiles
// of BK; one producer warpgroup.  Shared memory: QSLOTS Q tiles (the next
// item's Q lands while this one runs), a ring of STAGES K and V tiles,
// each consumer's 64 x D output staged for the TMA store, the Q slots'
// items, the mbarriers.  At D = 128: 64 + 64 + 64 + 32 KB and 1,136 B:
// 230,512 bytes of the 232,448 a block may take.
template <int D>
struct Fwd {
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr int STAGES = 2;
  static constexpr int QSLOTS = 2;
  static constexpr int BQ = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  // registers a thread after setmaxnreg (65,536 an SM): the producer's
  // warpgroup gives up what the consumers take
  static constexpr int PRODUCER_REGS = CONSUMERS == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 232;
  using GQ = Geo<D, BQ>;
  using GK = Geo<D, BK>;
  using GO = Geo<D, 64>;
  static constexpr uint32_t K_OFF = QSLOTS * GQ::TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * GK::TILE;
  static constexpr uint32_t O_OFF = V_OFF + STAGES * GK::TILE;
  static constexpr uint32_t ITEM_OFF = O_OFF + CONSUMERS * GO::TILE;
  static constexpr uint32_t BAR_OFF = ITEM_OFF + 16;
  // + the barriers (per Q slot full and empty; per stage K and V full and
  // empty), + room to align the base to 1024 bytes
  static constexpr size_t SMEM =
      BAR_OFF + 8 * (2 * QSLOTS + 4 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <=
                    65536,
                "more registers than an SM has");
};

// The wide body's tiling (bfloat16, 128 < D <= 256, run at 256; a
// narrower width is read in place): a work item is BQ = 128 query rows of
// one (batch x head), two consumer warpgroups of 64 rows each, against key
// tiles of BK keys; one producer warpgroup.  At D = 256 a 128-row Q tile
// is 64 KB and an 80-key K or V tile 40 KB (64 keys: 32 KB), so shared
// memory holds one Q slot and a ring of two K and two V tiles: 224 KB
// (192 KB) of the 232,448 bytes a block may take.  No second Q slot and
// no staging tiles of O fit: the next item's Q lands once this item has
// released the slot, and O leaves through the consumer's own 64 rows of
// the Q slot and a TMA store, the slot released once the stores have read
// it.  `launch.fwd_ablate` chose 80-key tiles and staged O (its wide_bk64
// variant and its wide_o_regs one, O from registers with the slot
// released after the consumers' last S, are slower); the turns, as the
// bfloat16 body's, neither pay nor cost there (wide_no_turns).
// Registers: a consumer's 64 x 256 float32 accumulator takes 128 a
// thread, the 64 x BK scores and P's bf16 fragments come on top: 232,
// the producer 40.  setmaxnreg.inc takes only what the block's other
// warpgroups gave back of the 168 a thread it was launched with (384
// threads), so the consumers' increase must not exceed the producer's
// decrease, or they wait for ever.
template <>
struct Fwd<256> {
  static constexpr int BK = 80;              // keys per K and V tile
  static constexpr int CONSUMERS = 2;        // of 64 query rows each
  static constexpr int STAGES = 2;           // K and V tiles in the ring
  static constexpr int BQ = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  using GQ = Geo<256, BQ>;
  using GK = Geo<256, BK>;
  static constexpr uint32_t K_OFF = GQ::TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * GK::TILE;
  static constexpr uint32_t ITEM_OFF = V_OFF + STAGES * GK::TILE;
  static constexpr uint32_t BAR_OFF = ITEM_OFF + 16;
  // + the barriers (Q full and empty; per stage K and V full and empty),
  // + room to align the base to 1024 bytes
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
  static_assert(BK % 16 == 0 && (BK == 64 || BK == 80),
                "S = Q K^T is m64n64k16 or m64n80k16");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <=
                    65536 / THREADS / 8 * 8 * THREADS,
                "more registers than the block was launched with");
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

// one box {AW, 1, rows, 1} at (column c, head h, row r, batch b) of a
// 4-D map over (D, heads, S, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int h, int r,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(h),
      "r"(r), "r"(b)
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

// bar.sync on named barrier `id` for n threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// order this thread's generic accesses to shared memory against the
// async proxy (TMA, wgmma operands)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, float x, float y,
                                          float z, float u) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(x),
               "f"(y), "f"(z), "f"(u)
               : "memory");
}

// one box {AW, 1, rows, 1} from shared memory at src to (column c, head
// h, row r, batch b) of a 4-D map over (D, heads, S, B); the parts of the
// box past the map's dims are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c, int h, int r,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(h), "r"(r), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// wait until this thread's committed bulk stores have read their shared
// memory (read_only) or are complete
template <bool read_only>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (read_only)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// D[64 x 120] += A[64 x 16] . B[16 x 120], A in registers, B MN-major
// (the P V product at h2o-danube's head dim: 15 of the 16 column groups
// of the D = 128 tile)
__device__ __forceinline__ void wgmma_rs_n120(float (&d)[60],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
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
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

// D[64 x 80] (+)= A[64 x 16] . B[16 x 80], both operands in shared memory
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S of the wide body's key tile: D[64 x N] (+)= A . B, both operands in
// shared memory, N = 64 or 80 keys
template <int N>
__device__ __forceinline__ void wgmma_ss_keys(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (N == 80) wgmma_ss_n80(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 120) wgmma_rs_n120(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Work item `item` of the forward's list: (batch b, head h, query tile
// qt).  The last query tiles (the most keys) come first; inside a tile the
// (batch, head) pairs in order, so a GQA group's query heads sit next to
// each other and read their KV head's tiles from L2.
__device__ __forceinline__ void work_item(int item, int B, int H, int n_qt,
                                          int& b, int& h, int& qt) {
  const int bh = item % (B * H);
  qt = n_qt - 1 - item / (B * H);
  b = bh / H;
  h = bh % H;
}

// W: the operands' width, D (the body's own), a narrower one fixed at
// compile time (h2o-danube's 120 on the D = 128 body: its P V product and
// accumulator take 120 columns), or 0 for the runtime width of the maps
// (any other multiple of 8 below D; the store map's width drops the rest).
// `work`: the ticket counter, zero at the launch and left zero.
template <int D, int W>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      float* __restrict__ lse, int* work, int B, int H,
                      int KV, int S, float scale_log2) {
  using F = Fwd<D>;
  using GQ = typename F::GQ;
  using GK = typename F::GK;
  using GO = typename F::GO;
  constexpr int NCONS = F::CONSUMERS, STAGES = F::STAGES;
  constexpr int QSLOTS = F::QSLOTS, BQ = F::BQ;
  // P V's output width: a narrower W fixed at compile time needs only its
  // own columns (m64nWk16); a runtime width computes all D
  constexpr int N = W > 0 ? W : D;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  volatile int* item_s = reinterpret_cast<volatile int*>(
      smem_raw + (base - smem_u32(smem_raw)) + F::ITEM_OFF);
  const uint32_t bar = base + F::BAR_OFF;
  // mbarriers: per Q slot full and empty; per stage K full, V full, K
  // empty and V empty (K is released as soon as S is computed, V after
  // P V, Q after the item's last S)
  const uint32_t full_q = bar, empty_q = full_q + 8 * QSLOTS,
                 full_k = empty_q + 8 * QSLOTS,
                 full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = empty_k + 8 * STAGES;

  const int G = H / KV;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QSLOTS; ++i) {
      mbar_init(full_q + 8 * i, 1);
      mbar_init(empty_q + 8 * i, 128 * NCONS);   // every consumer thread
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 128 * NCONS);
      mbar_init(empty_v + 8 * s, 128 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread takes the items and starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     F::PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == 0) {
      int j = 0;                                 // K, V tiles loaded so far
      for (int n = 0;; ++n) {
        // items in list order: the last query tiles (the most keys) first,
        // the heads of a GQA group next to each other
        const int item = atomicAdd(work, 1);
        const int qs = n % QSLOTS;
        mbar_wait(empty_q + 8 * qs, ((n / QSLOTS) & 1) ^ 1);
        if (item >= n_items) {
          // the last ticket of the launch puts the counter back to zero
          if (item == n_items + (int)gridDim.x - 1) atomicExch(work, 0);
          item_s[qs] = -1;
          mbar_arrive(full_q + 8 * qs);
          break;
        }
        int b, h, qt;
        work_item(item, B, H, n_qt, b, h, qt);
        const int kvh = h / G, q0 = qt * BQ;
        const int n_kv = (min(S, q0 + BQ) + BK - 1) / BK;
        item_s[qs] = item;
        mbar_expect_tx(full_q + 8 * qs, GQ::TILE);
        for (int c = 0; c < GQ::NC; ++c)
          tma_load(base + qs * GQ::TILE + c * GQ::CHUNK, &tq, full_q + 8 * qs,
                   c * GQ::AW, h, q0, b);
        for (int t = 0; t < n_kv; ++t, ++j) {
          const int s = j % STAGES;
          const uint32_t parity = ((j / STAGES) & 1) ^ 1;
          const uint32_t ks = base + F::K_OFF + s * GK::TILE;
          const uint32_t vs = base + F::V_OFF + s * GK::TILE;
          mbar_wait(empty_k + 8 * s, parity);
          mbar_expect_tx(full_k + 8 * s, GK::TILE);
          for (int c = 0; c < GK::NC; ++c)
            tma_load(ks + c * GK::CHUNK, &tk, full_k + 8 * s, c * GK::AW, kvh,
                     t * BK, b);
          mbar_wait(empty_v + 8 * s, parity);
          mbar_expect_tx(full_v + 8 * s, GK::TILE);
          for (int c = 0; c < GK::NC; ++c)
            tma_load(vs + c * GK::CHUNK, &tv, full_v + 8 * s, c * GK::AW, kvh,
                     t * BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     F::CONSUMER_REGS)
                 : "memory");
    // which 64 rows of an item; read through a shuffle, as the item below,
    // so that ptxas sees a warp-uniform value: a branch around wgmma on a
    // value it takes to be divergent serializes every wgmma of the kernel
    // (C7520)
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int tid = threadIdx.x % 128;
    // accumulator fragment: this thread holds rows r0 and r0 + 8 (h = 0, 1)
    // of the consumer's 64 at columns 8 j + c0 + {0, 1}: element
    // [4 j + 2 h + {0, 1}]
    const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    const uint32_t ob = base + F::O_OFF + w * GO::TILE;   // O staging

    float m[2], l[2], alpha[2];
    float acc[N / 2];
    float s[64];
    uint32_t p[32];

    // S = Q K^T of the tile in ring slot `slot` into s (one batch, not
    // committed)
    auto qk = [&](uint32_t qa, int slot) {
      const uint32_t ks = base + F::K_OFF + slot * GK::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % GK::AW) * 2;
        wgmma_ss_n128(s,
                      sdesc(qa + (kk * 16 / GQ::AW) * GQ::CHUNK + col, 16,
                            GQ::SBO, GQ::LAYOUT),
                      sdesc(ks + (kk * 16 / GK::AW) * GK::CHUNK + col, 16,
                            GK::SBO, GK::LAYOUT),
                      kk > 0);
      }
    };
    // O += P V of the tile in ring slot `slot` (one batch, not committed)
    auto pv = [&](int slot) {
      const uint32_t vs = base + F::V_OFF + slot * GK::TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<N>(acc, a,
                    sdesc(vs + kk * 16 * GK::ROW, GK::CHUNK, GK::SBO,
                          GK::LAYOUT));
      }
    };
    // online softmax of a tile's scores: m (log2 domain) and l updated, s
    // holds exp2(s * scale - m), alpha the rescale of earlier tiles.
    // `masked`: the consumer's last tile, where key 8 j + c0 + e of the
    // tile is masked above row dq + r0 (+ 8) of it
    auto softmax = [&](bool masked, int dq) {
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + c0 + (e & 1) > dq + r0 + 8 * (e >> 1))
              s[4 * j + e] = NEG;
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
      for (int i = 0; i < N / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          p[2 * j + h] = pack_bf16(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
    };
    // one turn on the tensor cores: wait for named barrier 1 + w, start
    // this consumer's products, hand the turn to the next consumer
    auto turn = [&](auto&& issue) {
      pin(acc);
      pin(p);
      bar_sync(1 + w);
      wgmma_fence();
      issue();
      bar_arrive(1 + (w + 1) % NCONS);
    };
    int j = 0;                                 // K, V tiles consumed so far
    auto slot = [&](int t) { return (j + t) % STAGES; };
    auto phase = [&](int t) { return (uint32_t)(((j + t) / STAGES) & 1); };

    // the epilogue of an item whose first row is row0 (none at row0 >= S):
    // O / l rounded to bf16 into this consumer's staging tile (the TMA
    // store's swizzled layout), then one TMA store a chunk that runs while
    // the next products do; the store map's dims drop rows past S and
    // columns past the width
    auto epilogue = [&](int b, int h, int row0) {
      if (row0 >= S) return;
      float den[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
        den[h2] = fmaxf(l[h2], 1e-30f);
      }
      if (tid == 0) bulk_wait<true>();         // the last store has read it
      named_sync(1 + NCONS + w, 128);
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + c0;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          st_shared(ob + (col / GO::AW) * GO::CHUNK +
                        GO::swizzle((r0 + 8 * h2) * GO::ROW +
                                    (col % GO::AW) * 2),
                    pack_bf16(acc[4 * jj + 2 * h2] / den[h2],
                              acc[4 * jj + 2 * h2 + 1] / den[h2]));
      }
      fence_async_smem();
      named_sync(1 + NCONS + w, 128);
      if (tid == 0) {
        for (int c = 0; c < GO::NC; ++c)
          tma_store(&to, ob + c * GO::CHUNK, c * GO::AW, h, row0, b);
        bulk_commit();
      }
      // m is in the log2 domain: lse = ln(2^m l)
      if (lse != nullptr && c0 == 0) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = row0 + r0 + 8 * h2;
          if (row < S)
            lse[((size_t)b * H + h) * S + row] =
                (m[h2] + log2f(den[h2])) * LN2;
        }
      }
    };

    // The consumers take turns on the tensor cores (named barrier 1 + w,
    // handed on in a cycle, across items), n_kv turns an item each.  A
    // consumer walks the key tiles 0 .. last that its rows see: each turn
    // starts S of tile t and P V of tile t - 1 together, then runs tile
    // t's softmax while the others start their products, and P V of tile
    // t - 1 runs under this softmax.  P V of an item's last tile goes out
    // with S of the next item's first tile, and the item's epilogue runs
    // under that S.  The turns past its last tile pass empty, releasing
    // the tiles it does not read.  A consumer with no row below S computes
    // its first S and P V all the same (never stored).  Every wgmma sits
    // in straight-line code or a loop: ptxas serializes wgmma issued on
    // paths that differ in what is in flight.
    int pv_slot = 0;                 // the pending P V's V slot and phase
    uint32_t pv_phase = 0;
    bool pv_real = false;            // false: none yet, or a discarded one
    int pb = 0, ph = 0, prow0 = S;   // the pending item's batch, head, row
    if (w == NCONS - 1) bar_arrive(1);         // consumer 0 goes first
    for (int n = 0;; ++n) {
      const int qs = n % QSLOTS;
      mbar_wait(full_q + 8 * qs, (n / QSLOTS) & 1);
      const int item = __shfl_sync(0xffffffffu, item_s[qs], 0);
      if (item < 0) break;
      int b, h, qt;
      work_item(item, B, H, n_qt, b, h, qt);
      const int q0 = qt * BQ;
      const int n_kv = (min(S, q0 + BQ) + BK - 1) / BK;
      const int row0 = q0 + 64 * w;            // this consumer's first row
      const uint32_t qa = base + qs * GQ::TILE + w * 64 * GQ::ROW;
      // the last key tile its rows below S see (0 if none is below S) and
      // its first key's offset from the first row (0 or 64); the rows see
      // every key of the earlier tiles
      const bool walks = row0 < S;
      const int last = walks ? min(S - 1, row0 + 63) / BK : 0;
      const int dq = row0 - last * BK;

      // turn 0: the pending P V, and S of tile 0
      mbar_wait(full_k + 8 * slot(0), phase(0));
      if (pv_real) mbar_wait(full_v + 8 * pv_slot, pv_phase);
      turn([&] {
        pv(pv_slot);
        wgmma_commit();
        qk(qa, slot(0));
        wgmma_commit();
      });
      wgmma_wait<1>();                         // the pending P V
      pin(acc);
      if (pv_real) mbar_arrive(empty_v + 8 * pv_slot);
      epilogue(pb, ph, prow0);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        m[h2] = NEG;
        l[h2] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      wgmma_wait<0>();                         // S of tile 0
      pin(s);
      mbar_arrive(empty_k + 8 * slot(0));
      if (last == 0) mbar_arrive(empty_q + 8 * qs);
      if (walks) {
        softmax(last == 0, dq);
        rescale_pack();
      } else {                                 // tile 0's V is not read
        mbar_wait(full_v + 8 * slot(0), phase(0));
        mbar_arrive(empty_v + 8 * slot(0));
      }
      for (int t = 1; t <= last; ++t) {
        mbar_wait(full_k + 8 * slot(t), phase(t));
        mbar_wait(full_v + 8 * slot(t - 1), phase(t - 1));
        turn([&] {
          qk(qa, slot(t));
          wgmma_commit();
          pv(slot(t - 1));
          wgmma_commit();
        });
        wgmma_wait<1>();                       // S of tile t
        pin(s);
        mbar_arrive(empty_k + 8 * slot(t));
        if (t == last) mbar_arrive(empty_q + 8 * qs);
        softmax(t == last, dq);
        wgmma_wait<0>();                       // P V of tile t - 1
        pin(acc);
        mbar_arrive(empty_v + 8 * slot(t - 1));
        rescale_pack();
      }
      // the turns past the last tile: its K and V are released unread
      // in turn t (never later than the others release theirs)
      for (int t = last + 1; t < n_kv; ++t) {
        mbar_wait(full_k + 8 * slot(t), phase(t));
        mbar_arrive(empty_k + 8 * slot(t));
        bar_sync(1 + w);
        bar_arrive(1 + (w + 1) % NCONS);
        mbar_wait(full_v + 8 * slot(t), phase(t));
        mbar_arrive(empty_v + 8 * slot(t));
      }
      pv_real = walks;
      pv_slot = slot(last);
      pv_phase = phase(last);
      pb = b;
      ph = h;
      prow0 = row0;
      j += n_kv;
    }
    // the last item's pending P V and its epilogue
    if (pv_real) mbar_wait(full_v + 8 * pv_slot, pv_phase);
    turn([&] {
      pv(pv_slot);
      wgmma_commit();
    });
    wgmma_wait<0>();
    pin(acc);
    if (pv_real) mbar_arrive(empty_v + 8 * pv_slot);
    epilogue(pb, ph, prow0);
    if (w == 0) bar_sync(1);                   // the last turn's hand-over
    if (tid == 0) bulk_wait<false>();
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

// a 4-D map over a (B, n heads, S, width) bfloat16 tensor with element
// strides `l` (the last axis contiguous), seen as (width, n, S, B), for
// the body of head dim D >= width; boxes of {AW, 1, rows, 1}: rows past S
// read as zeros, never the next head's, and so do columns width .. D - 1
template <int D>
int make_map(CUtensorMap* map, const void* ptr, const Lay& l, int n, int S,
             int B, int rows = 128, int width = D) {
  using G = Geo<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)n,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)l.h * 2, (cuuint64_t)l.s * 2,
                                 (cuuint64_t)l.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::AW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, G::SWIZZLE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The forward's ticket counter for launches on `stream` of the current
// device: one int in device memory, zeroed once, and left zero by every
// launch (the block that takes the last ticket puts it back), so launches
// on one stream share it in turn and no launch needs a memset.  It lives
// as long as the process (one int a device and stream).  The backward
// takes its counters from the caller's scratch instead, because its Delta
// pass runs first and zeroes them for free; the forward has no pass
// before it, and a memset would add a launch to every call, which
// short prompts would feel.  A launch that stops short leaves the counter
// dirty, but it also leaves the context with a sticky error, so no later
// launch runs on it.
int* work_counter(cudaStream_t stream) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, int*> counters;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return nullptr;
  std::lock_guard<std::mutex> lock(mu);
  int*& p = counters[{dev, stream}];
  if (p == nullptr) {
    int* c = nullptr;
    if (cudaMalloc(&c, sizeof(int)) != cudaSuccess) return nullptr;
    if (cudaMemsetAsync(c, 0, sizeof(int), stream) != cudaSuccess) {
      cudaFree(c);
      return nullptr;
    }
    p = c;
  }
  return p;
}

// the current device's SM count, read once a device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

// The schedule of the body of head dim D for B x H heads of S rows: its
// work items, (batch x head, query tile of BQ rows), and its grid, one
// persistent block an SM (fewer if there are fewer items).  `launch` and
// flash_attention_fwd_info both take it from here.
template <int D>
int schedule(int B, int H, int S, int* items, int* blocks) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int n_items = B * H * ((S + Fwd<D>::BQ - 1) / Fwd<D>::BQ);
  const int grid = n_items < sms ? n_items : sms;     // one block an SM
  *items = n_items;
  *blocks = grid;
  return 0;
}

// the body of head dim D on operands `width` <= D columns wide: the maps
// zero-fill the columns past width, which add exact zeros to every score
// and give output columns that the store map drops.  The persistent
// blocks of `schedule` take the work items in list order from the
// counter.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Lay* ly, int B, int H, int KV, int S, int width,
           float scale, cudaStream_t stream) {
  using F = Fwd<D>;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map<D>(&mq, q, ly[0], H, S, B, F::BQ, width);
  if (err == 0) err = make_map<D>(&mk, k, ly[1], KV, S, B, BK, width);
  if (err == 0) err = make_map<D>(&mv, v, ly[2], KV, S, B, BK, width);
  if (err == 0) err = make_map<D>(&mo, o, ly[3], H, S, B, 64, width);
  if (err != 0) return err;
  int* work = work_counter(stream);
  if (work == nullptr) return (int)cudaErrorMemoryAllocation;
  int n_items = 0, grid = 0;
  err = schedule<D>(B, H, S, &n_items, &grid);
  if (err != 0) return err;
  auto fn = width == D ? flash_fwd_bf16_kernel<D, D>
                       : flash_fwd_bf16_kernel<D, 0>;
  if constexpr (D == 128)
    if (width == 120) fn = flash_fwd_bf16_kernel<128, 120>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, F::THREADS, F::SMEM, stream>>>(
      mq, mk, mv, mo, lse, work, B, H, KV, S, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace bf16body

// What the D = 256 bodies add to run as the cluster forward (Fwd<256>,
// f32wide) and the cluster backward (widebwd, f32widebwd) above D = 256
// (see the note at the top of the file): the cluster's rank and size, the
// ticket rank 0 hands to every rank, the exchange of S's (and dP's)
// partial sums through distributed shared memory, and the launch.
namespace clusterbwd {

using bf16body::st_shared;

constexpr int MAX_C = 8;        // blocks a cluster: the portable limit
constexpr int WIDTH = 256;      // columns a block: its body's D
constexpr int XWARPS = 8;       // the compute warps that exchange
constexpr int XUNIT = 512;      // bytes between a lane's 16-byte units

__device__ __forceinline__ int rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ int size() {
  int n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}
// shared address a of this block as the cluster sees it in rank r
__device__ __forceinline__ uint32_t mapa(uint32_t a, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(a), "r"(r));
  return out;
}
// every thread of the cluster that has not exited arrives, then waits
// for the others (release and acquire at cluster scope)
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// an arrival on the mbarrier at cluster address bar (any rank's),
// releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(bar)
               : "memory");
}
// wait until the phase of this block's bar with this parity has
// completed, acquiring what its arrivals released at cluster scope
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ float4 ld4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// The cluster's n-th ticket, called by lane 0 of every rank's producer:
// rank 0 takes it from the counter and writes it into slot n & 1 of every
// rank (slots: two ints), arriving on that rank's mbarrier n & 1 (bars:
// two, count 1); every rank waits there and reads its slot.  One counter
// draw a cluster, so all ranks work on the same item; two slots, because
// rank 0 can draw ticket n + 1 while a rank still reads ticket n (not n +
// 2: rank 0 draws that only after its consumers finished item n, whose
// every step exchanged with every rank).  The forward's producer draws
// ticket n + 1 before its consumers finish item n, but ticket n + 2 only
// after it has waited for the Q slot that item n's epilogue releases: by
// then rank 0's consumers have made item n's exchanges (its first key
// tile's at least), which no rank's consumers reach before that rank's
// producer has read ticket n.
__device__ __forceinline__ int ticket(int* work, uint32_t slots,
                                      uint32_t bars, int n, int C, int r) {
  const uint32_t slot = slots + 4 * (n & 1), bar = bars + 8 * (n & 1);
  if (r == 0) {
    const int item = atomicAdd(work, 1);
    for (int p = 0; p < C; ++p) {
      asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(mapa(slot, p)),
                   "r"(item)
                   : "memory");
      arrive(mapa(bar, p));
    }
  }
  wait(bar, (n >> 1) & 1);
  int item;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(item) : "r"(slot) : "memory");
  return item;
}

// The exchange of one warp's partial sums at step `it`.  Lane l's N
// partials (N % 4 == 0) go to this block's buffer (it & 1) at a, N / 4
// 16-byte units XUNIT bytes apart (a warp's lanes side by side, no bank
// conflict); once the warp's stores are in (__syncwarp), lane 0 arrives on
// the warp's mbarrier (it & 1) of every other rank (count C - 1), and the
// warp waits for theirs on its own.  Then each lane reads the same units
// of every rank, its own included, and adds them in ascending rank order,
// ((s0 + s1) + s2) + ...: every rank forms the same bits.  Two buffers:
// a rank writes buffer (it & 1) again at step it + 2, after the arrivals
// of step it + 1, which every other rank makes after its reads of step
// it.
template <int N>
__device__ __forceinline__ void put(const float (&x)[N], uint32_t a) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    st_shared(a + j * XUNIT, x[4 * j], x[4 * j + 1], x[4 * j + 2],
              x[4 * j + 3]);
}
__device__ __forceinline__ void signal(uint32_t bar, int C, int r) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int p = 0; p < C; ++p)
      if (p != r) arrive(mapa(bar, p));
}
__device__ __forceinline__ void gather(uint32_t bar, int it) {
  wait(bar, (it >> 1) & 1);
}
template <int N>
__device__ __forceinline__ void sum(float (&x)[N], uint32_t a, int C) {
  float t[N];
  for (int p = 0; p < C; ++p) {
    const uint32_t ra = mapa(a, p);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 v = ld4(ra + j * XUNIT);
      t[4 * j] = v.x;
      t[4 * j + 1] = v.y;
      t[4 * j + 2] = v.z;
      t[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p == 0 ? t[i] : x[i] + t[i];
  }
}
// f32widebwd's exchange: a group's S or dP, 8 partials a lane
__device__ __forceinline__ void exchange(float (&x)[8], uint32_t a,
                                         uint32_t bar, int it, int C, int r) {
  put(x, a);
  signal(bar, C, r);
  gather(bar, it);
  sum(x, a, C);
}
// widebwd's: a consumer's S^T and dP^T fragments, 16 partials each
__device__ __forceinline__ void exchange(float (&x)[16], float (&y)[16],
                                         uint32_t a, uint32_t bar, int it,
                                         int C, int r) {
  put(x, a);
  put(y, a + 4 * XUNIT);
  signal(bar, C, r);
  gather(bar, it);
  sum(x, a, C);
  sum(y, a + 4 * XUNIT, C);
}

// The clusters of C blocks of `fn` (its dynamic shared memory set) that
// the current device holds at once; 0 if it cannot hold one.  Read once a
// device, kernel and C.
inline int max_clusters(const void* fn, int C, size_t smem, int threads) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> seen;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, fn, C);
  auto hit = seen.find(key);
  if (hit != seen.end()) return hit->second;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  seen[key] = n;
  return n;
}

// The slices and walks of operands `width` > 256 wide: n = ceil(width /
// 256) slices of 256 columns, G = ceil(n / MAX_C) walks (launches), C =
// ceil(n / G) <= MAX_C blocks a cluster; in walk g block r owns slice r +
// C g (none past the width is stored) and sums S (and dP) over its slices
// r, r + C, .., those below the width.  G = 1 up to 2048.
inline int walks(int width, int* C, int* G, int* n) {
  *n = (width + WIDTH - 1) / WIDTH;
  if (*n < 2) return (int)cudaErrorInvalidValue;
  *G = (*n + MAX_C - 1) / MAX_C;
  *C = (*n + *G - 1) / *G;
  return 0;
}

// In a walk, the slices of block `rank` of a cluster of C below the
// width (`slices` of them): rank + C j for j < ns; and those but the
// block's own in walk `walk` (the backward's other slices)
__device__ __forceinline__ int slices_of(int slices, int rank, int C) {
  return (slices - rank + C - 1) / C;
}
__device__ __forceinline__ int others(int slices, int rank, int C, int walk) {
  const int ns = slices_of(slices, rank, C);
  return ns - (walk < ns ? 1 : 0);
}

// The cluster schedule: C blocks a cluster and G walks (`walks`), one
// cluster per item up to what the device holds at once, so that every
// item a dq counter wait points at has been taken by a resident cluster
// (each walk is a launch of its own, and waits only on its own items).
inline int schedule(const void* fn, size_t smem, int threads, int n_items,
                    int width, int* C, int* G, int* clusters) {
  int n = 0;
  const int w = walks(width, C, G, &n);
  if (w != 0) return w;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int most = max_clusters(fn, *C, smem, threads);
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  *clusters = n_items < most ? n_items : most;
  return 0;
}

// launch fn on `clusters` clusters of C blocks
template <typename... Params, typename... Args>
int launch(void (*fn)(Params...), int C, int clusters, int threads,
           size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace clusterbwd

namespace bf16body {

// The wide body's (Fwd<256>'s) shared memory in each instantiation: CL =
// false, Fwd<256>'s own layout; CL = true, the cluster forward's (a
// 256-column slice of D > 256 a block; see the note at the top of
// the file), which has one K and V stage: the second stage's 80 KB hold the
// exchange of S's partials, two buffers of 8 warps x 10 16-byte units x 32
// lanes (a tile's 128 x 80 float32 partials, 40 KB each), beside the two
// ticket slots and 18 more mbarriers (the 16 warps' exchanges, the two
// tickets): 230,624 bytes.
template <bool CL>
struct WideL {
  using F = Fwd<256>;
  static constexpr int STAGES = CL ? 1 : F::STAGES;  // K and V tiles
  // a lane's partial S of a tile, F::BK / 2 floats, in 16-byte units;
  // above two ranks XSUM of them summed over the ranks at a time
  // (clusterbwd::sum; 8 or more at a time spill at 232 registers)
  static constexpr int XUNITS = F::BK / 8;
  static constexpr int XSUM = 4;
  static constexpr uint32_t XBUF =
      clusterbwd::XWARPS * XUNITS * clusterbwd::XUNIT;
  static constexpr uint32_t K_OFF = F::GQ::TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * F::GK::TILE;
  static constexpr uint32_t X_OFF = V_OFF + STAGES * F::GK::TILE;
  static constexpr uint32_t ITEM_OFF = X_OFF + (CL ? 2 * XBUF : 0);
  static constexpr uint32_t TICK_OFF = ITEM_OFF + 16;
  static constexpr uint32_t BAR_OFF = TICK_OFF + (CL ? 16 : 0);
  static constexpr size_t SMEM =
      BAR_OFF +
      8 * (2 + 4 * STAGES + (CL ? 2 * clusterbwd::XWARPS + 2 : 0)) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
  static_assert((F::BK / 2) % XSUM == 0 && XSUM % 4 == 0,
                "the partials summed in whole 16-byte units");
  static_assert(CL || (V_OFF == F::V_OFF && ITEM_OFF == F::ITEM_OFF &&
                       BAR_OFF == F::BAR_OFF && SMEM == F::SMEM),
                "CL = false is Fwd<256>'s own layout");
};

// The wide body (Fwd<256>; see the note at the top of the file): the
// bfloat16 body's persistent schedule, work list, ticket counter, turns
// and arithmetic, with one Q slot.  The maps hold the operands' real
// width (a multiple of 8, at most 256): they zero-fill the columns past
// it, and the store map `to` drops them.
// CL: the cluster forward, block `rank` of a cluster of C on columns 256
// rank .. 256 rank + 255 of operands 256 < width <= 2048 wide (above,
// the walks, below): the maps'
// coordinates start there (the columns past the width zero-filled, and
// not stored), rank 0 draws the tickets for the cluster (and leaves the
// counter at zero), every tile's S is summed over the ranks before the
// softmax (each warp's partials through distributed shared memory, sent
// while P V of the tile before runs and summed in rank order after it),
// and rank 0 writes lse.
// WALKS (above 2048: `slices` = ceil(width / 256) > 8): walk `walk` of
// clusterbwd::walks, block `rank` owning slice rank + C walk: per key tile
// each of its slices below the width in turn, slice rank + C jj's Q and K
// through the Q slot and the K stage, S summed over them (one turn each,
// the first also P V of the tile before), then the exchange and the
// softmax as above, V of the owned slice; the item's last Q stays for the
// epilogue.  (WALKS = false is the same kernel at one walk, whose loops
// over a block's slices fold away.)
template <bool CL, bool WALKS = false>
__global__ void __launch_bounds__(Fwd<256>::THREADS, 1)
flash_fwd_bf16_kernel_d256(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           float* __restrict__ lse, int* work, int B, int H,
                           int KV, int S, float scale_log2, int walk,
                           int slices) {
  using F = Fwd<256>;
  using L = WideL<CL>;
  using GQ = F::GQ;
  using GK = F::GK;
  constexpr int D = 256, KT = F::BK, NCONS = F::CONSUMERS;
  constexpr int STAGES = L::STAGES;
  static_assert(!WALKS || (CL && STAGES == 1), "walks: the cluster body");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  volatile int* item_s = reinterpret_cast<volatile int*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::ITEM_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  // mbarriers: Q full and empty; per stage K full, V full, K empty and V
  // empty (K is released as soon as S is computed, V after P V); CL: per
  // exchange buffer and compute warp the other ranks' arrivals, and the
  // two tickets'
  const uint32_t full_q = bar, empty_q = bar + 8, full_k = bar + 16,
                 full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = empty_k + 8 * STAGES;
  const uint32_t xin = empty_v + 8 * STAGES,
                 tick = xin + 16 * clusterbwd::XWARPS;

  const int G = H / KV;
  const int n_qt = (S + F::BQ - 1) / F::BQ;
  const int n_items = B * H * n_qt;
  int C = 1, rank = 0;
  if constexpr (CL) {
    C = clusterbwd::size();
    rank = clusterbwd::rank();
    if (rank != 0) lse = nullptr;              // rank 0 writes lse
  }
  // the owned slice's first column; WALKS: the block's slices below the
  // width, rank + C jj for jj < ns
  const int col0 = (WALKS ? rank + C * walk : rank) * D;
  const int ns = WALKS ? clusterbwd::slices_of(slices, rank, C) : 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    // each consumer's storing thread once its store has read the slot
    // (WALKS: every consumer thread, once it has read the slot)
    mbar_init(empty_q, WALKS ? 128 * NCONS : NCONS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 128 * NCONS);
      mbar_init(empty_v + 8 * s, 128 * NCONS);
    }
    if constexpr (CL) {
      for (int i = 0; i < 2 * clusterbwd::XWARPS; ++i)
        mbar_init(xin + 8 * i, C - 1);
      mbar_init(tick, 1);
      mbar_init(tick + 8, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL) clusterbwd::sync();        // every rank's mbarriers set

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread takes the items and starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     F::PRODUCER_REGS)
                 : "memory");
    if (WALKS && threadIdx.x == 0) {
      // per key tile: K and Q of each of the block's slices (loaded in
      // pairs: one count), then V of the owned one (one stage each)
      int jq = 0, jv = 0;                        // loads so far
      for (int n = 0;; ++n) {
        const int item = clusterbwd::ticket(work, base + L::TICK_OFF, tick,
                                            n, C, rank);
        if (item >= n_items) {
          if (rank == 0 && item == n_items + (int)gridDim.x / C - 1)
            atomicExch(work, 0);
          mbar_wait(empty_q, (jq & 1) ^ 1);
          item_s[0] = -1;
          mbar_arrive(full_q);
          break;
        }
        int b, h, qt;
        work_item(item, B, H, n_qt, b, h, qt);
        const int kvh = h / G, q0 = qt * F::BQ;
        const int n_kv = (min(S, q0 + F::BQ) + KT - 1) / KT;
        for (int t = 0; t < n_kv; ++t, ++jv) {
          for (int jj = 0; jj < ns; ++jj, ++jq) {
            const int col = (rank + C * jj) * D;
            mbar_wait(empty_k, (jq & 1) ^ 1);
            mbar_expect_tx(full_k, GK::TILE);
            for (int c = 0; c < GK::NC; ++c)
              tma_load(base + L::K_OFF + c * GK::CHUNK, &tk, full_k,
                       col + c * GK::AW, kvh, t * KT, b);
            mbar_wait(empty_q, (jq & 1) ^ 1);
            if (t == 0 && jj == 0) item_s[0] = item;
            mbar_expect_tx(full_q, GQ::TILE);
            for (int c = 0; c < GQ::NC; ++c)
              tma_load(base + c * GQ::CHUNK, &tq, full_q, col + c * GQ::AW,
                       h, q0, b);
          }
          mbar_wait(empty_v, (jv & 1) ^ 1);
          mbar_expect_tx(full_v, GK::TILE);
          for (int c = 0; c < GK::NC; ++c)
            tma_load(base + L::V_OFF + c * GK::CHUNK, &tv, full_v,
                     col0 + c * GK::AW, kvh, t * KT, b);
        }
      }
    } else if (threadIdx.x == 0) {
      int j = 0;                                 // K, V tiles loaded so far
      for (int n = 0;; ++n) {
        const int item =
            CL ? clusterbwd::ticket(work, base + L::TICK_OFF, tick, n, C,
                                    rank)
               : atomicAdd(work, 1);
        if (item >= n_items) {
          // the last ticket of the launch puts the counter back to zero
          // (CL: a cluster draws one ticket a turn, rank 0 for all)
          if constexpr (CL) {
            if (rank == 0 && item == n_items + (int)gridDim.x / C - 1)
              atomicExch(work, 0);
          } else {
            if (item == n_items + (int)gridDim.x - 1) atomicExch(work, 0);
          }
          mbar_wait(empty_q, (n & 1) ^ 1);
          item_s[0] = -1;
          mbar_arrive(full_q);
          break;
        }
        int b, h, qt;
        work_item(item, B, H, n_qt, b, h, qt);
        const int kvh = h / G, q0 = qt * F::BQ;
        const int n_kv = (min(S, q0 + F::BQ) + KT - 1) / KT;
        // K and V of key tile t into the next ring slot
        auto kv_load = [&](int t) {
          const int s = j % STAGES;
          const uint32_t parity = ((j / STAGES) & 1) ^ 1;
          const uint32_t ks = base + L::K_OFF + s * GK::TILE;
          const uint32_t vs = base + L::V_OFF + s * GK::TILE;
          mbar_wait(empty_k + 8 * s, parity);
          mbar_expect_tx(full_k + 8 * s, GK::TILE);
          for (int c = 0; c < GK::NC; ++c)
            tma_load(ks + c * GK::CHUNK, &tk, full_k + 8 * s,
                     col0 + c * GK::AW, kvh, t * KT, b);
          mbar_wait(empty_v + 8 * s, parity);
          mbar_expect_tx(full_v + 8 * s, GK::TILE);
          for (int c = 0; c < GK::NC; ++c)
            tma_load(vs + c * GK::CHUNK, &tv, full_v + 8 * s,
                     col0 + c * GK::AW, kvh, t * KT, b);
          ++j;
        };
        // the item's first tiles land while the consumers end the last
        // item (their slots are released by its last tiles alone), its Q
        // once the last item has released the one slot
        const int pre = min(n_kv, STAGES);
        for (int t = 0; t < pre; ++t) kv_load(t);
        mbar_wait(empty_q, (n & 1) ^ 1);
        item_s[0] = item;
        mbar_expect_tx(full_q, GQ::TILE);
        for (int c = 0; c < GQ::NC; ++c)
          tma_load(base + c * GQ::CHUNK, &tq, full_q, col0 + c * GQ::AW, h,
                   q0, b);
        for (int t = pre; t < n_kv; ++t) kv_load(t);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     F::CONSUMER_REGS)
                 : "memory");
    // which 64 rows of an item, read through a shuffle (warp-uniform for
    // ptxas: no C7520), as the item below
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int tid = threadIdx.x % 128;
    // accumulator fragment: rows r0 and r0 + 8 (h = 0, 1) of the
    // consumer's 64, columns 8 j + c0 + {0, 1}: element [4 j + 2 h + e]
    const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    // this consumer's 64 rows of the Q slot, in each column chunk
    const uint32_t qa = base + w * 64 * GQ::ROW;

    float m[2], l[2], alpha[2];
    float acc[D / 2];
    float sc[KT / 2];
    uint32_t pk[KT / 4];
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) pk[i] = 0;

    // S = Q K^T of the tile in ring slot `slot` into sc (one batch, not
    // committed): 16 k-steps over D
    auto qk = [&](int slot) {
      const uint32_t ks = base + L::K_OFF + slot * GK::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % GK::AW) * 2;
        const uint64_t da = sdesc(qa + (kk * 16 / GQ::AW) * GQ::CHUNK + col,
                                  16, GQ::SBO, GQ::LAYOUT);
        const uint64_t db = sdesc(ks + (kk * 16 / GK::AW) * GK::CHUNK + col,
                                  16, GK::SBO, GK::LAYOUT);
        wgmma_ss_keys<KT>(sc, da, db, kk > 0);
      }
    };
    // WALKS: S (+)= Q K^T of the block's slice jj, in the Q slot and K
    // stage: added to the slices before it (one batch, not committed)
    auto qk_at = [&](int jj) {
      const uint32_t ks = base + L::K_OFF;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % GK::AW) * 2;
        const uint64_t da = sdesc(qa + (kk * 16 / GQ::AW) * GQ::CHUNK + col,
                                  16, GQ::SBO, GQ::LAYOUT);
        const uint64_t db = sdesc(ks + (kk * 16 / GK::AW) * GK::CHUNK + col,
                                  16, GK::SBO, GK::LAYOUT);
        wgmma_ss_keys<KT>(sc, da, db, jj > 0 || kk > 0);
      }
    };
    // O += P V of the tile in ring slot `slot` (one batch, not committed):
    // m64n256k16, the largest N wgmma has
    auto pv = [&](int slot) {
      const uint32_t vs = base + L::V_OFF + slot * GK::TILE;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                               pk[4 * kk + 3]};
        wgmma_rs_n256(acc, a,
                      sdesc(vs + kk * 16 * GK::ROW, GK::CHUNK, GK::SBO,
                            GK::LAYOUT));
      }
    };
    // the online softmax of a tile's scores, as the bfloat16 body's: m
    // (log2 domain) and l updated, sc holds exp2(s * scale - m), alpha
    // the rescale of earlier tiles.  `masked`: some key of the tile lies
    // past this consumer's first row; key 8 j + c0 + e of the tile is then
    // masked above row `off` + r0 (+ 8) of it (off: the consumer's first
    // row less the tile's first key)
    auto online = [&](bool masked, int off) {
      if (masked) {
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * jj + c0 + (e & 1) > off + r0 + 8 * (e >> 1))
              sc[4 * jj + e] = NEG;
      }
      float mt[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mt[h2] = fmaxf(mt[h2], __shfl_xor_sync(0xffffffffu, mt[h2], 1));
        mt[h2] = fmaxf(mt[h2], __shfl_xor_sync(0xffffffffu, mt[h2], 2));
        const float m_new = fmaxf(m[h2], mt[h2] * scale_log2);
        alpha[h2] = ex2(m[h2] - m_new);
        m[h2] = m_new;
        l[h2] *= alpha[h2];
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
        l[(i >> 1) & 1] += sc[i];
      }
    };
    // rescale O by alpha and round P to the bf16 A fragments of P V:
    // pk[4 kk .. 4 kk + 3] holds keys 16 kk .. 16 kk + 15
    auto rescale_round = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          pk[2 * jj + h2] = pack_bf16(sc[4 * jj + 2 * h2],
                                      sc[4 * jj + 2 * h2 + 1]);
    };
    // one turn on the tensor cores (named barrier 1 + w, handed on to the
    // other consumer)
    auto take_turn = [&](auto&& issue) {
      pin(acc);
      pin(pk);
      bar_sync(1 + w);
      wgmma_fence();
      issue();
      bar_arrive(1 + (w + 1) % NCONS);
    };
    // CL: the sum of a tile's S over the ranks, outside the turns.  This
    // warp's partials (its lanes' KT / 2 floats) go to buffer x & 1, the
    // warp's exchange with the same warp of every rank (clusterbwd::put,
    // signal: `post`, while P V of the tile before runs); once the others'
    // are in (gather), the ranks' sums in rank order (`gather_sum`, after
    // that P V, whose A fragments' registers the sums then have): the
    // other rank's partial added to this one's in a pair, else XSUM of
    // them at a time through clusterbwd::sum.  The same bits in every
    // rank.
    int x = 0;                                 // exchanges so far
    auto xaddr = [&]() {
      const int xw = threadIdx.x / 32 - 4;     // compute warp 0 .. 7
      return base + L::X_OFF + (x & 1) * L::XBUF +
             xw * L::XUNITS * clusterbwd::XUNIT + (threadIdx.x & 31) * 16;
    };
    auto xbar = [&]() {
      return xin + 8 * ((x & 1) * clusterbwd::XWARPS + threadIdx.x / 32 - 4);
    };
    // (the cluster's size and rank read where they are used: registers
    // held across the walk are the consumers' scarcest resource)
    auto post = [&]() {
      clusterbwd::put(sc, xaddr());
      clusterbwd::signal(xbar(), clusterbwd::size(), clusterbwd::rank());
    };
    auto gather_sum = [&]() {
      clusterbwd::gather(xbar(), x);
      const uint32_t a = xaddr();
      const int C = clusterbwd::size();
      if (C == 2) {                            // the pair's sum
        // s0 + s1 == s1 + s0 to the bit: each rank adds the other's
        // partial to its own, still in sc, a 16-byte unit at a time
        const uint32_t ra = clusterbwd::mapa(a, clusterbwd::rank() ^ 1);
#pragma unroll
        for (int u = 0; u < KT / 8; ++u) {
          const float4 v = clusterbwd::ld4(ra + u * clusterbwd::XUNIT);
          sc[4 * u] += v.x;
          sc[4 * u + 1] += v.y;
          sc[4 * u + 2] += v.z;
          sc[4 * u + 3] += v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < KT / 2; i += L::XSUM) {
          float y[L::XSUM];
#pragma unroll
          for (int e = 0; e < L::XSUM; ++e) y[e] = sc[i + e];
          clusterbwd::sum(y, a + i / 4 * clusterbwd::XUNIT, C);
#pragma unroll
          for (int e = 0; e < L::XSUM; ++e) sc[i + e] = y[e];
        }
      }
      ++x;
    };
    int j = 0;                                 // K, V tiles consumed so far
    auto slot = [&](int t) { return (j + t) % STAGES; };
    auto phase = [&](int t) { return (uint32_t)(((j + t) / STAGES) & 1); };

    // O / l of an item whose first row is row0 (none at row0 >= S) in q's
    // dtype, and lse; releases the Q slot, where O is staged
    auto epilogue = [&](int b, int h, int row0) {
      if (row0 >= S) {
        if (WALKS || tid == 0) mbar_arrive(empty_q);
        return;
      }
      float den[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
        den[h2] = fmaxf(l[h2], 1e-30f);
      }
      // into this consumer's own rows of the Q slot (its last S has read
      // them) in the TMA store's swizzled layout, then one store a
      // column chunk; the map drops rows past S and columns past the
      // width.  The slot is released once the stores have read it.
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + c0;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          st_shared(qa + (col / GQ::AW) * GQ::CHUNK +
                        GQ::swizzle((r0 + 8 * h2) * GQ::ROW +
                                    (col % GQ::AW) * 2),
                    pack_bf16(acc[4 * jj + 2 * h2] / den[h2],
                              acc[4 * jj + 2 * h2 + 1] / den[h2]));
      }
      fence_async_smem();
      named_sync(1 + NCONS + w, 128);
      if (tid == 0) {
        if constexpr (WALKS) {                 // the owned slice, if any
          const int own = clusterbwd::rank() + clusterbwd::size() * walk;
          if (own < slices)
            for (int cc = 0; cc < GQ::NC; ++cc)
              tma_store(&to, qa + cc * GQ::CHUNK, own * D + cc * GQ::AW, h,
                        row0, b);
        } else {
          for (int cc = 0; cc < GQ::NC; ++cc)
            tma_store(&to, qa + cc * GQ::CHUNK,
                      (CL ? clusterbwd::rank() * D : 0) + cc * GQ::AW, h,
                      row0, b);
        }
        bulk_commit();
        bulk_wait<true>();
        mbar_arrive(empty_q);
      } else if constexpr (WALKS) {
        mbar_arrive(empty_q);
      }
      // m is in the log2 domain: lse = ln(2^m l)
      if (lse != nullptr && c0 == 0) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = row0 + r0 + 8 * h2;
          if (row < S)
            lse[((size_t)b * H + h) * S + row] =
                (m[h2] + log2f(den[h2])) * LN2;
        }
      }
    };

    // A consumer walks key tiles 0 .. last that its rows below S see:
    // turn 0 starts S of tile 0; turn t starts S of tile t and P V of
    // tile t - 1, then runs tile t's softmax while P V of tile t - 1 and
    // the other consumer's products run.  P V of the last tile follows
    // outside the turns (computed and dropped if no row is below S), then
    // the turns past the last tile, which release their tiles unread, and
    // the epilogue.  Every wgmma sits in straight-line code or a loop.
    if (w == NCONS - 1) bar_arrive(1);         // consumer 0 takes turn 0
    // WALKS: the same walk, each tile's S over the block's ns slices in
    // turn (the Q slot and K stage reloaded for each), every Q load
    // released once read but the item's last, which the epilogue
    // releases; waits as above, one turn a slice.  A slice's Q and K are
    // loaded in pairs: one count for both
    int nq = 0, nv = 0;                        // Q and K, V loads read
    auto qk_wait = [&]() {
      mbar_wait(full_q, nq & 1);
      mbar_wait(full_k, nq & 1);
    };
    auto qk_release = [&](bool keep) {         // keep: the item's last Q
      mbar_arrive(empty_k);
      if (!keep) mbar_arrive(empty_q);
      ++nq;
    };
    for (int n = 0; WALKS; ++n) {
      mbar_wait(full_q, nq & 1);
      const int item = __shfl_sync(0xffffffffu, item_s[0], 0);
      if (item < 0) break;
      int b, h, qt;
      work_item(item, B, H, n_qt, b, h, qt);
      const int q0 = qt * F::BQ;
      const int n_kv = (min(S, q0 + F::BQ) + KT - 1) / KT;
      const int row0 = q0 + 64 * w;            // this consumer's first row
      const bool walks = row0 < S;
      const int last = walks ? min(S - 1, row0 + 63) / KT : 0;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        m[h2] = NEG;
        l[h2] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      // tile 0: S over the slices
      for (int jj = 0; jj < ns; ++jj) {
        qk_wait();
        take_turn([&] {
          qk_at(jj);
          wgmma_commit();
        });
        wgmma_wait<0>();
        pin(sc);
        qk_release(n_kv == 1 && jj == ns - 1);
      }
      if (walks) {                             // S over all of D
        post();
        gather_sum();
        online(KT - 1 > row0, row0);
        rescale_round();
      } else {                                 // tile 0's V is not read
        mbar_wait(full_v, nv & 1);
        mbar_arrive(empty_v);
        ++nv;
      }
      for (int t = 1; t <= last; ++t) {
        // the first slice's S with P V of tile t - 1, then the others'
        qk_wait();
        mbar_wait(full_v, nv & 1);
        take_turn([&] {
          qk_at(0);
          wgmma_commit();
          pv(0);
          wgmma_commit();
        });
        wgmma_wait<0>();                       // S of slice 0, P V
        pin(sc);
        pin(acc);
        mbar_arrive(empty_v);
        ++nv;
        qk_release(t == n_kv - 1 && ns == 1);
        for (int jj = 1; jj < ns; ++jj) {
          qk_wait();
          take_turn([&] {
            qk_at(jj);
            wgmma_commit();
          });
          wgmma_wait<0>();
          pin(sc);
          qk_release(t == n_kv - 1 && jj == ns - 1);
        }
        post();                                // S over all of D
        gather_sum();
        online(t * KT + KT - 1 > row0, row0 - t * KT);
        rescale_round();
      }
      // P V of the last tile
      if (walks) mbar_wait(full_v, nv & 1);
      pin(acc);
      pin(pk);
      wgmma_fence();
      pv(0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      if (walks) {
        mbar_arrive(empty_v);
        ++nv;
      }
      // the turns past the last tile: its Q, K and V released unread
      for (int t = last + 1; t < n_kv; ++t) {
        for (int jj = 0; jj < ns; ++jj) {
          qk_wait();
          qk_release(t == n_kv - 1 && jj == ns - 1);
          take_turn([] {});
        }
        mbar_wait(full_v, nv & 1);
        mbar_arrive(empty_v);
        ++nv;
      }
      epilogue(b, h, row0);
    }
    for (int n = 0; !WALKS; ++n) {
      mbar_wait(full_q, n & 1);
      const int item = __shfl_sync(0xffffffffu, item_s[0], 0);
      if (item < 0) break;
      int b, h, qt;
      work_item(item, B, H, n_qt, b, h, qt);
      const int q0 = qt * F::BQ;
      const int n_kv = (min(S, q0 + F::BQ) + KT - 1) / KT;
      const int row0 = q0 + 64 * w;            // this consumer's first row
      const bool walks = row0 < S;
      const int last = walks ? min(S - 1, row0 + 63) / KT : 0;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        m[h2] = NEG;
        l[h2] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      mbar_wait(full_k + 8 * slot(0), phase(0));
      take_turn([&] {
        qk(slot(0));
        wgmma_commit();
      });
      wgmma_wait<0>();                         // S of tile 0
      pin(sc);
      mbar_arrive(empty_k + 8 * slot(0));
      if (walks) {
        if constexpr (CL) {                    // S over all of D
          post();
          gather_sum();
        }
        online(KT - 1 > row0, row0);
        rescale_round();
      } else {                                 // tile 0's V is not read
        mbar_wait(full_v + 8 * slot(0), phase(0));
        mbar_arrive(empty_v + 8 * slot(0));
      }
      for (int t = 1; t <= last; ++t) {
        mbar_wait(full_k + 8 * slot(t), phase(t));
        mbar_wait(full_v + 8 * slot(t - 1), phase(t - 1));
        take_turn([&] {
          qk(slot(t));
          wgmma_commit();
          pv(slot(t - 1));
          wgmma_commit();
        });
        wgmma_wait<1>();                       // S of tile t
        pin(sc);
        mbar_arrive(empty_k + 8 * slot(t));
        if constexpr (CL) {                    // S over all of D
          post();                              // under P V of tile t - 1
          wgmma_wait<0>();                     // P V of tile t - 1
          pin(acc);
          mbar_arrive(empty_v + 8 * slot(t - 1));
          gather_sum();
          online(t * KT + KT - 1 > row0, row0 - t * KT);
        } else {
          online(t * KT + KT - 1 > row0, row0 - t * KT);
          wgmma_wait<0>();                     // P V of tile t - 1
          pin(acc);
          mbar_arrive(empty_v + 8 * slot(t - 1));
        }
        rescale_round();
      }
      // P V of the last tile
      if (walks) mbar_wait(full_v + 8 * slot(last), phase(last));
      pin(acc);
      pin(pk);
      wgmma_fence();
      pv(slot(last));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      if (walks) mbar_arrive(empty_v + 8 * slot(last));
      // the turns past the last tile: its K and V released unread
      for (int t = last + 1; t < n_kv; ++t) {
        mbar_wait(full_k + 8 * slot(t), phase(t));
        mbar_arrive(empty_k + 8 * slot(t));
        take_turn([] {});
        mbar_wait(full_v + 8 * slot(t), phase(t));
        mbar_arrive(empty_v + 8 * slot(t));
      }
      epilogue(b, h, row0);
      j += n_kv;
    }
    if (w == 0) bar_sync(1);                   // the other's last hand-over
  }
  // no block leaves while another may still read its exchange buffers
  // (the producer warp's lanes together again first)
  if constexpr (CL) {
    __syncwarp();
    clusterbwd::sync();
  }
}

// The cluster forward's instantiation at G walks: <true, false> at one
// (256 < width <= 2048), <true, true> above
inline auto cluster_kernel(int G) {
  return G > 1 ? flash_fwd_bf16_kernel_d256<true, true>
               : flash_fwd_bf16_kernel_d256<true, false>;
}

// The cluster forward's schedule for operands `width` > 256 wide: the
// work items (as schedule<256>'s), C blocks a cluster and G walks
// (clusterbwd::walks) and the clusters (one an item, up to what the
// device holds at once)
int cluster_schedule(int B, int H, int S, int width, int* items, int* C,
                     int* G, int* clusters) {
  *items = B * H * ((S + Fwd<256>::BQ - 1) / Fwd<256>::BQ);
  int n = 0;
  const int err = clusterbwd::walks(width, C, G, &n);
  if (err != 0) return err;
  return clusterbwd::schedule(
      reinterpret_cast<const void*>(cluster_kernel(*G)), WideL<true>::SMEM,
      Fwd<256>::THREADS, *items, width, C, G, clusters);
}

// The cluster forward at width > 256 (a multiple of 8): maps over the
// whole width, whose columns past it land as zeros and are not stored;
// G launches, one a walk, each on the stream's ticket counter, left at
// zero by the launch; lse written by the first
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Lay* ly, int B, int H, int KV, int S,
                   int width, float scale, cudaStream_t stream) {
  using F = Fwd<256>;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map<256>(&mq, q, ly[0], H, S, B, F::BQ, width);
  if (err == 0) err = make_map<256>(&mk, k, ly[1], KV, S, B, F::BK, width);
  if (err == 0) err = make_map<256>(&mv, v, ly[2], KV, S, B, F::BK, width);
  if (err == 0) err = make_map<256>(&mo, o, ly[3], H, S, B, 64, width);
  if (err != 0) return err;
  int* work = work_counter(stream);
  if (work == nullptr) return (int)cudaErrorMemoryAllocation;
  int n_items = 0, C = 0, G = 0, clusters = 0;
  err = cluster_schedule(B, H, S, width, &n_items, &C, &G, &clusters);
  if (err != 0) return err;
  const int slices = (width + 255) / 256;
  for (int g = 0; g < G && err == 0; ++g)
    err = clusterbwd::launch(cluster_kernel(G), C, clusters, F::THREADS,
                             WideL<true>::SMEM, stream, mq, mk, mv, mo,
                             g == 0 ? lse : nullptr, work, B, H, KV, S,
                             scale * LOG2E, g, slices);
  return err;
}

// the wide body on operands `width` columns wide (a multiple of 8 up to
// 256): the same persistent schedule as the other bodies
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, const Lay* ly, int B, int H, int KV, int S,
                int width, float scale, cudaStream_t stream) {
  using F = Fwd<256>;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map<256>(&mq, q, ly[0], H, S, B, F::BQ, width);
  if (err == 0) err = make_map<256>(&mk, k, ly[1], KV, S, B, F::BK, width);
  if (err == 0) err = make_map<256>(&mv, v, ly[2], KV, S, B, F::BK, width);
  if (err == 0) err = make_map<256>(&mo, o, ly[3], H, S, B, 64, width);
  if (err != 0) return err;
  int* work = work_counter(stream);
  if (work == nullptr) return (int)cudaErrorMemoryAllocation;
  int n_items = 0, grid = 0;
  err = schedule<256>(B, H, S, &n_items, &grid);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel_d256<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_bf16_kernel_d256<false><<<grid, F::THREADS, F::SMEM, stream>>>(
      mq, mk, mv, mo, lse, work, B, H, KV, S, scale * LOG2E, 0, 1);
  return (int)cudaGetLastError();
}

}  // namespace bf16body

// ---------------------------------------------------------------------------
// The backward (see the note at the top of the file)
// ---------------------------------------------------------------------------

// Delta = rowsum(dO * o) in float32: one warp a row (row r of head r / S),
// the lanes' partial sums over D added by xor shuffles (a fixed order: the
// same bits on every run).  The first n_zero threads also zero `zero`,
// the main pass's counters.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, Lay lo, Lay ld_, int H,
                       int S, long long rows, int D, int* __restrict__ zero,
                       int n_zero) {
  const long long gid = (long long)blockIdx.x * 256 + threadIdx.x;
  if (gid < n_zero) zero[gid] = 0;
  const long long r = gid / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int s = (int)(r % S);
  const int bh = (int)(r / S);
  const T* op = at(o, lo, bh / H, bh % H) + s * lo.s;
  const T* dp = at(dout, ld_, bh / H, bh % H) + s * ld_.s;
  float x = 0.f;
  for (int c = lane; c < D; c += 32) x = fmaf(ld(op + c), ld(dp + c), x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) delta[r] = x;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta,
                 const Lay& lo, const Lay& ld_, int B, int H, int S, int D,
                 int* zero, int n_zero, cudaStream_t stream) {
  const long long rows = (long long)B * H * S;
  const long long threads = rows * 32 > n_zero ? rows * 32 : n_zero;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  flash_bwd_delta_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, lo, ld_,
      H, S, rows, D, zero, n_zero);
  return (int)cudaGetLastError();
}

namespace bf16bwd {

using namespace bf16body;   // mbarriers, TMA, wgmma helpers, Geo, make_map

constexpr int KT = 128;     // keys per work item, 64 per consumer
constexpr int QT = 64;      // queries per step
constexpr int NSTAGE = 2;   // depth of the Q / dO ring
constexpr int NTHREADS = 384;

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

// D[64 x N] (+)= A[64 x 16] . B[16 x N], both operands in shared memory
// and MN-major (A's rows run along M, B's along N)
__device__ __forceinline__ void wgmma_tt_n16(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_tt(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_tt_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_tt_n32(d, da, db, scale_d);
  else wgmma_tt_n64(d, da, db, scale_d);
}

// order this thread's generic accesses to global memory against the
// async proxy (bulk copies)
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
// wait until the counter at p reads at least n (acquire, device scope)
__device__ __forceinline__ void wait_count(const int* p, int n) {
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    if (v >= n) return;
    __nanosleep(64);
  }
}
// counter += 1, releasing this thread's earlier writes (device scope)
__device__ __forceinline__ void bump(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(p)
               : "memory");
}
// `bytes` of float32 from shared memory at src to global memory at dst,
// stored over it or added to it element by element (one bulk copy)
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_add(float* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
      " [%0], [%1], %2;" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}
// commit this thread's bulk copies and wait until they are complete (the
// global writes performed, the shared source free)
__device__ __forceinline__ void bulk_commit_wait() {
  asm volatile("cp.async.bulk.commit_group;\n"
               "cp.async.bulk.wait_group 0;" ::: "memory");
}

// Shared memory of the main pass for head dim D: K, V (128 rows each, an
// item's), NSTAGE slots of Q and of dO (64 rows each), two dS^T tiles
// (128 keys x 64 queries, bfloat16), two float32 dq shares (64 queries x
// D), NSTAGE slots of lse and of Delta (64 floats each), the shares'
// (batch x head, first query, key tile), the current item, the
// mbarriers.  At D = 128: 64 + 64 + 32 + 64 KB of tiles, 1,024 B of lse
// and Delta, 128 B of the rest, 1,024 B to align the base: 231,552 bytes
// of the 232,448 a block may take.
//
// A float32 share (and its tile of the accumulator in device memory, 64 x
// D floats a (batch x head, query tile)) is kept in the order of the
// wgmma fragments: the consumer's part (at D = 128 consumer w's 64
// columns, the second half; below that all D), then per group of four
// fragment elements c, per consumer thread t, the four floats
// [4 c .. 4 c + 3] of t's fragment.  So a consumer stores (and the last
// key tile loads) 16 contiguous bytes a thread, neighbouring threads on
// neighbouring addresses, and a share leaves for the accumulator as one
// contiguous bulk add.
template <int D>
struct Smem {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
  // dq's share of a step: at D = 128 each consumer takes 64 columns; below
  // that one consumer takes all D, the two in turn
  static constexpr bool SPLIT = D == 128;
  static constexpr int DQN = SPLIT ? 64 : D;
  static constexpr uint32_t DS_TILE = KT * QT * 2;
  static constexpr uint32_t DQ_TILE = QT * D * 4;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = G1::TILE;
  static constexpr uint32_t Q_OFF = 2 * G1::TILE;
  static constexpr uint32_t DO_OFF = Q_OFF + NSTAGE * G2::TILE;
  static constexpr uint32_t DS_OFF = DO_OFF + NSTAGE * G2::TILE;
  static constexpr uint32_t DQ_OFF = DS_OFF + 2 * DS_TILE;
  static constexpr uint32_t LSE_OFF = DQ_OFF + 2 * DQ_TILE;
  static constexpr uint32_t DL_OFF = LSE_OFF + NSTAGE * QT * 4;
  static constexpr uint32_t META_OFF = DL_OFF + NSTAGE * QT * 4;
  static constexpr uint32_t ITEM_OFF = META_OFF + 2 * 16;
  static constexpr uint32_t BAR_OFF = ITEM_OFF + 16;
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 + 2 * NSTAGE + 4) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
};

// byte offset `off` in a tile of 128-byte rows, swizzled as TMA's and
// wgmma's 128 B mode: the 16-byte unit XOR the row's low three bits
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// The main pass: persistent blocks over the work items (batch x KV head,
// 128-key tile), key-tile-major; see the note at the top of the file.
// Consumer w owns keys k0 + 64 w .. + 63 of the item and computes the
// transposed products S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
// are the A fragments of dv += P^T dO and dk += dS^T Q.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* acc,
                 __nv_bfloat16* __restrict__ dq,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, Lay ldq, Lay ldk, Lay ldv,
                 int* sem, int* work, int B, int H, int KV, int S,
                 float scale, float scale_log2) {
  using G1 = Geo<D, 128>;
  using G2 = Geo<D, 64>;
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  const float* lse_s = reinterpret_cast<const float*>(gb + L::LSE_OFF);
  const float* dl_s = reinterpret_cast<const float*>(gb + L::DL_OFF);
  volatile int* meta = reinterpret_cast<volatile int*>(gb + L::META_OFF);
  volatile int* item_s = reinterpret_cast<volatile int*>(gb + L::ITEM_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  // mbarriers: K and V full (TMA bytes) and empty (every consumer
  // thread); per ring slot full (TMA bytes, plus the producer warp's 32
  // cp.async arrivals) and empty; per dq share buffer full (every
  // consumer thread) and empty (the writer)
  const uint32_t full_kv = bar, empty_kv = bar + 8, full = bar + 16,
                 empty = full + 8 * NSTAGE, dq_full = empty + 8 * NSTAGE,
                 dq_empty = dq_full + 16;

  const int G = H / KV, BKV = B * KV;
  const int nQ = (S + QT - 1) / QT;                  // 64-query tiles
  const int n_items = BKV * ((S + KT - 1) / KT);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 256);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, 256);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(dq_full + 8 * s, 256);
      mbar_init(dq_empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) {
      // the producer warp: takes the items, loads K and V once an item and
      // each step's Q, dO (lane 0, TMA), lse and Delta (every lane)
      const int lane = threadIdx.x;
      int it = 0;                                    // steps so far
      for (int n = 0;; ++n) {
        int item = 0;
        if (lane == 0) item = atomicAdd(work, 1);
        item = __shfl_sync(0xffffffffu, item, 0);
        mbar_wait(empty_kv, (n & 1) ^ 1);            // the last item done
        if (item >= n_items) {
          if (lane == 0) {
            *item_s = -1;
            mbar_arrive(full_kv);
          }
          break;
        }
        const int bkv = item % BKV, kt = item / BKV;
        const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
        if (lane == 0) {
          *item_s = item;
          mbar_expect_tx(full_kv, 2 * G1::TILE);
          for (int c = 0; c < G1::NC; ++c) {
            tma_load(base + L::K_OFF + c * G1::CHUNK, &tk, full_kv,
                     c * G1::AW, kvh, k0, b);
            tma_load(base + L::V_OFF + c * G1::CHUNK, &tv, full_kv,
                     c * G1::AW, kvh, k0, b);
          }
        }
        const int steps = G * (nQ - k0 / QT);
        for (int s = 0; s < steps; ++s, ++it) {
          const int slot = it % NSTAGE;
          const int q0 = (nQ - 1 - s / G) * QT;
          const int h = kvh * G + s % G;
          mbar_wait(empty + 8 * slot, ((it / NSTAGE) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full + 8 * slot, 2 * G2::TILE);
            for (int c = 0; c < G2::NC; ++c) {
              tma_load(base + L::Q_OFF + slot * G2::TILE + c * G2::CHUNK,
                       &tq, full + 8 * slot, c * G2::AW, h, q0, b);
              tma_load(base + L::DO_OFF + slot * G2::TILE + c * G2::CHUNK,
                       &tdo, full + 8 * slot, c * G2::AW, h, q0, b);
            }
          }
          for (int i = lane; i < QT; i += 32) {
            const bool in = q0 + i < S;
            const size_t g = (size_t)(b * H + h) * S + (in ? q0 + i : 0);
            cp_async4(base + L::LSE_OFF + (slot * QT + i) * 4, lse + g, in);
            cp_async4(base + L::DL_OFF + (slot * QT + i) * 4, delta + g, in);
          }
          cp_async_arrive(full + 8 * slot);
        }
      }
    } else if (threadIdx.x == 32) {
      // the writer: each share that is not its tile's last goes to the
      // float32 accumulator, in key-tile order (the tile's counter)
      for (int n = 0;; ++n) {
        const int buf = n & 1;
        mbar_wait(dq_full + 8 * buf, (n >> 1) & 1);
        const int bh = meta[4 * buf], q0 = meta[4 * buf + 1],
                  kt = meta[4 * buf + 2];
        if (bh < 0) break;
        int* cnt = sem + bh * nQ + q0 / QT;
        float* dst = acc + ((size_t)bh * nQ + q0 / QT) * QT * D;
        if (kt > 0) {
          wait_count(cnt, kt);
          fence_async_global();
        }
        const uint32_t src = base + L::DQ_OFF + buf * L::DQ_TILE;
        if (kt == 0)
          bulk_store(dst, src, L::DQ_TILE);
        else
          bulk_add(dst, src, L::DQ_TILE);
        bulk_commit_wait();
        fence_async_global();
        bump(cnt);
        mbar_arrive(dq_empty + 8 * buf);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // which 64 keys of an item; read through a shuffle so that ptxas sees
    // a warp-uniform value: the branch around dq's product below on one it
    // takes to be divergent serializes every wgmma of the kernel (C7520)
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int tid = threadIdx.x % 128;
    // accumulator fragment: rows r0 and r0 + 8 (h = 0, 1) of this
    // consumer's 64, columns 8 j + c0 + {0, 1}: element [4 j + 2 h + e]
    const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    const uint32_t ka = base + L::K_OFF + w * 64 * G1::ROW;
    const uint32_t va = base + L::V_OFF + w * 64 * G1::ROW;
    // dq's B operand (K, MN-major), this consumer's first dq column and
    // its part of a share (floats)
    const uint32_t kb = base + L::K_OFF + (L::SPLIT ? w * G1::CHUNK : 0);
    const int colb = L::SPLIT ? 64 * w : 0;
    const int part = L::SPLIT ? w * QT * 64 : 0;

    float dk_acc[D / 2], dv_acc[D / 2];
    float st[32], dp[32], dq_acc[L::DQN / 2];
    uint32_t pa[16], da[16];

    // dq's share of the step whose dS^T is in buffer `buf`: dS K over the
    // item's 128 keys (one batch, not committed)
    auto dq_product = [&](int buf) {
      const uint32_t a = base + L::DS_OFF + buf * L::DS_TILE;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_tt<L::DQN>(dq_acc,
                         sdesc(a + kk * 16 * 128, L::DS_TILE, 1024, 1),
                         sdesc(kb + kk * 16 * G1::ROW, G1::CHUNK, G1::SBO,
                               G1::LAYOUT),
                         kk > 0);
    };
    int n_sh = 0;                  // shares handed to the writer so far
    // the last share of query tile qi of head bh, from its diagonal key
    // tile kt, in dq_acc: added to the other key tiles' sum (all of it
    // read first), scaled, rounded and written out as dq
    auto finish = [&](int bh, int qi, int kt) {
      const int q0 = qi * QT;
      float4 a[L::DQN / 8];
      if (kt > 0) {
        const float4* ap = reinterpret_cast<const float4*>(
            acc + ((size_t)bh * nQ + qi) * QT * D + part);
        if (tid == 0) wait_count(sem + bh * nQ + qi, kt);
        named_sync(4 + w, 128);
#pragma unroll
        for (int j = 0; j < L::DQN / 8; ++j) a[j] = __ldcg(ap + j * 128 + tid);
#pragma unroll
        for (int j = 0; j < L::DQN / 8; ++j) {
          dq_acc[4 * j] = a[j].x + dq_acc[4 * j];
          dq_acc[4 * j + 1] = a[j].y + dq_acc[4 * j + 1];
          dq_acc[4 * j + 2] = a[j].z + dq_acc[4 * j + 2];
          dq_acc[4 * j + 3] = a[j].w + dq_acc[4 * j + 3];
        }
      }
      __nv_bfloat16* out = at(dq, ldq, bh / H, bh % H);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < L::DQN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + row * ldq.s + colb +
                                             8 * j + c0) =
              __floats2bfloat162_rn(dq_acc[4 * j + 2 * h] * scale,
                                    dq_acc[4 * j + 2 * h + 1] * scale);
      }
    };
    // a share that is not its tile's last, in dq_acc where this consumer
    // computed it (act): to the writer through a share buffer
    auto share = [&](int bh, int qi, int kt, bool act) {
      const int q0 = qi * QT;
      const int buf = n_sh & 1;
      mbar_wait(dq_empty + 8 * buf, ((n_sh >> 1) & 1) ^ 1);
      if (act) {
        const uint32_t dst = base + L::DQ_OFF + buf * L::DQ_TILE + part * 4;
#pragma unroll
        for (int j = 0; j < L::DQN / 8; ++j)
          st_shared(dst + (j * 128 + tid) * 16, dq_acc[4 * j],
                    dq_acc[4 * j + 1], dq_acc[4 * j + 2], dq_acc[4 * j + 3]);
        fence_async_smem();
      }
      if (w == 0 && tid == 0) {
        meta[4 * buf] = bh;
        meta[4 * buf + 1] = q0;
        meta[4 * buf + 2] = kt;
      }
      mbar_arrive(dq_full + 8 * buf);
      ++n_sh;
    };

    int it = 0;                                  // steps so far
    if (w == 1) bar_arrive(1);                   // consumer 0 goes first
    for (int n = 0;; ++n) {
      mbar_wait(full_kv, n & 1);
      const int item = *item_s;
      if (item < 0) break;
      const int bkv = item % BKV, kt = item / BKV;
      const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
      const int kw = k0 + 64 * w;
      const int steps = G * (nQ - k0 / QT);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      for (int s = 0; s < steps; ++s, ++it) {
        const int slot = it % NSTAGE;
        const int qi = nQ - 1 - s / G;
        const int q0 = qi * QT;
        const uint32_t qs = base + L::Q_OFF + slot * G2::TILE;
        const uint32_t dos = base + L::DO_OFF + slot * G2::TILE;
        mbar_wait(full + 8 * slot, (it / NSTAGE) & 1);
        pin(dk_acc);
        pin(dv_acc);
        // this consumer's turn on the tensor cores: the other one's
        // exponentials run under these products, and its products under
        // this consumer's exponentials
        bar_sync(1 + w);
        wgmma_fence();
        scores<D>(st, ka, qs);                   // S^T = K Q^T
        scores<D>(dp, va, dos);                  // dP^T = V dO^T
        wgmma_commit();
        bar_arrive(2 - w);
        wgmma_wait<0>();
        pin(st);
        pin(dp);
        // keys above a query, and queries past S, get P = dS = 0
        const bool edge = q0 < kw + 64 || q0 + QT > S;
        const float* ls = lse_s + slot * QT;
        const float* dl = dl_s + slot * QT;
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
        // P^T and dS^T as bfloat16 A fragments; dS^T also into this
        // step's tile in shared memory (row = key, 128 B a row, swizzled)
        const uint32_t dsb = base + L::DS_OFF + (it & 1) * L::DS_TILE;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            pa[2 * j + h] = pack_bf16(st[4 * j + 2 * h], st[4 * j + 2 * h + 1]);
            da[2 * j + h] = pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
            const uint32_t row = 64 * w + r0 + 8 * h;
            st_shared(dsb + swz(row * 128 + 16 * j + 2 * c0),
                      da[2 * j + h]);
          }
        fence_async_smem();
        // both halves of dS^T in; both consumers past their last step, so
        // neither still reads the other tile
        named_sync(3, 256);
        pin(pa);
        pin(da);
        pin(dk_acc);
        pin(dv_acc);
        wgmma_fence();
        const bool act = L::SPLIT || (s & 1) == w;
        if (act) dq_product(it & 1);             // dq's share: dS K
        wgmma_commit();
        accumulate<D>(dv_acc, pa, dos);          // dv += P^T dO
        accumulate<D>(dk_acc, da, qs);           // dk += dS^T Q
        wgmma_commit();
        // a share goes out while dv and dk run; the diagonal tile's
        // last share is finished once they are done (and pa, da free)
        const int bh = b * H + kvh * G + s % G;
        const bool last = kt == q0 / KT;
        wgmma_wait<1>();
        pin(dq_acc);
        if (!last) share(bh, qi, kt, act);
        wgmma_wait<0>();                         // dv, dk: Q and dO read
        pin(dk_acc);
        pin(dv_acc);
        mbar_arrive(empty + 8 * slot);
        if (last && act) finish(bh, qi, kt);
      }
      mbar_arrive(empty_kv);                     // K and V read

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kw + r0 + 8 * h;
        if (key < S) {
          __nv_bfloat16* kp = at(dk, ldk, b, kvh) + key * ldk.s + c0;
          __nv_bfloat16* vp = at(dv, ldv, b, kvh) + key * ldv.s + c0;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(kp + 8 * j) =
                __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                      dk_acc[4 * j + 2 * h + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(vp + 8 * j) =
                __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                      dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    if (w == 0) bar_sync(1);                     // consumer 1's last turn
    // tell the writer to stop
    const int buf = n_sh & 1;
    mbar_wait(dq_empty + 8 * buf, ((n_sh >> 1) & 1) ^ 1);
    if (w == 0 && tid == 0) meta[4 * buf] = -1;
    mbar_arrive(dq_full + 8 * buf);
  }
}

// ly: the strides of q, k, v, o, dO, dq, dk, dv; acc a float32 scratch
// of B * H * ceil(S / 64) * 64 * D (dq's accumulator, a tile of 64 x D
// for each (batch x head, query tile)); sem B * H * ceil(S / 64) + 1 ints,
// zeroed (the Delta pass)
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, float* acc, int* sem, const Lay* ly, int B, int H,
           int KV, int S, float scale, cudaStream_t stream) {
  // 64-row boxes for the streamed Q and dO, 128-row for K and V
  CUtensorMap mq, mdo, mk, mv;
  int err = make_map<D>(&mq, q, ly[0], H, S, B, QT);
  if (err == 0) err = make_map<D>(&mdo, dout, ly[4], H, S, B, QT);
  if (err == 0) err = make_map<D>(&mk, k, ly[1], KV, S, B, KT);
  if (err == 0) err = make_map<D>(&mv, v, ly[2], KV, S, B, KT);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr size_t smem = Smem<D>::SMEM;
  e = cudaFuncSetAttribute(flash_bwd_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_items = B * KV * ((S + KT - 1) / KT);
  const int nQ = (S + QT - 1) / QT;
  flash_bwd_kernel<D><<<n_items < sms ? n_items : sms, NTHREADS, smem,
                        stream>>>(
      mq, mk, mv, mdo, lse, delta, acc,
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), ly[5], ly[6], ly[7], sem,
      sem + (size_t)B * H * nQ, B, H, KV, S, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace bf16bwd

namespace widebwd {

using namespace bf16body;   // mbarriers, TMA, wgmma helpers, Geo, make_map
using bf16bwd::bulk_add;
using bf16bwd::bulk_commit_wait;
using bf16bwd::bulk_store;
using bf16bwd::bump;
using bf16bwd::cp_async4;
using bf16bwd::cp_async_arrive;
using bf16bwd::fence_async_global;
using bf16bwd::swz;
using bf16bwd::wait_count;

constexpr int D = 256;      // the body's width (a narrower one read in place)
constexpr int KT = 64;      // keys per work item: the rows of dk and dv
constexpr int QT = 64;      // queries per step, 32 scored by each consumer
constexpr int STAGES = 2;   // depth of the Q / dO ring
constexpr int NTHREADS = 384;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

static_assert(KT == QT, "the diagonal key tile of query tile qi is qi");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <=
                  65536 / NTHREADS / 8 * 8 * NTHREADS,
              "more registers than the block was launched with");

// Shared memory: an item's K and V (64 keys x 256 each), STAGES slots of
// Q and of dO (64 queries each), two P^T and two dS^T tiles (64 keys x 64
// queries, bfloat16: a step's, while the other consumer may still read
// the last step's), STAGES slots of lse and Delta and of the staged
// share's (batch x head, query tile, key tile, last), the current item,
// the mbarriers: 64 + 128 + 32 KB of tiles, 1,024 B of lse and Delta,
// the rest and 1,024 B to align the base: 231,520 bytes of the 232,448 a
// block may take.  No room is left for a buffer of dq's share (64 KB a
// step in float32): a consumer stages its half of the share in the
// columns of the step's Q and dO tiles that only its own dv and dk read,
// once they are done (its dq columns 0 .. 63 in its Q chunks, 64 .. 127
// in its dO chunks, in fragment order).
//
// The cluster body (CL, a 256-column slice of D > 256 a block) has one Q /
// dO slot (ST = 1): the 64 KB of the second one hold the exchange of S^T
// and dP^T partials, two buffers of 8 warps x 8 16-byte units x 32 lanes
// (a step's 64 keys x 64 queries of each, float32), beside the two
// ticket slots and 20 more mbarriers (the 16 warps' exchanges, the two
// tickets, and the walks' sub-loads full and empty): 231,152 bytes.
template <bool CL>
struct Smem {
  using G = Geo<D, 64>;                         // K, V, Q or dO
  static constexpr int ST = CL ? 1 : STAGES;    // Q / dO slots
  static constexpr uint32_t PT_TILE = KT * QT * 2;
  static constexpr uint32_t XBUF = clusterbwd::XWARPS * 8 * clusterbwd::XUNIT;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = G::TILE;
  static constexpr uint32_t Q_OFF = 2 * G::TILE;
  static constexpr uint32_t DO_OFF = Q_OFF + ST * G::TILE;
  static constexpr uint32_t P_OFF = DO_OFF + ST * G::TILE;
  static constexpr uint32_t DS_OFF = P_OFF + 2 * PT_TILE;
  static constexpr uint32_t X_OFF = DS_OFF + 2 * PT_TILE;
  static constexpr uint32_t LSE_OFF = X_OFF + (CL ? 2 * XBUF : 0);
  static constexpr uint32_t DL_OFF = LSE_OFF + ST * QT * 4;
  static constexpr uint32_t META_OFF = DL_OFF + ST * QT * 4;
  static constexpr uint32_t ITEM_OFF = META_OFF + ST * 16;
  static constexpr uint32_t TICK_OFF = ITEM_OFF + 16;
  static constexpr uint32_t BAR_OFF = TICK_OFF + (CL ? 16 : 0);
  static constexpr size_t SMEM =
      BAR_OFF + 8 * (2 + 2 * ST + (CL ? 2 * clusterbwd::XWARPS + 4 : 0)) +
      1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
};

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], both operands in shared memory
// and K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], both operands in shared memory,
// A K-major, B MN-major
__device__ __forceinline__ void wgmma_sm_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
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
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], both operands in shared
// memory and MN-major
__device__ __forceinline__ void wgmma_tt_n128(float (&d)[64], uint64_t da,
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
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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

// The main pass at 128 < D <= 256: persistent blocks over the work items
// (batch x KV head, 64-key tile), key-tile-major; see the note at the top
// of the file.  Consumer w holds dk and dv of the item's 64 keys for
// columns 128 w .. 128 w + 127, and scores queries 32 w .. 32 w + 31 of
// each step.  The producer warp also adds each staged share to dq's
// accumulator (lane 0: bulk reduce-adds from shared memory, in key-tile
// order) before it loads the slot again.  `width`: the operands' real
// width (the maps zero-fill the columns past it; dq, dk and dv are stored
// below it).  `acc`: dq's float32 accumulator, a 64 x 256 tile for each
// (batch x head, query tile), in the consumers' fragment order; `sem` a
// counter for each such tile (the key tiles added so far), then the
// ticket counter, all zeroed by the Delta pass.
// CL: the cluster body, block `rank` of a cluster of C on columns 256 rank
// .. 256 rank + 255 of operands `width` > 256 wide: the maps' coordinates
// start there (the columns past width zero-filled), dq, dk and dv are
// stored from there below width, and acc and sem are the slice's own (a
// region of B * H * nQ tiles and counters each, slice-major), `work` the
// ticket counter after all of them.  Rank 0 draws the tickets for the
// cluster, and every step's S^T and dP^T are summed over the ranks
// (clusterbwd::exchange) before the softmax.
// WALKS (above 2048: `slices` = ceil(width / 256) > 8): walk `walk` of
// clusterbwd::walks, block `rank` owning slice rank + C walk (its K and V
// resident, its dv, dk and dq share, its region of acc and sem): each
// step first sums S^T and dP^T over the block's other slices below the
// width in ascending order, each through the step's Q / dO slot (its K
// and Q, then its V and dO, 64 KB each, one mbarrier pair), and then over
// the owned slice as above.  (WALKS = false is the same kernel at one
// walk: no other slices.)
template <bool CL, bool WALKS = false>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel_d256(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* acc,
                      __nv_bfloat16* __restrict__ dq,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Lay ldq, Lay ldk,
                      Lay ldv, int* sem, int* work, int B, int H, int KV,
                      int S, int width, float scale, float scale_log2,
                      int walk, int slices) {
  static_assert(!WALKS || CL, "walks: the cluster body");
  using L = Smem<CL>;
  using G = typename L::G;
  constexpr int ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  const float* lse_s = reinterpret_cast<const float*>(gb + L::LSE_OFF);
  const float* dl_s = reinterpret_cast<const float*>(gb + L::DL_OFF);
  volatile int* meta = reinterpret_cast<volatile int*>(gb + L::META_OFF);
  volatile int* item_s = reinterpret_cast<volatile int*>(gb + L::ITEM_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  // mbarriers: K and V full (TMA bytes) and empty (every consumer
  // thread); per ring slot full (TMA bytes, plus the producer warp's 32
  // cp.async arrivals) and staged (every consumer thread, once the step's
  // Q and dO are read and its dq share staged); CL: per exchange buffer
  // and compute warp the other ranks' arrivals, and the two tickets'
  const uint32_t full_kv = bar, empty_kv = bar + 8, full = bar + 16,
                 staged = full + 8 * ST;
  const uint32_t xin = staged + 8 * ST, tick = xin + 16 * clusterbwd::XWARPS;
  // WALKS: the other slices' sub-loads in the slot, full and empty
  const uint32_t full_x = tick + 16, empty_x = full_x + 8;

  const int GS = H / KV, BKV = B * KV;
  const int nQ = (S + QT - 1) / QT;                  // query tiles
  const int n_items = BKV * ((S + KT - 1) / KT);
  int C = 1, rank = 0;
  // the owned slice; WALKS: the block's slices below the width (rank + C
  // jj) but the owned one: n_other
  int own = 0, n_other = 0;
  if constexpr (CL) {
    C = clusterbwd::size();
    rank = clusterbwd::rank();
    own = rank;
    if constexpr (WALKS) {
      own += C * walk;
      n_other = clusterbwd::others(slices, rank, C, walk);
    }
    sem += (size_t)own * B * H * nQ;
    acc += (size_t)own * B * H * nQ * QT * D;
    dq += own * D;
    dk += own * D;
    dv += own * D;
    width -= own * D;                            // the slice's, >= 1 (WALKS:
                                                 // <= 0 past the width)
  }
  const int col0 = own * D;                      // the slice's first column
  // dq's accumulator tile: NP parts of 64 x 64 floats (columns 64 p ..
  // 64 p + 63), 4 but in a last slice narrower than 256 columns, whose
  // parts past its width are neither added nor read (their columns are
  // zero and never stored; WALKS: none in a slice past the width)
  const int NP = CL ? (WALKS ? max(0, min(4, (width + 63) / 64))
                             : min(4, (width + 63) / 64))
                    : 4;
  const size_t TF = (size_t)NP * QT * 64;          // floats a tile

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 256);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 33);
      mbar_init(staged + 8 * s, 256);
    }
    if constexpr (CL) {
      for (int i = 0; i < 2 * clusterbwd::XWARPS; ++i)
        mbar_init(xin + 8 * i, C - 1);
      mbar_init(tick, 1);
      mbar_init(tick + 8, 1);
    }
    if constexpr (WALKS) {
      mbar_init(full_x, 1);
      mbar_init(empty_x, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL) clusterbwd::sync();        // every rank's mbarriers set

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x < 32) {
      // the producer warp: takes the items, loads K and V once an item and
      // each step's Q, dO (lane 0, TMA), lse and Delta (every lane); before
      // it loads a slot again, lane 0 adds the share staged there
      const int lane = threadIdx.x;
      // the share that step `i` staged in its slot: to the accumulator's
      // tile, stored by key tile 0, added by the later ones once the tile's
      // counter reads their key tile, and the counter bumped once the adds
      // are complete (the diagonal tile's share is never staged: its
      // consumers round the sum into dq)
      auto add_share = [&](int i) {
        const int slot = i % ST;
        mbar_wait(staged + 8 * slot, (i / ST) & 1);
        const int bh = meta[4 * slot], qi = meta[4 * slot + 1],
                  kt = meta[4 * slot + 2];
        if (meta[4 * slot + 3]) return;
        int* cnt = sem + bh * nQ + qi;
        float* dst = acc + ((size_t)bh * nQ + qi) * TF;
        if (kt > 0) {
          wait_count(cnt, kt);
          fence_async_global();
        }
        for (int r = 0; r < NP; ++r) {               // consumer r / 2's half
          const uint32_t src = base + (r & 1 ? L::DO_OFF : L::Q_OFF) +
                               slot * G::TILE + (r >> 1) * 2 * G::CHUNK;
          if (kt == 0) bulk_store(dst + r * QT * 64, src, 2 * G::CHUNK);
          else bulk_add(dst + r * QT * 64, src, 2 * G::CHUNK);
        }
        bulk_commit_wait();
        fence_async_global();
        bump(cnt);
      };
      int it = 0;                                    // steps so far
      for (int n = 0;; ++n) {
        int item = 0;
        if (lane == 0)
          item = CL ? clusterbwd::ticket(work, base + L::TICK_OFF, tick, n, C,
                                         rank)
                    : atomicAdd(work, 1);
        item = __shfl_sync(0xffffffffu, item, 0);
        mbar_wait(empty_kv, (n & 1) ^ 1);            // the last item done
        if (item >= n_items) {
          if (lane == 0) {
            *item_s = -1;
            mbar_arrive(full_kv);
            for (int i = it < ST ? 0 : it - ST; i < it; ++i)
              add_share(i);
          }
          break;
        }
        const int bkv = item % BKV, kt = item / BKV;
        const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
        if (lane == 0) {
          *item_s = item;
          mbar_expect_tx(full_kv, 2 * G::TILE);
          for (int c = 0; c < G::NC; ++c) {
            tma_load(base + L::K_OFF + c * G::CHUNK, &tk, full_kv,
                     col0 + c * G::AW, kvh, k0, b);
            tma_load(base + L::V_OFF + c * G::CHUNK, &tv, full_kv,
                     col0 + c * G::AW, kvh, k0, b);
          }
        }
        const int steps = GS * (nQ - kt);
        for (int s = 0; s < steps; ++s, ++it) {
          const int slot = it % ST;
          const int q0 = (nQ - 1 - s / GS) * QT;
          const int h = kvh * GS + s % GS;
          if (it >= ST) {          // the slot's last step staged its share
            if (lane == 0) add_share(it - ST);
            __syncwarp();
          }
          if (lane == 0) {
            if constexpr (WALKS) {
              // the other slices in ascending order: K and Q, then V and
              // dO, into the slot (K or V in the Q tile, Q or dO in the
              // dO tile), each once the one before is read (a step has an
              // even number of them: K and Q the even phases of full_x)
              const int no = clusterbwd::others(slices, clusterbwd::rank(),
                                                clusterbwd::size(), walk);
              for (int i = 0; i < no; ++i) {
                const int col = (clusterbwd::rank() + clusterbwd::size() *
                                 (i + (i >= walk))) * D;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  mbar_wait(empty_x, e ^ 1);
                  mbar_expect_tx(full_x, 2 * G::TILE);
                  for (int c = 0; c < G::NC; ++c) {
                    tma_load(base + L::Q_OFF + c * G::CHUNK, e ? &tv : &tk,
                             full_x, col + c * G::AW, kvh, k0, b);
                    tma_load(base + L::DO_OFF + c * G::CHUNK, e ? &tdo : &tq,
                             full_x, col + c * G::AW, h, q0, b);
                  }
                }
              }
              mbar_wait(empty_x, 1);                 // the last one read
            }
            mbar_expect_tx(full + 8 * slot, 2 * G::TILE);
            for (int c = 0; c < G::NC; ++c) {
              tma_load(base + L::Q_OFF + slot * G::TILE + c * G::CHUNK,
                       &tq, full + 8 * slot, col0 + c * G::AW, h, q0,
                       b);
              tma_load(base + L::DO_OFF + slot * G::TILE + c * G::CHUNK,
                       &tdo, full + 8 * slot, col0 + c * G::AW, h,
                       q0, b);
            }
          }
          for (int i = lane; i < QT; i += 32) {
            const bool in = q0 + i < S;
            const size_t g = (size_t)(b * H + h) * S + (in ? q0 + i : 0);
            cp_async4(base + L::LSE_OFF + (slot * QT + i) * 4, lse + g, in);
            cp_async4(base + L::DL_OFF + (slot * QT + i) * 4, delta + g, in);
          }
          cp_async_arrive(full + 8 * slot);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     CONSUMER_REGS)
                 : "memory");
    // which half of the columns and of each step's queries; read through
    // a shuffle so that ptxas sees a warp-uniform value (no C7520)
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int tid = threadIdx.x % 128;
    // accumulator fragment: rows r0 and r0 + 8 (h = 0, 1), columns
    // 8 j + c0 + {0, 1}: element [4 j + 2 h + e]
    const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
    const int c0 = 2 * (tid % 4);
    const uint32_t ks = base + L::K_OFF, vs = base + L::V_OFF;

    float dk_acc[64], dv_acc[64];    // 64 keys x this consumer's 128 columns
    float st[16], dp[16];            // S^T, dP^T: 64 keys x 32 queries
    float dq_acc[64];                // dq's share: 64 queries x 128 columns

    // S^T (a = K) or dP^T (a = V) of this consumer's 32 queries of the
    // Q or dO tile at b: 16 k-steps over D (one batch, not committed),
    // added to s's sum so far if `add`
    auto scores = [&](float (&s)[16], uint32_t a, uint32_t b, bool add) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / G::AW) * G::CHUNK +
                             (kk * 16 % G::AW) * 2;
        wgmma_ss_n32(s, sdesc(a + off, 16, G::SBO, G::LAYOUT),
                     sdesc(b + 32 * w * G::ROW + off, 16, G::SBO, G::LAYOUT),
                     add || kk > 0);
      }
    };
    // d += A T over the step's 64 queries: A the P^T or dS^T tile at a
    // (keys x queries, K-major), T this consumer's 128 columns of the dO or
    // Q tile at t (MN-major)
    auto accumulate = [&](float (&d)[64], uint32_t a, uint32_t t) {
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        wgmma_sm_n128(d, sdesc(a + kk * 32, 16, 1024, 1),
                      sdesc(t + 2 * w * G::CHUNK + kk * 16 * G::ROW,
                            G::CHUNK, G::SBO, G::LAYOUT));
    };
    // dq's share: dS K over the item's 64 keys for this consumer's 128
    // columns (dS the MN-major A from the dS^T tile at ds, K the MN-major
    // B)
    auto dq_product = [&](uint32_t ds) {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_tt_n128(dq_acc, sdesc(ds + kk * 16 * 128, L::PT_TILE, 1024, 1),
                      sdesc(ks + 2 * w * G::CHUNK + kk * 16 * G::ROW,
                            G::CHUNK, G::SBO, G::LAYOUT),
                      kk > 0);
    };
    // the share of a step that is not its query tile's last: into the
    // slot's Q chunks of this consumer (its columns 0 .. 63) and its dO
    // chunks (64 .. 127), as float4s in fragment order, where only its
    // own dv and dk read (done)
    auto stage = [&](int slot) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        st_shared(base + (j < 8 ? L::Q_OFF : L::DO_OFF) + slot * G::TILE +
                      2 * w * G::CHUNK + ((j % 8) * 128 + tid) * 16,
                  dq_acc[4 * j], dq_acc[4 * j + 1], dq_acc[4 * j + 2],
                  dq_acc[4 * j + 3]);
    };
    // the share of the diagonal tile (the query tile's last) added to the
    // sum of the others from `tile` (this consumer's half of the
    // accumulator's, in the same order; none at kt = 0), scaled and
    // rounded into dq below the width
    auto finish = [&](const float* tile, int kt, int bh, int q0) {
      if (kt > 0) {
        const float4* tp = reinterpret_cast<const float4*>(tile) + tid;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (CL && 2 * w + j / 8 >= NP) continue;   // past the width
          const float4 a = __ldcg(tp + j * 128);
          dq_acc[4 * j] = a.x + dq_acc[4 * j];
          dq_acc[4 * j + 1] = a.y + dq_acc[4 * j + 1];
          dq_acc[4 * j + 2] = a.z + dq_acc[4 * j + 2];
          dq_acc[4 * j + 3] = a.w + dq_acc[4 * j + 3];
        }
      }
      __nv_bfloat16* out = at(dq, ldq, bh / H, bh % H);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * w + 8 * j + c0;
          if (col < width)
            *reinterpret_cast<__nv_bfloat162*>(out + row * ldq.s + col) =
                __floats2bfloat162_rn(dq_acc[4 * j + 2 * h] * scale,
                                      dq_acc[4 * j + 2 * h + 1] * scale);
        }
      }
    };

    int it = 0;                                  // steps so far
    for (int n = 0;; ++n) {
      mbar_wait(full_kv, n & 1);
      const int item = __shfl_sync(0xffffffffu, *item_s, 0);
      if (item < 0) break;
      const int bkv = item % BKV, kt = item / BKV;
      const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
      const int steps = GS * (nQ - kt);
#pragma unroll
      for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      for (int s = 0; s < steps; ++s, ++it) {
        const int slot = it % ST;
        const int qi = nQ - 1 - s / GS;
        const int q0 = qi * QT;
        const int bh = b * H + kvh * GS + s % GS;
        const uint32_t qs = base + L::Q_OFF + slot * G::TILE;
        const uint32_t dos = base + L::DO_OFF + slot * G::TILE;
        const uint32_t pt = base + L::P_OFF + (it & 1) * L::PT_TILE;
        const uint32_t dst = base + L::DS_OFF + (it & 1) * L::PT_TILE;
        if constexpr (WALKS) {
          // the other slices' S^T and dP^T, from the slot: each slice two
          // phases of full_x (a step has an even number), K and Q the
          // even one, V and dO the odd one
          for (int i = n_other; i > 0; --i) {
            const bool add = i != n_other;
            mbar_wait(full_x, 0);                // K and Q
            pin(dk_acc);
            pin(dv_acc);
            wgmma_fence();
            scores(st, qs, dos, add);
            wgmma_commit();
            wgmma_wait<0>();
            pin(st);
            mbar_arrive(empty_x);
            mbar_wait(full_x, 1);                // V and dO
            pin(dk_acc);
            pin(dv_acc);
            wgmma_fence();
            scores(dp, qs, dos, add);
            wgmma_commit();
            wgmma_wait<0>();
            pin(dp);
            mbar_arrive(empty_x);
          }
        }
        mbar_wait(full + 8 * slot, (it / ST) & 1);
        pin(dk_acc);
        pin(dv_acc);
        wgmma_fence();
        // S^T = K Q^T, dP^T = V dO^T (WALKS: added to the other slices')
        scores(st, ks, qs, WALKS && n_other > 0);
        scores(dp, vs, dos, WALKS && n_other > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(st);
        pin(dp);
        if constexpr (CL) {                      // the sums over all of D
          const int xw = threadIdx.x / 32 - 4;   // compute warp 0 .. 7
          clusterbwd::exchange(
              st, dp,
              base + L::X_OFF + (it & 1) * L::XBUF +
                  xw * 8 * clusterbwd::XUNIT + (threadIdx.x & 31) * 16,
              xin + 8 * ((it & 1) * clusterbwd::XWARPS + xw), it, C, rank);
        }
        // keys above a query, and queries past S, get P = dS = 0
        const int qw = q0 + 32 * w;              // this consumer's first
        const bool edge = qw < k0 + KT || qw + 32 > S;
        const float* ls = lse_s + slot * QT + 32 * w;
        const float* dl = dl_s + slot * QT + 32 * w;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + c0 + e;
            const float l2 = ls[col] * LOG2E;
            const float dlt = dl[col];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              float p = ex2(fmaf(st[i], scale_log2, -l2));
              if (edge && (k0 + r0 + 8 * h > qw + col || qw + col >= S))
                p = 0.f;
              st[i] = p;
              dp[i] = p * (dp[i] - dlt);
            }
          }
        // P^T and dS^T rounded to bfloat16 into the step's tiles (row =
        // key, 128 B a row, swizzled), this consumer's 32 query columns
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t off =
                swz((r0 + 8 * h) * 128 + 64 * w + 16 * j + 2 * c0);
            st_shared(pt + off,
                      pack_bf16(st[4 * j + 2 * h], st[4 * j + 2 * h + 1]));
            st_shared(dst + off,
                      pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]));
          }
        fence_async_smem();
        // both consumers' halves in; both past their last step, so neither
        // still reads the other tiles
        named_sync(1, 256);
        const bool last = kt == qi;              // the diagonal key tile
        pin(dk_acc);
        pin(dv_acc);
        wgmma_fence();
        dq_product(dst);                         // dq's share: dS K
        accumulate(dv_acc, pt, dos);             // dv += P^T dO
        accumulate(dk_acc, dst, qs);             // dk += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();                         // Q and dO read
        pin(dq_acc);
        pin(dk_acc);
        pin(dv_acc);
        if (w == 0 && tid == 0) {                // for the producer's add
          meta[4 * slot] = bh;
          meta[4 * slot + 1] = qi;
          meta[4 * slot + 2] = kt;
          meta[4 * slot + 3] = last;
        }
        const float* tile = acc + ((size_t)bh * nQ + qi) * TF + w * QT * 128;
        if (last) {
          mbar_arrive(staged + 8 * slot);        // nothing staged
          // the other key tiles' adds to this tile are in
          if (kt > 0) {
            if (tid == 0) wait_count(sem + bh * nQ + qi, kt);
            named_sync(2 + w, 128);
          }
          finish(tile, kt, bh, q0);
        } else {
          stage(slot);
          fence_async_smem();
          mbar_arrive(staged + 8 * slot);
        }
      }
      mbar_arrive(empty_kv);                     // K and V read

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + r0 + 8 * h;
        if (key >= S) continue;
        __nv_bfloat16* kp = at(dk, ldk, b, kvh) + key * ldk.s;
        __nv_bfloat16* vp = at(dv, ldv, b, kvh) + key * ldv.s;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * w + 8 * j + c0;
          if (col < width) {
            *reinterpret_cast<__nv_bfloat162*>(kp + col) =
                __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                      dk_acc[4 * j + 2 * h + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(vp + col) =
                __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                      dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
  // no block leaves while another may still read its exchange buffers
  if constexpr (CL) clusterbwd::sync();
}

// The schedule for B x KV heads of S rows: the work items and the grid,
// one persistent block an SM (fewer if there are fewer items)
int schedule(int B, int KV, int S, int* items, int* blocks) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *items = B * KV * ((S + KT - 1) / KT);
  *blocks = *items < sms ? *items : sms;
  return 0;
}

// ly: the strides of q, k, v, o, dO, dq, dk, dv; acc a float32 scratch of
// B * H * ceil(S / 64) * 64 * 256; sem B * H * ceil(S / 64) + 1 ints,
// zeroed (the Delta pass); width the operands' (a multiple of 8, at most
// 256)
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, float* acc, int* sem, const Lay* ly, int B, int H,
           int KV, int S, int width, float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int err = make_map<D>(&mq, q, ly[0], H, S, B, QT, width);
  if (err == 0) err = make_map<D>(&mdo, dout, ly[4], H, S, B, QT, width);
  if (err == 0) err = make_map<D>(&mk, k, ly[1], KV, S, B, KT, width);
  if (err == 0) err = make_map<D>(&mv, v, ly[2], KV, S, B, KT, width);
  if (err != 0) return err;
  int n_items = 0, grid = 0;
  err = schedule(B, KV, S, &n_items, &grid);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel_d256<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<false>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nQ = (S + QT - 1) / QT;
  flash_bwd_kernel_d256<false><<<grid, NTHREADS, Smem<false>::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, acc, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      ly[5], ly[6], ly[7], sem, sem + (size_t)B * H * nQ, B, H, KV, S,
      width, scale, scale * LOG2E, 0, 1);
  return (int)cudaGetLastError();
}

// The cluster body's instantiation at G walks: <true, false> at one (256
// < width <= 2048), <true, true> above
inline auto cluster_kernel(int G) {
  return G > 1 ? flash_bwd_kernel_d256<true, true>
               : flash_bwd_kernel_d256<true, false>;
}

// The cluster body's schedule for operands `width` > 256 wide: the work
// items (as above), C blocks a cluster and G walks (clusterbwd::walks)
// and the clusters (one an item, up to what the device holds at once)
int cluster_schedule(int B, int KV, int S, int width, int* items, int* C,
                     int* G, int* clusters) {
  *items = B * KV * ((S + KT - 1) / KT);
  int n = 0;
  const int err = clusterbwd::walks(width, C, G, &n);
  if (err != 0) return err;
  return clusterbwd::schedule(reinterpret_cast<const void*>(cluster_kernel(*G)),
                              Smem<true>::SMEM, NTHREADS, *items, width, C, G,
                              clusters);
}

// The cluster body at width > 256 (a multiple of 8): acc a float32
// scratch of B * H * ceil(S / 64) * 64 * W, W the width rounded up to 64
// (a region of 256-column tiles a slice, the last slice's tiles as wide
// as its 64-column parts), and sem C * G * B * H * ceil(S / 64) + G ints,
// zeroed (the Delta pass): one region of counters a slice of the C G the
// walks own (those past the width counted, never added), then each
// walk's ticket counter; G launches, one a walk
int launch_cluster(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, float* acc, int* sem,
                   const Lay* ly, int B, int H, int KV, int S, int width,
                   float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int err = make_map<D>(&mq, q, ly[0], H, S, B, QT, width);
  if (err == 0) err = make_map<D>(&mdo, dout, ly[4], H, S, B, QT, width);
  if (err == 0) err = make_map<D>(&mk, k, ly[1], KV, S, B, KT, width);
  if (err == 0) err = make_map<D>(&mv, v, ly[2], KV, S, B, KT, width);
  if (err != 0) return err;
  int n_items = 0, C = 0, G = 0, clusters = 0;
  err = cluster_schedule(B, KV, S, width, &n_items, &C, &G, &clusters);
  if (err != 0) return err;
  const int nQ = (S + QT - 1) / QT;
  const int slices = (width + D - 1) / D;
  for (int g = 0; g < G && err == 0; ++g)
    err = clusterbwd::launch(
        cluster_kernel(G), C, clusters, NTHREADS, Smem<true>::SMEM, stream,
        mq, mk, mv, mdo, lse, delta, acc, static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        ly[5], ly[6], ly[7], sem, sem + (size_t)C * G * B * H * nQ + g, B, H,
        KV, S, width, scale, scale * LOG2E, g, slices);
  return err;
}

}  // namespace widebwd

namespace f32bwd {

using namespace bf16body;   // mbarriers, TMA loads, named barriers, sm_count
using bf16bwd::bulk_add;
using bf16bwd::bulk_commit_wait;
using bf16bwd::bulk_store;
using bf16bwd::bump;
using bf16bwd::cp_async4;
using bf16bwd::cp_async_arrive;
using bf16bwd::fence_async_global;
using bf16bwd::wait_count;

constexpr int KT = 64;          // keys per work item: the rows of dk and dv
constexpr int QT = 64;          // queries per step
constexpr int CONSUMERS = 256;  // two groups of 128 compute threads
constexpr int NTHREADS = CONSUMERS + 128;   // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PS = QT + 8;      // row stride (floats) of the P and dS tiles
constexpr int TS = QT + 4;      // row stride of the dS^T tile

static_assert(KT == QT, "the diagonal key tile of query tile qi is qi");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <=
                  65536 / NTHREADS / 8 * 8 * NTHREADS,
              "more registers than the block was launched with");

// An R-row float32 tile of D columns as TMA lands it: D / AW chunks of R
// rows x AW floats, one swizzle atom a row (128 B; 64 B at D = 16), so a
// 16-byte unit of a row sits at its index XOR the row's low bits.
template <int D, int R = 64>
struct Tile {
  static constexpr int AW = D < 32 ? D : 32;        // floats in a chunk row
  static constexpr int NC = D / AW;
  static constexpr int UPR = AW / 4;                // units in a chunk row
  static constexpr uint32_t ROW = AW * 4;
  static constexpr uint32_t CHUNK = R * ROW;
  static constexpr uint32_t BYTES = NC * CHUNK;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // the byte offset of 16-byte unit u (columns 4 u .. 4 u + 3) of row r
  static __device__ __forceinline__ uint32_t at(int r, int u) {
    const uint32_t off = r * ROW + (u % UPR) * 16;
    return (u / UPR) * CHUNK + (off ^ (((off >> 7) & (UPR - 1)) << 4));
  }
};

// Shared memory at head dim D: the item's K and V, the step's Q and dO
// (one slot: TMA, 64 rows each), the P and dS tiles (queries x keys) and
// the dS^T tile (keys x queries) with padded rows, dq's float32 share of
// the step (64 x D, in the dq threads' order), the step's lse and Delta,
// the current item, the mbarriers.  At D = 128: 128 KB of operand tiles,
// 52 KB of P, dS and dS^T, 32 KB of share, 512 B of lse and Delta, the
// rest and 1,024 B to align the base: 219,712 bytes of the 232,448 a
// block may take.  A second Q / dO slot (64 KB) does not fit beside the
// share; the next step's Q and dO load while dq's share is computed.
template <int D>
struct Smem {
  using T = Tile<D>;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = T::BYTES;
  static constexpr uint32_t Q_OFF = 2 * T::BYTES;
  static constexpr uint32_t DO_OFF = 3 * T::BYTES;
  static constexpr uint32_t P_OFF = 4 * T::BYTES;
  static constexpr uint32_t DS_OFF = P_OFF + QT * PS * 4;
  static constexpr uint32_t DST_OFF = DS_OFF + QT * PS * 4;
  static constexpr uint32_t SH_OFF = DST_OFF + KT * TS * 4;
  static constexpr uint32_t SHARE = QT * D * 4;
  static constexpr uint32_t LSE_OFF = SH_OFF + SHARE;
  static constexpr uint32_t DL_OFF = LSE_OFF + QT * 4;
  static constexpr uint32_t ITEM_OFF = DL_OFF + QT * 4;
  static constexpr uint32_t BAR_OFF = ITEM_OFF + 16;
  static constexpr size_t SMEM = BAR_OFF + 8 * 6 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
};

// How a thread's share of each product is laid out at head dim D.
//   S and dP (a group's 128 threads, 64 queries x 64 keys): queries
//   qa + 4 r (r < 8) x keys ka + 8 c (c < 4), the dot over D from 16-byte
//   units of both rows (LDS.128: a query row is one address for 8 lanes,
//   the 8 key rows of 8 lanes sit in 8 different units);
//   dv and dk (a group's 128 threads, 64 keys x D): KJ keys x UC column
//   units, summed over the step's queries (both operands rows of shared
//   tiles, LDS.64 or LDS.128);
//   dq's share (256 threads, 64 queries x D): QI consecutive queries x one
//   column unit, summed over the item's keys (dS^T rows, K rows).
template <int D>
struct Frag {
  static constexpr int UC = D == 128 ? 2 : 1;       // column units, dv / dk
  static constexpr int CG = D / (4 * UC);           // column groups
  static constexpr int KJ = 64 * CG / 128;          // keys a thread
  static constexpr int KW = KJ < 4 ? KJ : 4;        // keys a load
  static constexpr int DCG = D / 4;                 // dq's column groups
  static constexpr int QI = 64 * DCG / 256;         // dq's queries a thread
  static_assert(KJ * 4 * UC * 128 == 64 * D && QI * 4 * 256 == 64 * D,
                "every output of a tile owned once");
};

__device__ __forceinline__ float4 lds4(const uint8_t* p, uint32_t off) {
  return *reinterpret_cast<const float4*>(p + off);
}

// N (1, 2, 4 or 8) consecutive floats of shared memory at p
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// The main pass (float32, D in {16, 32, 64, 128}): persistent blocks over
// the work items (batch x KV head, 64-key tile), key-tile-major, as the
// tensor-core bodies; see the note at the top of the file.  Threads 0 ..
// 127 (group 0) compute S, P and dv, threads 128 .. 255 (group 1) dP, dS
// and dk, all 256 dq's share (232 registers each after setmaxnreg); the
// first warp of the last warpgroup is the producer (40).  `acc`: dq's
// float32 accumulator, a 64 x D tile for each (batch x head, query tile),
// in the dq threads' order; `sem` a counter for each such tile (the key
// tiles added so far), then the ticket counter, all zeroed by the Delta
// pass.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* acc,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv, Lay ldq, Lay ldk, Lay ldv,
                     int* sem, int* work, int B, int H, int KV, int S,
                     float scale) {
  using T = Tile<D>;
  using L = Smem<D>;
  using F = Frag<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  volatile int* item_s = reinterpret_cast<volatile int*>(gb + L::ITEM_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  // mbarriers: K and V full (TMA bytes) and empty (every compute thread,
  // after the item's last dq share); the step's Q / dO slot full (TMA
  // bytes and the producer warp's 32 cp.async arrivals for lse and Delta)
  // and empty (every compute thread, after dv and dk); dq's share staged
  // (every compute thread) and freed (the producer, its add complete)
  const uint32_t full_kv = bar, empty_kv = bar + 8, full = bar + 16,
                 empty = bar + 24, staged = bar + 32, freed = bar + 40;

  const int G = H / KV, BKV = B * KV;
  const int nQ = (S + QT - 1) / QT;          // query tiles = key tiles
  const int n_items = BKV * nQ;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, CONSUMERS);
    mbar_init(full, 33);
    mbar_init(empty, CONSUMERS);
    mbar_init(staged, CONSUMERS);
    mbar_init(freed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x >= CONSUMERS + 32) return;
    // the producer warp: takes the items, loads K and V once an item and
    // each step's Q, dO (lane 0, TMA), lse and Delta (every lane); once a
    // step's loads are issued, lane 0 adds the step before's dq share
    const int lane = threadIdx.x - CONSUMERS;
    int it = 0;                                  // steps so far
    int n_sh = 0;                                // shares added so far
    int p_bh = -1, p_qi = 0, p_kt = 0;           // the share pending
    // the pending share to the accumulator's tile: stored by key tile 0,
    // added by the later ones once the tile's counter reads their key
    // tile; the counter bumped once the add is complete
    auto add_share = [&]() {
      mbar_wait(staged, n_sh & 1);
      int* cnt = sem + p_bh * nQ + p_qi;
      float* dst = acc + ((size_t)p_bh * nQ + p_qi) * QT * D;
      if (p_kt > 0) {
        wait_count(cnt, p_kt);
        fence_async_global();
        bulk_add(dst, base + L::SH_OFF, L::SHARE);
      } else {
        bulk_store(dst, base + L::SH_OFF, L::SHARE);
      }
      bulk_commit_wait();
      fence_async_global();
      bump(cnt);
      mbar_arrive(freed);
      ++n_sh;
    };
    for (int n = 0;; ++n) {
      int item = 0;
      if (lane == 0) item = atomicAdd(work, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      mbar_wait(empty_kv, (n & 1) ^ 1);          // the last item done
      if (item >= n_items) {
        if (lane == 0) {
          *item_s = -1;
          mbar_arrive(full_kv);
          if (p_bh >= 0) add_share();
        }
        break;
      }
      const int bkv = item % BKV, kt = item / BKV;
      const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
      if (lane == 0) {
        *item_s = item;
        mbar_expect_tx(full_kv, 2 * T::BYTES);
        for (int c = 0; c < T::NC; ++c) {
          tma_load(base + L::K_OFF + c * T::CHUNK, &tk, full_kv, c * T::AW,
                   kvh, k0, b);
          tma_load(base + L::V_OFF + c * T::CHUNK, &tv, full_kv, c * T::AW,
                   kvh, k0, b);
        }
      }
      const int steps = G * (nQ - kt);
      for (int s = 0; s < steps; ++s, ++it) {
        const int qi = nQ - 1 - s / G, q0 = qi * QT;
        const int h = kvh * G + s % G;
        mbar_wait(empty, (it & 1) ^ 1);          // the step before read
        if (lane == 0) {
          mbar_expect_tx(full, 2 * T::BYTES);
          for (int c = 0; c < T::NC; ++c) {
            tma_load(base + L::Q_OFF + c * T::CHUNK, &tq, full, c * T::AW,
                     h, q0, b);
            tma_load(base + L::DO_OFF + c * T::CHUNK, &tdo, full,
                     c * T::AW, h, q0, b);
          }
        }
        for (int i = lane; i < QT; i += 32) {
          const bool in = q0 + i < S;
          const size_t g = (size_t)(b * H + h) * S + (in ? q0 + i : 0);
          cp_async4(base + L::LSE_OFF + i * 4, lse + g, in);
          cp_async4(base + L::DL_OFF + i * 4, delta + g, in);
        }
        cp_async_arrive(full);
        if (p_bh >= 0) {                        // staged while these load
          if (lane == 0) add_share();
          __syncwarp();
        }
        // the diagonal tile's share is never staged: its compute threads
        // round the sum into dq
        p_bh = qi == kt ? -1 : b * H + h;
        p_qi = qi;
        p_kt = kt;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    const int tid = threadIdx.x;
    // the group: 0 (S, P, dv) or 1 (dP, dS, dk); warp-uniform
    const int grp = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int g = tid % 128, warp = g / 32, lane = tid % 32;
    const int qa = 32 * (warp >> 1) + lane / 8;     // S and dP: queries
    const int ka = 32 * (warp & 1) + lane % 8;      // and keys
    const int cg = g % F::CG, jg = g / F::CG;       // dv and dk
    const int cu = tid % F::DCG, iq = tid / F::DCG * F::QI;   // dq
    float* ps = reinterpret_cast<float*>(gb + L::P_OFF);
    float* dss = reinterpret_cast<float*>(gb + L::DS_OFF);
    float* dst = reinterpret_cast<float*>(gb + L::DST_OFF);
    const float* lse_s = reinterpret_cast<const float*>(gb + L::LSE_OFF);
    const float* dl_s = reinterpret_cast<const float*>(gb + L::DL_OFF);
    // group 0: S from Q and K, then dv += P^T dO; group 1: dP from dO and
    // V, then dk += dS^T Q
    const uint32_t ta = grp ? L::DO_OFF : L::Q_OFF;
    const uint32_t tb = grp ? L::V_OFF : L::K_OFF;
    const float* pa = grp ? dss : ps;
    const uint32_t tc = grp ? L::Q_OFF : L::DO_OFF;

    float kv_acc[F::KJ][4 * F::UC];   // dv (group 0) or dk (group 1)
    float kv_step[F::KJ][4 * F::UC];  // the step's share of it
    float x[8][4];                    // S or dP, then P or dS
    int n_sh = 0;                     // shares staged so far
    int it = 0;                       // steps so far
    for (int n = 0;; ++n) {
      mbar_wait(full_kv, n & 1);
      const int item = *item_s;
      if (item < 0) break;
      const int bkv = item % BKV, kt = item / BKV;
      const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
      const int steps = G * (nQ - kt);
#pragma unroll
      for (int j = 0; j < F::KJ; ++j)
#pragma unroll
        for (int c = 0; c < 4 * F::UC; ++c) kv_acc[j][c] = 0.f;
      for (int s = 0; s < steps; ++s, ++it) {
        const int qi = nQ - 1 - s / G, q0 = qi * QT;
        const int h = kvh * G + s % G, bh = b * H + h;
        mbar_wait(full, it & 1);
        // S = Q K^T (group 0) or dP = dO V^T (group 1): each dot over D
        // in column order
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) x[r][c] = 0.f;
        // units unrolled by 4: by 8, ptxas spills at D = 128
#pragma unroll 1
        for (int ch = 0; ch < T::NC; ++ch) {
#pragma unroll 4
          for (int w = 0; w < T::UPR; ++w) {
            const int u = ch * T::UPR + w;
            float4 kf[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              kf[c] = lds4(gb, tb + T::at(ka + 8 * c, u));
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float4 qf = lds4(gb, ta + T::at(qa + 4 * r, u));
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                x[r][c] = fmaf(qf.x, kf[c].x, x[r][c]);
                x[r][c] = fmaf(qf.y, kf[c].y, x[r][c]);
                x[r][c] = fmaf(qf.z, kf[c].z, x[r][c]);
                x[r][c] = fmaf(qf.w, kf[c].w, x[r][c]);
              }
            }
          }
        }
        if (grp == 0) {
          // P = exp(S D^-0.5 - lse) for keys at or below the query and
          // queries below S, else 0, into the P tile
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int i = qa + 4 * r;
            const float ls = lse_s[i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = ka + 8 * c;
              ps[i * PS + j] = k0 + j <= q0 + i && q0 + i < S
                                   ? expf(fmaf(x[r][c], scale, -ls)) : 0.f;
            }
          }
          named_sync(2, 128);            // the P tile whole, for dv
          bar_arrive(1);                 // and for group 1's dS
        } else {
          bar_sync(1);                   // the P tile whole
          // dS = P (dP - Delta), into the dS and dS^T tiles
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int i = qa + 4 * r;
            const float dl = dl_s[i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = ka + 8 * c;
              const float d = ps[i * PS + j] * (x[r][c] - dl);
              dss[i * PS + j] = d;
              dst[j * TS + i] = d;
            }
          }
          named_sync(3, 128);            // the dS tile whole, for dk
          bar_arrive(4);                 // and dS^T for dq
        }
        // dv += P^T dO (group 0) or dk += dS^T Q (group 1): the step's
        // sum over its queries in order, then added to the item's
#pragma unroll
        for (int j = 0; j < F::KJ; ++j)
#pragma unroll
          for (int c = 0; c < 4 * F::UC; ++c) kv_step[j][c] = 0.f;
#pragma unroll 4
        for (int i = 0; i < QT; ++i) {
          float a[F::KJ];
#pragma unroll
          for (int m = 0; m < F::KJ / F::KW; ++m) {
            float y[F::KW];
            lds<F::KW>(y, pa + i * PS + F::KW * jg + 32 * m);
#pragma unroll
            for (int e = 0; e < F::KW; ++e) a[F::KW * m + e] = y[e];
          }
#pragma unroll
          for (int uu = 0; uu < F::UC; ++uu) {
            const float4 bv = lds4(gb, tc + T::at(i, cg + F::CG * uu));
#pragma unroll
            for (int j = 0; j < F::KJ; ++j) {
              float* y = kv_step[j] + 4 * uu;
              y[0] = fmaf(a[j], bv.x, y[0]);
              y[1] = fmaf(a[j], bv.y, y[1]);
              y[2] = fmaf(a[j], bv.z, y[2]);
              y[3] = fmaf(a[j], bv.w, y[3]);
            }
          }
        }
        mbar_arrive(empty);              // Q, dO, lse and Delta read
#pragma unroll
        for (int j = 0; j < F::KJ; ++j)
#pragma unroll
          for (int c = 0; c < 4 * F::UC; ++c) kv_acc[j][c] += kv_step[j][c];
        if (grp == 0) bar_sync(4);       // the dS^T tile whole
        // dq's share: dS K over the item's keys in order
        float dqa[F::QI][4];
#pragma unroll
        for (int r = 0; r < F::QI; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[r][e] = 0.f;
#pragma unroll 8
        for (int j = 0; j < KT; ++j) {
          float a[F::QI];
          lds<F::QI>(a, dst + j * TS + iq);
          const float4 kb = lds4(gb, L::K_OFF + T::at(j, cu));
#pragma unroll
          for (int r = 0; r < F::QI; ++r) {
            dqa[r][0] = fmaf(a[r], kb.x, dqa[r][0]);
            dqa[r][1] = fmaf(a[r], kb.y, dqa[r][1]);
            dqa[r][2] = fmaf(a[r], kb.z, dqa[r][2]);
            dqa[r][3] = fmaf(a[r], kb.w, dqa[r][3]);
          }
        }
        if (s == steps - 1) mbar_arrive(empty_kv);   // K and V read
        if (qi != kt) {
          // to the producer through the share buffer, once the last
          // share's add has read it: query iq + r's four columns as
          // float4 r * 256 + tid
          mbar_wait(freed, (n_sh & 1) ^ 1);
#pragma unroll
          for (int r = 0; r < F::QI; ++r)
            st_shared(base + L::SH_OFF + (r * CONSUMERS + tid) * 16,
                      dqa[r][0], dqa[r][1], dqa[r][2], dqa[r][3]);
          fence_async_smem();
          mbar_arrive(staged);
          ++n_sh;
        } else {
          // the diagonal tile, the last: the other key tiles' sum (all
          // of it added first) plus this share, scaled into dq
          if (kt > 0) {
            if (tid == 0) wait_count(sem + bh * nQ + qi, kt);
            named_sync(5, CONSUMERS);
            const float4* ap = reinterpret_cast<const float4*>(
                                   acc + ((size_t)bh * nQ + qi) * QT * D) +
                               tid;
#pragma unroll
            for (int r = 0; r < F::QI; ++r) {
              const float4 y = __ldcg(ap + r * CONSUMERS);
              dqa[r][0] = y.x + dqa[r][0];
              dqa[r][1] = y.y + dqa[r][1];
              dqa[r][2] = y.z + dqa[r][2];
              dqa[r][3] = y.w + dqa[r][3];
            }
          }
          float* out = at(dq, ldq, b, h) + 4 * cu;
#pragma unroll
          for (int r = 0; r < F::QI; ++r) {
            const int row = q0 + iq + r;
            if (row < S)
              *reinterpret_cast<float4*>(out + row * ldq.s) =
                  make_float4(dqa[r][0] * scale, dqa[r][1] * scale,
                              dqa[r][2] * scale, dqa[r][3] * scale);
          }
        }
      }
      // dv (group 0) or dk = D^-0.5 sum (group 1) of the item's keys
      float* out = grp ? at(dk, ldk, b, kvh) : at(dv, ldv, b, kvh);
      const long long rs = grp ? ldk.s : ldv.s;
      const float sc = grp ? scale : 1.f;
#pragma unroll
      for (int j = 0; j < F::KJ; ++j) {
        const int key = k0 + F::KW * jg + j % F::KW + 32 * (j / F::KW);
        if (key >= S) continue;
#pragma unroll
        for (int uu = 0; uu < F::UC; ++uu)
          *reinterpret_cast<float4*>(out + key * rs +
                                     4 * (cg + F::CG * uu)) =
              make_float4(kv_acc[j][4 * uu] * sc, kv_acc[j][4 * uu + 1] * sc,
                          kv_acc[j][4 * uu + 2] * sc,
                          kv_acc[j][4 * uu + 3] * sc);
      }
    }
  }
}

// a 4-D map over a (B, n heads, S, width) float32 tensor with element
// strides `l` (the last axis contiguous), seen as (width, n, S, B), for
// tiles of R rows x D >= width columns; boxes of {AW, 1, R, 1}: rows past
// S read as zeros, never the next head's, and so do columns width .. D - 1
template <int D, int R = 64>
int make_map(CUtensorMap* map, const void* ptr, const Lay& l, int n, int S,
             int B, int width = D) {
  using T = Tile<D, R>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)n,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)l.h * 4, (cuuint64_t)l.s * 4,
                                 (cuuint64_t)l.b * 4};
  const cuuint32_t box[4] = {(cuuint32_t)T::AW, 1, (cuuint32_t)R, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, T::SWIZZLE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The schedule for B x KV heads of S rows: the work items and the grid,
// one persistent block an SM (fewer if there are fewer items)
int schedule(int B, int KV, int S, int* items, int* blocks) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *items = B * KV * ((S + KT - 1) / KT);
  *blocks = *items < sms ? *items : sms;
  return 0;
}

// ly: the strides of q, k, v, o, dO, dq, dk, dv (each start and stride a
// multiple of 16 bytes); acc a float32 scratch of B * H * ceil(S / 64) *
// 64 * D; sem B * H * ceil(S / 64) + 1 ints, zeroed (the Delta pass)
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, float* acc, int* sem, const Lay* ly, int B, int H,
           int KV, int S, float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int err = make_map<D>(&mq, q, ly[0], H, S, B);
  if (err == 0) err = make_map<D>(&mdo, dout, ly[4], H, S, B);
  if (err == 0) err = make_map<D>(&mk, k, ly[1], KV, S, B);
  if (err == 0) err = make_map<D>(&mv, v, ly[2], KV, S, B);
  if (err != 0) return err;
  int n_items = 0, grid = 0;
  err = schedule(B, KV, S, &n_items, &grid);
  if (err != 0) return err;
  constexpr size_t smem = Smem<D>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nQ = (S + QT - 1) / QT;
  flash_bwd_f32_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, mdo, lse, delta, acc, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), ly[5], ly[6], ly[7],
      sem, sem + (size_t)B * H * nQ, B, H, KV, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32bwd

namespace f32wide {

using namespace bf16body;   // mbarriers, TMA loads, the work list, NEG
using f32bwd::lds;
using f32bwd::lds4;

constexpr int D = 256;          // the body's width (a narrower one read in place)
constexpr int BQ = 64;          // query rows of a work item, 8 a compute warp
constexpr int BK = 32;          // keys per K and V tile
constexpr int STAGES = 2;       // K and V tiles in the ring
constexpr int WARPS = 8;        // compute warps
constexpr int THREADS = 32 * WARPS + 128;  // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PT = BQ + 8;      // row stride (floats) of the P^T tile
constexpr int PARTS = 4;        // S: D split among 4 lanes

using TQ = f32bwd::Tile<D, BQ>;   // the item's Q: 64 KB
using TK = f32bwd::Tile<D, BK>;   // a K or V tile: 32 KB

// Shared memory: Q (64 rows, resident for the item), STAGES K tiles and
// STAGES V tiles of 32 rows (TMA, 128 B swizzled), the P^T tile (32 keys
// x 64 rows at a padded row of 72 floats: a lane's keys kq + 4 c put the
// 32 lanes' stores on 32 banks), each row's rescale factor and sum (2 x
// 64 floats), the current item, the mbarriers: 65,536 + 131,072 + 9,216 +
// 512 + 16 + 80 + 1,024 to align the base = 207,456 bytes of the 232,448
// a block may take.  (f32body's layout at D = 256, Q and K
// at pitch D + 1 beside V and P, takes 213,760 and holds one K and V
// tile: no room to load the next under the products.)
constexpr uint32_t Q_OFF = 0;
constexpr uint32_t K_OFF = TQ::BYTES;
constexpr uint32_t V_OFF = K_OFF + STAGES * TK::BYTES;
constexpr uint32_t P_OFF = V_OFF + STAGES * TK::BYTES;
constexpr uint32_t ROW_OFF = P_OFF + BK * PT * 4;
constexpr uint32_t ITEM_OFF = ROW_OFF + 2 * BQ * 4;
constexpr uint32_t BAR_OFF = ITEM_OFF + 16;
constexpr size_t SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;
static_assert(SMEM <= 232448, "more shared memory than a block may take");
// The cluster forward (CL) adds, after the mbarriers, the exchange of S's
// partials, two buffers of 8 warps x 2 16-byte units x 32 lanes (a
// tile's 64 x 32 float32 partials, a lane's row against 8 keys), the two
// ticket slots and 18 more mbarriers (the 16 warps' exchanges, the two
// tickets): 224,000 bytes.
constexpr uint32_t XBUF = clusterbwd::XWARPS * 2 * clusterbwd::XUNIT;
constexpr uint32_t X_OFF = (BAR_OFF + 8 * (2 + 4 * STAGES) + 15) / 16 * 16;
constexpr uint32_t TICK_OFF = X_OFF + 2 * XBUF;
constexpr uint32_t XBAR_OFF = TICK_OFF + 16;
constexpr size_t CL_SMEM = XBAR_OFF + 8 * (2 * clusterbwd::XWARPS + 2) + 1024;
static_assert(CL_SMEM <= 232448, "more shared memory than a block may take");
static_assert(BQ == 8 * WARPS, "a compute warp owns 8 rows of an item");
static_assert(WARPS == clusterbwd::XWARPS, "every compute warp exchanges");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 32 * WARPS <=
                  65536 / THREADS / 8 * 8 * THREADS,
              "more registers than the block was launched with");

// The forward at float32 and 128 < D <= 256 (see the note at the top of
// the file): persistent blocks over the bfloat16 bodies' work list (the
// last query tiles first, a GQA group's heads side by side), one ticket
// counter.  Compute warp w owns rows 8 w .. 8 w + 7 of an item.  S splits
// D four ways: lane (p, h, kq) = (lane / 8, lane / 4 % 2, lane % 4) sums
// units 16 p .. 16 p + 15 of the dots of rows 8 w + 4 h + r (r < 4) with
// keys kq + 4 c (c < 8) of a tile, 32 partial dots from 12 16-byte loads a
// unit (a warp's 16-byte load moves 512 bytes, 4 cycles of shared memory,
// whatever it broadcasts, so what counts is loads per product); xor
// shuffles add the quarters, (x0 + x1) + (x2 + x3), and leave the lane one
// row, 8 w + 4 h + 2 (p & 1) + p / 2, against 8 keys.  A row's max and sum
// are taken over its 4 lanes (xor shuffles).  P goes to the P^T tile
// (keys x rows) and the rows' rescale factors beside it, and P V gives
// each lane O of all 8 rows at 8 columns (units lane and lane + 32): per
// key two loads of P^T and two of V for 64 products.  No step waits on
// another warp.  `work`: the ticket counter, zero at the launch and left
// zero.
// The maps hold the operands' real width (a multiple of 4, at most 256):
// the columns past it land as zeros, and O is stored below it.
// CL: the cluster forward, block `rank` of a cluster of C on columns 256
// rank .. 256 rank + 255 of operands 256 < width <= 2048 wide (above,
// the walks, below), as
// Fwd<256>'s: the maps' coordinates start there, O is stored from there
// below width, rank 0 draws the tickets (and leaves the counter at zero)
// and writes lse, and each lane's row against its 8 keys of a tile (the
// quarters added) is summed over the ranks (clusterbwd::exchange) before
// the softmax.
// WALKS (above 2048), as Fwd<256>'s: walk `walk`, block `rank` owning
// slice rank + C walk; per key tile its slices below the width in turn,
// each slice's Q and K, every lane's quarter of the dots summed over them
// in slice order, then the quarters, the exchange, the softmax, and V of
// the owned slice.  The same bytes laid out for the walks: two Q slots
// (the second in the V stages' room, its mbarriers V stage 0's) and one
// ring of two stages (the K stages) that carries each tile's K tiles and
// then its V tile in load order, so that no slice waits for the one
// before it to be read: the next slice's Q and K land under its dots.
// Each Q slot has its own item word.
template <bool CL, bool WALKS = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          float* __restrict__ o, float* __restrict__ lse,
                          Lay lo, int* work, int B, int H, int KV, int S,
                          int width, float scale, int walk) {
  static_assert(!WALKS || CL, "walks: the cluster body");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  volatile int* item_s = reinterpret_cast<volatile int*>(gb + ITEM_OFF);
  const uint32_t bar = base + BAR_OFF;
  // mbarriers: Q full (TMA bytes) and empty (every compute thread, after
  // the item's last S); per stage K full and V full (TMA bytes), K empty
  // (every compute thread, after the tile's S) and V empty (after P V)
  const uint32_t full_q = bar, empty_q = bar + 8, full_k = bar + 16,
                 full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = empty_k + 8 * STAGES;
  // CL: per exchange buffer and compute warp the other ranks' arrivals,
  // and the two tickets'
  const uint32_t xin = base + XBAR_OFF, tick = xin + 16 * clusterbwd::XWARPS;

  const int G = H / KV;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;
  int C = 1, rank = 0;
  int own = 0;                                 // the owned slice
  if constexpr (CL) {
    C = clusterbwd::size();
    rank = clusterbwd::rank();
    own = rank;
    if constexpr (WALKS) own += C * walk;
    o += own * D;
    width -= own * D;                          // the slice's, >= 1 (WALKS:
                                               // <= 0 past the width)
    if (own != 0) lse = nullptr;               // rank 0 writes lse
  }
  const int col0 = own * D;                    // the slice's first column
  // WALKS: the block's slices below the width, rank + C jj for jj <
  // ns_(), read where it is used (registers are scarce in both roles)
  auto ns_ = [&]() {
    return clusterbwd::slices_of((width + own * D + D - 1) / D, rank, C);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 32 * WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 32 * WARPS);
      mbar_init(empty_v + 8 * s, 32 * WARPS);
    }
    if constexpr (CL) {
      for (int i = 0; i < 2 * clusterbwd::XWARPS; ++i)
        mbar_init(xin + 8 * i, C - 1);
      mbar_init(tick, 1);
      mbar_init(tick + 8, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL) clusterbwd::sync();        // every rank's mbarriers set

  if (threadIdx.x >= 32 * WARPS) {
    // the producer warpgroup's first thread takes the items and starts
    // every load; the compute warps take the registers it gives back (O,
    // S's partial dots and the loaded units take more than the 168 a
    // thread the launch allows)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    // CL: the other producer warps wait at the end with the others; the
    // first one's lanes wait for its first thread (below)
    if constexpr (CL) {
      if (threadIdx.x >= 32 * WARPS + 32) {
        clusterbwd::sync();
        return;
      }
    } else if (threadIdx.x != 32 * WARPS) {
      return;
    }
    int j = 0;                                   // K, V tiles loaded so far
    // WALKS: tile j (of all items so far) is Q loads j ns + jj and ring
    // loads j (ns + 1) + jj, its V the ring's next
    for (int n = 0; !CL || threadIdx.x == 32 * WARPS; ++n) {
      const int item = CL ? clusterbwd::ticket(work, base + TICK_OFF, tick,
                                               n, C, rank)
                          : atomicAdd(work, 1);
      if (item >= n_items) {
        // the last ticket of the launch puts the counter back to zero
        // (CL: a cluster draws one ticket a turn, rank 0 for all)
        if constexpr (CL) {
          if (rank == 0 && item == n_items + (int)gridDim.x / C - 1)
            atomicExch(work, 0);
        } else {
          if (item == n_items + (int)gridDim.x - 1) atomicExch(work, 0);
        }
        if constexpr (WALKS) {
          const int jq = j * ns_(), i = jq & 1;
          mbar_wait(i ? empty_v : empty_q, ((jq >> 1) & 1) ^ 1);
          item_s[i] = -1;
          mbar_arrive(i ? full_v : full_q);
        } else {
          mbar_wait(empty_q, (n & 1) ^ 1);
          *item_s = -1;
          mbar_arrive(full_q);
        }
        break;
      }
      int b, h, qt;
      work_item(item, B, H, n_qt, b, h, qt);
      const int kvh = h / G, q0 = qt * BQ;
      const int n_kv = (min(S, q0 + BQ) + BK - 1) / BK;
      if constexpr (WALKS) {
        // per key tile: each of the block's slices' Q (slot jq & 1) and K
        // (the ring), then the owned slice's V (the ring)
        auto ring_load = [&](const CUtensorMap* map, int col, int t,
                             int jr) {
          const int s = jr & 1;
          mbar_wait(empty_k + 8 * s, ((jr >> 1) & 1) ^ 1);
          mbar_expect_tx(full_k + 8 * s, TK::BYTES);
          for (int c = 0; c < TK::NC; ++c)
            tma_load(base + K_OFF + s * TK::BYTES + c * TK::CHUNK, map,
                     full_k + 8 * s, col + c * TK::AW, kvh, t * BK, b);
        };
        for (int t = 0; t < n_kv; ++t, ++j) {
          for (int jj = 0; jj < ns_(); ++jj) {
            const int col = (rank + C * jj) * D, jq = j * ns_() + jj;
            const int i = jq & 1;
            const uint32_t fq = i ? full_v : full_q;
            mbar_wait(i ? empty_v : empty_q, ((jq >> 1) & 1) ^ 1);
            if (t == 0 && jj == 0) item_s[i] = item;
            mbar_expect_tx(fq, TQ::BYTES);
            for (int c = 0; c < TQ::NC; ++c)
              tma_load(base + (i ? V_OFF : Q_OFF) + c * TQ::CHUNK, &tq, fq,
                       col + c * TQ::AW, h, q0, b);
            ring_load(&tk, col, t, j * (ns_() + 1) + jj);
          }
          ring_load(&tv, col0, t, (j + 1) * (ns_() + 1) - 1);
        }
        continue;
      }
      // K and V of key tile t into the next ring slot
      auto kv_load = [&](int t) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, TK::BYTES);
        for (int c = 0; c < TK::NC; ++c)
          tma_load(base + K_OFF + s * TK::BYTES + c * TK::CHUNK, &tk,
                   full_k + 8 * s, col0 + c * TK::AW, kvh, t * BK, b);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, TK::BYTES);
        for (int c = 0; c < TK::NC; ++c)
          tma_load(base + V_OFF + s * TK::BYTES + c * TK::CHUNK, &tv,
                   full_v + 8 * s, col0 + c * TK::AW, kvh, t * BK, b);
        ++j;
      };
      // the item's first tiles land while the consumers end the last item
      // (their slots are released by its last tiles alone), its Q once
      // the last item's S has released the one slot
      const int pre = min(n_kv, STAGES);
      for (int t = 0; t < pre; ++t) kv_load(t);
      mbar_wait(empty_q, (n & 1) ^ 1);
      *item_s = item;
      mbar_expect_tx(full_q, TQ::BYTES);
      for (int c = 0; c < TQ::NC; ++c)
        tma_load(base + Q_OFF + c * TQ::CHUNK, &tq, full_q, col0 + c * TQ::AW,
                 h, q0, b);
      for (int t = pre; t < n_kv; ++t) kv_load(t);
    }
    if constexpr (CL) __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int pq = lane / 8, kq = lane % 4;
    const int r4 = 8 * warp + 4 * (lane / 4 % 2);      // S: rows r4 + r
    const int ro = r4 + 2 * (pq & 1) + (pq >> 1);      // the lane's row
    float* pt = reinterpret_cast<float*>(gb + P_OFF);
    float* alpha_s = reinterpret_cast<float*>(gb + ROW_OFF);
    float* l_s = alpha_s + BQ;
    int j = 0;                                   // K, V tiles read so far
    // WALKS: tile t of an item is Q loads (j + t) ns + jj (slot: the
    // load's parity) and ring loads (j + t) (ns + 1) + jj, its V the
    // ring's next
    for (int n = 0;; ++n) {
      int item;
      if constexpr (WALKS) {
        const int jq = j * ns_();
        mbar_wait(jq & 1 ? full_v : full_q, (jq >> 1) & 1);
        item = item_s[jq & 1];
      } else {
        mbar_wait(full_q, n & 1);
        item = *item_s;
      }
      if (item < 0) break;
      int b, h, qt;
      work_item(item, B, H, n_qt, b, h, qt);
      const int q0 = qt * BQ;
      const int n_kv = (min(S, q0 + BQ) + BK - 1) / BK;
      // the lane's row: running max and sum; O: rows 8 warp + r8 x
      // columns 4 (lane + 32 uu) + e, element [r8][4 uu + e]
      float m = NEG, l = 0.f;
      float acc[8][8];
#pragma unroll
      for (int r8 = 0; r8 < 8; ++r8)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r8][e] = 0.f;
      for (int t = 0; t < n_kv; ++t, ++j) {
        const int s = j % STAGES;
        const uint32_t parity = (j / STAGES) & 1;
        // WALKS: the tile's V is the ring's load after its ns K tiles
        const int jv = (j + 1) * (ns_() + 1) - 1;
        const uint32_t ks = K_OFF + s * TK::BYTES;
        const uint32_t vs = WALKS ? K_OFF + (jv & 1) * TK::BYTES
                                  : V_OFF + s * TK::BYTES;
        const uint32_t full_vt = WALKS ? full_k + 8 * (jv & 1)
                                       : full_v + 8 * s;
        const uint32_t empty_vt = WALKS ? empty_k + 8 * (jv & 1)
                                        : empty_v + 8 * s;
        const uint32_t vpar = WALKS ? (jv >> 1) & 1 : parity;
        // S = Q K^T: each quarter of a dot over D in column order
        float x[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) x[r][c] = 0.f;
        if constexpr (WALKS) {
          // the block's slices in order, each quarter's chain carried on
          // (Q in slot jq & 1, K in the ring)
          for (int jj = 0; jj < ns_(); ++jj) {
            const int jq = j * ns_() + jj, jr = j * (ns_() + 1) + jj;
            const int i = jq & 1, sr = jr & 1;
            const uint32_t qb = i ? V_OFF : Q_OFF;
            const uint32_t kb = K_OFF + sr * TK::BYTES;
            if (t > 0 || jj > 0)
              mbar_wait(i ? full_v : full_q, (jq >> 1) & 1);
            mbar_wait(full_k + 8 * sr, (jr >> 1) & 1);
#pragma unroll 2
            for (int tt = 0; tt < D / 4 / PARTS; ++tt) {
              const int u = D / 4 / PARTS * pq + tt;
              float4 qf[4];
#pragma unroll
              for (int r = 0; r < 4; ++r)
                qf[r] = lds4(gb, qb + TQ::at(r4 + r, u));
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                const float4 kf = lds4(gb, kb + TK::at(kq + 4 * c, u));
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  x[r][c] = fmaf(qf[r].x, kf.x, x[r][c]);
                  x[r][c] = fmaf(qf[r].y, kf.y, x[r][c]);
                  x[r][c] = fmaf(qf[r].z, kf.z, x[r][c]);
                  x[r][c] = fmaf(qf[r].w, kf.w, x[r][c]);
                }
              }
            }
            mbar_arrive(empty_k + 8 * sr);       // K read
            mbar_arrive(i ? empty_v : empty_q);  // Q read
          }
        } else {
          mbar_wait(full_k + 8 * s, parity);
#pragma unroll 2
          for (int tt = 0; tt < D / 4 / PARTS; ++tt) {
            const int u = D / 4 / PARTS * pq + tt;
            float4 qf[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              qf[r] = lds4(gb, Q_OFF + TQ::at(r4 + r, u));
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float4 kf = lds4(gb, ks + TK::at(kq + 4 * c, u));
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                x[r][c] = fmaf(qf[r].x, kf.x, x[r][c]);
                x[r][c] = fmaf(qf[r].y, kf.y, x[r][c]);
                x[r][c] = fmaf(qf[r].z, kf.z, x[r][c]);
                x[r][c] = fmaf(qf[r].w, kf.w, x[r][c]);
              }
            }
          }
          mbar_arrive(empty_k + 8 * s);            // K read
          if (t == n_kv - 1) mbar_arrive(empty_q);   // Q read
        }
        // the quarters: p and p ^ 1 (lanes 8 apart) keep rows 0, 1 where
        // p is even and 2, 3 where it is odd, then p and p ^ 2 (16 apart)
        float z[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float y[2];
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const float mine = pq & 1 ? x[r2 + 2][c] : x[r2][c];
            const float other = pq & 1 ? x[r2][c] : x[r2 + 2][c];
            y[r2] = mine + __shfl_xor_sync(0xffffffffu, other, 8);
          }
          const float mine = pq & 2 ? y[1] : y[0];
          const float other = pq & 2 ? y[0] : y[1];
          z[c] = mine + __shfl_xor_sync(0xffffffffu, other, 16);
        }
        if constexpr (CL)                        // the sums over all of D
          clusterbwd::exchange(
              z, base + X_OFF + (j & 1) * XBUF + warp * 2 * clusterbwd::XUNIT +
                     lane * 16,
              xin + 8 * ((j & 1) * clusterbwd::XWARPS + warp), j, C, rank);
        // the online softmax of the lane's row over the tile's keys (its
        // 8, then its row's 4 lanes); P into the P^T tile
        const int k0 = t * BK, qpos = q0 + ro;
        float mt = NEG;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kpos = k0 + kq + 4 * c;
          z[c] = (kpos <= qpos && kpos < S) ? z[c] * scale : NEG;
          mt = fmaxf(mt, z[c]);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m, mt);
        const float alpha = expf(m - m_new);
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float p = expf(z[c] - m_new);
          pt[(kq + 4 * c) * PT + ro] = p;
          rs += p;
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l = l * alpha + rs;
        m = m_new;
        if (kq == 0) alpha_s[ro] = alpha;
        __syncwarp();                            // the warp's P and alphas
        float al[8];
        lds<8>(al, alpha_s + 8 * warp);
#pragma unroll
        for (int r8 = 0; r8 < 8; ++r8)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r8][e] *= al[r8];
        mbar_wait(full_vt, vpar);
        // O += P V: the tile's keys in order, the warp's 8 rows of P^T and
        // the lane's two column units of V
#pragma unroll 4
        for (int key = 0; key < BK; ++key) {
          float pr[8];
          lds<8>(pr, pt + key * PT + 8 * warp);
#pragma unroll
          for (int uu = 0; uu < 2; ++uu) {
            const float4 vf = lds4(gb, vs + TK::at(key, lane + 32 * uu));
#pragma unroll
            for (int r8 = 0; r8 < 8; ++r8) {
              float* y = acc[r8] + 4 * uu;
              y[0] = fmaf(pr[r8], vf.x, y[0]);
              y[1] = fmaf(pr[r8], vf.y, y[1]);
              y[2] = fmaf(pr[r8], vf.z, y[2]);
              y[3] = fmaf(pr[r8], vf.w, y[3]);
            }
          }
        }
        __syncwarp();                            // P read before it is rewritten
        mbar_arrive(empty_vt);                   // V read
      }
      // O / l from registers, rows below S and columns below the width;
      // lse from the rows' own lanes
      const float den = fmaxf(l, 1e-30f);
      if (kq == 0) {
        l_s[ro] = den;
        if (lse != nullptr && q0 + ro < S)
          lse[(size_t)(b * H + h) * S + q0 + ro] = m + logf(den);
      }
      __syncwarp();
      float dn[8];
      lds<8>(dn, l_s + 8 * warp);
      float* op = at(o, lo, b, h);
#pragma unroll
      for (int r8 = 0; r8 < 8; ++r8) {
        const int row = q0 + 8 * warp + r8;
        if (row >= S) continue;
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) {
          const int col = 4 * (lane + 32 * uu);
          if (col < width)
            *reinterpret_cast<float4*>(op + row * lo.s + col) =
                make_float4(acc[r8][4 * uu] / dn[r8],
                            acc[r8][4 * uu + 1] / dn[r8],
                            acc[r8][4 * uu + 2] / dn[r8],
                            acc[r8][4 * uu + 3] / dn[r8]);
        }
      }
      __syncwarp();                              // l_s read
    }
  }
  // no block leaves while another may still read its exchange buffers
  if constexpr (CL) clusterbwd::sync();
}

// The schedule for B x H heads of S rows: the work items (batch x head,
// 64-row query tile) and the grid, one persistent block an SM (fewer if
// there are fewer items).  `launch` and flash_attention_fwd_info both
// take it from here.
int schedule(int B, int H, int S, int* items, int* blocks) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *items = B * H * ((S + BQ - 1) / BQ);
  *blocks = *items < sms ? *items : sms;
  return 0;
}

// q, o (B, H, S, width), k, v (B, KV, S, width) float32 with the strides
// ly[0 .. 3] (starts and strides multiples of 16 bytes), width <= 256 a
// multiple of 4; lse null or float32 (B, H, S)
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Lay* ly, int B, int H, int KV, int S, int width,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = f32bwd::make_map<D, BQ>(&mq, q, ly[0], H, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, BK>(&mk, k, ly[1], KV, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, BK>(&mv, v, ly[2], KV, S, B, width);
  if (err != 0) return err;
  int* work = work_counter(stream);
  if (work == nullptr) return (int)cudaErrorMemoryAllocation;
  int n_items = 0, grid = 0;
  err = schedule(B, H, S, &n_items, &grid);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_wide_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32_wide_kernel<false><<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mv, static_cast<float*>(o), lse, ly[3], work, B, H, KV, S,
      width, scale, 0);
  return (int)cudaGetLastError();
}

// The cluster forward's instantiation at G walks (as Fwd<256>'s)
inline auto cluster_kernel(int G) {
  return G > 1 ? flash_fwd_f32_wide_kernel<true, true>
               : flash_fwd_f32_wide_kernel<true, false>;
}

// The cluster forward's schedule for operands `width` > 256 wide: the
// work items (as `schedule`'s), C blocks a cluster and G walks
// (clusterbwd::walks) and the clusters (one an item, up to what the
// device holds at once)
int cluster_schedule(int B, int H, int S, int width, int* items, int* C,
                     int* G, int* clusters) {
  *items = B * H * ((S + BQ - 1) / BQ);
  int n = 0;
  const int err = clusterbwd::walks(width, C, G, &n);
  if (err != 0) return err;
  return clusterbwd::schedule(reinterpret_cast<const void*>(cluster_kernel(*G)),
                              CL_SMEM, THREADS, *items, width, C, G,
                              clusters);
}

// The cluster forward at width > 256 (a multiple of 4): maps over the
// whole width, whose columns past it land as zeros and are not stored;
// G launches, one a walk, each on the stream's ticket counter, left at
// zero by the launch; lse written by the first
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Lay* ly, int B, int H, int KV, int S,
                   int width, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = f32bwd::make_map<D, BQ>(&mq, q, ly[0], H, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, BK>(&mk, k, ly[1], KV, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, BK>(&mv, v, ly[2], KV, S, B, width);
  if (err != 0) return err;
  int* work = work_counter(stream);
  if (work == nullptr) return (int)cudaErrorMemoryAllocation;
  int n_items = 0, C = 0, G = 0, clusters = 0;
  err = cluster_schedule(B, H, S, width, &n_items, &C, &G, &clusters);
  if (err != 0) return err;
  for (int g = 0; g < G && err == 0; ++g)
    err = clusterbwd::launch(cluster_kernel(G), C, clusters, THREADS,
                             CL_SMEM, stream, mq, mk, mv,
                             static_cast<float*>(o), g == 0 ? lse : nullptr,
                             ly[3], work, B, H, KV, S, width, scale, g);
  return err;
}

}  // namespace f32wide

namespace f32widebwd {

using namespace bf16body;   // mbarriers, TMA loads, named barriers, sm_count
using bf16bwd::bulk_add;
using bf16bwd::bulk_commit_wait;
using bf16bwd::bulk_store;
using bf16bwd::bump;
using bf16bwd::cp_async4;
using bf16bwd::cp_async_arrive;
using bf16bwd::fence_async_global;
using bf16bwd::wait_count;
using f32bwd::lds;
using f32bwd::lds4;

constexpr int D = 256;          // the body's width (a narrower one read in place)
constexpr int KT = 32;          // keys per work item: the rows of dk and dv
constexpr int QT = 32;          // queries per step
constexpr int CONSUMERS = 256;  // two groups of 128 compute threads
constexpr int NTHREADS = CONSUMERS + 128;   // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PS = QT + 4;      // row stride (floats) of the P and dS tiles
constexpr int TS = QT + 4;      // row stride of the dS^T tile
constexpr int PARTS = 4;        // S and dP: D split among 4 lanes
// dv and dk (a group's 128 threads, 32 keys x D): KJ consecutive keys x
// UC column units a thread; dq's share (256 threads, 32 queries x D): QI
// consecutive queries x one column unit
constexpr int UC = 2;
constexpr int CG = D / (4 * UC);            // column groups of dv and dk
constexpr int KJ = KT * CG / 128;           // their keys a thread
constexpr int DCG = D / 4;                  // dq's column groups
constexpr int QI = QT * DCG / CONSUMERS;    // dq's queries a thread

static_assert(KT == QT, "the diagonal key tile of query tile qi is qi");
static_assert(KJ * 4 * UC * 128 == KT * D && QI * 4 * CONSUMERS == QT * D,
              "every output of a tile owned once");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <=
                  65536 / NTHREADS / 8 * 8 * NTHREADS,
              "more registers than the block was launched with");

using T = f32bwd::Tile<D, KT>;  // K, V, Q and dO alike: 32 rows, 32 KB

// Shared memory: the item's K and V, the step's Q and dO (one slot), the
// P and dS tiles (queries x keys) and the dS^T tile (keys x queries) with
// padded rows, dq's float32 share of the step (32 x D, in the dq
// threads' order), the step's lse and Delta, the item, the mbarriers:
// 131,072 B of operand tiles, 13,824 of P, dS and dS^T, 32,768 of share,
// 256 of lse and Delta, the rest and 1,024 to align the base: 179,008
// bytes of the 232,448 a block may take.  A second Q / dO slot (64 KB)
// does not fit beside the share; the next step's Q and dO load while
// dq's share is computed, as at D <= 128.
constexpr uint32_t K_OFF = 0;
constexpr uint32_t V_OFF = T::BYTES;
constexpr uint32_t Q_OFF = 2 * T::BYTES;
constexpr uint32_t DO_OFF = 3 * T::BYTES;
constexpr uint32_t P_OFF = 4 * T::BYTES;
constexpr uint32_t DS_OFF = P_OFF + QT * PS * 4;
constexpr uint32_t DST_OFF = DS_OFF + QT * PS * 4;
constexpr uint32_t SH_OFF = DST_OFF + KT * TS * 4;
constexpr uint32_t SHARE = QT * D * 4;
constexpr uint32_t LSE_OFF = SH_OFF + SHARE;
constexpr uint32_t DL_OFF = LSE_OFF + QT * 4;
constexpr uint32_t ITEM_OFF = DL_OFF + QT * 4;
constexpr uint32_t BAR_OFF = ITEM_OFF + 16;
constexpr size_t SMEM = BAR_OFF + 8 * 6 + 1024;
static_assert(SMEM <= 232448, "more shared memory than a block may take");
// The cluster body (CL) adds, after the mbarriers, the exchange of S and
// dP partials, two buffers of 8 warps x 2 16-byte units x 32 lanes (a
// step's 32 x 32 of each, float32), the two ticket slots and 22 more
// mbarriers (the 16 warps' exchanges, the two tickets, the walks'
// sub-loads of S and of dP full and empty): 195,584 bytes.
constexpr uint32_t XBUF = clusterbwd::XWARPS * 2 * clusterbwd::XUNIT;
constexpr uint32_t X_OFF = (BAR_OFF + 8 * 6 + 15) / 16 * 16;
constexpr uint32_t TICK_OFF = X_OFF + 2 * XBUF;
constexpr uint32_t XBAR_OFF = TICK_OFF + 16;
constexpr size_t CL_SMEM = XBAR_OFF + 8 * (2 * clusterbwd::XWARPS + 6) + 1024;
static_assert(CL_SMEM <= 232448, "more shared memory than a block may take");

// The main pass (float32, 128 < D <= 256): f32bwd's roles, list order,
// walk, tickets, counters and dq add order over items of 32 keys and
// steps of 32 queries; see the note at the top of the file.  Threads 0 ..
// 127 (group 0) compute S, P and dv, threads 128 .. 255 (group 1) dP, dS
// and dk, all 256 dq's share (232 registers each after setmaxnreg); the
// first warp of the last warpgroup is the producer (40).  S and dP split
// D four ways: lane (p, rg) = (lane / 8, lane % 8) of a group's warp w
// sums units 16 p .. 16 p + 15 of the dots of queries rg + 8 r (r < 4)
// with keys 8 w + c (c < 8), 32 partial dots from 12 16-byte loads a
// unit (a 4 x 2 tile over all of D would take 6 loads for 8 dots, and a
// warp's 16-byte load moves 512 bytes, 4 cycles of shared memory,
// whatever it broadcasts); xor shuffles then add the quarters, (x0 + x1)
// + (x2 + x3), and leave each lane one query, rg + 8 (2 (p & 1) + p /
// 2), against the warp's 8 keys.  `acc`: dq's
// float32 accumulator, a 32 x D tile for each (batch x head, query tile),
// in the dq threads' order; `sem` a counter for each such tile, then the
// ticket counter, all zeroed by the Delta pass.  The maps hold the
// operands' real width (a multiple of 4, at most D): the columns past it
// land as zeros, and the gradients are stored below it.
// CL: the cluster body, block `rank` of a cluster of C on columns 256 rank
// .. 256 rank + 255 of operands `width` > 256 wide, as widebwd's: the
// maps' coordinates start there, dq, dk and dv are stored from there
// below width, acc and sem are the slice's own regions, `work` the ticket
// counter after all of them; rank 0 draws the tickets, and each group's S
// or dP is summed over the ranks (clusterbwd::exchange) before P and dS.
// WALKS (above 2048), as widebwd's: walk `walk`, block `rank` owning
// slice rank + C walk; each step first carries each lane's quarter chain
// of S (group 0) and dP (group 1) over the block's other slices below the
// width in ascending order, through the step's Q / dO slot (a slice's K
// and Q for group 0, then its V and dO for group 1: an mbarrier pair
// each), and then over the owned slice as above.
template <bool CL, bool WALKS = false>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* acc,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, Lay ldq, Lay ldk, Lay ldv,
                          int* sem, int* work, int B, int H, int KV, int S,
                          int width, float scale, int walk) {
  static_assert(!WALKS || CL, "walks: the cluster body");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  volatile int* item_s = reinterpret_cast<volatile int*>(gb + ITEM_OFF);
  const uint32_t bar = base + BAR_OFF;
  // mbarriers, as f32bwd's: K and V full and empty; the step's Q / dO
  // slot full (TMA bytes and the producer warp's 32 cp.async arrivals)
  // and empty; dq's share staged and freed
  const uint32_t full_kv = bar, empty_kv = bar + 8, full = bar + 16,
                 empty = bar + 24, staged = bar + 32, freed = bar + 40;
  // CL: per exchange buffer and compute warp the other ranks' arrivals,
  // and the two tickets'; WALKS: the sub-loads of S (a) and of dP (b),
  // full and empty
  const uint32_t xin = base + XBAR_OFF, tick = xin + 16 * clusterbwd::XWARPS;
  const uint32_t full_a = tick + 16, empty_a = full_a + 8,
                 full_b = full_a + 16, empty_b = full_a + 24;

  const int G = H / KV, BKV = B * KV;
  const int nQ = (S + QT - 1) / QT;          // query tiles = key tiles
  const int n_items = BKV * nQ;
  int C = 1, rank = 0;
  // the owned slice; WALKS: the block's slices below the width (rank + C
  // jj) but the owned one: n_other
  int own = 0, n_other = 0;
  if constexpr (CL) {
    C = clusterbwd::size();
    rank = clusterbwd::rank();
    own = rank;
    if constexpr (WALKS) {
      own += C * walk;
      n_other = clusterbwd::others((width + D - 1) / D, rank, C, walk);
    }
    sem += (size_t)own * B * H * nQ;
    acc += (size_t)own * B * H * nQ * QT * D;
    dq += own * D;
    dk += own * D;
    dv += own * D;
    width -= own * D;                        // the slice's, >= 1 (WALKS:
                                             // <= 0 past the width)
  }
  const int col0 = own * D;                  // the slice's first column
  // dq's accumulator tile and share: QT queries x U column units (4
  // floats), U = DCG but in a last slice narrower than 256 columns, whose
  // units past its width are neither staged nor read (WALKS: none in a
  // slice past the width); in the dq threads' order, [r][query group tid /
  // DCG][unit] for query iq + r
  const int U = CL ? (WALKS ? max(0, min(DCG, (width + 3) / 4))
                            : min(DCG, (width + 3) / 4))
                   : DCG;
  const size_t TF = (size_t)QT * 4 * U;      // floats a tile

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, CONSUMERS);
    mbar_init(full, 33);
    mbar_init(empty, CONSUMERS);
    mbar_init(staged, CONSUMERS);
    mbar_init(freed, 1);
    if constexpr (CL) {
      for (int i = 0; i < 2 * clusterbwd::XWARPS; ++i)
        mbar_init(xin + 8 * i, C - 1);
      mbar_init(tick, 1);
      mbar_init(tick + 8, 1);
    }
    if constexpr (WALKS) {
      mbar_init(full_a, 1);
      mbar_init(empty_a, 128);               // group 0
      mbar_init(full_b, 1);
      mbar_init(empty_b, 128);               // group 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL) clusterbwd::sync();    // every rank's mbarriers set

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x >= CONSUMERS + 32) {
      if constexpr (CL) clusterbwd::sync();  // with the others, at the end
      return;
    }
    // the producer warp: takes the items, loads K and V once an item and
    // each step's Q, dO (lane 0, TMA), lse and Delta (every lane); once a
    // step's loads are issued, lane 0 adds the step before's dq share
    const int lane = threadIdx.x - CONSUMERS;
    int it = 0;                                  // steps so far
    int n_sh = 0;                                // shares added so far
    int p_bh = -1, p_qi = 0, p_kt = 0;           // the share pending
    // the pending share to the accumulator's tile: stored by key tile 0,
    // added by the later ones once the tile's counter reads their key
    // tile; the counter bumped once the add is complete
    auto add_share = [&]() {
      mbar_wait(staged, n_sh & 1);
      int* cnt = sem + p_bh * nQ + p_qi;
      float* dst = acc + ((size_t)p_bh * nQ + p_qi) * TF;
      if (p_kt > 0) {
        wait_count(cnt, p_kt);
        fence_async_global();
        if (!WALKS || TF > 0) bulk_add(dst, base + SH_OFF, TF * 4);
      } else if (!WALKS || TF > 0) {
        bulk_store(dst, base + SH_OFF, TF * 4);
      }
      bulk_commit_wait();
      fence_async_global();
      bump(cnt);
      mbar_arrive(freed);
      ++n_sh;
    };
    for (int n = 0;; ++n) {
      int item = 0;
      if (lane == 0)
        item = CL ? clusterbwd::ticket(work, base + TICK_OFF, tick, n, C,
                                       rank)
                  : atomicAdd(work, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      mbar_wait(empty_kv, (n & 1) ^ 1);          // the last item done
      if (item >= n_items) {
        if (lane == 0) {
          *item_s = -1;
          mbar_arrive(full_kv);
          if (p_bh >= 0) add_share();
        }
        break;
      }
      const int bkv = item % BKV, kt = item / BKV;
      const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
      if (lane == 0) {
        *item_s = item;
        mbar_expect_tx(full_kv, 2 * T::BYTES);
        for (int c = 0; c < T::NC; ++c) {
          tma_load(base + K_OFF + c * T::CHUNK, &tk, full_kv,
                   col0 + c * T::AW, kvh, k0, b);
          tma_load(base + V_OFF + c * T::CHUNK, &tv, full_kv,
                   col0 + c * T::AW, kvh, k0, b);
        }
      }
      const int steps = G * (nQ - kt);
      for (int s = 0; s < steps; ++s, ++it) {
        const int qi = nQ - 1 - s / G, q0 = qi * QT;
        const int h = kvh * G + s % G;
        mbar_wait(empty, (it & 1) ^ 1);          // the step before read
        if (lane == 0) {
          if constexpr (WALKS) {
            // the other slices in ascending order through the slot: K
            // (Q tile) and Q (dO tile) for group 0's S, then V and dO for
            // group 1's dP, each once the one before is read (step it's
            // i-th is the pairs' phase it n_other + i)
            for (int i = 0; i < n_other; ++i) {
              const int col = (rank + C * (i + (i >= walk))) * D;
              const int nx = it * n_other + i;
              mbar_wait(empty_b, (nx & 1) ^ 1);
              mbar_expect_tx(full_a, 2 * T::BYTES);
              for (int c = 0; c < T::NC; ++c) {
                tma_load(base + Q_OFF + c * T::CHUNK, &tk, full_a,
                         col + c * T::AW, kvh, k0, b);
                tma_load(base + DO_OFF + c * T::CHUNK, &tq, full_a,
                         col + c * T::AW, h, q0, b);
              }
              mbar_wait(empty_a, nx & 1);
              mbar_expect_tx(full_b, 2 * T::BYTES);
              for (int c = 0; c < T::NC; ++c) {
                tma_load(base + Q_OFF + c * T::CHUNK, &tv, full_b,
                         col + c * T::AW, kvh, k0, b);
                tma_load(base + DO_OFF + c * T::CHUNK, &tdo, full_b,
                         col + c * T::AW, h, q0, b);
              }
            }
            mbar_wait(empty_b, ((it + 1) * n_other & 1) ^ 1);  // the last read
          }
          mbar_expect_tx(full, 2 * T::BYTES);
          for (int c = 0; c < T::NC; ++c) {
            tma_load(base + Q_OFF + c * T::CHUNK, &tq, full,
                     col0 + c * T::AW, h, q0, b);
            tma_load(base + DO_OFF + c * T::CHUNK, &tdo, full,
                     col0 + c * T::AW, h, q0, b);
          }
        }
        {                                        // one row a lane
          const bool in = q0 + lane < S;
          const size_t g = (size_t)(b * H + h) * S + (in ? q0 + lane : 0);
          cp_async4(base + LSE_OFF + lane * 4, lse + g, in);
          cp_async4(base + DL_OFF + lane * 4, delta + g, in);
        }
        cp_async_arrive(full);
        if (p_bh >= 0) {                        // staged while these load
          if (lane == 0) add_share();
          __syncwarp();
        }
        // the diagonal tile's share is never staged: its compute threads
        // round the sum into dq
        p_bh = qi == kt ? -1 : b * H + h;
        p_qi = qi;
        p_kt = kt;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    const int tid = threadIdx.x;
    // the group: 0 (S, P, dv) or 1 (dP, dS, dk); warp-uniform
    const int grp = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int g = tid % 128, warp = g / 32, lane = tid % 32;
    // S and dP: D's quarter p, queries rg + 8 r x keys k8 + c; then the
    // lane's own query qo against the 8 keys
    const int pq = lane / 8, rg = lane % 8, k8 = 8 * warp;
    const int qo = rg + 8 * (2 * (pq & 1) + (pq >> 1));
    const int cg = g % CG, jg = g / CG;         // dv and dk
    const int cu = tid % DCG, iq = tid / DCG * QI;   // dq
    // the thread's float4 of a query's row of the share: [group][unit]
    // (tid itself at U = DCG)
    const int so = CL ? tid / DCG * U + cu : tid;
    float* ps = reinterpret_cast<float*>(gb + P_OFF);
    float* dss = reinterpret_cast<float*>(gb + DS_OFF);
    float* dst = reinterpret_cast<float*>(gb + DST_OFF);
    const float* lse_s = reinterpret_cast<const float*>(gb + LSE_OFF);
    const float* dl_s = reinterpret_cast<const float*>(gb + DL_OFF);
    // group 0: S from Q and K, then dv += P^T dO; group 1: dP from dO and
    // V, then dk += dS^T Q
    const uint32_t ta = grp ? DO_OFF : Q_OFF;
    const uint32_t tb = grp ? V_OFF : K_OFF;
    const float* pa = grp ? dss : ps;
    const uint32_t tc = grp ? Q_OFF : DO_OFF;

    float kv_acc[KJ][4 * UC];   // dv (group 0) or dk (group 1)
    float kv_step[KJ][4 * UC];  // the step's share of it
    float x[4][8];              // S or dP over the lane's quarter of D
    float z[8];                 // the lane's query: S or dP, then P or dS
    int n_sh = 0;               // shares staged so far
    int it = 0;                 // steps so far
    for (int n = 0;; ++n) {
      mbar_wait(full_kv, n & 1);
      const int item = *item_s;
      if (item < 0) break;
      const int bkv = item % BKV, kt = item / BKV;
      const int b = bkv / KV, kvh = bkv % KV, k0 = kt * KT;
      const int steps = G * (nQ - kt);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
#pragma unroll
        for (int c = 0; c < 4 * UC; ++c) kv_acc[j][c] = 0.f;
      for (int s = 0; s < steps; ++s, ++it) {
        const int qi = nQ - 1 - s / G, q0 = qi * QT;
        const int h = kvh * G + s % G, bh = b * H + h;
        // S = Q K^T (group 0) or dP = dO V^T (group 1): each quarter of
        // a dot over D in column order, then the quarters added (WALKS:
        // each quarter's chain over the other slices first, from the
        // slot: Q or dO in its dO tile, K or V in its Q tile)
        auto dots = [&](uint32_t ta, uint32_t tb) {
#pragma unroll 2
          for (int t = 0; t < D / 4 / PARTS; ++t) {
            const int u = D / 4 / PARTS * pq + t;
            float4 qf[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              qf[r] = lds4(gb, ta + T::at(rg + 8 * r, u));
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float4 kf = lds4(gb, tb + T::at(k8 + c, u));
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                x[r][c] = fmaf(qf[r].x, kf.x, x[r][c]);
                x[r][c] = fmaf(qf[r].y, kf.y, x[r][c]);
                x[r][c] = fmaf(qf[r].z, kf.z, x[r][c]);
                x[r][c] = fmaf(qf[r].w, kf.w, x[r][c]);
              }
            }
          }
        };
        if constexpr (WALKS) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) x[r][c] = 0.f;
          // group 0 reads each other slice's K and Q (full_a, empty_a),
          // group 1 its V and dO (full_b, empty_b): step it's i-th is
          // the pair's phase it n_other + i
          for (int i = 0; i < n_other; ++i) {
            mbar_wait(full_a + 16 * grp, (it * n_other + i) & 1);
            dots(DO_OFF, Q_OFF);
            mbar_arrive(empty_a + 16 * grp);
          }
          mbar_wait(full, it & 1);
        } else {
          mbar_wait(full, it & 1);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) x[r][c] = 0.f;
        }
        dots(ta, tb);
        // quarters p and p ^ 1 (lanes 8 apart): rows 0, 1 stay where p is
        // even, rows 2, 3 where it is odd; then p and p ^ 2 (16 apart)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float y[2];
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const float mine = pq & 1 ? x[r2 + 2][c] : x[r2][c];
            const float other = pq & 1 ? x[r2][c] : x[r2 + 2][c];
            y[r2] = mine + __shfl_xor_sync(0xffffffffu, other, 8);
          }
          const float mine = pq & 2 ? y[1] : y[0];
          const float other = pq & 2 ? y[0] : y[1];
          z[c] = mine + __shfl_xor_sync(0xffffffffu, other, 16);
        }
        if constexpr (CL)                // the sums over all of D
          clusterbwd::exchange(    // compute warp tid / 32: 0 .. 7
              z, base + X_OFF + (it & 1) * XBUF + tid / 32 * 2 *
                     clusterbwd::XUNIT + lane * 16,
              xin + 8 * ((it & 1) * clusterbwd::XWARPS + tid / 32), it, C,
              rank);
        if (grp == 0) {
          // P = exp(S D^-0.5 - lse) for keys at or below the query and
          // queries below S, else 0, into the P tile
          const float ls = lse_s[qo];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            z[c] = k0 + k8 + c <= q0 + qo && q0 + qo < S
                       ? expf(fmaf(z[c], scale, -ls)) : 0.f;
          float4* pw = reinterpret_cast<float4*>(ps + qo * PS + k8);
          pw[0] = make_float4(z[0], z[1], z[2], z[3]);
          pw[1] = make_float4(z[4], z[5], z[6], z[7]);
          named_sync(2, 128);            // the P tile whole, for dv
          bar_arrive(1);                 // and for group 1's dS
        } else {
          bar_sync(1);                   // the P tile whole
          // dS = P (dP - Delta), into the dS and dS^T tiles
          const float dl = dl_s[qo];
          float pr[8];
          lds<8>(pr, ps + qo * PS + k8);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            z[c] = pr[c] * (z[c] - dl);
            dst[(k8 + c) * TS + qo] = z[c];
          }
          float4* dw = reinterpret_cast<float4*>(dss + qo * PS + k8);
          dw[0] = make_float4(z[0], z[1], z[2], z[3]);
          dw[1] = make_float4(z[4], z[5], z[6], z[7]);
          named_sync(3, 128);            // the dS tile whole, for dk
          bar_arrive(4);                 // and dS^T for dq
        }
        // dv += P^T dO (group 0) or dk += dS^T Q (group 1): the step's
        // sum over its queries in order, then added to the item's
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
          for (int c = 0; c < 4 * UC; ++c) kv_step[j][c] = 0.f;
#pragma unroll 4
        for (int i = 0; i < QT; ++i) {
          float a[KJ];
          lds<KJ>(a, pa + i * PS + KJ * jg);
#pragma unroll
          for (int uu = 0; uu < UC; ++uu) {
            const float4 bv = lds4(gb, tc + T::at(i, cg + CG * uu));
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              float* y = kv_step[j] + 4 * uu;
              y[0] = fmaf(a[j], bv.x, y[0]);
              y[1] = fmaf(a[j], bv.y, y[1]);
              y[2] = fmaf(a[j], bv.z, y[2]);
              y[3] = fmaf(a[j], bv.w, y[3]);
            }
          }
        }
        mbar_arrive(empty);              // Q, dO, lse and Delta read
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
          for (int c = 0; c < 4 * UC; ++c) kv_acc[j][c] += kv_step[j][c];
        if (grp == 0) bar_sync(4);       // the dS^T tile whole
        // dq's share: dS K over the item's keys in order
        float dqa[QI][4];
#pragma unroll
        for (int r = 0; r < QI; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[r][e] = 0.f;
#pragma unroll 8
        for (int j = 0; j < KT; ++j) {
          float a[QI];
          lds<QI>(a, dst + j * TS + iq);
          const float4 kb = lds4(gb, K_OFF + T::at(j, cu));
#pragma unroll
          for (int r = 0; r < QI; ++r) {
            dqa[r][0] = fmaf(a[r], kb.x, dqa[r][0]);
            dqa[r][1] = fmaf(a[r], kb.y, dqa[r][1]);
            dqa[r][2] = fmaf(a[r], kb.z, dqa[r][2]);
            dqa[r][3] = fmaf(a[r], kb.w, dqa[r][3]);
          }
        }
        if (s == steps - 1) mbar_arrive(empty_kv);   // K and V read
        if (qi != kt) {
          // to the producer through the share buffer, once the last
          // share's add has read it: query iq + r's four columns as
          // float4 r * 4 U + so (r * 256 + tid at U = DCG)
          mbar_wait(freed, (n_sh & 1) ^ 1);
          if (!CL || cu < U) {
#pragma unroll
            for (int r = 0; r < QI; ++r)
              st_shared(base + SH_OFF + (r * 4 * U + so) * 16, dqa[r][0],
                        dqa[r][1], dqa[r][2], dqa[r][3]);
          }
          fence_async_smem();
          mbar_arrive(staged);
          ++n_sh;
        } else {
          // the diagonal tile, the last: the other key tiles' sum (all
          // of it added first) plus this share, scaled into dq
          if (kt > 0) {
            if (tid == 0) wait_count(sem + bh * nQ + qi, kt);
            named_sync(5, CONSUMERS);
            const float4* ap = reinterpret_cast<const float4*>(
                                   acc + ((size_t)bh * nQ + qi) * TF) +
                               so;
#pragma unroll
            for (int r = 0; r < QI; ++r) {
              if (CL && cu >= U) break;      // a unit past the width
              const float4 y = __ldcg(ap + r * 4 * U);
              dqa[r][0] = y.x + dqa[r][0];
              dqa[r][1] = y.y + dqa[r][1];
              dqa[r][2] = y.z + dqa[r][2];
              dqa[r][3] = y.w + dqa[r][3];
            }
          }
          float* out = at(dq, ldq, b, h) + 4 * cu;
          if (4 * cu < width) {
#pragma unroll
            for (int r = 0; r < QI; ++r) {
              const int row = q0 + iq + r;
              if (row < S)
                *reinterpret_cast<float4*>(out + row * ldq.s) =
                    make_float4(dqa[r][0] * scale, dqa[r][1] * scale,
                                dqa[r][2] * scale, dqa[r][3] * scale);
            }
          }
        }
      }
      // dv (group 0) or dk = D^-0.5 sum (group 1) of the item's keys
      float* out = grp ? at(dk, ldk, b, kvh) : at(dv, ldv, b, kvh);
      const long long rs = grp ? ldk.s : ldv.s;
      const float sc = grp ? scale : 1.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = k0 + KJ * jg + j;
        if (key >= S) continue;
#pragma unroll
        for (int uu = 0; uu < UC; ++uu) {
          const int col = 4 * (cg + CG * uu);
          if (col < width)
            *reinterpret_cast<float4*>(out + key * rs + col) =
                make_float4(kv_acc[j][4 * uu] * sc,
                            kv_acc[j][4 * uu + 1] * sc,
                            kv_acc[j][4 * uu + 2] * sc,
                            kv_acc[j][4 * uu + 3] * sc);
        }
      }
    }
  }
  // no block leaves while another may still read its exchange buffers
  if constexpr (CL) clusterbwd::sync();
}

// The schedule for B x KV heads of S rows: the work items (batch x KV
// head, 32-key tile) and the grid, one persistent block an SM (fewer if
// there are fewer items)
int schedule(int B, int KV, int S, int* items, int* blocks) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *items = B * KV * ((S + KT - 1) / KT);
  *blocks = *items < sms ? *items : sms;
  return 0;
}

// ly: the strides of q, k, v, o, dO, dq, dk, dv (each start and stride a
// multiple of 16 bytes), width <= D a multiple of 4; acc a float32
// scratch of B * H * ceil(S / 32) * 32 * D; sem B * H * ceil(S / 32) + 1
// ints, zeroed (the Delta pass)
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, float* acc, int* sem, const Lay* ly, int B, int H,
           int KV, int S, int width, float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int err = f32bwd::make_map<D, QT>(&mq, q, ly[0], H, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, QT>(&mdo, dout, ly[4], H, S, B,
                                              width);
  if (err == 0) err = f32bwd::make_map<D, KT>(&mk, k, ly[1], KV, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, KT>(&mv, v, ly[2], KV, S, B, width);
  if (err != 0) return err;
  int n_items = 0, grid = 0;
  err = schedule(B, KV, S, &n_items, &grid);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_f32_wide_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nQ = (S + QT - 1) / QT;
  flash_bwd_f32_wide_kernel<false><<<grid, NTHREADS, SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, acc, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), ly[5], ly[6], ly[7],
      sem, sem + (size_t)B * H * nQ, B, H, KV, S, width, scale, 0);
  return (int)cudaGetLastError();
}

// The cluster body's instantiation at G walks (as widebwd's)
inline auto cluster_kernel(int G) {
  return G > 1 ? flash_bwd_f32_wide_kernel<true, true>
               : flash_bwd_f32_wide_kernel<true, false>;
}

// The cluster body's schedule for operands `width` > 256 wide: the work
// items, C blocks a cluster and G walks (clusterbwd::walks) and the
// clusters
int cluster_schedule(int B, int KV, int S, int width, int* items, int* C,
                     int* G, int* clusters) {
  *items = B * KV * ((S + KT - 1) / KT);
  int n = 0;
  const int err = clusterbwd::walks(width, C, G, &n);
  if (err != 0) return err;
  return clusterbwd::schedule(reinterpret_cast<const void*>(cluster_kernel(*G)),
                              CL_SMEM, NTHREADS, *items, width, C, G,
                              clusters);
}

// The cluster body at width > 256 (a multiple of 4): acc a float32
// scratch of B * H * ceil(S / 32) * 32 * width (a region of 256-column
// tiles a slice, the last slice's tiles as wide as its columns) and sem
// C * G * B * H * ceil(S / 32) + G ints, zeroed (the Delta pass), one
// region of counters a slice of the C G the walks own, then each walk's
// ticket counter; G launches, one a walk
int launch_cluster(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, float* acc, int* sem,
                   const Lay* ly, int B, int H, int KV, int S, int width,
                   float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int err = f32bwd::make_map<D, QT>(&mq, q, ly[0], H, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, QT>(&mdo, dout, ly[4], H, S, B,
                                              width);
  if (err == 0) err = f32bwd::make_map<D, KT>(&mk, k, ly[1], KV, S, B, width);
  if (err == 0) err = f32bwd::make_map<D, KT>(&mv, v, ly[2], KV, S, B, width);
  if (err != 0) return err;
  int n_items = 0, C = 0, G = 0, clusters = 0;
  err = cluster_schedule(B, KV, S, width, &n_items, &C, &G, &clusters);
  if (err != 0) return err;
  const int nQ = (S + QT - 1) / QT;
  for (int g = 0; g < G && err == 0; ++g)
    err = clusterbwd::launch(
        cluster_kernel(G), C, clusters, NTHREADS, CL_SMEM, stream, mq, mk,
        mv, mdo, lse, delta, acc, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), ly[5], ly[6],
        ly[7], sem, sem + (size_t)C * G * B * H * nQ + g, B, H, KV, S, width,
        scale, g);
  return err;
}

}  // namespace f32widebwd

}  // namespace

// q, o: (B, H, S, width); k, v: (B, KV, S, width), float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1), run by the body of head dim D; strides: 12
// element strides, (batch, head, row) of q, k, v and o in that order,
// each a multiple of 16 bytes, the last axis contiguous; lse null or a
// contiguous float32 (B, H, S) that receives each row's natural
// log-sum-exp.  width == D, except on the TMA-fed bodies: at bfloat16
// width <= D may be any multiple of 8, at float32 on the D = 256 body any
// multiple of 4 (a row of 16-byte units, as TMA needs): the maps
// zero-fill columns width .. D - 1 and only columns below width are
// stored.  At D > 256 (width == D, D % 8 == 0 at bfloat16, D % 4 == 0 at
// float32) the cluster forward: clusters of C blocks, each its dtype's
// D = 256 body on 256-column slices, in G walks (clusterbwd::walks; one
// up to 2048).  The caller checks KV | H, D in {16, 32, 64, 128, 256} or
// D > 256 and, at float32 up to 128, the grid's y dimension: B * H <=
// 65535 (the other bodies' grid is one persistent block per SM, or
// cluster per C SMs).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* strides, int B, int H,
                                      int KV, int S, int D, int width,
                                      int is_bf16, float scale,
                                      void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Lay* ly = static_cast<const Lay*>(strides);
  if (D > clusterbwd::WIDTH) {
    if (width != D || D % (is_bf16 ? 8 : 4))
      return (int)cudaErrorInvalidValue;
    return is_bf16 ? bf16body::launch_cluster(q, k, v, o, l, ly, B, H, KV, S,
                                              width, scale, st)
                   : f32wide::launch_cluster(q, k, v, o, l, ly, B, H, KV, S,
                                             width, scale, st);
  }
  const bool tma = is_bf16 || D == 256;
  if (width > D || width < 1 ||
      (width != D && (!tma || width % (is_bf16 ? 8 : 4))))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (D) {
      case 16: return bf16body::launch<16>(q, k, v, o, l, ly, B, H, KV, S,
                                           width, scale, st);
      case 32: return bf16body::launch<32>(q, k, v, o, l, ly, B, H, KV, S,
                                           width, scale, st);
      case 64: return bf16body::launch<64>(q, k, v, o, l, ly, B, H, KV, S,
                                           width, scale, st);
      case 128: return bf16body::launch<128>(q, k, v, o, l, ly, B, H, KV, S,
                                             width, scale, st);
      case 256: return bf16body::launch_wide(q, k, v, o, l, ly, B, H, KV, S,
                                             width, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return f32body::launch<16>(q, k, v, o, l, ly, B, H, KV, S,
                                        scale, st);
    case 32: return f32body::launch<32>(q, k, v, o, l, ly, B, H, KV, S,
                                        scale, st);
    case 64: return f32body::launch<64>(q, k, v, o, l, ly, B, H, KV, S,
                                        scale, st);
    case 128: return f32body::launch<128>(q, k, v, o, l, ly, B, H, KV, S,
                                          scale, st);
    case 256: return f32wide::launch(q, k, v, o, l, ly, B, H, KV, S, width,
                                     scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How a persistent forward body runs B x H heads of S rows on the
// current device, as flash_attention_launch schedules it: at bfloat16
// (is_bf16 = 1) the tensor-core body of head dim D (16, 32, 64, 128 or
// 256), at float32 the D = 256 body (f32wide), and in both the cluster
// forward at D > 256 (D % 8 == 0 at bfloat16, D % 4 == 0 at float32):
// out[0] query rows of a work item, out[1] keys of a KV tile, out[2] the
// work items, out[3] the grid's persistent blocks, out[4] its clusters,
// out[5] the blocks a cluster (C = 1 but for the cluster forward) and
// out[6] the walks, launches of that grid (G = 1 but above 2048).
extern "C" int flash_attention_fwd_info(int B, int H, int S, int D,
                                        int is_bf16, int* out) {
  out[5] = 1;
  out[6] = 1;
  int err = 0;
  if (D > clusterbwd::WIDTH) {
    if (D % (is_bf16 ? 8 : 4)) return (int)cudaErrorInvalidValue;
    out[0] = is_bf16 ? bf16body::Fwd<256>::BQ : f32wide::BQ;
    out[1] = is_bf16 ? bf16body::Fwd<256>::BK : f32wide::BK;
    err = is_bf16 ? bf16body::cluster_schedule(B, H, S, D, out + 2, out + 5,
                                               out + 6, out + 4)
                  : f32wide::cluster_schedule(B, H, S, D, out + 2, out + 5,
                                              out + 6, out + 4);
    out[3] = out[4] * out[5];
    return err;
  }
  if (!is_bf16) {
    if (D != 256) return (int)cudaErrorInvalidValue;
    out[0] = f32wide::BQ;
    out[1] = f32wide::BK;
    err = f32wide::schedule(B, H, S, out + 2, out + 3);
  } else {
    out[1] = bf16body::BK;
    switch (D) {
      case 16: out[0] = bf16body::Fwd<16>::BQ;
               err = bf16body::schedule<16>(B, H, S, out + 2, out + 3);
               break;
      case 32: out[0] = bf16body::Fwd<32>::BQ;
               err = bf16body::schedule<32>(B, H, S, out + 2, out + 3);
               break;
      case 64: out[0] = bf16body::Fwd<64>::BQ;
               err = bf16body::schedule<64>(B, H, S, out + 2, out + 3);
               break;
      case 128: out[0] = bf16body::Fwd<128>::BQ;
                err = bf16body::schedule<128>(B, H, S, out + 2, out + 3);
                break;
      case 256: out[0] = bf16body::Fwd<256>::BQ;
                out[1] = bf16body::Fwd<256>::BK;
                err = bf16body::schedule<256>(B, H, S, out + 2, out + 3);
                break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  out[4] = out[3];
  return err;
}

// The backward: dq, dk, dv of causal GQA attention from q, o, dout (B, H,
// S, D), k, v (B, KV, S, D), lse (B, H, S) float32 (the forward's), float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); dq (B, H, S, D), dk, dv (B, KV,
// S, D) in that dtype; strides: 24 element strides, (batch, head, row) of
// q, k, v, o, dout, dq, dk, dv in that order, each a multiple of 16
// bytes, the last axis contiguous; delta a float32 (B, H, S) scratch.
// At D in {16, 32, 64, 128} in either dtype: ws a float32 scratch of
// B * H * ceil(S / 64) * 64 * D (dq's accumulator), sem B * H *
// ceil(S / 64) + 1 ints of scratch; bfloat16 at 128 < D <= 256 with
// D % 8 == 0 (the D = 256 body, the operands read in place at width D):
// ws B * H * ceil(S / 64) * 64 * 256 floats, sem as at D <= 128; float32
// at 128 < D <= 256 with D % 4 == 0 (f32widebwd, read in place the same
// way): ws B * H * ceil(S / 32) * 32 * 256 floats, sem B * H *
// ceil(S / 32) + 1 ints; at D > 256 with D % 8 == 0 (bfloat16) or
// D % 4 == 0 (float32) the cluster body, C blocks a cluster in G walks
// (clusterbwd::walks): ws B * H * ceil(S / QT) * QT * W floats (W = D
// rounded up to 64 at bfloat16, D at float32: each slice's dq tiles as
// wide as its columns), sem C * G * B * H * ceil(S / QT) + G ints (QT =
// 64 at bfloat16 and 32 at float32).  Launches the Delta pass, then the
// main pass (G of them on the cluster body), and returns the first
// launch error.  The caller checks KV | H.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* ws, void* sem, const void* strides, int B, int H,
    int KV, int S, int D, int is_bf16, float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(sem);
  const Lay* ly = static_cast<const Lay*>(strides);
  const bool narrow = D == 16 || D == 32 || D == 64 || D == 128;
  const bool tc = is_bf16 && narrow;
  const bool wide = is_bf16 && D > 128 && D <= 256 && D % 8 == 0;
  const bool f32 = !is_bf16 && narrow;
  const bool f32w = !is_bf16 && D > 128 && D <= 256 && D % 4 == 0;
  const bool cl = D > 256 && D % (is_bf16 ? 8 : 4) == 0;
  if (!tc && !wide && !f32 && !f32w && !cl) return (int)cudaErrorInvalidValue;
  const int qt = is_bf16 ? widebwd::QT : f32widebwd::QT;   // cl's
  int C = 0, G = 0, n = 0;
  if (cl && clusterbwd::walks(D, &C, &G, &n) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_zero =
      tc ? B * H * ((S + bf16bwd::QT - 1) / bf16bwd::QT) + 1
      : wide ? B * H * ((S + widebwd::QT - 1) / widebwd::QT) + 1
      : f32 ? B * H * ((S + f32bwd::QT - 1) / f32bwd::QT) + 1
      : f32w ? B * H * ((S + f32widebwd::QT - 1) / f32widebwd::QT) + 1
      : C * G * B * H * ((S + qt - 1) / qt) + G;
  int err = is_bf16
                ? launch_delta<__nv_bfloat16>(o, dout, dl, ly[3], ly[4], B,
                                              H, S, D, cnt, n_zero, st)
                : launch_delta<float>(o, dout, dl, ly[3], ly[4], B, H, S, D,
                                      cnt, n_zero, st);
  if (err != 0) return err;
  if (cl)
    return is_bf16 ? widebwd::launch_cluster(q, k, v, dout, l, dl, dq, dk,
                                             dv, w, cnt, ly, B, H, KV, S, D,
                                             scale, st)
                   : f32widebwd::launch_cluster(q, k, v, dout, l, dl, dq, dk,
                                                dv, w, cnt, ly, B, H, KV, S,
                                                D, scale, st);
  if (!is_bf16) {
    switch (D) {
      case 16: return f32bwd::launch<16>(q, k, v, dout, l, dl, dq, dk, dv, w,
                                         cnt, ly, B, H, KV, S, scale, st);
      case 32: return f32bwd::launch<32>(q, k, v, dout, l, dl, dq, dk, dv, w,
                                         cnt, ly, B, H, KV, S, scale, st);
      case 64: return f32bwd::launch<64>(q, k, v, dout, l, dl, dq, dk, dv, w,
                                         cnt, ly, B, H, KV, S, scale, st);
      case 128: return f32bwd::launch<128>(q, k, v, dout, l, dl, dq, dk, dv,
                                           w, cnt, ly, B, H, KV, S, scale, st);
      default:
        return f32widebwd::launch(q, k, v, dout, l, dl, dq, dk, dv, w, cnt,
                                  ly, B, H, KV, S, D, scale, st);
    }
  }
  if (wide)
    return widebwd::launch(q, k, v, dout, l, dl, dq, dk, dv, w, cnt, ly, B,
                           H, KV, S, D, scale, st);
  switch (D) {
    case 16: return bf16bwd::launch<16>(q, k, v, dout, l, dl, dq, dk, dv, w,
                                        cnt, ly, B, H, KV, S, scale, st);
    case 32: return bf16bwd::launch<32>(q, k, v, dout, l, dl, dq, dk, dv, w,
                                        cnt, ly, B, H, KV, S, scale, st);
    case 64: return bf16bwd::launch<64>(q, k, v, dout, l, dl, dq, dk, dv, w,
                                        cnt, ly, B, H, KV, S, scale, st);
    default: return bf16bwd::launch<128>(q, k, v, dout, l, dl, dq, dk, dv,
                                         w, cnt, ly, B, H, KV, S, scale, st);
  }
}

// How the backward's persistent body for head dim D runs B x KV heads of
// S rows on the current device, as flash_attention_bwd_launch schedules
// it: at bfloat16 (is_bf16 = 1) the tensor-core bodies (16, 32, 64, 128,
// or the D = 256 body's 128 < D <= 256 with D % 8 == 0), at float32 the
// CUDA-core bodies f32bwd (16, 32, 64, 128) and f32widebwd (128 < D <=
// 256 with D % 4 == 0), and in both the cluster body above 256 (D % 8 ==
// 0 at bfloat16, D % 4 == 0 at float32): out[0] keys of a work item,
// out[1] queries of a step, out[2] the work items, out[3] the grid's
// persistent blocks, out[4] its clusters, out[5] the blocks a cluster (C
// = 1 but for the cluster body) and out[6] the walks, launches of that
// grid (G = 1 but above 2048).
extern "C" int flash_attention_bwd_info(int B, int KV, int S, int D,
                                        int is_bf16, int* out) {
  out[5] = 1;
  out[6] = 1;
  int err = 0;
  if (D > 256 && D % (is_bf16 ? 8 : 4) == 0) {
    out[0] = is_bf16 ? widebwd::KT : f32widebwd::KT;
    out[1] = is_bf16 ? widebwd::QT : f32widebwd::QT;
    err = is_bf16 ? widebwd::cluster_schedule(B, KV, S, D, out + 2, out + 5,
                                              out + 6, out + 4)
                  : f32widebwd::cluster_schedule(B, KV, S, D, out + 2,
                                                 out + 5, out + 6, out + 4);
    out[3] = out[4] * out[5];
    return err;
  }
  if (!is_bf16 && D > 128 && D <= 256 && D % 4 == 0) {
    out[0] = f32widebwd::KT;
    out[1] = f32widebwd::QT;
    err = f32widebwd::schedule(B, KV, S, out + 2, out + 3);
  } else if (!is_bf16) {
    if (D != 16 && D != 32 && D != 64 && D != 128)
      return (int)cudaErrorInvalidValue;
    out[0] = f32bwd::KT;
    out[1] = f32bwd::QT;
    err = f32bwd::schedule(B, KV, S, out + 2, out + 3);
  } else if (D > 128 && D <= 256 && D % 8 == 0) {
    out[0] = widebwd::KT;
    out[1] = widebwd::QT;
    err = widebwd::schedule(B, KV, S, out + 2, out + 3);
  } else {
    if (D != 16 && D != 32 && D != 64 && D != 128)
      return (int)cudaErrorInvalidValue;
    const int sms = bf16body::sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    out[0] = bf16bwd::KT;
    out[1] = bf16bwd::QT;
    out[2] = B * KV * ((S + bf16bwd::KT - 1) / bf16bwd::KT);
    out[3] = out[2] < sms ? out[2] : sms;
  }
  out[4] = out[3];
  return err;
}
