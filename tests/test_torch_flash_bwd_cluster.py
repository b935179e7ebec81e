"""A CPU model of the flash backward's cluster body (every D > 256:
``csrc/flash_attention.cu``, namespace `clusterbwd` and the D = 256 bodies
`widebwd` and `f32widebwd` instantiated with CL = true, and above 2048
with WALKS = true), and of the wrapper's routes there.

The model follows the kernel, whose constants it reads from the source:

* n = ceil(width / 256) slices of 256 columns (the last ragged, its
  columns past the width zero-filled), G = ceil(n / 8) walks (launches),
  C = ceil(n / G) blocks a cluster; in walk g block r owns slice r + C g
  (its K, V, dv, dk and dq share; one walk, G = 1, up to 2048);
* rank 0 draws each ticket from the counter and writes it into every
  rank's two slots, so the cluster's blocks take the same items, in the
  D = 256 body's list order and walk (bfloat16: 64-key items, 64-query
  steps; float32: 32 and 32);
* per step each block sums S and dP over its slices below the width (its
  other slices r + C j in ascending order, then the owned one) in its
  body's order (float32: each quarter of a slice's dots in column order,
  the quarter's chain carried from slice to slice, then (x0 + x1) +
  (x2 + x3); bfloat16: the wgmma's float32 sums over the columns), stores
  the partials, arrives on every other rank's mbarrier,
  waits for theirs, and adds the C partials in ascending rank order; so
  every block forms the same P and dS, and then its columns' dv, dk and dq
  share as the D = 256 body does; dq's shares go to the slice's own
  accumulator under the slice's own counters, in key-tile order.

Tolerances: the emulated arithmetic within 1e-5 x max|grad| (float32) and
2e-2 x max|grad| (bfloat16) of `flash_attention_bwd_plain` and of
jax.vjp of the reference's dense oracle, as the D = 256 bodies' models
hold them."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JRef
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import bwd_ablate as BA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
F32 = np.float32
LOG2E = F32(1.4426950408889634)


def _span(ns, src=_SRC):
    return src[src.index(f"namespace {ns} {{"):
               src.index(f"}}  // namespace {ns}")]


def _const(name, ns, src=_SRC):
    """An int constant of namespace `ns`: its expression as written (C++
    integer arithmetic), its names the namespace's other constants."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", _span(ns, src))[1]
    names = {n: _const(n, ns, src)
             for n in set(re.findall(r"\b[A-Z][A-Z_0-9]*\b", expr))}
    return int(eval(expr.replace("/", "//"), {"__builtins__": {}}, names))


CL = {n: _const(n, "clusterbwd") for n in ("MAX_C", "WIDTH", "XWARPS",
                                           "XUNIT")}
WIDTH = CL["WIDTH"]
#: (keys per item, queries per step) of each dtype's D = 256 body
TILES = {"bf16": (_const("KT", "widebwd"), _const("QT", "widebwd")),
         "f32": (_const("KT", "f32widebwd"), _const("QT", "f32widebwd"))}


def walks(width):
    """(C, G, n) for operands `width` > 256 wide, as `clusterbwd::walks`
    takes them: n slices, G walks, C blocks a cluster."""
    n = -(-width // WIDTH)
    G = -(-n // CL["MAX_C"])
    return -(-n // G), G, n


def n_blocks(width):
    """C: the blocks of a cluster for operands `width` wide."""
    return walks(width)[0]


def slices_of(n, r, C):
    """`clusterbwd::slices_of`: block r's slices below the width."""
    return (n - r + C - 1) // C


def others(n, r, C, g):
    """`clusterbwd::others`: those but the owned one in walk g, in
    ascending order, as slice indices."""
    return [r + C * j for j in range(slices_of(n, r, C)) if j != g]


# ---------------------------------------------------------------------------
# constants, shared memory, the C rule
# ---------------------------------------------------------------------------


def test_constants_and_shared_memory():
    """The cluster's constants are the wrapper's; both cluster bodies'
    layouts fit a block's 232,448 bytes, as the source's comments count
    them (bfloat16 one Q / dO slot and the exchange's two 32 KB buffers;
    float32 the D = 256 layout and two 8 KB buffers), and the source
    asserts it for each."""
    assert (CL["MAX_C"], WIDTH) == (8, 256)
    assert FA.CLUSTER_WIDTH == WIDTH
    assert FA.CLUSTER_BLOCKS == CL["MAX_C"]
    assert TILES == {"bf16": FA.BWD_TILES[256],
                     "f32": FA.BWD_F32_WIDE_TILES}
    # a warp's lanes side by side: one 16-byte unit a lane, 32 lanes
    assert CL["XUNIT"] == 32 * 16 and CL["XWARPS"] == 8
    # bfloat16: K, V, one Q and one dO slot (64 x 256 each), P^T and dS^T
    # twice, two exchange buffers (8 warps x 8 units: S^T's and dP^T's 16
    # floats a lane), lse, Delta, meta, item, tickets, mbarriers (the
    # walks' sub-loads' two among them)
    kt, qt = TILES["bf16"]
    tile = 64 * 256 * 2
    xbuf = CL["XWARPS"] * 8 * CL["XUNIT"]
    assert xbuf == 2 * kt * qt * 4          # a step's S^T and dP^T, float32
    smem_bf16 = (4 * tile + 4 * kt * qt * 2 + 2 * xbuf + 2 * qt * 4 + 16
                 + 16 + 16 + 8 * (2 + 2 + 2 * CL["XWARPS"] + 4) + 1024)
    assert smem_bf16 == 231_152 <= 232_448
    assert "231,152" in _span("widebwd")
    # float32: the D = 256 layout (179,008 with its alignment), aligned
    # to 16, two buffers of 8 warps x 2 units (z's 8 floats a lane), the
    # tickets, 22 mbarriers (the walks' two pairs among them)
    kt, qt = TILES["f32"]
    xbuf = CL["XWARPS"] * 2 * CL["XUNIT"]
    assert xbuf == 2 * kt * qt * 4
    bar_end = 179_008 - 1024
    smem_f32 = (-(-bar_end // 16) * 16 + 2 * xbuf + 16
                + 8 * (2 * CL["XWARPS"] + 6) + 1024)
    assert smem_f32 == 195_584 <= 232_448
    assert "195,584" in _span("f32widebwd")
    assert ("static_assert(CL_SMEM <= 232448, \"more shared memory than a "
            "block may take\");") in _span("f32widebwd")
    # widebwd's Smem is one template for both bodies, its assert in it
    body = _span("widebwd")
    assert "template <bool CL>\nstruct Smem {" in body
    assert "static constexpr int ST = CL ? 1 : STAGES;" in body
    assert "static_assert(SMEM <= 232448" in body
    for ns in ("widebwd", "f32widebwd"):
        assert "template <bool CL, bool WALKS = false>\n__global__" in \
            _span(ns)


_WALK_RULE = ["*n = (width + WIDTH - 1) / WIDTH;",
              "if (*n < 2) return (int)cudaErrorInvalidValue;",
              "*G = (*n + MAX_C - 1) / MAX_C;", "*C = (*n + *G - 1) / *G;",
              "return (slices - rank + C - 1) / C;",
              "return ns - (walk < ns ? 1 : 0);"]


@pytest.mark.parametrize("width,C,G", [
    (257, 2, 1), (264, 2, 1), (512, 2, 1), (513, 3, 1), (768, 3, 1),
    (2048, 8, 1), (2049, 5, 2), (2056, 5, 2), (2112, 5, 2), (2304, 5, 2),
    (4096, 8, 2), (4100, 6, 3), (4160, 6, 3), (8192, 8, 4)])
def test_the_c_rule(width, C, G):
    """(C, G) from one place, `clusterbwd::walks` (n = ceil(width / 256)
    slices, G = ceil(n / 8) walks, C = ceil(n / G) <= 8), as the wrapper's
    allocation (`cluster_walks`) takes them; the walks cover the n slices
    once each (block r of walk g owns slice r + C g; slices past the width
    are owned by nobody's data), and each block's slices for S and dP are
    its r + C j below the width."""
    assert walks(width)[:2] == (C, G) == FA.cluster_walks(width)
    for stmt in _WALK_RULE:
        assert stmt in _span("clusterbwd"), stmt
    n = walks(width)[2]
    assert 2 <= C <= CL["MAX_C"] and C * G >= n > C * (G - 1)
    owned = sorted(r + C * g for g in range(G) for r in range(C))
    assert owned == list(range(C * G))
    for g in range(G):
        for r in range(C):
            mine = others(n, r, C, g) + ([r + C * g] if r + C * g < n
                                         else [])
            assert sorted(mine) == [s for s in range(n) if s % C == r]


# ---------------------------------------------------------------------------
# the wrapper's routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,bf16,f32", [
    (257, ("cluster", 264), ("cluster", 260)),
    (264, ("cluster", 264), ("cluster", 264)),
    (318, ("cluster", 320), ("cluster", 320)),
    (320, ("cluster", 320), ("cluster", 320)),
    (512, ("cluster", 512), ("cluster", 512)),
    (766, ("cluster", 768), ("cluster", 768)),
    (768, ("cluster", 768), ("cluster", 768)),
    (2045, ("cluster", 2048), ("cluster", 2048)),
    (2048, ("cluster", 2048), ("cluster", 2048)),
    (2049, ("cluster", 2056), ("cluster", 2052)),
    (2056, ("cluster", 2056), ("cluster", 2056)),
    (2112, ("cluster", 2112), ("cluster", 2112)),
    (2304, ("cluster", 2304), ("cluster", 2304)),
    (4100, ("cluster", 4104), ("cluster", 4100)),
    (8192, ("cluster", 8192), ("cluster", 8192))])
def test_cluster_routes(D, bf16, f32):
    """Above D = 256 both dtypes run the cluster backward, at every width
    (in walks above 2048): in place when a row is whole 16-byte units (D %
    8 == 0 at bfloat16, D % 4 == 0 at float32), else zero-padded to the
    next such width.  The route takes 16-byte starts and strides (TMA);
    the launcher takes the same widths, with no upper bound."""
    assert FA._backward_route(torch.bfloat16, D) == bf16
    assert FA._backward_route(torch.float32, D) == f32
    for dt, route in ((torch.bfloat16, bf16), (torch.float32, f32)):
        q = torch.zeros((1, 1, 1, D), dtype=dt)
        assert FA._bwd_align(q, *route) == 16
    assert "const bool cl = D > 256 && D % (is_bf16 ? 8 : 4) == 0;" in _SRC
    assert "MAX_D" not in _SRC and "simplebwd" not in _SRC


# ---------------------------------------------------------------------------
# the work list and the per-slice dq add order
# ---------------------------------------------------------------------------


def _steps(item, B, H, KV, S, kt_, qt):
    """The D = 256 body's walk of one item: (batch x head, query tile)
    steps in order."""
    BKV, G, nQ = B * KV, H // KV, -(-S // qt)
    kt, bkv = divmod(item, BKV)
    b, kvh = divmod(bkv, KV)
    return [(b * H + kvh * G + s % G, nQ - 1 - s // G)
            for s in range(G * (nQ - kt * kt_ // qt))]


def _simulate_adds(B, H, KV, S, clusters, C, dtype):
    """The work list on `clusters` resident clusters of C blocks, one
    step a tick for the whole cluster (its blocks exchange every step);
    block r of a step of key tile kt waits until its slice's counter for
    the (batch x head, query tile) reads kt.  Returns (adds per (bh, qi,
    r) in order, the steps that waited, whether every wait pointed at an
    item already handed out)."""
    kt_, qt = TILES[dtype]
    BKV = B * KV
    n_items = BKV * -(-S // kt_)
    nxt, count, adds = 0, {}, {}
    cur = [None] * clusters
    waited, earlier = 0, True
    while True:
        for i in range(clusters):
            if cur[i] is None and nxt < n_items:
                cur[i] = (nxt, _steps(nxt, B, H, KV, S, kt_, qt), 0)
                nxt += 1
        if all(c is None for c in cur):
            return adds, waited, earlier
        moved = False
        for i, c in enumerate(cur):
            if c is None:
                continue
            item, steps, pos = c
            kt = item // BKV
            bh, qi = steps[pos]
            if any(count.get((bh, qi, r), 0) < kt for r in range(C)):
                waited += 1
                earlier = earlier and 0 <= item - BKV < nxt
                continue
            for r in range(C):
                count[(bh, qi, r)] = count.get((bh, qi, r), 0) + 1
                adds.setdefault((bh, qi, r), []).append(kt)
            moved = True
            cur[i] = None if pos + 1 == len(steps) else (item, steps, pos + 1)
        assert moved, "no cluster could move: a wait that never ends"


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B,H,KV,S,D,clusters", [
    (1, 8, 2, 2048, 512, 66),          # the smoke's D = 512 shape
    (4, 8, 2, 2048, 512, 66), (1, 4, 1, 300, 768, 44), (2, 4, 2, 100, 2048,
                                                        16),
    (1, 2, 1, 1, 320, 66), (1, 8, 2, 700, 512, 1),
    (1, 2, 1, 300, 2304, 26), (1, 4, 2, 130, 4160, 3)])
def test_work_list_and_slice_add_order(B, H, KV, S, D, clusters, dtype):
    """Every (batch x head, query tile, slice) receives each key tile with
    a causal pair exactly once, in ascending order, the diagonal last (in
    walks above 2048: each walk a launch on its own slices' counters, C G
    of them); every wait points at an item earlier in the list (taken by
    a resident cluster of the same walk); no wait lasts for ever; at the
    D = 512 shape on 66 clusters (B 1: 64 bfloat16 items, one wave; 128
    float32 items) the steps that wait are under 2 % of all steps."""
    kt_, qt = TILES[dtype]
    C, G, _ = walks(D)
    adds, waited, earlier = {}, 0, True
    for g in range(G):
        a, w_, e_ = _simulate_adds(B, H, KV, S, clusters, C, dtype)
        adds.update({(bh, qi, r + C * g): v for (bh, qi, r), v in a.items()})
        waited, earlier = waited + w_, earlier and e_
    nQ = -(-S // qt)
    assert sorted(adds) == [(bh, qi, r) for bh in range(B * H)
                            for qi in range(nQ) for r in range(C * G)]
    for (bh, qi, r), kts in adds.items():
        causal = [kt for kt in range(-(-S // kt_))
                  if kt * kt_ <= min(qi * qt + qt - 1, S - 1)]
        assert kts == causal, ((bh, qi, r), kts)
        assert kts[-1] == qi
    assert earlier
    n_steps = sum(len(v) for v in adds.values()) // (C * G)
    if (B, S, D, clusters) == (1, 2048, 512, 66):
        assert n_steps == B * H * nQ * (nQ + 1) // 2
        assert waited < 0.02 * n_steps, (waited, n_steps)
        n_items = B * KV * -(-S // kt_)
        assert n_items == (64 if dtype == "bf16" else 128)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fmaf, elementwise (exact product, one rounding to float64 and one
    to float32: rarely a last bit off the card's)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _delta(o, do):
    """The Delta pass: lane l sums columns l, l + 32, ... with fmaf, then
    x += shfl_xor(x, off) for off = 16 .. 1."""
    lanes = np.zeros(o.shape[:-1] + (32,), F32)
    for c in range(o.shape[-1]):
        lanes[..., c % 32] = _fma(o[..., c], do[..., c], lanes[..., c % 32])
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    return lanes[..., 0]


def _quarter_dots(A, Bm, slices=(0,)):
    """A Bm^T over the 256-column slices `slices` in that order as
    f32widebwd sums S and dP: each quarter of a slice's dots (64 columns)
    in column order with fmaf, the quarter's chain carried on from slice
    to slice, then (x0 + x1) + (x2 + x3)."""
    x = []
    for p in range(4):
        acc = np.zeros((A.shape[0], Bm.shape[0]), F32)
        for sl in slices:
            for d in range(WIDTH * sl + 64 * p, WIDTH * sl + 64 * p + 64):
                acc = _fma(A[:, d, None], Bm[None, :, d], acc)
        x.append(acc)
    return (x[0] + x[1]) + (x[2] + x[3])


def _mm_slices(A, Bm, slices):
    """A Bm^T over the slices in that order, float32 (the wgmma's sums)."""
    acc = np.zeros((A.shape[0], Bm.shape[0]), F32)
    for sl in slices:
        c = slice(WIDTH * sl, WIDTH * (sl + 1))
        acc = (acc + A[:, c] @ Bm[:, c].T).astype(F32)
    return acc


def rank_sums(parts, order=None):
    """The C ranks' sums of their partials, each rank adding the units it
    reads in `order(r)` (the kernel's: ascending rank order for every
    rank)."""
    out = []
    for r in range(len(parts)):
        seq = order(r) if order else range(len(parts))
        acc = None
        for p in seq:
            acc = parts[p] if acc is None else acc + parts[p]
        out.append(acc)
    return out


def emulate(q, k, v, o, lse, do, dtype):
    """dq, dk, dv as the cluster body computes them from q, k, v, o, dO
    (B, H|KV, S, D; bfloat16 values for "bf16") and float32 lse: the
    operands zero-filled to whole slices and tiles; in each walk g each
    item's steps in the D = 256 body's order, each rank r's S and dP
    summed over its slices in the body's order (its other slices r + C j
    below the width ascending, then the owned one, r + C g, if below the
    width) and over the ranks in rank order by every rank (every rank's
    sums checked bit-equal), then P, dS and the column-by-column products
    of the D = 256 body (which no slicing changes) for the walk's owned
    slices, dq's shares in each slice's own accumulator.  Returns the
    gradients and whether a rank adding its own partial first would ever
    have formed other bits (C > 2)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    kt_, qt = TILES[dtype]
    C, G, n = walks(D)
    W = n * WIDTH
    GS, nQ = H // KV, -(-S // qt)
    Sp = nQ * qt

    def fill(x):
        return np.pad(x.float().numpy().astype(F32),
                      [(0, 0), (0, 0), (0, Sp - S), (0, W - D)])

    qn, kn, vn, don = (fill(x) for x in (q, k, v, do))
    if dtype == "f32":
        delta = _delta(o.numpy().astype(F32), do.numpy().astype(F32))
    else:
        delta = np.einsum("bhsd,bhsd->bhs", o.float().numpy(),
                          do.float().numpy()).astype(F32)
    delta = np.pad(delta, [(0, 0), (0, 0), (0, Sp - S)])
    ls = np.pad(lse.numpy().astype(F32), [(0, 0), (0, 0), (0, Sp - S)])
    scale = F32(D ** -0.5)
    sl2 = F32(D ** -0.5 * LOG2E)
    dq = np.zeros((B, H, Sp, W), F32)
    dk = np.zeros((B, KV, Sp, W), F32)
    dv = np.zeros_like(dk)
    own_first_differs = False
    BKV = B * KV
    for g in range(G):
        seqs = [others(n, r, C, g) + ([r + C * g] if r + C * g < n else [])
                for r in range(C)]
        owned = [r + C * g for r in range(C) if r + C * g < n]
        oc = np.concatenate([np.arange(WIDTH * sl, WIDTH * (sl + 1))
                             for sl in owned])
        acc = {}
        for item in range(BKV * -(-S // kt_)):
            kt, bkv = divmod(item, BKV)
            b, kvh = divmod(bkv, KV)
            k0 = kt * kt_
            K, V = kn[b, kvh, k0:k0 + kt_], vn[b, kvh, k0:k0 + kt_]
            acc_v = np.zeros((kt_, W), F32)
            acc_k = np.zeros_like(acc_v)
            for bh, qi in _steps(item, B, H, KV, S, kt_, qt):
                h, q0 = bh % H, qi * qt
                Q, dO = qn[b, h, q0:q0 + qt], don[b, h, q0:q0 + qt]
                if dtype == "f32":          # queries x keys
                    sp = [_quarter_dots(Q, K, sq) for sq in seqs]
                    dpp = [_quarter_dots(dO, V, sq) for sq in seqs]
                else:                       # keys x queries (S^T, dP^T)
                    sp = [_mm_slices(K, Q, sq) for sq in seqs]
                    dpp = [_mm_slices(V, dO, sq) for sq in seqs]
                sums = rank_sums(sp), rank_sums(dpp)
                for got in sums:
                    assert all(np.array_equal(got[0], x) for x in got), \
                        "ranks formed different sums"
                if C > 2:
                    own = rank_sums(sp, lambda r: [r] + [p for p in range(C)
                                                         if p != r])
                    own_first_differs |= not all(np.array_equal(own[0], x)
                                                 for x in own)
                s, dp = sums[0][0], sums[1][0]
                if dtype == "bf16":
                    s, dp = s.T, dp.T
                rows = np.arange(q0, q0 + qt)[:, None]
                keys = np.arange(k0, k0 + kt_)[None, :]
                lrow = ls[b, h, q0:q0 + qt, None]
                with np.errstate(over="ignore"):
                    e = (np.exp(_fma(s, scale, -lrow)) if dtype == "f32" else
                         np.exp2(s * sl2 - lrow * LOG2E))
                p = np.where((keys <= rows) & (rows < S), e,
                             F32(0)).astype(F32)
                ds = (p * (dp - delta[b, h, q0:q0 + qt, None])).astype(F32)
                if dtype == "f32":
                    step_v = np.zeros((kt_, W), F32)
                    step_k = np.zeros_like(step_v)
                    for i in range(qt):      # the step's queries in order
                        step_v = _fma(p[i, :, None], dO[i, None, :], step_v)
                        step_k = _fma(ds[i, :, None], Q[i, None, :], step_k)
                    acc_v = acc_v + step_v
                    acc_k = acc_k + step_k
                    share = np.zeros((qt, W), F32)
                    for j in range(kt_):     # the item's keys in order
                        share = _fma(ds[:, j, None], K[j, None, :], share)
                else:
                    pb = torch.from_numpy(p).bfloat16().float().numpy()
                    dsb = torch.from_numpy(ds).bfloat16().float().numpy()
                    acc_v += pb.T @ dO
                    acc_k += dsb.T @ Q
                    share = dsb @ K
                acc[bh, qi] = share if kt == 0 else acc[bh, qi] + share
                if kt == qi:                 # the diagonal: the last add
                    dq[b, h][q0:q0 + qt, oc] = (acc.pop((bh, qi))
                                                * scale)[:, oc]
            dk[b, kvh][k0:k0 + kt_, oc] = (acc_k * scale)[:, oc]
            dv[b, kvh][k0:k0 + kt_, oc] = acc_v[:, oc]
        assert not acc
    out = [torch.from_numpy(np.ascontiguousarray(x[:, :, :S, :D]))
           for x in (dq, dk, dv)]
    if dtype == "bf16":
        out = [x.bfloat16() for x in out]
    return tuple(out), own_first_differs


def _max_rel(got, want):
    g, w = got.float().numpy(), np.asarray(want, F32)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)


def _jax_grads(arrs, jdt):
    q, k, v, ct = (jnp.asarray(a, jdt) for a in arrs)

    @jax.jit
    def grads(q, k, v, ct):
        out, vjp = jax.vjp(JRef.flash_attention_ref, q, k, v)
        return vjp(ct.astype(out.dtype))

    return grads(q, k, v, ct)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [264, 320, 512, 768])
@pytest.mark.parametrize("S", [40, 100])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
def test_cluster_arithmetic_within_tolerance(rng, H, KV, S, D, dtype):
    """The emulated cluster body: every rank forms the same S and dP bits
    (and at C = 3 a rank adding its own partial first would not); the
    gradients against `flash_attention_bwd_plain` on the same (o, lse)
    and against jax.vjp of the reference's dense oracle within 1e-5 x
    max|grad| at float32 and 2e-2 x max|grad| at bfloat16; GQA and MQA, S
    ragged against the tiles, 264 and 320 with a ragged last slice, 768
    three slices."""
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, do = (torch.as_tensor(a).to(tdt) for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    got, own_first_differs = emulate(q, k, v, o, lse, do, dtype)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert own_first_differs == (n_blocks(D) > 2)
    tol = 1e-5 if dtype == "f32" else 2e-2
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, p in zip(got, plain):
        assert _max_rel(g, p.float().numpy()) <= tol
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    for g, w in zip(got, _jax_grads(arrs, jdt)):
        assert _max_rel(g, np.asarray(w, F32)) <= tol


@pytest.mark.parametrize("dtype,D,S,H,KV", [
    ("f32", 2112, 40, 4, 2), ("bf16", 2112, 70, 4, 1),
    ("f32", 2304, 33, 2, 1), ("bf16", 2304, 100, 2, 1),
    ("f32", 4100, 40, 2, 1), ("bf16", 4104, 33, 4, 2)])
def test_walks_arithmetic_within_tolerance(rng, dtype, D, S, H, KV):
    """The emulated walks (G = 2 over 9 slices at 2112 and 2304, G = 3
    over 17 at 4100 / 4104, whose last slice is ragged and whose last
    walk leaves a rank without a slice): every rank of a walk forms the
    same S and dP bits (not those of a rank adding its own partial
    first); the gradients within 1e-5 x max|grad| (float32) or 2e-2 x
    max|grad| (bfloat16) of `flash_attention_bwd_plain` and of jax.vjp of
    the reference's dense oracle; S ragged against the tiles."""
    assert walks(D)[1] == (2 if D < 4096 else 3)
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, do = (torch.as_tensor(a).to(tdt) for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    got, own_first_differs = emulate(q, k, v, o, lse, do, dtype)
    assert own_first_differs
    tol = 1e-5 if dtype == "f32" else 2e-2
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, p in zip(got, plain):
        assert _max_rel(g, p.float().numpy()) <= tol
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    for g, w in zip(got, _jax_grads(arrs, jdt)):
        assert _max_rel(g, np.asarray(w, F32)) <= tol


# ---------------------------------------------------------------------------
# the protocol: tickets, exchanges, cluster barriers
# ---------------------------------------------------------------------------


class _Mbar:
    """An mbarrier: a phase completes when `count` arrivals are in; a wait
    on parity P passes once the phase of that parity has completed.
    Arrivals count in `progress`, so that a hang is a long run of steps
    with none."""

    def __init__(self, count, progress):
        self.count, self.pending, self.phases = count, 0, 0
        self.progress = progress

    def arrive(self):
        self.progress[0] += 1
        self.pending += 1
        if self.pending == self.count:
            self.phases, self.pending = self.phases + 1, 0

    def done(self, parity):
        return (self.phases & 1) != parity


class _Named:
    """A barrier of `units` agents (a named barrier, or the cluster
    barrier at the end): arrive and go on, or sync and wait."""

    def __init__(self, units, progress):
        self.units, self.n, self.gen = units, 0, 0
        self.progress = progress

    def arrive(self):
        self.progress[0] += 1
        self.n += 1
        if self.n == self.units:
            self.gen, self.n = self.gen + 1, 0

    def sync(self):
        gen = self.gen
        self.arrive()
        while self.gen == gen:
            yield


def _wait(bar, parity):
    while not bar.done(parity):
        yield


def _run(agents, rng, progress):
    idle, seen = 0, progress[0]
    while agents:
        i = int(rng.integers(len(agents)))
        try:
            next(agents[i])
        except StopIteration:
            agents.pop(i)
            idle = 0
            continue
        if progress[0] != seen:
            seen, idle = progress[0], 0
        else:
            idle += 1
        if idle > 200 * len(agents) + 2000:
            raise AssertionError("the barrier protocol hangs")


# what the simulation models, as the source spells it
_PROTOCOL = {
    "clusterbwd": [
        "const int item = atomicAdd(work, 1);",
        "for (int p = 0; p < C; ++p) {",
        "arrive(mapa(bar, p));",
        "wait(bar, (n >> 1) & 1);",
        "const uint32_t slot = slots + 4 * (n & 1), bar = bars + 8 * (n & 1);",
        "__syncwarp();\n  if ((threadIdx.x & 31) == 0)",
        "      if (p != r) arrive(mapa(bar, p));",
        "  wait(bar, (it >> 1) & 1);",
        "x[i] = p == 0 ? t[i] : x[i] + t[i];",
        "barrier.cluster.arrive.release.aligned;",
        "barrier.cluster.wait.acquire.aligned;",
        "mbarrier.arrive.release.cluster.shared::cluster.b64",
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"],
    "widebwd": [
        "mbar_init(xin + 8 * i, C - 1);", "mbar_init(tick, 1);",
        "mbar_init(tick + 8, 1);",
        "if constexpr (CL) clusterbwd::sync();        // every rank's",
        "item = CL ? clusterbwd::ticket(work, base + L::TICK_OFF, tick, n, C,",
        "base + L::X_OFF + (it & 1) * L::XBUF +",
        "xin + 8 * ((it & 1) * clusterbwd::XWARPS + xw), it, C, rank);",
        "  if constexpr (CL) clusterbwd::sync();\n}",
        "sem += (size_t)own * B * H * nQ;",
        "acc += (size_t)own * B * H * nQ * QT * D;",
        "if (it >= ST) {", "add_share(it - ST);",
        "mbar_wait(staged + 8 * slot, (i / ST) & 1);",
        "mbar_wait(full + 8 * slot, (it / ST) & 1);",
        "sem + (size_t)C * G * B * H * nQ + g, B, H,",
        "own += C * walk;", "n_other = clusterbwd::others(slices, rank, C, walk);",
        "mbar_init(full_x, 1);", "mbar_init(empty_x, 256);",
        "const int no = clusterbwd::others(slices, clusterbwd::rank(),",
        "for (int i = 0; i < no; ++i) {", "for (int e = 0; e < 2; ++e) {",
        "mbar_wait(empty_x, e ^ 1);",
        "mbar_wait(empty_x, 1);                 // the last one read",
        "for (int i = n_other; i > 0; --i) {",
        "mbar_wait(full_x, 0);                // K and Q",
        "mbar_wait(full_x, 1);                // V and dO",
        "mbar_arrive(empty_x);"],
    "f32widebwd": [
        "mbar_init(xin + 8 * i, C - 1);", "mbar_init(tick, 1);",
        "mbar_init(tick + 8, 1);",
        "if constexpr (CL) clusterbwd::sync();    // every rank's",
        "if constexpr (CL) clusterbwd::sync();  // with the others, at the",
        "item = CL ? clusterbwd::ticket(work, base + TICK_OFF, tick, n, C,",
        "z, base + X_OFF + (it & 1) * XBUF + tid / 32 * 2 *",
        "xin + 8 * ((it & 1) * clusterbwd::XWARPS + tid / 32), it, C,",
        "  if constexpr (CL) clusterbwd::sync();\n}",
        "sem += (size_t)own * B * H * nQ;",
        "acc += (size_t)own * B * H * nQ * QT * D;",
        "ly[7], sem, sem + (size_t)C * G * B * H * nQ + g, B, H, KV, S, width,",
        "own += C * walk;",
        "n_other = clusterbwd::others((width + D - 1) / D, rank, C, walk);",
        "mbar_init(full_a, 1);", "mbar_init(empty_a, 128);",
        "mbar_init(full_b, 1);", "mbar_init(empty_b, 128);",
        "for (int i = 0; i < n_other; ++i) {",
        "const int nx = it * n_other + i;",
        "mbar_wait(empty_b, (nx & 1) ^ 1);", "mbar_wait(empty_a, nx & 1);",
        "mbar_wait(empty_b, ((it + 1) * n_other & 1) ^ 1);  // the last read",
        "mbar_wait(full_a + 16 * grp, (it * n_other + i) & 1);",
        "mbar_arrive(empty_a + 16 * grp);"],
}


def test_protocol_is_the_sources():
    """Every ticket, exchange and barrier step the simulation models is
    in the source; the exchange sits between S and dP's sums and the
    softmax in both bodies."""
    for ns, stmts in _PROTOCOL.items():
        body = _span(ns)
        for stmt in stmts:
            assert stmt in body, (ns, stmt)
    wide = _span("widebwd")
    assert wide.index("scores(dp, qs, dos, add);") < \
        wide.index("scores(dp, vs, dos, WALKS && n_other > 0);") < \
        wide.index("clusterbwd::exchange(") < wide.index("float p = ex2(")
    f32 = _span("f32widebwd")
    assert f32.index("z[c] = mine + __shfl_xor_sync(0xffffffffu, other, "
                     "16);") < f32.index("clusterbwd::exchange(") < \
        f32.index("? expf(fmaf(z[c], scale, -ls)) : 0.f;")


def _simulate(body, B, H, KV, S, C, clusters, rng, *, G=1, n=None,
              fault=None):
    """The cluster body's waits and arrivals: `clusters` clusters of C
    blocks, each block a producer and two consumer agents (bfloat16: the
    two consumer warpgroups, one Q / dO slot; float32: groups 0 and 1,
    f32widebwd's slot, share buffer and named barriers), all sharing the
    ticket counter and the per-slice dq counters, under a random
    scheduler; in G walks over n slices (one launch each, its own ticket
    counter), where each step first takes the block's other slices
    through the slot (bfloat16: K and Q, then V and dO, one mbarrier pair
    for both consumers; float32: K and Q for group 0, then V and dO for
    group 1, a pair each) and then the owned slice's Q and dO.  Every
    exchange stores a tag (item, step) in the block's buffer, and each
    reader checks the tags of every rank's buffer it reads, one rank at a
    time; every load into the slot stores its tag, which its readers check
    before and after reading.  Faults: "no_wait" (a consumer reads
    without waiting for the other ranks' arrivals), "one_buffer" (one
    exchange buffer, a phase a step), "own_tickets" (each block draws its
    own ticket from the counter), "x_early" (the producer loads the slot
    again before its readers released the other slice they read).
    Returns the (walk, cluster, rank, item) taken.  A hang, or a tag that
    is not the reader's, fails."""
    kt_, qt = TILES[body]
    BKV, GS, nQ = B * KV, H // KV, -(-S // qt)
    n_items = BKV * -(-S // kt_)
    n = C * G if n is None else n
    taken, progress = [], [0]
    counters = {}

    def launch(g):
        ticket = [0]

        def cluster(ci):
            slots = [[None, None] for _ in range(C)]
            tick = [[_Mbar(1, progress) for _ in range(2)] for _ in range(C)]
            nbuf = 1 if fault == "one_buffer" else 2
            xbuf = [[[None, None] for _ in range(nbuf)] for _ in range(C)]
            xin = [[[_Mbar(C - 1, progress) for _ in range(2)]
                    for _ in range(nbuf)] for _ in range(C)]
            end = _Named(3 * C, progress)

            def exchange(r, a, it, tag):
                buf = it % nbuf
                parity = (it // nbuf) & 1
                xbuf[r][buf][a] = tag
                yield
                for p in range(C):
                    if p != r:
                        xin[p][buf][a].arrive()
                if fault != "no_wait":
                    yield from _wait(xin[r][buf][a], parity)
                for p in range(C):              # one rank's units at a time
                    got = xbuf[p][buf][a]
                    assert got == tag, f"read {got} at {tag}: a stale partial"
                    yield

            def block(r):
                sl = r + C * g                  # the owned slice
                n_other = len(others(n, r, C, g))
                full_kv, empty_kv = _Mbar(1, progress), _Mbar(2, progress)
                item_s = [None]
                slot = [None]                   # the tag of the slot's load
                if body == "bf16":
                    full, staged = _Mbar(1, progress), _Mbar(2, progress)
                    halves = _Named(2, progress)
                    meta = [None]
                    full_x, empty_x = _Mbar(1, progress), _Mbar(2, progress)
                else:
                    full, empty = _Mbar(1, progress), _Mbar(2, progress)
                    staged, freed = _Mbar(2, progress), _Mbar(1, progress)
                    p_ready, ds_ready, diag = (_Named(2, progress)
                                               for _ in range(3))
                    fab = [_Mbar(1, progress) for _ in range(2)]
                    eab = [_Mbar(1, progress) for _ in range(2)]

                def read(tag):
                    assert slot[0] == tag, f"read {slot[0]} at {tag}: stale"
                    yield
                    assert slot[0] == tag, f"read {slot[0]} at {tag}: stale"

                def draw(n_):
                    if fault == "own_tickets":
                        item = ticket[0]
                        ticket[0] += 1
                        yield
                        return item
                    if r == 0:
                        item = ticket[0]
                        ticket[0] += 1
                        for p in range(C):
                            slots[p][n_ & 1] = item
                            tick[p][n_ & 1].arrive()
                    yield from _wait(tick[r][n_ & 1], (n_ >> 1) & 1)
                    return slots[r][n_ & 1]

                def add(bh, qi, kt):
                    while counters.get((bh, qi, sl), 0) < kt:
                        yield
                    counters[bh, qi, sl] = counters.get((bh, qi, sl), 0) + 1
                    progress[0] += 1

                def producer_bf16():
                    it = px = 0

                    def add_share(i):
                        yield from _wait(staged, i & 1)
                        bh, qi, kt, last = meta[0]
                        if not last:
                            yield from add(bh, qi, kt)

                    for n_ in range(10 ** 9):
                        item = yield from draw(n_)
                        yield from _wait(empty_kv, (n_ & 1) ^ 1)
                        if item >= n_items:
                            item_s[0] = -1
                            full_kv.arrive()
                            if it > 0:
                                yield from add_share(it - 1)
                            break
                        taken.append((g, ci, r, item))
                        kt = item // BKV
                        item_s[0] = item
                        full_kv.arrive()
                        for s_ in range(GS * (nQ - kt)):
                            if it >= 1:
                                yield from add_share(it - 1)
                            for i in range(n_other):
                                for e in range(2):
                                    if fault != "x_early":
                                        yield from _wait(empty_x,
                                                         (px & 1) ^ 1)
                                    slot[0] = (item, s_, i, e)
                                    full_x.arrive()
                                    px += 1
                            if G > 1:
                                yield from _wait(empty_x, (px & 1) ^ 1)
                            slot[0] = (item, s_)
                            full.arrive()
                            it += 1
                    yield from end.sync()

                def consumer_bf16(w):
                    it = px = 0
                    for n_ in range(10 ** 9):
                        yield from _wait(full_kv, n_ & 1)
                        item = item_s[0]
                        if item < 0:
                            break
                        kt, bkv = divmod(item, BKV)
                        b, kvh = divmod(bkv, KV)
                        for s_ in range(GS * (nQ - kt)):
                            qi = nQ - 1 - s_ // GS
                            bh = b * H + kvh * GS + s_ % GS
                            for i in range(n_other):
                                for e in range(2):
                                    yield from _wait(full_x, px & 1)
                                    yield from read((item, s_, i, e))
                                    empty_x.arrive()
                                    px += 1
                            yield from _wait(full, it & 1)
                            yield from read((item, s_))
                            yield from exchange(r, w, it, (item, s_))
                            yield from halves.sync()
                            last = kt == qi
                            if w == 0:
                                meta[0] = (bh, qi, kt, last)
                            yield from read((item, s_))
                            staged.arrive()
                            if last and kt > 0:
                                while counters.get((bh, qi, sl), 0) < kt:
                                    yield
                            it += 1
                        empty_kv.arrive()
                    yield from end.sync()

                def producer_f32():
                    it = nx = 0
                    n_sh = [0]
                    pend = [None]

                    def add_share():
                        yield from _wait(staged, n_sh[0] & 1)
                        yield from add(*pend[0])
                        freed.arrive()
                        n_sh[0] += 1

                    for n_ in range(10 ** 9):
                        item = yield from draw(n_)
                        yield from _wait(empty_kv, (n_ & 1) ^ 1)
                        if item >= n_items:
                            item_s[0] = -1
                            full_kv.arrive()
                            if pend[0] is not None:
                                yield from add_share()
                            break
                        taken.append((g, ci, r, item))
                        kt, bkv = divmod(item, BKV)
                        b, kvh = divmod(bkv, KV)
                        item_s[0] = item
                        full_kv.arrive()
                        for s_ in range(GS * (nQ - kt)):
                            qi = nQ - 1 - s_ // GS
                            yield from _wait(empty, (it & 1) ^ 1)
                            for i in range(n_other):
                                if fault != "x_early":
                                    yield from _wait(eab[1], (nx & 1) ^ 1)
                                slot[0] = (item, s_, i, 0)
                                fab[0].arrive()
                                if fault != "x_early":
                                    yield from _wait(eab[0], nx & 1)
                                slot[0] = (item, s_, i, 1)
                                fab[1].arrive()
                                nx += 1
                            if G > 1:
                                yield from _wait(eab[1], (nx & 1) ^ 1)
                            slot[0] = (item, s_)
                            full.arrive()
                            if pend[0] is not None:
                                yield from add_share()
                            pend[0] = None if qi == kt else (
                                b * H + kvh * GS + s_ % GS, qi, kt)
                            it += 1
                    yield from end.sync()

                def group_f32(gr):
                    it = n_sh = nx = 0
                    for n_ in range(10 ** 9):
                        yield from _wait(full_kv, n_ & 1)
                        item = item_s[0]
                        if item < 0:
                            break
                        kt, bkv = divmod(item, BKV)
                        b, kvh = divmod(bkv, KV)
                        steps = GS * (nQ - kt)
                        for s_ in range(steps):
                            qi = nQ - 1 - s_ // GS
                            bh = b * H + kvh * GS + s_ % GS
                            for i in range(n_other):
                                yield from _wait(fab[gr], nx & 1)
                                yield from read((item, s_, i, gr))
                                eab[gr].arrive()
                                nx += 1
                            yield from _wait(full, it & 1)
                            yield from read((item, s_))
                            yield from exchange(r, gr, it, (item, s_))
                            if gr == 0:
                                p_ready.arrive()
                                yield from read((item, s_))
                                empty.arrive()
                                yield from ds_ready.sync()
                            else:
                                yield from p_ready.sync()
                                ds_ready.arrive()
                                yield from read((item, s_))
                                empty.arrive()
                            if s_ == steps - 1:
                                empty_kv.arrive()
                            if qi != kt:
                                yield from _wait(freed, (n_sh & 1) ^ 1)
                                staged.arrive()
                                n_sh += 1
                            elif kt > 0:
                                if gr == 0:
                                    while counters.get((bh, qi, sl), 0) < kt:
                                        yield
                                yield from diag.sync()
                            it += 1
                    yield from end.sync()

                if body == "bf16":
                    return [producer_bf16(), consumer_bf16(0),
                            consumer_bf16(1)]
                return [producer_f32(), group_f32(0), group_f32(1)]

            return [a for r in range(C) for a in block(r)]

        return [a for ci in range(clusters) for a in cluster(ci)]

    for g in range(G):                          # one launch a walk, in turn
        _run(launch(g), rng, progress)
    return taken


_SHAPES = [(1, 2, 1, 64, 2, 1, 1, None), (1, 4, 2, 257, 2, 2, 1, None),
           (2, 4, 1, 200, 3, 3, 1, None), (1, 2, 2, 1, 2, 4, 1, None),
           (1, 8, 2, 300, 3, 2, 1, None), (2, 2, 1, 129, 8, 2, 1, None),
           (1, 2, 1, 130, 5, 2, 2, 9), (1, 4, 2, 70, 6, 3, 3, 17),
           (1, 2, 1, 64, 8, 1, 2, 16)]


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("B,H,KV,S,C,clusters,G,n", _SHAPES)
def test_cluster_protocol_completes(rng, body, B, H, KV, S, C, clusters, G,
                                    n):
    """The cluster body's tickets, exchanges, the walks' loads of the
    other slices and the waits end under random interleavings: no block
    hangs, no reader sees another step's partial or another load's slot,
    every item of every walk is taken by exactly one cluster and by each
    of its ranks (more clusters than items included; G = 2 over 9 slices
    and G = 3 over 17, a rank of the last walk owning no slice)."""
    kt_ = TILES[body][0]
    for _ in range(2):
        taken = _simulate(body, B, H, KV, S, C, clusters, rng, G=G, n=n)
        by_item = {}
        for g, ci, r, item in taken:
            by_item.setdefault((g, item), []).append((ci, r))
        assert sorted(by_item) == [(g, i) for g in range(G)
                                   for i in range(B * KV * -(-S // kt_))]
        for item, who in by_item.items():
            assert len({ci for ci, _ in who}) == 1
            assert sorted(r for _, r in who) == list(range(C))


def _fails(body, shape, rng, fault, tries=6, **walk):
    for _ in range(tries):
        try:
            _simulate(body, *shape, rng, fault=fault, **walk)
        except AssertionError as e:
            assert "hangs" in str(e) or "stale" in str(e), str(e)
            return True
    return False


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("fault,walk", [
    ("no_wait", {}), ("one_buffer", {}), ("own_tickets", {}),
    ("no_wait", {"G": 2, "n": 9}), ("one_buffer", {"G": 2, "n": 9}),
    ("own_tickets", {"G": 2, "n": 9}), ("x_early", {"G": 2, "n": 9}),
    ("x_early", {"G": 3, "n": 17})])
def test_cluster_protocol_fails_on_a_broken_wait(rng, body, fault, walk):
    """The simulation catches each broken step of the protocol, at one
    walk and in walks: a read before the other ranks' arrivals (a stale
    partial), one exchange buffer (a partial overwritten before a slower
    rank read it), blocks that draw their own tickets (ranks of a cluster
    on different items: the exchanges' tags differ, or a block waits for
    an exchange that never comes), and, in walks, a load into the slot
    before the other slice there was read (a stale slot)."""
    C = 2 if not walk else -(-walk["n"] // walk["G"])
    assert _fails(body, (1, 4, 2, 300 if not walk else 100, C, 2), rng,
                  fault, **walk)


# ---------------------------------------------------------------------------
# launch.bwd_ablate's variants of the exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in BA.PATCHES
                                  if n.startswith("cl_")])
def test_cl_ablate_patches_touch_the_exchange_alone(name):
    """Each `cl_*` variant of `launch.bwd_ablate` applies and changes the
    cluster backward's exchange (namespace clusterbwd) and nothing else,
    so the D <= 256 bodies and the tickets are as they are; no other
    variant touches that namespace."""
    out = BA.variant_source(name)
    a = _SRC.index("namespace clusterbwd {")
    b = _SRC.index("}  // namespace clusterbwd")
    assert out != _SRC and out[:a] == _SRC[:a]
    assert out.endswith(_SRC[b:])
    assert BA.body_of(name) == "cl"
    assert _span("clusterbwd", out).count("ticket(") == \
        _span("clusterbwd").count("ticket(")
    for other in BA.PATCHES:
        if not other.startswith("cl_"):
            assert _span("clusterbwd", BA.variant_source(other)) == \
                _span("clusterbwd")


def test_ablate_d512_presets():
    """`--shape d512` and `d512_f32`: B 1, H 8, KV 2, S 2048, D 512, and
    `d2304` and `d2304_f32`: B 1, H 2, KV 1, S 2048, D 2304 (two walks),
    in bfloat16 and float32 operands; a shape above 256 runs the `cl_*`
    variants by default (`cl_one_slice` among them: the walks' S and dP
    over the owned slice alone); `--parent` takes every shape of one walk
    (a parent's cluster body takes this wrapper's scratch there) and
    refuses those above 2048 (a parent before the walks runs simplebwd on
    another scratch)."""
    assert BA.parse_shape("d512") == BA.parse_shape("d512_f32") == (
        1, 8, 2, 2048, 512)
    assert BA.parse_shape("d2304") == BA.parse_shape("d2304_f32") == (
        1, 2, 1, 2048, 2304)
    assert {"d512_f32", "d2304_f32"} <= set(BA.FLOAT32_PRESETS)
    assert not {"d512", "d2304"} & set(BA.FLOAT32_PRESETS)
    assert {"cl_no_sum", "cl_no_sync", "cl_no_xch",
            "cl_one_slice"} <= set(BA.PATCHES)
    assert BA.NAMESPACES["cl"] == "clusterbwd"
    one = BA.variant_source("cl_one_slice")
    assert "  return 1;\n}" in _span("clusterbwd", one)
    assert "  return 0;\n}" in _span("clusterbwd", one)
    for shape in ("yi", "wide", "f32", "wide_f32", "d512", "d512_f32",
                  "1,2,1,64,2048"):
        assert BA.parent_refusal(shape) is None
    for shape in ("d2304", "d2304_f32", "1,2,1,64,2056"):
        assert "D <= 2048" in BA.parent_refusal(shape)
    for shape in ("d2304", "d2304_f32"):
        with pytest.raises(SystemExit, match="D <= 2048"):
            BA.main(["--shape", shape, "--parent", "x.cu"])
