"""A CPU model of the flash forward's cluster body (every D > 256:
``csrc/flash_attention.cu``, the D = 256 bodies `Fwd<256>`
(``flash_fwd_bf16_kernel_d256``) and `f32wide`
(``flash_fwd_f32_wide_kernel``) instantiated with CL = true, and above
2048 with WALKS = true, the exchange of namespace `clusterbwd`), and of
the wrapper's routes there.

The model follows the kernel, whose constants it reads from the source:

* n = ceil(width / 256) slices of 256 columns (the last ragged, its
  columns past the width zero-filled), G = ceil(n / 8) walks (launches),
  C = ceil(n / G) blocks a cluster; in walk g block r owns slice r + C g
  (its V tiles and output columns; one walk, G = 1, up to 2048);
* rank 0 draws each ticket from the stream's counter and writes it into
  every rank's two slots, so the cluster's blocks take the same items in
  the D = 256 body's list order (bfloat16: 128-row items, 80-key tiles;
  float32: 64 and 32); the launch's last ticket, n_items + clusters - 1,
  puts the counter back to zero;
* per key tile each block sums S over its slices r, r + C, .. below the
  width, in that order in every walk, in its body's order (float32: each
  quarter of a slice's dots in column order, the quarter's chain carried
  from slice to slice, then (x0 + x1) + (x2 + x3); bfloat16: the wgmma's
  float32 sums over the columns), stores the partials, arrives on every other rank's mbarrier,
  waits for theirs, and adds the C partials in ascending rank order (a
  pair: its own and the other's, the same bits either way round); so
  every block forms the same m, l and P, and then O for its own columns;
  rank 0 writes lse.

Tolerances: the emulated arithmetic within 1e-5 x max|o| (float32) and
2e-2 x max|o| (bfloat16) of `flash_attention_plain`, of the reference's
dense oracle and of its Pallas kernel in interpret mode."""
import difflib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JO
from repro.kernels import ref as JRef
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import fwd_ablate as FWA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
F32 = np.float32
NEG = F32(-1e30)
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


def _wide_const(name, src=_SRC):
    """An int constant of `Fwd<256>`, as written."""
    return int(re.search(rf"static constexpr int {name} = (\d+);",
                         src[src.index("struct Fwd<256> {"):])[1])


def _layout(src=_SRC):
    """The text of `WideL`, the D = 256 body's layout in each
    instantiation."""
    a = src.index("template <bool CL>\nstruct WideL {")
    return src[a:src.index("\n};\n", a)]


CL = {n: _const(n, "clusterbwd") for n in ("MAX_C", "WIDTH", "XWARPS",
                                           "XUNIT")}
WIDTH = CL["WIDTH"]
BF16 = {n: _wide_const(n) for n in ("BK", "CONSUMERS", "STAGES")}
BF16["BQ"] = 64 * BF16["CONSUMERS"]
XSUM = int(re.search(r"static constexpr int XSUM = (\d+);", _layout())[1])
FP32 = {n: _const(n, "f32wide") for n in ("BQ", "BK", "STAGES", "WARPS")}
#: (query rows per item, keys per tile) of each dtype's D = 256 body
TILES = {"bf16": (BF16["BQ"], BF16["BK"]), "f32": (FP32["BQ"], FP32["BK"])}


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


# ---------------------------------------------------------------------------
# constants, shared memory, the C rule, the routes
# ---------------------------------------------------------------------------


def test_constants_and_shared_memory():
    """Both cluster bodies' layouts fit a block's 232,448 bytes, as the
    source's comments count them (bfloat16: Q, one K and V stage and the
    exchange's two 40 KB buffers in the second stage's room; float32: the
    D = 256 layout and two 8 KB buffers), the source asserts it, and the
    CL = false instantiation keeps Fwd<256>'s own layout; the tiles are
    the wrapper's, and the exchange's units a lane's partials."""
    assert (CL["MAX_C"], WIDTH) == (8, 256)
    assert FA.CLUSTER_WIDTH == WIDTH and FA.CLUSTER_BLOCKS == CL["MAX_C"]
    assert TILES == {"bf16": FA.TILES[torch.bfloat16][256],
                     "f32": FA.TILES[torch.float32][256]}
    # bfloat16: 128 x 256 Q, one 80 x 256 K and V tile, two buffers of 8
    # warps x (40 floats a lane: 10 units) x 32 lanes, item, tickets,
    # mbarriers (Q full / empty, the stage's four, 16 exchanges, 2 tickets)
    bq, bk = TILES["bf16"]
    units = bk // 8
    xbuf = CL["XWARPS"] * units * CL["XUNIT"]
    assert xbuf == bq * bk * 4                   # a tile's partial S
    smem = (bq * 256 * 2 + 2 * bk * 256 * 2 + 2 * xbuf + 16 + 16
            + 8 * (2 + 4 + 2 * CL["XWARPS"] + 2) + 1024)
    assert smem == 230_624 <= 232_448
    text = _layout()
    assert "230,624" in _SRC[_SRC.index("struct WideL {") - 900:
                             _SRC.index("struct WideL {")]
    assert "static constexpr int STAGES = CL ? 1 : F::STAGES;" in text
    assert "static_assert(SMEM <= 232448" in text
    assert "\"CL = false is Fwd<256>'s own layout\"" in text
    assert BF16["STAGES"] == 2 and bk % 16 == 0
    # the sum's chunks: whole 16-byte units of a lane's bk / 2 floats
    assert (bk // 2) % XSUM == 0 and XSUM % 4 == 0
    # float32: f32wide's 207,456 (with its alignment), aligned to 16, two
    # buffers of 8 warps x 2 units (a lane's row against 8 keys), the
    # tickets, 18 mbarriers
    body = _span("f32wide")
    assert "207,456" in body and "224,000" in body
    bq, bk = TILES["f32"]
    xbuf = CL["XWARPS"] * 2 * CL["XUNIT"]
    assert xbuf == bq * bk * 4
    bar_end = 207_456 - 1024
    smem = (-(-bar_end // 16) * 16 + 2 * xbuf + 16
            + 8 * (2 * CL["XWARPS"] + 2) + 1024)
    assert smem == 224_000 <= 232_448
    assert "static_assert(CL_SMEM <= 232448" in body
    assert FP32["STAGES"] == 2 and FP32["WARPS"] == CL["XWARPS"]
    for kernel in ("flash_fwd_bf16_kernel_d256(const",
                   "flash_fwd_f32_wide_kernel(const"):
        head = _SRC[:_SRC.index(kernel)]
        assert head.rstrip().endswith(
            "__global__ void __launch_bounds__(Fwd<256>::THREADS, 1)"
            if "d256" in kernel else
            "__global__ void __launch_bounds__(THREADS, 1)")
        assert head[head.rindex("template <bool CL, bool WALKS = false>"):
                    ].count("\n") == 2


@pytest.mark.parametrize("width,C,G", [
    (257, 2, 1), (264, 2, 1), (512, 2, 1), (513, 3, 1), (768, 3, 1),
    (2048, 8, 1), (2049, 5, 2), (2056, 5, 2), (2112, 5, 2), (2304, 5, 2),
    (4096, 8, 2), (4100, 6, 3), (4160, 6, 3), (8192, 8, 4)])
def test_the_c_rule(width, C, G):
    """(C, G) from one place, `clusterbwd::walks` (shared with the
    backward, the wrapper's `cluster_walks`), C within 2 .. 8; the
    forward's launchers and its info take the cluster route for every D >
    256, the launcher one launch a walk (lse written by the first), and
    the info returns G beside C."""
    assert walks(width)[:2] == (C, G) == FA.cluster_walks(width)
    assert "*G = (*n + MAX_C - 1) / MAX_C;" in _span("clusterbwd")
    assert "*C = (*n + *G - 1) / *G;" in _span("clusterbwd")
    fwd = _SRC[_SRC.index('extern "C" int flash_attention_launch('):
               _SRC.index('extern "C" int flash_attention_bwd_launch(')]
    assert fwd.count("if (D > clusterbwd::WIDTH) {") == 2
    assert "out[6] = 1;" in fwd
    for ns in ("bf16body", "f32wide"):
        assert f"{ns}::launch_cluster(" in fwd
        assert f"{ns}::cluster_schedule(" in fwd
    # both forward launchers (and both backward ones) launch one walk at a
    # time; the forward's first walk alone writes lse
    assert _SRC.count("for (int g = 0; g < G && err == 0; ++g)") == 4
    assert _SRC.count("g == 0 ? lse : nullptr") == 2


@pytest.mark.parametrize("D,bf16,f32", [
    (257, ("cluster", 264), ("cluster", 260)),
    (260, ("cluster", 264), ("cluster", 260)),
    (320, ("cluster", 320), ("cluster", 320)),
    (512, ("cluster", 512), ("cluster", 512)),
    (768, ("cluster", 768), ("cluster", 768)),
    (2048, ("cluster", 2048), ("cluster", 2048)),
    (2049, ("cluster", 2056), ("cluster", 2052)),
    (2112, ("cluster", 2112), ("cluster", 2112)),
    (2304, ("cluster", 2304), ("cluster", 2304)),
    (4100, ("cluster", 4104), ("cluster", 4100)),
    (8192, ("cluster", 8192), ("cluster", 8192))])
def test_forward_routes_above_256(D, bf16, f32):
    """Above D = 256 both dtypes run the cluster forward at every width
    (in walks above 2048): in place when a row is whole 16-byte units (D
    % 8 == 0 at bfloat16, D % 4 == 0 at float32), else zero-padded to the
    next such width, the backward's rule; the route takes 16-byte starts
    and strides (TMA), and the wrapper has no widebody route left."""
    assert FA._forward_route(torch.bfloat16, D) == bf16
    assert FA._forward_route(torch.float32, D) == f32
    for dt, route in ((torch.bfloat16, bf16), (torch.float32, f32)):
        back = FA._backward_route(dt, D)
        assert route == back
        q = torch.zeros((1, 1, 1, D), dtype=dt)
        assert FA._fwd_align(q, *route) == 16
    assert "widebody" not in _SRC and "flash_attention_wide_launch" not in \
        _SRC


def test_cluster_forward_on_the_cpu_is_the_plain_version(rng):
    """On CPU tensors the wrapper runs the plain version at any width,
    the cluster route's included (a ragged D = 260 and 320)."""
    for D in (260, 320):
        q, k, v = (torch.as_tensor(rng.normal(size=(1, h, 20, D)).astype(
            np.float32)) for h in (4, 2, 2))
        o, lse = FA.flash_attention_fwd(q, k, v)
        po, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
        assert torch.equal(o, po) and torch.equal(lse, plse)


# ---------------------------------------------------------------------------
# the work list and the tickets
# ---------------------------------------------------------------------------


def work_list(B, H, S, body):
    """`work_item` over the schedule's items: (bh, query tile) in list
    order, the last query tiles first, a tile's heads in order."""
    bq = TILES[body][0]
    n_qt = -(-S // bq)
    return [(i % (B * H), n_qt - 1 - i // (B * H))
            for i in range(B * H * n_qt)]


def draw_tickets(n_items, clusters, rng, reset):
    """Clusters drawing tickets from one counter in a random order, one
    draw a turn by rank 0, until each has drawn one past the last item;
    `reset` is the ticket that puts the counter back to zero.  Returns
    (the items each cluster took, the counter after)."""
    counter, taken, live = [0], {c: [] for c in range(clusters)}, \
        list(range(clusters))
    while live:
        c = live[int(rng.integers(len(live)))]
        item = counter[0]
        counter[0] += 1
        if item >= n_items:
            if item == reset:
                counter[0] = 0
            live.remove(c)
        else:
            taken[c].append(item)
    return taken, counter[0]


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("B,H,KV,S,clusters", [
    (1, 8, 2, 2048, 66), (4, 8, 2, 2048, 66), (1, 2, 1, 1, 66),
    (2, 4, 4, 130, 3), (1, 4, 1, 70, 1)])
def test_work_list_and_ticket_reset(rng, body, B, H, KV, S, clusters):
    """The cluster forward's items are the D = 256 body's (every (batch x
    head, query tile) once, the most key tiles first, a GQA group's heads
    side by side); rank 0 draws one ticket a turn for its cluster, so a
    launch of `clusters` clusters draws n_items + clusters tickets, and the
    last, n_items + clusters - 1, leaves the counter at zero: the source's
    reset in both bodies.  Reset at the blocks' count (n_items + C x
    clusters - 1, the persistent bodies' rule) the counter stays dirty and
    the next launch on the stream would skip items."""
    items = work_list(B, H, S, body)
    bq, bk = TILES[body]
    n_qt = -(-S // bq)
    assert sorted(items) == [(bh, qt) for bh in range(B * H)
                             for qt in range(n_qt)]
    n_kv = [-(-min(S, qt * bq + bq) // bk) for _, qt in items]
    assert n_kv == sorted(n_kv, reverse=True)
    G = H // KV
    for i in range(0, len(items), G):
        heads = [bh for bh, _ in items[i:i + G]]
        assert heads == list(range(heads[0], heads[0] + G))
    n_items = len(items)
    clusters = min(clusters, n_items)
    for _ in range(3):
        taken, counter = draw_tickets(n_items, clusters, rng,
                                      n_items + clusters - 1)
        assert sorted(i for t in taken.values() for i in t) == \
            list(range(n_items))
        assert counter == 0
    C = 2
    _, counter = draw_tickets(n_items, clusters, rng,
                              n_items + C * clusters - 1)
    assert counter == n_items + clusters
    reset = ("if (rank == 0 && item == n_items + (int)gridDim.x / C - 1) "
             "atomicExch(work, 0);")
    for body in (_wide_body(), _span("f32wide")):
        assert reset in re.sub(r"\s+", " ", body)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fmaf, elementwise (exact product, one rounding to float64 and one
    to float32: rarely a last bit off the card's)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _quarter_dots(A, Bm, slices=(0,)):
    """A Bm^T over the 256-column slices `slices` in that order as f32wide
    sums S: each quarter of a slice's dots (64 columns) in column order
    with fmaf, the quarter's chain carried on from slice to slice, then
    (x0 + x1) + (x2 + x3)."""
    x = []
    for p in range(4):
        acc = np.zeros((A.shape[0], Bm.shape[0]), F32)
        for sl in slices:
            for d in range(WIDTH * sl + 64 * p, WIDTH * sl + 64 * p + 64):
                acc = _fma(A[:, d, None], Bm[None, :, d], acc)
        x.append(acc)
    return (x[0] + x[1]) + (x[2] + x[3])


def rank_sums(parts, pair=False):
    """Each rank's sum of the C partials: in ascending rank order, or
    (`pair`, two ranks) its own plus the other's."""
    C = len(parts)
    if pair:
        assert C == 2
        return [parts[r] + parts[r ^ 1] for r in range(C)]
    out = []
    for _ in range(C):
        acc = parts[0]
        for p in range(1, C):
            acc = acc + parts[p]
        out.append(acc)
    return out


def _cluster_s(Q, K, body):
    """S of one tile as the cluster's ranks form it (in every walk): each
    rank's slices r, r + C, .. summed in its body's order, then the ranks'
    sums; every rank's bits checked equal."""
    C, G, n = walks(Q.shape[1])
    seqs = [[r + C * j for j in range(slices_of(n, r, C))] for r in range(C)]
    if body == "f32":
        parts = [_quarter_dots(Q, K, sq) for sq in seqs]
        sums = rank_sums(parts)
    else:
        parts = []
        for sq in seqs:
            acc = np.zeros((Q.shape[0], K.shape[0]), F32)
            for sl in sq:
                c = slice(WIDTH * sl, WIDTH * (sl + 1))
                acc = (acc + Q[:, c] @ K[:, c].T).astype(F32)
            parts.append(acc)
        sums = rank_sums(parts, pair=C == 2)
    assert all(np.array_equal(sums[0], x) for x in sums), \
        "ranks formed different sums"
    return sums[0]


def emulate(q, k, v, body):
    """(o, lse) as the cluster forward computes them from q (B, H, S, D),
    k, v (B, KV, S, D) (bfloat16 values for "bf16"): the operands
    zero-filled to whole slices and tiles, each item's key tiles in order,
    S summed over each rank's slices and over the ranks (the same in every
    walk: each forms the same P and its owned columns of O), then the D =
    256 body's softmax and P V on the whole width (column by column, which
    no slicing changes): float32 with fmaf and expf (f32wide), bfloat16 in
    the log2 domain with P rounded to bfloat16 (Fwd<256>, each consumer's
    64 rows, its masked tiles' keys past a row at -1e30)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    bq, bk = TILES[body]
    W = walks(D)[2] * WIDTH
    G, n_qt = H // KV, -(-S // bq)
    Sp = -(-n_qt * bq // bk) * bk

    def fill(x):
        return np.pad(x.float().numpy().astype(F32),
                      [(0, 0), (0, 0), (0, Sp - S), (0, W - D)])

    qn, kn, vn = fill(q), fill(k), fill(v)
    scale = F32(D ** -0.5)
    sl2 = F32(D ** -0.5 * LOG2E)
    o = np.zeros((B, H, Sp, W), F32)
    lse = np.zeros((B, H, Sp), F32)
    rows_a = 64 if body == "bf16" else bq        # rows of one walk
    lanes = np.arange(4)
    for bh, qt in work_list(B, H, S, body):
        b, h = divmod(bh, H)
        for r0 in range(qt * bq, qt * bq + bq, rows_a):
            if r0 >= S:
                continue
            rows = np.arange(r0, r0 + rows_a)
            last = min(S - 1, r0 + rows_a - 1) // bk
            Q = qn[b, h, r0:r0 + rows_a]
            m = np.full(rows_a, NEG, F32)
            l = np.zeros(rows_a, F32)
            acc = np.zeros((rows_a, W), F32)
            for t in range(last + 1):
                keys = np.arange(t * bk, t * bk + bk)
                K = kn[b, h // G, keys]
                V = vn[b, h // G, keys]
                s = _cluster_s(Q, K, body)
                mask = (keys[None, :] <= rows[:, None]) & (keys[None, :] < S)
                with np.errstate(under="ignore", over="ignore"):
                    if body == "f32":
                        x = np.where(mask, (s * scale).astype(F32), NEG)
                        m_new = np.maximum(m, x.max(1))
                        alpha = np.exp(m - m_new).astype(F32)
                        p = np.exp(x - m_new[:, None]).astype(F32)
                        part = np.zeros((rows_a, 4), F32)
                        for c in range(bk // 4):
                            part = part + p[:, lanes + 4 * c]
                        for off in (1, 2):
                            part = part + part[:, lanes ^ off]
                        l = (l * alpha + part[:, 0]).astype(F32)
                        acc = acc * alpha[:, None]
                        for j in range(bk):      # the tile's keys in order
                            acc = _fma(p[:, j, None], V[None, j, :], acc)
                    else:
                        x = np.where(keys[None, :] > rows[:, None], NEG, s)
                        m_new = np.maximum(m, x.max(1) * sl2)
                        alpha = np.exp2(m - m_new).astype(F32)
                        p = np.exp2(x * sl2 - m_new[:, None]).astype(F32)
                        l = (l * alpha + p.sum(1)).astype(F32)
                        pb = torch.as_tensor(p).bfloat16().float().numpy()
                        acc = (acc * alpha[:, None] + pb @ V).astype(F32)
                m = m_new
            den = np.maximum(l, F32(1e-30))
            o[b, h, r0:r0 + rows_a] = acc / den[:, None]
            lse[b, h, r0:r0 + rows_a] = (
                m + np.log(den) if body == "f32"
                else (m + np.log2(den)) / LOG2E)
    out = torch.from_numpy(np.ascontiguousarray(o[:, :, :S, :D]))
    if body == "bf16":
        out = out.bfloat16()
    return out, lse[:, :, :S]


def _max_rel(got, want):
    g, w = got.float().numpy(), np.asarray(want, F32)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)


def _block(S):
    """The reference kernel's block: the largest divisor of S up to 64."""
    return max(d for d in range(1, min(S, 64) + 1) if S % d == 0)


@pytest.mark.parametrize("body", ["f32", "bf16"])
@pytest.mark.parametrize("D", [320, 512, 768])
@pytest.mark.parametrize("S", [1, 70, 130])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_cluster_arithmetic_within_tolerance(rng, H, KV, S, D, body):
    """The emulated cluster forward: every rank forms the same S bits; its
    output within 1e-5 x max|o| (float32) or 2e-2 x max|o| (bfloat16) of
    `flash_attention_plain`, of the reference's dense oracle
    (`flash_attention_ref`) and of its Pallas kernel in interpret mode
    (blocks dividing S), and lse within 1e-5 of the plain version's; MHA,
    GQA and MQA, S = 1 and ragged against the tiles, 320 with a ragged
    last slice, 768 three slices."""
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV)]
    tdt = torch.float32 if body == "f32" else torch.bfloat16
    q, k, v = (torch.as_tensor(a).to(tdt) for a in arrs)
    got, lse = emulate(q, k, v, body)
    assert got.shape == q.shape and got.dtype == tdt
    tol = 1e-5 if body == "f32" else 2e-2
    po, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
    assert _max_rel(got, po.float().numpy()) <= tol
    np.testing.assert_allclose(lse, plse.numpy(), atol=1e-5, rtol=1e-5)
    jdt = jnp.float32 if body == "f32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jdt)
                  for x in (q, k, v))
    assert _max_rel(got, np.asarray(JRef.flash_attention_ref(jq, jk, jv),
                                    F32)) <= tol
    blk = _block(S)
    jo = JO.flash_attention(jq, jk, jv, bq=blk, bk=blk)
    assert _max_rel(got, np.asarray(jo, F32)) <= tol


@pytest.mark.parametrize("body,D,S,H,KV", [
    ("f32", 2112, 70, 4, 2), ("bf16", 2112, 130, 4, 1),
    ("f32", 2304, 1, 2, 1), ("bf16", 2304, 70, 2, 1),
    ("f32", 4100, 40, 2, 1), ("bf16", 4104, 33, 4, 2)])
def test_walks_arithmetic_within_tolerance(rng, body, D, S, H, KV):
    """The emulated walks (G = 2 over 9 slices at 2112 and 2304, G = 3
    over 17 at 4100 / 4104, a ragged last slice, a last walk in which a
    rank owns no slice): every rank forms the same S bits; the output
    within 1e-5 x max|o| (float32) or 2e-2 x max|o| (bfloat16) of
    `flash_attention_plain` and of the reference's dense oracle, and lse
    within 1e-5 of the plain version's; S = 1 and ragged."""
    assert walks(D)[1] == (2 if D < 4096 else 3)
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV)]
    tdt = torch.float32 if body == "f32" else torch.bfloat16
    q, k, v = (torch.as_tensor(a).to(tdt) for a in arrs)
    got, lse = emulate(q, k, v, body)
    assert got.shape == q.shape and got.dtype == tdt
    tol = 1e-5 if body == "f32" else 2e-2
    po, plse = FA.flash_attention_plain(q, k, v, return_lse=True)
    assert _max_rel(got, po.float().numpy()) <= tol
    np.testing.assert_allclose(lse, plse.numpy(), atol=1e-5, rtol=1e-5)
    jdt = jnp.float32 if body == "f32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jdt)
                  for x in (q, k, v))
    assert _max_rel(got, np.asarray(JRef.flash_attention_ref(jq, jk, jv),
                                    F32)) <= tol


@pytest.mark.parametrize("body", ["f32", "bf16"])
def test_walks_against_the_reference_kernel(rng, body):
    """At D = 2112 (two walks of five blocks) the emulated walks, the
    port's CPU path and the reference's Pallas kernel in interpret mode
    agree within 1e-5 x max|o| (float32) or 2e-2 x max|o| (bfloat16)."""
    S, D = 64, 2112
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (4, 2, 2)]
    tdt = torch.float32 if body == "f32" else torch.bfloat16
    q, k, v = (torch.as_tensor(a).to(tdt) for a in arrs)
    got, _ = emulate(q, k, v, body)
    tol = 1e-5 if body == "f32" else 2e-2
    jdt = jnp.float32 if body == "f32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jdt)
                  for x in (q, k, v))
    jo = np.asarray(JO.flash_attention(jq, jk, jv, bq=_block(S),
                                       bk=_block(S)), F32)
    assert _max_rel(got, jo) <= tol
    assert _max_rel(FA.flash_attention(q, k, v), jo) <= tol


# ---------------------------------------------------------------------------
# the protocol: tickets, ring, turns, exchanges, cluster barriers
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
    "wide": [
        "mbar_init(xin + 8 * i, C - 1);", "mbar_init(tick, 1);",
        "mbar_init(tick + 8, 1);",
        "if constexpr (CL) clusterbwd::sync();        // every rank's",
        "CL ? clusterbwd::ticket(work, base + L::TICK_OFF, tick, n, C,",
        "mbar_wait(empty_q, (n & 1) ^ 1);",
        "mbar_init(empty_q, WALKS ? 128 * NCONS : NCONS);",
        "const int ns = WALKS ? clusterbwd::slices_of(slices, rank, C) : 1;",
        "for (int t = 0; t < n_kv; ++t, ++jv) {",
        "for (int jj = 0; jj < ns; ++jj, ++jq) {",
        "mbar_wait(empty_k, (jq & 1) ^ 1);", "mbar_wait(empty_q, (jq & 1) ^ 1);",
        "if (t == 0 && jj == 0) item_s[0] = item;",
        "mbar_wait(empty_v, (jv & 1) ^ 1);",
        "mbar_wait(full_q, nq & 1);", "mbar_wait(full_k, nq & 1);",
        "mbar_wait(full_v, nv & 1);",
        "qk_release(n_kv == 1 && jj == ns - 1);",
        "qk_release(t == n_kv - 1 && jj == ns - 1);",
        "if (!keep) mbar_arrive(empty_q);",
        "} else if constexpr (WALKS) {\n        mbar_arrive(empty_q);",
        "if (WALKS || tid == 0) mbar_arrive(empty_q);",
        "const int pre = min(n_kv, STAGES);",
        "return base + L::X_OFF + (x & 1) * L::XBUF +",
        "return xin + 8 * ((x & 1) * clusterbwd::XWARPS + threadIdx.x / 32 "
        "- 4);",
        "clusterbwd::gather(xbar(), x);",
        "        if constexpr (CL) {                    // S over all of D\n"
        "          post();                              // under P V of tile "
        "t - 1\n"
        "          wgmma_wait<0>();                     // P V of tile t - 1\n"
        "          pin(acc);\n"
        "          mbar_arrive(empty_v + 8 * slot(t - 1));\n"
        "          gather_sum();",
        "if (w == NCONS - 1) bar_arrive(1);",
        "    __syncwarp();\n    clusterbwd::sync();\n  }\n}"],
    "f32wide": [
        "mbar_init(xin + 8 * i, C - 1);", "mbar_init(tick, 1);",
        "mbar_init(tick + 8, 1);",
        "if constexpr (CL) clusterbwd::sync();        // every rank's",
        "const int item = CL ? clusterbwd::ticket(work, base + TICK_OFF, tick,",
        "z, base + X_OFF + (j & 1) * XBUF + warp * 2 * clusterbwd::XUNIT +",
        "xin + 8 * ((j & 1) * clusterbwd::XWARPS + warp), j, C, rank);",
        "if (t == n_kv - 1) mbar_arrive(empty_q);   // Q read",
        "  if constexpr (CL) clusterbwd::sync();\n}",
        "return clusterbwd::slices_of((width + own * D + D - 1) / D, rank, C);",
        "mbar_wait(i ? empty_v : empty_q, ((jq >> 1) & 1) ^ 1);",
        "if (t == 0 && jj == 0) item_s[i] = item;",
        "mbar_wait(empty_k + 8 * s, ((jr >> 1) & 1) ^ 1);",
        "ring_load(&tk, col, t, j * (ns_() + 1) + jj);",
        "ring_load(&tv, col0, t, (j + 1) * (ns_() + 1) - 1);",
        "const int col = (rank + C * jj) * D, jq = j * ns_() + jj;",
        "mbar_wait(jq & 1 ? full_v : full_q, (jq >> 1) & 1);",
        "item = item_s[jq & 1];",
        "const int jq = j * ns_() + jj, jr = j * (ns_() + 1) + jj;",
        "mbar_wait(i ? full_v : full_q, (jq >> 1) & 1);",
        "mbar_wait(full_k + 8 * sr, (jr >> 1) & 1);",
        "mbar_arrive(i ? empty_v : empty_q);  // Q read",
        "const int jv = (j + 1) * (ns_() + 1) - 1;"],
}


def _wide_body(src=_SRC):
    return src[src.index("flash_fwd_bf16_kernel_d256(const"):
               src.index("int launch_wide(")]


def test_protocol_is_the_sources():
    """Every ticket, exchange and barrier step the simulation models is in
    the source; the exchange sits between S's sums and the softmax in both
    bodies, and the bfloat16 body's pair adds the other rank's partial to
    its own."""
    for where, stmts in _PROTOCOL.items():
        body = _wide_body() if where == "wide" else _span(where)
        for stmt in stmts:
            assert stmt in body, (where, stmt)
    wide = _wide_body()
    assert wide.index("wgmma_wait<1>();                       // S of tile "
                      "t") < wide.index("          post();                    "
                                        "          // under P V") < wide.index(
        "          online(t * KT + KT - 1 > row0, row0 - t * KT);")
    assert "clusterbwd::mapa(a, clusterbwd::rank() ^ 1);" in wide
    f32 = _span("f32wide")
    assert f32.index("z[c] = mine + __shfl_xor_sync(0xffffffffu, other, "
                     "16);") < f32.index("clusterbwd::exchange(") < \
        f32.index("z[c] = (kpos <= qpos && kpos < S) ? z[c] * scale : NEG;")


def _simulate(body, B, H, S, C, clusters, rng, *, G=1, n=None, fault=None):
    """The cluster forward's waits and arrivals: `clusters` clusters of C
    blocks sharing the ticket counter, each block a producer (the tickets,
    the Q slot, the K and V ring) and its consumers (bfloat16: the two
    warpgroups of 64 rows, taking turns, one ring stage; float32: the
    eight warps as two agents of four, two stages), under a random
    scheduler; in G walks over n slices (one launch each, on the same
    counter), where each key tile takes each of the block's slices' Q and
    K in turn (bfloat16: the Q slot and the K stage, one turn a slice, the
    item's last Q kept for the epilogue; float32: two Q slots, and one
    ring of two stages for the K tiles and then the V tile).  Every
    exchange stores a tag (item, tile) in the block's buffer, and each
    reader checks the tags of every rank's buffer it reads; in walks every
    Q and K load stores its tag, which its readers check before and after
    reading.  Faults: "no_wait" (a reader does not wait for the other
    ranks' arrivals), "one_buffer" (one exchange buffer), "own_tickets"
    (each block draws its own tickets), "one_slot" (one ticket slot and
    mbarrier), "wrong_reset" (the counter reset at the blocks' count),
    "q_early" (in walks, a Q loaded before the one it replaces was read).
    Returns ((walk, cluster, rank, item) taken, the counter after).  A
    hang, or a tag that is not the reader's, fails."""
    bq, bk = TILES[body]
    stages = 1 if body == "bf16" else FP32["STAGES"]
    n_qt = -(-S // bq)
    BH = B * H
    n_items = BH * n_qt
    n = C * G if n is None else n
    ticket, taken, progress = [0], [], [0]
    reset = n_items + (C * clusters if fault == "wrong_reset"
                       else clusters) - 1

    def n_kv(item):
        qt = n_qt - 1 - item // BH
        return -(-min(S, qt * bq + bq) // bk)

    def stale(got, tag):
        assert got == tag, f"read {got} at {tag}: a stale tile"

    def launch(g):
        def cluster(ci):
            nslot = 1 if fault == "one_slot" else 2
            slots = [[None] * 2 for _ in range(C)]
            tick = [[_Mbar(1, progress) for _ in range(2)] for _ in range(C)]
            nbuf = 1 if fault == "one_buffer" else 2
            xbuf = [[[None, None] for _ in range(nbuf)] for _ in range(C)]
            xin = [[[_Mbar(C - 1, progress) for _ in range(2)]
                    for _ in range(nbuf)] for _ in range(C)]
            end = _Named(3 * C, progress)

            def exchange(r, a, x, tag):
                buf = x % nbuf
                xbuf[r][buf][a] = tag
                yield
                for p in range(C):
                    if p != r:
                        xin[p][buf][a].arrive()
                if fault != "no_wait":
                    yield from _wait(xin[r][buf][a], (x // nbuf) & 1)
                for p in range(C):              # one rank's units at a time
                    got = xbuf[p][buf][a]
                    assert got == tag, f"read {got} at {tag}: a stale partial"
                    yield

            def block(r):
                ns = slices_of(n, r, C) if G > 1 else 1
                full_q, empty_q = _Mbar(1, progress), _Mbar(2, progress)
                full_k, full_v, empty_k, empty_v = (
                    [_Mbar(c, progress) for _ in range(stages)]
                    for c in (1, 1, 2, 2))
                turns = [_Named(2, progress) for _ in range(2)]
                item_s = [None, None]
                qtag, ktag = [None, None], [None, None]
                ohalf = [None, None]            # O staged in the Q slot

                def draw(n_):
                    if fault == "own_tickets":
                        item = ticket[0]
                        ticket[0] += 1
                        yield
                        return item
                    s_ = n_ % nslot
                    if r == 0:
                        item = ticket[0]
                        ticket[0] += 1
                        if item == reset:
                            ticket[0] = 0
                        for p in range(C):
                            slots[p][s_] = item
                            tick[p][s_].arrive()
                    yield from _wait(tick[r][s_], (n_ // nslot) & 1)
                    return slots[r][s_]

                def producer():
                    j = 0
                    for n_ in range(10 ** 9):
                        item = yield from draw(n_)
                        if item >= n_items:
                            yield from _wait(empty_q, (n_ & 1) ^ 1)
                            item_s[0] = -1
                            full_q.arrive()
                            break
                        taken.append((g, ci, r, item))

                        def kv_load():
                            nonlocal j
                            s_, par = j % stages, ((j // stages) & 1) ^ 1
                            yield from _wait(empty_k[s_], par)
                            full_k[s_].arrive()
                            yield from _wait(empty_v[s_], par)
                            full_v[s_].arrive()
                            j += 1

                        pre = min(n_kv(item), stages)
                        for _ in range(pre):
                            yield from kv_load()
                        yield from _wait(empty_q, (n_ & 1) ^ 1)
                        item_s[0] = item
                        full_q.arrive()
                        for _ in range(pre, n_kv(item)):
                            yield from kv_load()
                    yield from end.sync()

                def producer_walks_bf16():
                    jk = jq = jv = 0
                    for n_ in range(10 ** 9):
                        item = yield from draw(n_)
                        if item >= n_items:
                            yield from _wait(empty_q, (jq & 1) ^ 1)
                            item_s[0] = -1
                            full_q.arrive()
                            break
                        taken.append((g, ci, r, item))
                        for t in range(n_kv(item)):
                            for jj in range(ns):
                                yield from _wait(empty_k[0], (jk & 1) ^ 1)
                                ktag[0] = (item, t, jj)
                                full_k[0].arrive()
                                jk += 1
                                if fault != "q_early":
                                    yield from _wait(empty_q, (jq & 1) ^ 1)
                                if t == 0 and jj == 0:
                                    item_s[0] = item
                                qtag[0] = ohalf[0] = ohalf[1] = (item, t, jj)
                                full_q.arrive()
                                jq += 1
                            yield from _wait(empty_v[0], (jv & 1) ^ 1)
                            full_v[0].arrive()
                            jv += 1
                    yield from end.sync()

                def producer_walks_f32():
                    # two Q slots (the second's mbarriers V stage 0's), one
                    # ring (the K stages) of the K tiles, then the V tile
                    fq, eq = [full_q, full_v[0]], [empty_q, empty_v[0]]
                    jr = jq = 0

                    def ring(tag):
                        nonlocal jr
                        s_ = jr & 1
                        yield from _wait(empty_k[s_], ((jr >> 1) & 1) ^ 1)
                        ktag[s_] = tag
                        full_k[s_].arrive()
                        jr += 1

                    for n_ in range(10 ** 9):
                        item = yield from draw(n_)
                        if item >= n_items:
                            i = jq & 1
                            yield from _wait(eq[i], ((jq >> 1) & 1) ^ 1)
                            item_s[i] = -1
                            fq[i].arrive()
                            break
                        taken.append((g, ci, r, item))
                        for t in range(n_kv(item)):
                            for jj in range(ns):
                                i = jq & 1
                                if fault != "q_early":
                                    yield from _wait(eq[i],
                                                     ((jq >> 1) & 1) ^ 1)
                                if t == 0 and jj == 0:
                                    item_s[i] = item
                                qtag[i] = (item, t, jj)
                                fq[i].arrive()
                                jq += 1
                                yield from ring((item, t, jj))
                            yield from ring((item, t, "v"))
                    yield from end.sync()

                def consumer_bf16(w):
                    def turn():
                        yield from turns[w].sync()
                        turns[(w + 1) % 2].arrive()

                    if w == 1:
                        turns[0].arrive()
                    j, x = 0, 0
                    for n_ in range(10 ** 9):
                        yield from _wait(full_q, n_ & 1)
                        item = item_s[0]
                        if item < 0:
                            break
                        qt = n_qt - 1 - item // BH
                        row0 = qt * bq + 64 * w
                        walks = row0 < S
                        last = min(S - 1, row0 + 63) // bk if walks else 0
                        nk = n_kv(item)

                        def sl(t):
                            return (j + t) % stages, ((j + t) // stages) & 1

                        s_, par = sl(0)
                        yield from _wait(full_k[s_], par)
                        yield from turn()
                        empty_k[s_].arrive()
                        if walks:
                            yield from exchange(r, w, x, (item, 0))
                            x += 1
                        else:
                            yield from _wait(full_v[s_], par)
                            empty_v[s_].arrive()
                        for t in range(1, last + 1):
                            s_, par = sl(t)
                            sv, pv = sl(t - 1)
                            yield from _wait(full_k[s_], par)
                            yield from _wait(full_v[sv], pv)
                            yield from turn()
                            empty_k[s_].arrive()
                            empty_v[sv].arrive()     # P V done, then the sums
                            yield from exchange(r, w, x, (item, t))
                            x += 1
                        if walks:
                            s_, par = sl(last)
                            yield from _wait(full_v[s_], par)
                            empty_v[s_].arrive()
                        for t in range(last + 1, nk):
                            s_, par = sl(t)
                            yield from _wait(full_k[s_], par)
                            empty_k[s_].arrive()
                            yield from turn()
                            yield from _wait(full_v[s_], par)
                            empty_v[s_].arrive()
                        empty_q.arrive()             # the epilogue's store read
                        j += nk
                    if w == 0:                       # the other's last hand-over
                        yield from turns[0].sync()
                    yield from end.sync()

                def consumer_walks_bf16(w):
                    def turn():
                        yield from turns[w].sync()
                        turns[(w + 1) % 2].arrive()

                    if w == 1:
                        turns[0].arrive()
                    nq = nk = nv = x = 0
                    for n_ in range(10 ** 9):
                        yield from _wait(full_q, nq & 1)
                        item = item_s[0]
                        if item < 0:
                            break
                        qt = n_qt - 1 - item // BH
                        row0 = qt * bq + 64 * w
                        walks = row0 < S
                        last = min(S - 1, row0 + 63) // bk if walks else 0
                        n_t = n_kv(item)

                        def s_turn(t, jj, wait_q, keep, read=True):
                            nonlocal nq, nk
                            if wait_q:
                                yield from _wait(full_q, nq & 1)
                            yield from _wait(full_k[0], nk & 1)
                            tag = (item, t, jj)
                            if read:
                                stale(qtag[0], tag)
                                stale(ktag[0], tag)
                            yield from turn()
                            if read:
                                stale(qtag[0], tag)
                                stale(ktag[0], tag)
                            empty_k[0].arrive()
                            nk += 1
                            if not keep:
                                empty_q.arrive()
                            nq += 1

                        for jj in range(ns):
                            yield from s_turn(0, jj, jj > 0,
                                              n_t == 1 and jj == ns - 1)
                        if walks:
                            yield from exchange(r, w, x, (item, 0))
                            x += 1
                        else:
                            yield from _wait(full_v[0], nv & 1)
                            empty_v[0].arrive()
                            nv += 1
                        for t in range(1, last + 1):
                            yield from _wait(full_v[0], nv & 1)  # P V of t - 1
                            for jj in range(ns):
                                yield from s_turn(t, jj, True,
                                                  t == n_t - 1
                                                  and jj == ns - 1)
                                if jj == 0:
                                    empty_v[0].arrive()
                                    nv += 1
                            yield from exchange(r, w, x, (item, t))
                            x += 1
                        if walks:
                            yield from _wait(full_v[0], nv & 1)
                            empty_v[0].arrive()
                            nv += 1
                        for t in range(last + 1, n_t):
                            for jj in range(ns):
                                yield from s_turn(t, jj, True,
                                                  t == n_t - 1
                                                  and jj == ns - 1, False)
                            yield from _wait(full_v[0], nv & 1)
                            empty_v[0].arrive()
                            nv += 1
                        if walks:                    # O staged, then stored
                            ohalf[w] = ("o", item)
                            yield
                            stale(ohalf[w], ("o", item))
                        empty_q.arrive()             # the epilogue's store read
                    if w == 0:                       # the other's last hand-over
                        yield from turns[0].sync()
                    yield from end.sync()

                def warps_f32(a):
                    j = 0
                    for n_ in range(10 ** 9):
                        yield from _wait(full_q, n_ & 1)
                        item = item_s[0]
                        if item < 0:
                            break
                        nk = n_kv(item)
                        for t in range(nk):
                            s_, par = j % stages, (j // stages) & 1
                            yield from _wait(full_k[s_], par)
                            empty_k[s_].arrive()
                            if t == nk - 1:
                                empty_q.arrive()
                            yield from exchange(r, a, j, (item, t))
                            yield from _wait(full_v[s_], par)
                            empty_v[s_].arrive()
                            j += 1
                    yield from end.sync()

                def warps_walks_f32(a):
                    fq, eq = [full_q, full_v[0]], [empty_q, empty_v[0]]
                    j = jr = jq = 0
                    for n_ in range(10 ** 9):
                        yield from _wait(fq[jq & 1], (jq >> 1) & 1)
                        item = item_s[jq & 1]
                        if item < 0:
                            break
                        for t in range(n_kv(item)):
                            for jj in range(ns):
                                i, sr = jq & 1, jr & 1
                                if t > 0 or jj > 0:
                                    yield from _wait(fq[i], (jq >> 1) & 1)
                                yield from _wait(full_k[sr], (jr >> 1) & 1)
                                tag = (item, t, jj)
                                stale(qtag[i], tag)
                                stale(ktag[sr], tag)
                                yield
                                stale(qtag[i], tag)
                                stale(ktag[sr], tag)
                                empty_k[sr].arrive()
                                eq[i].arrive()
                                jq += 1
                                jr += 1
                            yield from exchange(r, a, j, (item, t))
                            sv = jr & 1
                            yield from _wait(full_k[sv], (jr >> 1) & 1)
                            stale(ktag[sv], (item, t, "v"))
                            yield
                            stale(ktag[sv], (item, t, "v"))
                            empty_k[sv].arrive()
                            jr += 1
                            j += 1
                    yield from end.sync()

                if body == "bf16":
                    if G > 1:
                        return [producer_walks_bf16(), consumer_walks_bf16(0),
                                consumer_walks_bf16(1)]
                    return [producer(), consumer_bf16(0), consumer_bf16(1)]
                if G > 1:
                    return [producer_walks_f32(), warps_walks_f32(0),
                            warps_walks_f32(1)]
                return [producer(), warps_f32(0), warps_f32(1)]

            return [a for r in range(C) for a in block(r)]

        return [a for ci in range(clusters) for a in cluster(ci)]

    for g in range(G):                  # one launch a walk, on one counter
        _run(launch(g), rng, progress)
    return taken, ticket[0]


_SHAPES = [(1, 2, 64, 2, 1, 1, None), (1, 4, 257, 2, 2, 1, None),
           (2, 4, 200, 3, 3, 1, None), (1, 2, 1, 2, 4, 1, None),
           (1, 8, 300, 3, 2, 1, None), (2, 2, 129, 8, 2, 1, None),
           (1, 4, 400, 2, 3, 1, None), (1, 2, 200, 5, 2, 2, 9),
           (1, 4, 130, 6, 3, 3, 17), (1, 2, 64, 8, 1, 2, 16)]


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("B,H,S,C,clusters,G,n", _SHAPES)
def test_cluster_protocol_completes(rng, body, B, H, S, C, clusters, G, n):
    """The cluster forward's tickets, ring, turns, exchanges, the walks'
    slices and waits end under random interleavings: no block hangs, no
    reader sees another tile's partial or another load's Q or K, every
    item of every walk is taken by exactly one cluster and by each of its
    ranks (more clusters than items included; G = 2 over 9 slices, G = 3
    over 17, whose ranks have 1 to 3 slices), and the counter is back at
    zero after each walk's launch."""
    n_items = B * H * -(-S // TILES[body][0])
    clusters = min(clusters, n_items)
    for _ in range(2):
        taken, counter = _simulate(body, B, H, S, C, clusters, rng, G=G,
                                   n=n)
        by_item = {}
        for g, ci, r, item in taken:
            by_item.setdefault((g, item), []).append((ci, r))
        assert sorted(by_item) == [(g, i) for g in range(G)
                                   for i in range(n_items)]
        for item, who in by_item.items():
            assert len({ci for ci, _ in who}) == 1
            assert sorted(r for _, r in who) == list(range(C))
        assert counter == 0


def _fails(body, shape, rng, fault, tries=8, **walk):
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
    ("one_slot", {}), ("no_wait", {"G": 2, "n": 9}),
    ("one_buffer", {"G": 2, "n": 9}), ("own_tickets", {"G": 2, "n": 9}),
    ("q_early", {"G": 3, "n": 17})])
def test_cluster_protocol_fails_on_a_broken_wait(rng, body, fault, walk):
    """The simulation catches each broken step of the protocol, at one
    walk and in walks: a read before the other ranks' arrivals (a stale
    partial), one exchange buffer (a partial overwritten before a slower
    rank read it), blocks that draw their own tickets (ranks of a cluster
    on different items), one ticket slot (rank 0's next ticket over one a
    rank has not read: the forward's producer draws before its consumers
    end the item), and, in walks, a Q loaded before the one it replaces
    was read (float32: a stale Q where a rank's three slices outrun the
    ring; bfloat16: over the item's O staged in the slot)."""
    # one slot fails where rank 0 can draw twice before its consumers move:
    # items whose K and V tiles all fit the ring
    if walk:
        shape = (1, 4, 130, -(-walk["n"] // walk["G"]), 2)
    else:
        shape = (1, 4, 64, 2, 2) if fault == "one_slot" else (1, 4, 300, 2, 2)
    assert _fails(body, shape, rng, fault, **walk)


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("walk", [{}, {"G": 2, "n": 9}])
def test_cluster_protocol_wrong_reset_leaves_the_counter(rng, body, walk):
    """Reset at the blocks' count, the launch completes but leaves the
    counter past zero: the next launch on the stream (in walks, the next
    walk's) would start there and skip items."""
    C = 2 if not walk else 5
    n_items = 4 * -(-300 // TILES[body][0])
    taken, counter = _simulate(body, 1, 4, 300, C, 2, rng,
                               fault="wrong_reset", **walk)
    if not walk:
        assert counter == n_items + 2
    else:                               # the second walk started dirty
        second = sorted({i for g, _, _, i in taken if g == 1})
        assert counter != 0 and second != list(range(n_items))


# ---------------------------------------------------------------------------
# launch.fwd_ablate's presets and variants above D = 256
# ---------------------------------------------------------------------------


def test_ablate_d512_presets():
    """`--shape d512` and `d512_f32`: B 1, H 8, KV 2, S 2048, D 512, and
    `d2304` and `d2304_f32`: B 1, H 2, KV 1, S 2048, D 2304 (two walks),
    in bfloat16 and float32 operands; a shape above 256 runs base and the
    `cl_*` variants by default (`cl_one_slice`: the walks' S over each
    block's first slice alone, the cost of the recomputed S), and
    `--parent` takes every shape of one walk and refuses those above 2048
    (a parent before the walks runs widebody there)."""
    assert FWA.parse_shape("d512") == FWA.parse_shape("d512_f32") == (
        1, 8, 2, 2048, 512)
    assert FWA.parse_shape("d2304") == FWA.parse_shape("d2304_f32") == (
        1, 2, 1, 2048, 2304)
    assert {"d512_f32", "d2304_f32"} <= set(FWA.FLOAT32_PRESETS)
    assert not {"d512", "d2304"} & set(FWA.FLOAT32_PRESETS)
    assert [FWA.dtype_of(s) for s in ("d512", "d512_f32", "d2304",
                                      "d2304_f32")] == [
        "bfloat16", "float32", "bfloat16", "float32"]
    assert {"cl_no_xch", "cl_one_slice", "wide_one_stage"} <= \
        set(FWA.PATCHES)
    assert FWA.default_variants(["d512"]) == ["base", "cl_no_xch",
                                              "cl_one_slice"]
    assert FWA.default_variants(["yi", "wide"]) == list(FWA.PATCHES)
    one = FWA.variant_source("cl_one_slice")
    assert "  return 1;\n}" in _span("clusterbwd", one)
    for shape in ("yi", "wide", "wide_f32", "1,2,1,64,256", "d512",
                  "d512_f32", "1,2,1,64,2048"):
        assert FWA.parent_refusal(shape) is None
    for shape in ("d2304", "d2304_f32", "1,2,1,64,2056"):
        assert "D <= 2048" in FWA.parent_refusal(shape)
    for shape in ("d2304", "d2304_f32"):
        with pytest.raises(SystemExit, match="D <= 2048"):
            FWA.main(["--shape", shape, "--parent", "x.cu"])


def test_ablate_variants_of_the_cluster_forward():
    """`cl_no_xch` cuts the exchange and nothing else: its changes lie in
    namespace clusterbwd (the backward's variant of the same name) and the
    bfloat16 body's pair sum; `wide_one_stage` changes Fwd<256>'s ring
    depth alone (the D = 256 body then runs one stage, as its cluster
    instantiation does); the ptxas notes name the cluster bodies."""
    out = FWA.variant_source("cl_no_xch")
    src_lines = _SRC.splitlines()
    ops = difflib.SequenceMatcher(None, src_lines, out.splitlines(),
                                  autojunk=False).get_opcodes()
    changed = [x for tag, i1, i2, _, _ in ops if tag != "equal"
               for x in src_lines[i1:i2]]
    span = _span("clusterbwd")
    pair = "      if (C == 2) {                            // the pair's sum"
    assert changed and pair in changed
    for x in changed:
        assert x in span or x == pair, x
    assert ("      if (C == 0) {                            // the pair's "
            "sum") in out
    one = FWA.variant_source("wide_one_stage")
    diff = [(x, y) for x, y in zip(_SRC.splitlines(), one.splitlines())
            if x != y]
    assert diff == [("  static constexpr int STAGES = 2;           // K and "
                     "V tiles in the ring",
                     "  static constexpr int STAGES = 1;           // K and "
                     "V tiles in the ring")]
    assert _wide_const("STAGES", one) == 1
    log = ("ptxas info    : Function properties for _ZN_flash_fwd_bf16_"
           "kernel_d256ILb1EEv\n    0 bytes stack frame, 0 bytes spill "
           "stores, 0 bytes spill loads\nptxas info    : Used 168 registers\n"
           "ptxas info    : Function properties for _ZN_flash_fwd_f32_wide_"
           "kernelILb0EEv\n    0 bytes stack frame, 4 bytes spill stores, 4 "
           "bytes spill loads\nptxas info    : Used 168 registers\n")
    assert FWA.forward_notes(log) == [
        "<256> cluster spill 0+0 B, 168 regs",
        "f32<256> wide spill 4+4 B, 168 regs"]
