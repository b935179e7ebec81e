"""A CPU model of flash attention's float32 bodies at 128 < D <= 256
(``csrc/flash_attention.cu``: namespace `f32wide`, the forward's
`flash_fwd_f32_wide_kernel`, and namespace `f32widebwd`, the backward's
`flash_bwd_f32_wide_kernel`), and of the wrapper's float32 routes there.

The model follows the kernels, whose constants it reads from the source:

* forward: a work item is (batch x head, 64-row query tile), the last
  query tiles first and the heads of a tile in order; persistent blocks
  take items from one ticket counter, and the launch's last ticket puts
  it back to zero.  A producer thread loads the item's Q once and its
  32-key K and V tiles through a ring of two stages; eight compute warps
  own 8 rows each.  Per tile: S (each quarter of a dot over D in column
  order with fmaf, then (x0 + x1) + (x2 + x3)), masked and scaled, the
  online softmax (a row's sum over its 4 lanes' partial sums of 8 keys
  each, then xor shuffles), O rescaled and P V added key by key (fmaf);
  O / max(l, 1e-30) and lse = m + log(den) at the end;
* backward: f32bwd's walk, tickets, counters and sums at items of 32 keys
  and steps of 32 queries: S and dP (quarters of the dots over D in
  column order, then (x0 + x1) + (x2 + x3)), P =
  exp(S D^-0.5 - lse), dS = P (dP - Delta), the step's P^T dO and dS^T Q
  summed over its 32 queries in order and added to the item's dv and dk,
  dq's share dS K over the item's 32 keys in order, added to a float32
  accumulator per (batch x head, query tile) in key-tile order, the
  diagonal tile adding the sum to its own share and scaling it into dq.

Tolerances: the emulated arithmetic within 1e-5 x max|grad| of
`flash_attention_bwd_plain` and of jax.vjp of the reference (float32, as
`test_torch_flash_bwd_f32.py` holds f32bwd); the forward within the
suite's float32 tolerance (2e-5) of the plain version and of the
reference's Pallas kernel in interpret mode, lse within 1e-5."""
import math
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JRef
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import bwd_ablate as BA
from repro_torch.launch import fwd_ablate as FWA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
F32 = np.float32
NEG = F32(-1e30)


def _span(ns, src=_SRC):
    return src[src.index(f"namespace {ns} {{"):
               src.index(f"}}  // namespace {ns}")]


def _const(name, ns, src=_SRC):
    """An int constant of namespace `ns` in `src`: its expression as
    written (C++ integer arithmetic), its names the namespace's other
    constants."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", _span(ns, src))[1]
    names = {n: _const(n, ns, src)
             for n in set(re.findall(r"\b[A-Z][A-Z_0-9]*\b", expr))}
    return int(eval(expr.replace("/", "//"), {"__builtins__": {}}, names))


FWD = {n: _const(n, "f32wide") for n in (
    "D", "BQ", "BK", "STAGES", "WARPS", "THREADS", "PRODUCER_REGS",
    "CONSUMER_REGS", "PT", "PARTS")}
BWD = {n: _const(n, "f32widebwd") for n in (
    "D", "KT", "QT", "CONSUMERS", "NTHREADS", "PRODUCER_REGS",
    "CONSUMER_REGS", "PS", "TS", "PARTS", "UC", "CG", "KJ", "DCG", "QI")}
KT, QT = BWD["KT"], BWD["QT"]


def tile_at(r, u, rows):
    """`f32bwd::Tile<256, rows>::at`: the byte offset of 16-byte unit u
    (columns 4 u .. 4 u + 3) of row r in a tile TMA lands with the 128 B
    swizzle, 32-float chunks of `rows` rows."""
    off = r * 128 + (u % 8) * 16
    return (u // 8) * rows * 128 + (off ^ (((off >> 7) & 7) << 4))


def _tile_bytes(rows):
    return rows * 256 * 4


def fwd_smem():
    """`f32wide::SMEM`: Q, STAGES K and V tiles, the P^T tile, the rows'
    rescale factors and sums, the item, the mbarriers (Q full / empty,
    per stage K and V full / empty), room to align the base."""
    F = FWD
    return (_tile_bytes(F["BQ"]) + 2 * F["STAGES"] * _tile_bytes(F["BK"])
            + F["BK"] * F["PT"] * 4 + 2 * F["BQ"] * 4 + 16
            + 8 * (2 + 4 * F["STAGES"]) + 1024)


def bwd_smem():
    """`f32widebwd::SMEM`: K, V, Q and dO tiles, P and dS tiles, the dS^T
    tile, dq's share, lse and Delta, the item, six mbarriers, alignment."""
    return (4 * _tile_bytes(KT) + 2 * QT * BWD["PS"] * 4 + KT * BWD["TS"] * 4
            + QT * 256 * 4 + 2 * QT * 4 + 16 + 8 * 6 + 1024)


# ---------------------------------------------------------------------------
# constants, shared memory, registers
# ---------------------------------------------------------------------------


def test_constants_match_the_wrapper():
    """The source's tiles are the wrapper's; both layouts fit a block's
    232,448 bytes of shared memory at D = 256, as the header comments
    count them; the backward's register split fits the launch; each
    thread of a product owns its share of every output once."""
    assert (FWD["D"], FWD["BQ"], FWD["BK"], FWD["STAGES"]) == (256, 64, 32, 2)
    assert FWD["THREADS"] == 32 * FWD["WARPS"] + 128 and FWD["WARPS"] == 8
    assert FWD["BQ"] == 8 * FWD["WARPS"]
    assert FA.TILES[torch.float32][256] == (FWD["BQ"], FWD["BK"])
    assert FA.HEAD_DIMS[torch.float32][-1] == 256
    assert (BWD["D"], KT, QT, BWD["CONSUMERS"], BWD["NTHREADS"]) == (
        256, 32, 32, 256, 384)
    assert FA.BWD_F32_WIDE_TILES == (KT, QT)
    assert FA.BWD_F32_HEAD_DIMS[-1] == 256
    assert fwd_smem() == 207_456 <= 232_448
    assert bwd_smem() == 179_008 <= 232_448
    assert "207,456" in _SRC[:_SRC.index("#include")]
    assert "207,456" in _span("f32wide")
    assert "179,008" in _span("f32widebwd")
    for ns in ("f32wide", "f32widebwd"):
        assert "static_assert(SMEM <= 232448" in _span(ns)
    assert ("constexpr size_t SMEM = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;"
            in _span("f32wide"))
    assert "constexpr size_t SMEM = BAR_OFF + 8 * 6 + 1024;" in \
        _span("f32widebwd")
    for regs, n in ((BWD, BWD["NTHREADS"]), (FWD, FWD["THREADS"])):
        assert regs["PRODUCER_REGS"] * 128 + regs["CONSUMER_REGS"] * 256 \
            <= 65536 // n // 8 * 8 * n
    # dv / dk: 8 keys x 8 columns a thread, 64 floats as f32bwd at D = 128
    assert BWD["KJ"] * 4 * BWD["UC"] == 64
    assert BWD["KJ"] * 4 * BWD["UC"] * 128 == KT * 256
    assert BWD["QI"] * 4 * BWD["CONSUMERS"] == QT * 256
    # the forward's O: 8 rows x 8 columns a thread; S and dP split D into
    # PARTS quarters of 16 units, 4 x 8 partial dots a thread
    assert 8 * 8 * 32 * FWD["WARPS"] == FWD["BQ"] * 256
    assert FWD["PARTS"] == BWD["PARTS"] == 4
    assert 4 * 8 * 32 * 4 == BWD["QT"] * BWD["KT"] * BWD["PARTS"]
    # the tiles' swizzle, as the source computes it
    tile = _span("f32bwd")
    assert "static constexpr uint32_t CHUNK = R * ROW;" in tile
    assert ("return (u / UPR) * CHUNK + (off ^ (((off >> 7) & (UPR - 1)) "
            "<< 4));") in tile


def _waves(addrs, width):
    """Shared-memory wavefronts of one warp's access, lane i reading or
    writing `width` bytes at addrs[i]: the most distinct 4-byte words any
    of the 32 banks serves; and the fewest any access of as many distinct
    words could take."""
    words = {a // 4 + w for a in addrs for w in range(width // 4)}
    per_bank = Counter(wd % 32 for wd in words)
    return max(per_bank.values()), math.ceil(len(words) / 32)


def _conflict_free(addrs, width):
    """Whether the banks add no cycle to a warp's access: a 16-byte load
    or store moves 512 bytes, 4 cycles at 128 bytes a cycle, so up to 4
    distinct words on a bank cost nothing more (a broadcast to 8 lanes
    each from 4 rows of one bank is as fast as 32 distinct units); a
    4-byte access needs the fewest wavefronts its distinct words allow."""
    got, least = _waves(addrs, width)
    return got <= max(least, width // 4)


def test_forward_shared_accesses_are_conflict_free():
    """Every shared access of the forward's compute warps, lane by lane as
    the source indexes them: the S product's Q and K units, the P^T
    stores (32 banks), the rescale factors, the P^T rows and V units of P
    V, each in the fewest wavefronts its distinct words allow."""
    body = _span("f32wide")
    for stmt in ("const int pq = lane / 8, kq = lane % 4;",
                 "const int r4 = 8 * warp + 4 * (lane / 4 % 2);",
                 "const int ro = r4 + 2 * (pq & 1) + (pq >> 1);",
                 "const int u = D / 4 / PARTS * pq + tt;",
                 "qf[r] = lds4(gb, Q_OFF + TQ::at(r4 + r, u));",
                 "lds4(gb, ks + TK::at(kq + 4 * c, u));",
                 "pt[(kq + 4 * c) * PT + ro] = p;",
                 "if (kq == 0) alpha_s[ro] = alpha;",
                 "lds<8>(al, alpha_s + 8 * warp);",
                 "lds<8>(pr, pt + key * PT + 8 * warp);",
                 "lds4(gb, vs + TK::at(key, lane + 32 * uu));"):
        assert stmt in body, stmt
    PT, BK, BQ = FWD["PT"], FWD["BK"], FWD["BQ"]
    assert PT % 32 == 8 and PT % 4 == 0 and PT >= BQ
    lane = np.arange(32)
    pq, kq = lane // 8, lane % 4
    for warp in range(FWD["WARPS"]):
        r4 = 8 * warp + 4 * (lane // 4 % 2)
        ro = r4 + 2 * (pq & 1) + (pq >> 1)
        assert sorted(set(ro)) == list(range(8 * warp, 8 * warp + 8))
        for tt in range(16):
            u = 16 * pq + tt
            for r in range(4):
                assert _conflict_free(tile_at(r4 + r, u, BQ), 16)
            for c in range(8):
                assert _conflict_free(tile_at(kq + 4 * c, u, BK), 16)
        for c in range(8):
            addr = 4 * ((kq + 4 * c) * PT + ro)
            assert len(set(addr)) == 32 and _conflict_free(addr, 4)
        for key in range(BK):
            assert _conflict_free(np.full(32, 4 * (key * PT + 8 * warp)), 16)
            for uu in range(2):
                assert _conflict_free(tile_at(key, lane + 32 * uu, BK), 16)
    # the S lanes cover each (row, key, quarter) of the tile once
    seen = Counter((int(r4[i] + r), int(kq[i] + 4 * c), int(pq[i]))
                   for i in range(32) for r in range(4) for c in range(8))
    assert len(seen) == 8 * 32 * 4 and set(seen.values()) == {1}


def test_backward_shared_accesses_are_conflict_free():
    """The backward's shared accesses as the source indexes them: S and
    dP's units, the P and dS stores (16 bytes a lane) and dS^T stores (32
    banks), dv and dk's P / dS rows and Q / dO units, dq's dS^T rows and K
    units, the share's stores."""
    body = _span("f32widebwd")
    for stmt in ("const int pq = lane / 8, rg = lane % 8, k8 = 8 * warp;",
                 "const int qo = rg + 8 * (2 * (pq & 1) + (pq >> 1));",
                 "const int cg = g % CG, jg = g / CG;",
                 "const int cu = tid % DCG, iq = tid / DCG * QI;",
                 "const int u = D / 4 / PARTS * pq + t;",
                 "qf[r] = lds4(gb, ta + T::at(rg + 8 * r, u));",
                 "const float4 kf = lds4(gb, tb + T::at(k8 + c, u));",
                 "reinterpret_cast<float4*>(ps + qo * PS + k8);",
                 "reinterpret_cast<float4*>(dss + qo * PS + k8);",
                 "lds<8>(pr, ps + qo * PS + k8);",
                 "dst[(k8 + c) * TS + qo] = z[c];",
                 "lds<KJ>(a, pa + i * PS + KJ * jg);",
                 "lds4(gb, tc + T::at(i, cg + CG * uu));",
                 "lds<QI>(a, dst + j * TS + iq);",
                 "lds4(gb, K_OFF + T::at(j, cu));",
                 "st_shared(base + SH_OFF + (r * 4 * U + so) * 16, dqa[r][0],",
                 "const int so = CL ? tid / DCG * U + cu : tid;",
                 "const int U = CL ? (WALKS ? max(0, min(DCG, (width + 3) / 4))",
                 "                            : min(DCG, (width + 3) / 4))"):
        assert stmt in body, stmt
    PS, TS, CG, KJ, DCG, QI = (BWD[n] for n in ("PS", "TS", "CG", "KJ",
                                                "DCG", "QI"))
    assert PS % 4 == TS % 4 == 0 and (PS // 4) % 2 == 1
    lane = np.arange(32)
    pq, rg = lane // 8, lane % 8
    qo = rg + 8 * (2 * (pq & 1) + (pq >> 1))
    assert sorted(qo) == list(range(32))
    for warp in range(4):                       # a group's four warps
        k8 = 8 * warp
        for t in range(16):
            u = 16 * pq + t
            for r in range(4):
                assert _conflict_free(tile_at(rg + 8 * r, u, QT), 16)
            for c in range(8):
                assert _conflict_free(tile_at(np.full(32, k8 + c), u, KT),
                                      16)
        for half in range(2):
            assert _conflict_free(4 * (qo * PS + k8) + 16 * half, 16)
        for c in range(8):
            assert _conflict_free(4 * ((k8 + c) * TS + qo), 4)
        g = 32 * warp + lane
        cg, jg = g % CG, g // CG
        for i in range(QT):
            for half in range(KJ // 4):
                assert _conflict_free(4 * (i * PS + KJ * jg) + 16 * half, 16)
            for uu in range(BWD["UC"]):
                assert _conflict_free(tile_at(i, cg + CG * uu, QT), 16)
    for warp in range(8):                       # dq: all 256 threads
        tid = 32 * warp + lane
        cu, iq = tid % DCG, tid // DCG * QI
        for j in range(KT):
            for half in range(QI // 4):
                assert _conflict_free(4 * (j * TS + iq) + 16 * half, 16)
            assert _conflict_free(tile_at(j, cu, KT), 16)
        # the share's units: U = DCG (r * 256 + tid), or a cluster body's
        # narrower last slice, whose units past its width stay out
        for U in (DCG, 2, 16, 33):
            on = cu < U
            for r in range(QI):
                if on.any():
                    assert _conflict_free(
                        16 * ((r * 4 + tid // DCG) * U + cu)[on], 16)


# ---------------------------------------------------------------------------
# the wrapper's float32 routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,fwd,bwd", [
    (129, ("padded", 256), ("padded", 256)),
    (160, ("in place", 256), ("in place", 256)),
    (192, ("in place", 256), ("in place", 256)),
    (200, ("in place", 256), ("in place", 256)),
    (255, ("padded", 256), ("padded", 256)),
    (256, ("in place", 256), ("in place", 256)),
    (257, ("cluster", 260), ("cluster", 260)),
    (512, ("cluster", 512), ("cluster", 512))])
def test_float32_routes_above_128(D, fwd, bwd):
    """float32 at 128 < D <= 256 runs the D = 256 bodies: in place when a
    row is whole 16-byte units (D % 4 == 0; TMA zero-fills the columns
    past D), else zero-padded to 256; above 256 the cluster forward and
    the cluster backward (f32wide and f32widebwd on each 256-column
    slice; 257 zero-padded to 260, the next whole 16-byte row).  The
    TMA-fed bodies need 16-byte starts and strides."""
    assert FA._forward_route(torch.float32, D) == fwd
    assert FA._backward_route(torch.float32, D) == bwd
    q = torch.zeros((1, 1, 1, D))
    assert FA._fwd_align(q, *fwd) == 16
    assert FA._bwd_align(q, *bwd) == 16
    # the launchers take the same widths
    assert "const bool f32w = !is_bf16 && D > 128 && D <= 256 && D % 4 == 0;" \
        in _SRC
    assert "(width != D && (!tma || width % (is_bf16 ? 8 : 4))))" in _SRC


@pytest.mark.parametrize("D", [160, 256])
def test_float32_wide_plain_matches_reference(rng, D):
    """The wrapper on CPU tensors at the new bodies' head dims: the plain
    forward and its backward, as the reference computes them."""
    B, H, KV, S = 1, 4, 2, 40
    arrs = [rng.normal(size=(B, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]
    q, k, v, do = (torch.as_tensor(a) for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    np.testing.assert_allclose(o.numpy(), np.asarray(JRef.flash_attention_ref(
        *(jnp.asarray(a) for a in arrs[:3]))), atol=2e-5, rtol=2e-5)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do)
    for g, w in zip(got, _jax_grads(arrs)):
        assert _max_rel(g, w) <= 1e-5


# ---------------------------------------------------------------------------
# the forward's work list, tickets and arithmetic
# ---------------------------------------------------------------------------


def quarter_dots(A, Bm):
    """A Bm^T as f32wide's S and f32widebwd's S and dP take it over 256
    columns: each quarter of a dot (64 columns) summed in column order
    with fmaf, then (x0 + x1) + (x2 + x3)."""
    x = []
    for p in range(4):
        acc = np.zeros((A.shape[0], Bm.shape[0]), F32)
        for d in range(64 * p, 64 * p + 64):
            acc = _fma(A[:, d, None], Bm[None, :, d], acc)
        x.append(acc)
    return (x[0] + x[1]) + (x[2] + x[3])


def fwd_work_list(B, H, S):
    """`work_item` over the schedule's items: (bh, query tile) in list
    order, the last query tiles first, a tile's heads in order."""
    n_qt = -(-S // FWD["BQ"])
    return [(i % (B * H), n_qt - 1 - i // (B * H))
            for i in range(B * H * n_qt)]


@pytest.mark.parametrize("B,H,KV,S", [(4, 8, 2, 2048), (1, 2, 1, 1),
                                      (2, 4, 4, 100), (1, 16, 4, 1000)])
def test_forward_work_list(B, H, KV, S):
    """Every (batch x head, 64-row query tile) is one item; the list
    holds the most key tiles first; a GQA group's heads sit side by side
    (they read their KV head's tiles from L2)."""
    body = _span("f32wide")
    assert "work_item(item, B, H, n_qt, b, h, qt);" in body
    assert "*items = B * H * ((S + BQ - 1) / BQ);" in body
    assert "const int n_kv = (min(S, q0 + BQ) + BK - 1) / BK;" in body
    items = fwd_work_list(B, H, S)
    n_qt = -(-S // FWD["BQ"])
    assert sorted(items) == [(bh, qt) for bh in range(B * H)
                             for qt in range(n_qt)]
    n_kv = [-(-min(S, qt * 64 + 64) // 32) for _, qt in items]
    assert n_kv == sorted(n_kv, reverse=True)
    G = H // KV
    for i in range(0, len(items), G):
        heads = [bh for bh, _ in items[i:i + G]]
        assert heads == list(range(heads[0], heads[0] + G))
        assert len({bh // G for bh in heads}) == 1


def emulate_fwd(q, k, v):
    """(o, lse) as f32wide computes them from float32 q (B, H, S, D), k,
    v (B, KV, S, D): the operands zero-filled to 256 columns (in place,
    TMA's zero fill; or the padded route's copies) and to whole tiles,
    each item's key tiles in order and each sum in the kernel's order."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    BQ, BK = FWD["BQ"], FWD["BK"]
    G, n_qt = H // KV, -(-S // BQ)
    Sp = n_qt * BQ

    def fill(x):
        return np.pad(np.asarray(x, F32),
                      [(0, 0), (0, 0), (0, Sp - S), (0, 256 - D)])

    qn, kn, vn = fill(q), fill(k), fill(v)
    scale = F32(D ** -0.5)
    o = np.zeros((B, H, Sp, 256), F32)
    lse = np.zeros((B, H, Sp), F32)
    lanes = np.arange(4)
    for b in range(B):
        for h in range(H):
            for qt in range(n_qt):
                q0 = qt * BQ
                Q = qn[b, h, q0:q0 + BQ]
                m = np.full(BQ, NEG, F32)
                l = np.zeros(BQ, F32)
                acc = np.zeros((BQ, 256), F32)
                rows = np.arange(q0, q0 + BQ)[:, None]
                for t in range(-(-min(S, q0 + BQ) // BK)):
                    k0 = t * BK
                    K = kn[b, h // G, k0:k0 + BK]
                    V = vn[b, h // G, k0:k0 + BK]
                    s = quarter_dots(Q, K)
                    keys = np.arange(k0, k0 + BK)[None, :]
                    x = np.where((keys <= rows) & (keys < S),
                                 (s * scale).astype(F32), NEG)
                    m_new = np.maximum(m, x.max(1))
                    with np.errstate(under="ignore"):
                        alpha = np.exp(m - m_new).astype(F32)
                        p = np.exp(x - m_new[:, None]).astype(F32)
                    # lane kq sums keys kq, kq + 4, ..., kq + 28, then
                    # the row's 4 lanes' sums by xor shuffles
                    part = np.zeros((BQ, 4), F32)
                    for c in range(8):
                        part = part + p[:, lanes + 4 * c]
                    for off in (1, 2):
                        part = part + part[:, lanes ^ off]
                    l = (l * alpha + part[:, 0]).astype(F32)
                    acc = acc * alpha[:, None]
                    for j in range(BK):          # the tile's keys in order
                        acc = _fma(p[:, j, None], V[None, j, :], acc)
                    m = m_new
                den = np.maximum(l, F32(1e-30))
                o[b, h, q0:q0 + BQ] = acc / den[:, None]
                lse[b, h, q0:q0 + BQ] = m + np.log(den)
    return o[:, :, :S, :D], lse[:, :, :S]


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("S", [40, 96])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
def test_forward_arithmetic_within_tolerance(rng, H, KV, S, D):
    """The emulated forward against `flash_attention_plain` and the
    reference's Pallas kernel in interpret mode (its blocks dividing S)
    at the float32 tolerance (2e-5), lse within 1e-5 of the plain
    version's; GQA and MQA, S ragged against the 64-row items (and at 40
    against the 32-key tiles), D = 160 read in place."""
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV)]
    o, lse = emulate_fwd(*arrs)
    po, plse = FA.flash_attention_plain(*(torch.as_tensor(a) for a in arrs),
                                        return_lse=True)
    np.testing.assert_allclose(o, po.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse, plse.numpy(), atol=1e-5, rtol=1e-5)
    blk = math.gcd(S, 32)
    jo = JO.flash_attention(*(jnp.asarray(a) for a in arrs), bq=blk,
                            bk=blk)
    np.testing.assert_allclose(o, np.asarray(jo), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the forward's barrier protocol and tickets
# ---------------------------------------------------------------------------


class _Mbar:
    """An mbarrier: a phase completes when `count` arrivals are in (a
    group of threads counts as one, TMA bytes as one); a wait on parity P
    passes once the phase of that parity has completed.  Arrivals count
    in `progress`, so that a hang is a run of steps with none."""

    def __init__(self, count, progress):
        self.count, self.pending, self.phases = count, 0, 0
        self.progress = progress

    def arrive(self):
        self.progress[0] += 1
        self.pending += 1
        assert self.pending <= self.count, "more arrivals than the phase"
        if self.pending == self.count:
            self.phases, self.pending = self.phases + 1, 0

    def done(self, parity):
        return (self.phases & 1) != parity


def _wait(bar, parity):
    while not bar.done(parity):
        yield


def _run(agents, rng, progress):
    """Step the agents (generators) in a random order until all end; a
    long run of steps with no arrival and no agent ending is a hang."""
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


# what the forward's simulation models, as the source spells it
_FWD_PROTOCOL = [
    "mbar_init(full_q, 1);", "mbar_init(empty_q, 32 * WARPS);",
    "mbar_init(full_k + 8 * s, 1);", "mbar_init(full_v + 8 * s, 1);",
    "mbar_init(empty_k + 8 * s, 32 * WARPS);",
    "mbar_init(empty_v + 8 * s, 32 * WARPS);",
    ": atomicAdd(work, 1);",
    "if (item == n_items + (int)gridDim.x - 1) atomicExch(work, 0);",
    "mbar_wait(empty_q, (n & 1) ^ 1);", "*item_s = -1;",
    "const uint32_t parity = ((j / STAGES) & 1) ^ 1;",
    "mbar_wait(empty_k + 8 * s, parity);",
    "mbar_wait(empty_v + 8 * s, parity);",
    "const int pre = min(n_kv, STAGES);",
    "for (int t = 0; t < pre; ++t) kv_load(t);",
    "for (int t = pre; t < n_kv; ++t) kv_load(t);",
    "mbar_wait(full_q, n & 1);", "if (item < 0) break;",
    "const uint32_t parity = (j / STAGES) & 1;",
    "mbar_wait(full_k + 8 * s, parity);",
    "mbar_arrive(empty_k + 8 * s);            // K read",
    "if (t == n_kv - 1) mbar_arrive(empty_q);   // Q read",
    ": full_v + 8 * s;", ": empty_v + 8 * s;",
    "const uint32_t vpar = WALKS ? (jv >> 1) & 1 : parity;",
    "mbar_wait(full_vt, vpar);",
    "mbar_arrive(empty_vt);                   // V read"]


def _simulate_fwd(B, H, S, blocks, rng, *, stages=2, fault=None):
    """`flash_fwd_f32_wide_kernel`'s waits and arrivals per block (the
    producer thread, and the eight compute warps as two agents of four),
    blocks sharing the ticket counter, under a random scheduler.
    `fault`: "no_q_release", the warps never release Q; "v_parity", the
    producer waits on a V slot's phase still to come; "no_end", the
    producer leaves without telling the warps.  Returns (the items each
    block took, the counter after the launch)."""
    n_qt = -(-S // FWD["BQ"])
    n_items = B * H * n_qt
    ticket, taken, progress = [0], [], [0]

    def n_kv(item):
        qt = n_qt - 1 - item // (B * H)
        return -(-min(S, qt * FWD["BQ"] + FWD["BQ"]) // FWD["BK"])

    def block(bi):
        full_q, empty_q = _Mbar(1, progress), _Mbar(2, progress)
        full_k = [_Mbar(1, progress) for _ in range(stages)]
        full_v = [_Mbar(1, progress) for _ in range(stages)]
        empty_k = [_Mbar(2, progress) for _ in range(stages)]
        empty_v = [_Mbar(2, progress) for _ in range(stages)]
        item_s = [None]

        def producer():
            j = 0
            for n in range(10 ** 9):
                item = ticket[0]
                ticket[0] += 1
                if item >= n_items:
                    if item == n_items + blocks - 1:
                        ticket[0] = 0
                    yield from _wait(empty_q, (n & 1) ^ 1)
                    if fault != "no_end":
                        item_s[0] = -1
                        full_q.arrive()
                    return
                taken.append((bi, item))

                def kv_load():
                    nonlocal j
                    s = j % stages
                    par = ((j // stages) & 1) ^ 1
                    yield from _wait(empty_k[s], par)
                    full_k[s].arrive()
                    vpar = par ^ 1 if fault == "v_parity" else par
                    yield from _wait(empty_v[s], vpar)
                    full_v[s].arrive()
                    j += 1

                pre = min(n_kv(item), stages)
                for _ in range(pre):
                    yield from kv_load()
                yield from _wait(empty_q, (n & 1) ^ 1)
                item_s[0] = item
                full_q.arrive()
                for _ in range(pre, n_kv(item)):
                    yield from kv_load()

        def warps():
            j = 0
            for n in range(10 ** 9):
                yield from _wait(full_q, n & 1)
                item = item_s[0]
                if item < 0:
                    return
                last = n_kv(item) - 1
                for t in range(last + 1):
                    s, par = j % stages, (j // stages) & 1
                    yield from _wait(full_k[s], par)
                    empty_k[s].arrive()
                    if t == last and fault != "no_q_release":
                        empty_q.arrive()
                    yield from _wait(full_v[s], par)
                    empty_v[s].arrive()
                    j += 1

        return [producer(), warps(), warps()]

    _run([a for bi in range(blocks) for a in block(bi)], rng, progress)
    return taken, ticket[0]


def test_forward_protocol_is_the_sources():
    """Every wait and arrival the forward's simulation models is in the
    body, and the one-stage ablation differs in the ring's depth alone."""
    body = _span("f32wide")
    for stmt in _FWD_PROTOCOL:
        assert stmt in body, stmt
    one = FWA.variant_source("f32w_one_stage")
    assert _const("STAGES", "f32wide", one) == 1
    assert _span("f32wide", one).replace(
        "constexpr int STAGES = 1;", "constexpr int STAGES = 2;") == body


@pytest.mark.parametrize("stages", [2, 1])
@pytest.mark.parametrize("B,H,S,blocks", [
    (1, 2, 64, 1), (1, 4, 257, 2), (2, 4, 200, 3), (1, 2, 1, 4),
    (1, 8, 300, 5), (2, 2, 129, 8)])
def test_forward_protocol_completes(rng, B, H, S, blocks, stages):
    """The forward's waits and arrivals end under random interleavings,
    with the kernel's ring and the one-stage variant's: every item taken
    once, more blocks than items included, and the counter left zero."""
    for _ in range(3):
        taken, counter = _simulate_fwd(B, H, S, blocks, rng, stages=stages)
        assert sorted(i for _, i in taken) == list(
            range(B * H * -(-S // 64)))
        assert counter == 0


@pytest.mark.parametrize("fault", ["no_q_release", "v_parity", "no_end"])
@pytest.mark.parametrize("B,H,S,blocks", [(1, 2, 200, 2), (1, 4, 300, 3)])
def test_forward_protocol_hangs_on_a_broken_wait(rng, B, H, S, blocks,
                                                 fault):
    """The simulation sees a wait that can never be met: Q never
    released, a V slot awaited one phase late, or the warps never told
    that the list has ended."""
    with pytest.raises(AssertionError, match="hangs"):
        _simulate_fwd(B, H, S, blocks, rng, fault=fault)


# ---------------------------------------------------------------------------
# the backward's work list and dq's add order
# ---------------------------------------------------------------------------


def _steps(item, B, H, KV, S):
    """The backward's walk of one item: its (batch x head, query tile)
    steps in order."""
    BKV, G, nQ = B * KV, H // KV, -(-S // QT)
    kt, bkv = divmod(item, BKV)
    b, kvh = divmod(bkv, KV)
    return [(b * H + kvh * G + s % G, nQ - 1 - s // G)
            for s in range(G * (nQ - kt))]


def _simulate_adds(B, H, KV, S, blocks):
    """The work list on `blocks` persistent blocks, one step a tick, items
    handed out in list order as blocks free up; a step of key tile kt
    waits until its tile's counter reads kt.  Returns (adds per (bh, qi)
    in order, steps that waited a tick, and whether every wait pointed at
    an item already handed out)."""
    BKV = B * KV
    n_items = BKV * -(-S // KT)
    nxt, count, adds = 0, {}, {}
    cur = [None] * blocks
    waited, earlier = 0, True
    while True:
        for i in range(blocks):
            if cur[i] is None and nxt < n_items:
                cur[i] = (nxt, _steps(nxt, B, H, KV, S), 0)
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
            if count.get((bh, qi), 0) < kt:
                waited += 1
                earlier = earlier and 0 <= item - BKV < nxt
                continue
            count[(bh, qi)] = count.get((bh, qi), 0) + 1
            adds.setdefault((bh, qi), []).append(kt)
            moved = True
            cur[i] = None if pos + 1 == len(steps) else (item, steps, pos + 1)
        assert moved, "no block could move: a wait that never ends"


@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (4, 8, 2, 2048, 132),        # the wide shape on 132 SMs
    (1, 4, 4, 1, 132), (1, 8, 1, 257, 3), (2, 8, 2, 100, 132),
    (1, 4, 2, 700, 1), (3, 6, 3, 513, 7)])
def test_backward_work_list_and_dq_add_order(B, H, KV, S, blocks):
    """Every (batch x head, 32-query tile) receives each key tile that
    has a causal pair with it exactly once, in ascending order, the
    diagonal last; every wait points at an item earlier in the list; no
    wait lasts for ever; at the wide shape the steps that wait are under
    2 % of all steps."""
    body = _span("f32widebwd")
    assert "const int n_items = BKV * nQ;" in body
    assert "const int bkv = item % BKV, kt = item / BKV;" in body
    assert "const int qi = nQ - 1 - s / G, q0 = qi * QT;" in body
    assert "*items = B * KV * ((S + KT - 1) / KT);" in body
    adds, waited, earlier = _simulate_adds(B, H, KV, S, blocks)
    nQ = -(-S // QT)
    assert sorted(adds) == [(bh, qi) for bh in range(B * H)
                            for qi in range(nQ)]
    for (bh, qi), kts in adds.items():
        assert kts == list(range(qi + 1)), ((bh, qi), kts)
    assert earlier
    n_steps = sum(len(v) for v in adds.values())
    assert n_steps == B * H * nQ * (nQ + 1) // 2
    if blocks == 132 and S == 2048:
        assert waited < 0.02 * n_steps, (waited, n_steps)


# ---------------------------------------------------------------------------
# the backward's arithmetic
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fmaf, elementwise: the product exact in float64, one rounding of
    the sum to float64 and one to float32 (a double rounding that can
    differ from the card's in the last bit, rarely)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _delta(o, do):
    """The Delta pass: lane l of a row's warp sums columns l, l + 32, ...
    in order with fmaf, then x += shfl_xor(x, off) for off = 16 .. 1."""
    lanes = np.zeros(o.shape[:-1] + (32,), F32)
    for c in range(o.shape[-1]):
        lanes[..., c % 32] = _fma(o[..., c], do[..., c], lanes[..., c % 32])
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    return lanes[..., 0]


def emulate_bwd(q, k, v, o, lse, do):
    """dq, dk, dv as f32widebwd computes them from float32 q, k, v, o, dO
    (B, H|KV, S, D) and lse: Delta at the real width, the operands
    zero-filled to 256 columns and to whole 32-row tiles, each item's
    steps in the kernel's order and each sum in the kernel's order."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G, nQ = H // KV, -(-S // QT)
    Sp = nQ * QT
    delta = np.pad(_delta(o.numpy().astype(F32), do.numpy().astype(F32)),
                   [(0, 0), (0, 0), (0, Sp - S)])

    def fill(x):
        return np.pad(x.numpy().astype(F32),
                      [(0, 0), (0, 0), (0, Sp - S), (0, 256 - D)])

    qn, kn, vn, don = (fill(x) for x in (q, k, v, do))
    ls = np.pad(lse.numpy().astype(F32), [(0, 0), (0, 0), (0, Sp - S)])
    scale = F32(D ** -0.5)
    acc = {}
    dq = np.zeros((B, H, Sp, 256), F32)
    dk = np.zeros((B, KV, Sp, 256), F32)
    dv = np.zeros_like(dk)
    BKV = B * KV
    for item in range(BKV * nQ):
        kt, bkv = divmod(item, BKV)
        b, kvh = divmod(bkv, KV)
        k0 = kt * KT
        K, V = kn[b, kvh, k0:k0 + KT], vn[b, kvh, k0:k0 + KT]
        acc_v = np.zeros((KT, 256), F32)
        acc_k = np.zeros_like(acc_v)
        for bh, qi in _steps(item, B, H, KV, S):
            h, q0 = bh % H, qi * QT
            Q, dO = qn[b, h, q0:q0 + QT], don[b, h, q0:q0 + QT]
            s, dp = quarter_dots(Q, K), quarter_dots(dO, V)
            rows = np.arange(q0, q0 + QT)[:, None]
            keys = np.arange(k0, k0 + KT)[None, :]
            with np.errstate(over="ignore"):
                e = np.exp(_fma(s, scale, -ls[b, h, q0:q0 + QT, None]))
            p = np.where((keys <= rows) & (rows < S), e, F32(0)).astype(F32)
            ds = p * (dp - delta[b, h, q0:q0 + QT, None])
            step_v = np.zeros((KT, 256), F32)
            step_k = np.zeros_like(step_v)
            for i in range(QT):              # the step's queries in order
                step_v = _fma(p[i, :, None], dO[i, None, :], step_v)
                step_k = _fma(ds[i, :, None], Q[i, None, :], step_k)
            acc_v = acc_v + step_v
            acc_k = acc_k + step_k
            share = np.zeros((QT, 256), F32)
            for j in range(KT):              # the item's keys in order
                share = _fma(ds[:, j, None], K[j, None, :], share)
            if qi != kt:                     # to the accumulator's tile
                acc[bh, qi] = share if kt == 0 else acc[bh, qi] + share
            else:                            # the diagonal: the last
                total = share if kt == 0 else acc.pop((bh, qi)) + share
                dq[b, h, q0:q0 + QT] = total * scale
        dk[b, kvh, k0:k0 + KT] = acc_k * scale
        dv[b, kvh, k0:k0 + KT] = acc_v
    assert not acc                           # every tile finished
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, :, :S, :D]))
                 for x in (dq, dk, dv))


def _max_rel(got, want):
    g, w = got.numpy(), np.asarray(want, F32)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)


def _jax_grads(arrs):
    q, k, v, ct = (jnp.asarray(a, jnp.float32) for a in arrs)

    @jax.jit
    def grads(q, k, v, ct):
        out, vjp = jax.vjp(JRef.flash_attention_ref, q, k, v)
        return vjp(ct.astype(out.dtype))

    return grads(q, k, v, ct)


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("S", [40, 100])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
def test_backward_arithmetic_within_tolerance(rng, H, KV, S, D):
    """The emulated backward against `flash_attention_bwd_plain` on the
    same (o, lse) and against jax.vjp of the reference's dense oracle,
    each gradient within 1e-5 x max|grad|; GQA and MQA, S ragged against
    the 32-row tiles, D = 160 read in place by the D = 256 body."""
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]
    q, k, v, do = (torch.as_tensor(a) for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    got = emulate_bwd(q, k, v, o, lse, do)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, p in zip(got, plain):
        assert _max_rel(g, p.numpy()) <= 1e-5
    for g, w in zip(got, _jax_grads(arrs)):
        assert _max_rel(g, np.asarray(w, F32)) <= 1e-5


# ---------------------------------------------------------------------------
# the backward's barrier protocol
# ---------------------------------------------------------------------------


class _Named:
    """A named barrier of `units` groups of 128 threads: bar.arrive adds
    a group and goes on, bar.sync adds it and waits for the generation."""

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


# what the backward's simulation models, as the source spells it
_BWD_PROTOCOL = [
    "mbar_init(full_kv, 1);", "mbar_init(empty_kv, CONSUMERS);",
    "mbar_init(full, 33);", "mbar_init(empty, CONSUMERS);",
    "mbar_init(staged, CONSUMERS);", "mbar_init(freed, 1);",
    "mbar_wait(empty_kv, (n & 1) ^ 1);", "mbar_wait(empty, (it & 1) ^ 1);",
    "mbar_wait(staged, n_sh & 1);", "wait_count(cnt, p_kt);",
    "mbar_arrive(freed);", "p_bh = qi == kt ? -1 : b * H + h;",
    "cp_async_arrive(full);",
    "mbar_wait(full_kv, n & 1);", "mbar_wait(full, it & 1);",
    "bar_arrive(1);", "bar_sync(1);", "bar_arrive(4);",
    "if (grp == 0) bar_sync(4);", "mbar_arrive(empty);",
    "if (s == steps - 1) mbar_arrive(empty_kv);",
    "mbar_wait(freed, (n_sh & 1) ^ 1);", "mbar_arrive(staged);",
    "if (tid == 0) wait_count(sem + bh * nQ + qi, kt);",
    "named_sync(5, CONSUMERS);"]


def _simulate_bwd(B, H, KV, S, blocks, rng, *, fault=None):
    """`flash_bwd_f32_wide_kernel`'s waits and arrivals per block (the
    producer warp, group 0 and group 1 of the compute threads), blocks
    sharing the ticket counter and the dq counters, under a random
    scheduler.  `fault`: "own_add", a diagonal step waits until the
    counter reads kt + 1; "reversed", the list hands out the last key
    tiles first; "no free", the producer never frees the share buffer.
    Returns the items each block took."""
    BKV, G, nQ = B * KV, H // KV, -(-S // QT)
    nK = -(-S // KT)
    n_items = BKV * nK
    ticket, taken, progress = [0], [], [0]
    counters = {}

    def decode(item):
        kt, bkv = divmod(item, BKV)
        if fault == "reversed":
            kt = nK - 1 - kt
        return kt, bkv

    def block(bi):
        full_kv, empty_kv = _Mbar(1, progress), _Mbar(2, progress)
        full, empty = _Mbar(1, progress), _Mbar(2, progress)
        staged, freed = _Mbar(2, progress), _Mbar(1, progress)
        p_ready, ds_ready, diag = (_Named(2, progress) for _ in range(3))
        item_s = [None]

        def producer():
            it = n_sh = 0
            pend = None

            def add_share():
                nonlocal n_sh
                yield from _wait(staged, n_sh & 1)
                bh, qi, kt = pend
                while counters.get((bh, qi), 0) < kt:
                    yield
                counters[bh, qi] = counters.get((bh, qi), 0) + 1
                progress[0] += 1
                if fault != "no free":
                    freed.arrive()
                n_sh += 1

            for n in range(10 ** 9):
                item = ticket[0]
                ticket[0] += 1
                yield from _wait(empty_kv, (n & 1) ^ 1)
                if item >= n_items:
                    item_s[0] = -1
                    full_kv.arrive()
                    if pend is not None:
                        yield from add_share()
                    return
                taken.append((bi, item))
                kt, bkv = decode(item)
                b, kvh = divmod(bkv, KV)
                item_s[0] = item
                full_kv.arrive()
                for s in range(G * (nQ - kt)):
                    qi = nQ - 1 - s // G
                    yield from _wait(empty, (it & 1) ^ 1)
                    full.arrive()
                    if pend is not None:
                        yield from add_share()
                    pend = None if qi == kt else (b * H + kvh * G + s % G,
                                                  qi, kt)
                    it += 1

        def group(g):
            it = n_sh = 0
            for n in range(10 ** 9):
                yield from _wait(full_kv, n & 1)
                item = item_s[0]
                if item < 0:
                    return
                kt, bkv = decode(item)
                b, kvh = divmod(bkv, KV)
                steps = G * (nQ - kt)
                for s in range(steps):
                    qi = nQ - 1 - s // G
                    bh = b * H + kvh * G + s % G
                    yield from _wait(full, it & 1)
                    if g == 0:
                        p_ready.arrive()             # P in its tile
                        empty.arrive()               # dv: dO read
                        yield from ds_ready.sync()   # dS^T in its tile
                    else:
                        yield from p_ready.sync()
                        ds_ready.arrive()
                        empty.arrive()               # dk: Q read
                    if s == steps - 1:
                        empty_kv.arrive()            # dq: K read
                    if qi != kt:
                        yield from _wait(freed, (n_sh & 1) ^ 1)
                        staged.arrive()
                        n_sh += 1
                    elif kt > 0:
                        if g == 0:                   # thread 0's wait
                            need = kt + 1 if fault == "own_add" else kt
                            while counters.get((bh, qi), 0) < need:
                                yield
                        yield from diag.sync()
                    it += 1

        return [producer(), group(0), group(1)]

    _run([a for bi in range(blocks) for a in block(bi)], rng, progress)
    return taken


def test_backward_protocol_is_the_sources():
    """Every wait and arrival the backward's simulation models is in the
    body."""
    body = _span("f32widebwd")
    for stmt in _BWD_PROTOCOL:
        assert stmt in body, stmt


@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (1, 2, 1, 64, 1), (1, 4, 2, 257, 2), (2, 4, 1, 200, 3),
    (1, 2, 2, 1, 4), (1, 8, 2, 300, 5), (2, 2, 1, 129, 8),
    (2, 4, 4, 64, 132)])
def test_backward_protocol_completes(rng, B, H, KV, S, blocks):
    """The backward's waits and arrivals end under random interleavings:
    no block hangs and every item is taken once (more blocks than items
    included)."""
    for _ in range(3):
        taken = _simulate_bwd(B, H, KV, S, blocks, rng)
        assert sorted(i for _, i in taken) == list(
            range(B * KV * -(-S // KT)))


@pytest.mark.parametrize("fault", ["own_add", "reversed", "no free"])
@pytest.mark.parametrize("B,H,KV,S,blocks", [(1, 2, 1, 200, 2),
                                             (1, 4, 2, 300, 3)])
def test_backward_protocol_hangs_on_a_broken_wait(rng, B, H, KV, S, blocks,
                                                  fault):
    """The simulation sees a wait that can never be met: a diagonal step
    waiting for one add more than its tile gets, a list that hands out
    later key tiles first, or a share buffer never freed."""
    with pytest.raises(AssertionError, match="hangs"):
        _simulate_bwd(B, H, KV, S, blocks, rng, fault=fault)


# ---------------------------------------------------------------------------
# the ablations' variants of the two bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in BA.PATCHES
                                  if n.startswith("f32w_")])
def test_f32w_bwd_ablate_patches_touch_the_body_alone(name):
    """Each `f32w_*` variant of `launch.bwd_ablate` applies and changes
    the float32 D = 256 body's namespace and nothing else; the other
    variants leave that namespace as it is."""
    out = BA.variant_source(name)
    a = _SRC.index("namespace f32widebwd {")
    b = _SRC.index("}  // namespace f32widebwd")
    assert out != _SRC
    assert out[:a] == _SRC[:a]
    assert out.endswith(_SRC[b:])
    assert BA.body_of(name) == "f32w"
    for other in BA.PATCHES:
        if not other.startswith("f32w_"):
            assert _span("f32widebwd", BA.variant_source(other)) == \
                _span("f32widebwd")


def test_bwd_ablate_wide_f32_preset():
    """`--shape wide_f32` is the wide shape in float32 operands, its
    default variants the f32w_* ones."""
    assert BA.parse_shape("wide_f32") == (4, 8, 2, 2048, 256)
    assert "wide_f32" in BA.FLOAT32_PRESETS
    assert BA.NAMESPACES["f32w"] == "f32widebwd"
    assert {"f32w_no_dq", "f32w_no_exp", "f32w_no_sdp", "f32w_no_kv",
            "f32w_no_dqmm"} <= set(BA.PATCHES)


@pytest.mark.parametrize("name", [n for n in FWA.PATCHES
                                  if n.startswith("f32")])
def test_f32_fwd_ablate_patches_touch_float32_at_256_alone(name):
    """Each float32 variant of `launch.fwd_ablate` changes nothing but
    float32 at D = 256: the `f32w_*` ones the f32wide namespace alone,
    `f32_body256` the launcher's one line that sends float32 D = 256 to
    f32wide, which it sends to f32body<256> as it stands instead (the
    floor f32wide has to beat; f32body's layout fits at D = 256: 213,760
    bytes)."""
    out = FWA.variant_source(name)
    if name.startswith("f32w_"):
        a = _SRC.index("namespace f32wide {")
        b = _SRC.index("}  // namespace f32wide")
        assert out != _SRC and out[:a] == _SRC[:a]
        assert out.endswith(_SRC[b:])
    else:
        diff = [(x, y) for x, y in zip(_SRC.splitlines(), out.splitlines())
                if x != y]
        assert len(diff) == 2 and len(out.splitlines()) == \
            len(_SRC.splitlines())
        assert "f32wide::launch" in diff[0][0]
        assert "f32body::launch<256>" in diff[0][1]
        f = {n: int(re.search(rf"constexpr int {n} = (\d+);",
                              _span("f32body"))[1]) for n in ("BQ", "BK")}
        assert "constexpr int PS = BK + 1;" in _span("f32body")
        smem = 4 * ((f["BQ"] + f["BK"]) * 257 + f["BK"] * 256
                    + f["BQ"] * (f["BK"] + 1))
        assert smem == 213_760 <= 232_448
    for other in FWA.PATCHES:
        if not other.startswith("f32"):
            assert _span("f32wide", FWA.variant_source(other)) == \
                _span("f32wide")
