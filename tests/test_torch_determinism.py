"""The port's plain accumulations are deterministic: the plain
`gee_scatter`, the plain `gee_delta_renorm` and `core.gee` give the same
bits on every call and at every thread count, bit-equal to a serial
float32 sum in the kernels' order (numpy's unbuffered ``np.add.at``).

PyTorch's CPU ``index_put_(accumulate=True)`` is not: at 80,000
contributions into a (2000, 8) Z its sums change from call to call and
with the thread count, which made bit-equality tests through the plain
versions (recovery, checkpoints, ivf at nprobe = K) pass or fail by
chance."""
import numpy as np
import pytest
import torch

from repro_torch.core import gee as G
from repro_torch.kernels.gee_scatter import gee_scatter_plain
from repro_torch.kernels.ops import pack_edges
from repro_torch.kernels.query_fused import (gee_delta_renorm_plain,
                                             normalize_rows)

N, K, M = 2000, 8, 80_000


@pytest.fixture
def threads():
    """Run the body at 1 and at 4 threads; restore the count after."""
    old = torch.get_num_threads()
    yield
    torch.set_num_threads(old)


def _contributions(rng):
    rows = rng.integers(0, N, M)
    cls = rng.integers(0, K, M)
    val = rng.random(M).astype(np.float32) - np.float32(0.3)
    return rows, cls, val


def _serial(rows, cls, val, Z0=None):
    Z = np.zeros((N, K), np.float32) if Z0 is None else Z0.copy()
    np.add.at(Z, (rows, cls), val)
    return Z


@pytest.mark.parametrize("n_threads", [1, 4])
def test_plain_scatter_is_the_serial_sum(rng, threads, n_threads):
    torch.set_num_threads(n_threads)
    rows, cls, val = _contributions(rng)
    row_ptr, cb, vb, T = pack_edges(torch.as_tensor(rows),
                                    torch.as_tensor(cls),
                                    torch.as_tensor(val), N, 256)
    want = _serial(rows, cls, val)      # packing keeps each row's order
    for _ in range(20):
        Z = gee_scatter_plain(row_ptr, cb, vb, num_tiles=T, tile_n=256,
                              kdim=K)
        assert np.array_equal(Z[:N].numpy(), want)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_plain_delta_adds_in_list_order(rng, threads, n_threads):
    torch.set_num_threads(n_threads)
    rows, cls, val = _contributions(rng)
    order = np.argsort(rows, kind="stable")
    rows, cls, val = rows[order], cls[order], val[order]
    Z0 = rng.random((N, K), dtype=np.float32)
    want = _serial(rows, cls, val, Z0)
    args = [torch.as_tensor(a) for a in (rows.astype(np.int32),
                                         cls.astype(np.int32), val)]
    for _ in range(20):
        Z_new, Zn = gee_delta_renorm_plain(torch.as_tensor(Z0), *args)
        assert np.array_equal(Z_new.numpy(), want)
        assert torch.equal(Zn, normalize_rows(torch.as_tensor(want)))


@pytest.mark.parametrize("n_threads", [1, 4])
def test_core_gee_is_the_serial_sum_in_edge_order(rng, threads,
                                                  n_threads):
    torch.set_num_threads(n_threads)
    s = M // 2
    u, v = rng.integers(0, N, s), rng.integers(0, N, s)
    w = rng.random(s).astype(np.float32) + np.float32(0.5)
    Y = rng.integers(-1, K, N).astype(np.int32)
    t = [torch.as_tensor(a) for a in (u, v, w, Y)]
    Wv = G.make_w(t[3], K)
    dst, cls, val = G.edge_contributions(*t, Wv)
    want = _serial(dst.numpy(), cls.numpy(), val.numpy())
    # Laplacian degrees: u's contributions, then v's, each in edge order
    deg = np.zeros(N, np.float32)
    np.add.at(deg, u, w)
    np.add.at(deg, v, w)
    scale = torch.rsqrt(torch.clamp_min(torch.as_tensor(deg), 1.0))
    wl = t[2] * scale[t[0].long()] * scale[t[1].long()]
    lap = _serial(*(x.numpy() for x in G.edge_contributions(
        t[0], t[1], wl, t[3], Wv)))
    for _ in range(20):
        assert np.array_equal(G.gee(*t, K=K, n=N).numpy(), want)
        assert np.array_equal(
            G.gee_apply_delta(torch.zeros(N, K), *t, Wv, K=K).numpy(),
            want)
        assert np.array_equal(G.gee(*t, K=K, n=N, laplacian=True).numpy(),
                              lap)


def test_the_cards_ordered_add_is_the_serial_sum(rng):
    """`_add_by_rank`, the tensor-op form a card runs, on the CPU: the
    same bits as numpy's serial add, with a run as long as 3,000."""
    rows, cls, val = _contributions(rng)
    rows[:3000] = 17
    cls[:3000] = 2
    idx = torch.as_tensor(rows * K + cls)
    Z0 = rng.random((N, K), dtype=np.float32)
    got = G._add_by_rank(torch.tensor(Z0).view(-1), idx,
                         torch.as_tensor(val))
    assert np.array_equal(got.view(N, K).numpy(),
                          _serial(rows, cls, val, Z0))
    empty = torch.zeros(4)
    assert torch.equal(G._add_by_rank(empty, torch.zeros(0, dtype=torch.long),
                                      torch.zeros(0)), torch.zeros(4))
