"""Distributed GEE: the paper's shared-memory edge parallelism mapped to
collectives over `torch.distributed`.

The port of `repro.core.distributed`.  The paper's Ligra version splits
the edge loop across cores that share one Z and race on it with atomic
adds.  Here every rank holds a contiguous slice of the (padded) edge
list, and "who owns Z" is an explicit choice among four modes, which
compute the same Z up to float rounding:

  replicated      each rank scatters its slice into a full (n, K) Z,
                  then `all_reduce`.  Memory O(n K) per rank.
  reduce_scatter  the same local pass; `reduce_scatter_tensor` leaves
                  each rank its (n / p, K) row shard.
  a2a             contributions bucketed by destination row shard (a
                  stable sort, then capacity-padded (p, cap) buckets, as
                  an MoE dispatch), exchanged with one
                  `all_to_all_single`, then scattered into the shard.
  ring            the same buckets, folded into an accumulator that is
                  passed around the ring with point-to-point sends
                  (rank i sends to i - 1): p - 1 steps, neighbour
                  traffic only.

Bucketed modes pad each bucket to cap = mean x capacity_factor; overflow
is counted and returned (`exact_capacity_factor` measures a factor that
drops nothing).  Ranks are processes: `gee_sharded` runs on this rank's
edge slice and returns this rank's result, `gee_distributed` is the host
wrapper that returns the full Z on every rank.  Every scatter is the
ordered plain sum (`core.gee.scatter_add_ordered`): the reference's
bodies scatter with plain XLA, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.gee import (add_in_order, edge_contributions, make_w,
                                  scatter_add_ordered)
from repro_torch.device import resolve_device

AXIS = "edges"

#: the one-rank group `edge_mesh` started, None when it started none.
#: Process-wide, as torch's default group is; a group the caller
#: initialized is never touched.
_started = None

# torch 2.13 renamed the tensor forms of two collectives; take whichever
# this installation has
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def edge_mesh(devices=None) -> DeviceMesh:
    """Flat 1-D mesh named "edges" over the process group's world (GEE
    has no model dimension).  `devices` is the device type the ranks run
    on, "cuda" (the default) or "cpu": NCCL for the card, gloo for the
    CPU, one card per rank.

    With no process group initialized (one process, as the reference's
    one-device mesh needs no set-up), this starts a one-rank group on a
    `HashStore`.  That group is this module's: `destroy_local_group()`
    ends it, after which `init_process_group` may start another, and a
    later `edge_mesh` for the other device type replaces it.  A group
    whose backend cannot run the device type raises; nothing falls back
    to another backend or device."""
    kind = resolve_device("cuda" if devices is None else devices).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"edge_mesh runs on cpu or cuda, not {kind}")
    backend = "nccl" if kind == "cuda" else "gloo"
    if _ours() and backend not in str(dist.get_backend()):
        destroy_local_group()
    if not dist.is_initialized():
        _start_local_group(backend)
    have = str(dist.get_backend())
    if backend not in have:
        raise RuntimeError(f"the process group's backend {have!r} cannot "
                           f"run {kind} collectives (needs {backend})")
    return DeviceMesh(kind, list(range(dist.get_world_size())),
                      mesh_dim_names=(AXIS,))


def _start_local_group(backend: str) -> None:
    global _started
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)
    _started = dist.group.WORLD


def _ours() -> bool:
    return (_started is not None and dist.is_initialized()
            and dist.group.WORLD is _started)


def destroy_local_group() -> None:
    """End the one-rank group `edge_mesh` started, if it is still the
    default group."""
    global _started
    if _ours():
        dist.destroy_process_group()
    _started = None


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on under `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def world_size(mesh: Optional[DeviceMesh] = None) -> int:
    """Ranks of `mesh`, else of the initialized default group, else 1:
    in torch an SPMD program's devices are its ranks."""
    if mesh is not None:
        return mesh.size()
    return dist.get_world_size() if dist.is_initialized() else 1


def pad_rows(n: int, p: int) -> int:
    return ((n + p - 1) // p) * p


# ---------------------------------------------------------------------------
# in-rank helpers
# ---------------------------------------------------------------------------


def _bucket_by_owner(dst, cls, val, rows: int, p: int, cap: int):
    """Pack contributions into (p, cap) per-owner buckets (a stable sort,
    then padding), as the reference's jnp version does: contributions
    past a bucket's cap are dropped in list order.

    Returns (b_row int32, b_cls int32, b_val float32, dropped): b_row
    holds owner-local rows; padded slots have row 0, class 0, value 0."""
    dev = dst.device
    dst = dst.long()
    owner = torch.div(dst, rows, rounding_mode="floor")
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order]
    row_s = (dst - owner * rows)[order]
    starts = torch.searchsorted(owner_s,
                                torch.arange(p, dtype=owner_s.dtype,
                                             device=dev))
    pos = torch.arange(owner_s.shape[0], device=dev) - starts[owner_s]
    keep = pos < cap
    slot = torch.where(keep, owner_s * cap + pos,
                       torch.full_like(pos, p * cap))

    def pack(x, dtype):
        buf = torch.zeros(p * cap + 1, dtype=dtype, device=dev)
        buf[slot] = x.to(dtype)
        return buf[:-1].view(p, cap)

    b_row = pack(row_s, torch.int32)
    b_cls = pack(cls[order], torch.int32)
    b_val = pack(torch.where(keep, val[order], torch.zeros((), device=dev)),
                 torch.float32)
    return b_row, b_cls, b_val, (~keep).sum()


def _scatter_rows(rows: int, K: int, r, c, v, device) -> torch.Tensor:
    """Z (rows, K) from contributions in list order.  Zero values are
    left out: adding 0 changes no entry, and a bucket's padded slots
    (row 0, class 0) and the unlabelled donors' contributions (class 0
    of their row) would otherwise form long runs of one entry, which the
    card's ordered sum (`core.gee.add_in_order`) walks one add at a
    time."""
    keep = v != 0
    return scatter_add_ordered(
        torch.zeros((rows, K), dtype=torch.float32, device=device),
        r[keep], c[keep], v[keep])


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(p, cap) buckets: row i goes to rank i, row j of the result came
    from rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _no_drops(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# per-rank bodies
# ---------------------------------------------------------------------------


def _body_replicated(u, v, w, Y, Wv, *, K, n, group):
    dst, cls, val = edge_contributions(u, v, w, Y, Wv)
    Z = _scatter_rows(n, K, dst, cls, val, w.device)
    dist.all_reduce(Z, group=group)
    return Z, _no_drops(w.device)


def _body_reduce_scatter(u, v, w, Y, Wv, *, K, n, p, group):
    dst, cls, val = edge_contributions(u, v, w, Y, Wv)
    Z = _scatter_rows(n, K, dst, cls, val, w.device)
    Zs = torch.empty((n // p, K), dtype=torch.float32, device=w.device)
    _reduce_scatter(Zs, Z, group=group)
    return Zs, _no_drops(w.device)


def _body_a2a(u, v, w, Y, Wv, *, K, n, p, cap, group):
    rows = n // p
    dst, cls, val = edge_contributions(u, v, w, Y, Wv)
    b_row, b_cls, b_val, dropped = _bucket_by_owner(dst, cls, val, rows, p,
                                                    cap)
    del dst, cls, val
    r = _all_to_all(b_row, group)
    c = _all_to_all(b_cls, group)
    x = _all_to_all(b_val, group)
    del b_row, b_cls, b_val
    Z = _scatter_rows(rows, K, r.view(-1), c.view(-1), x.view(-1), w.device)
    dist.all_reduce(dropped, group=group)
    return Z, dropped


def _body_a2a_prebucketed(b_dst, b_src, b_w, Y, Wv, *, K, n, p, group):
    """Steady-state a2a: the buckets were built once at ingestion (a
    contribution's owner depends only on its destination, not on the
    labels), so refinement iterations skip the sort.  b_* are this
    rank's (p, cap) per-owner buckets of (local row, class-source node,
    weight); class and value resolve from the CURRENT labels."""
    src = b_src.long()
    Ys = Y[src]
    cls = torch.clamp_min(Ys, 0)
    val = torch.where(Ys >= 0, Wv[src] * b_w,
                      torch.zeros((), device=b_w.device))
    r = _all_to_all(b_dst, group)
    c = _all_to_all(cls, group)
    x = _all_to_all(val, group)
    Z = _scatter_rows(n // p, K, r.view(-1), c.view(-1), x.view(-1),
                      b_w.device)
    return Z, _no_drops(b_w.device)


def _body_ring(u, v, w, Y, Wv, *, K, n, p, cap, group):
    rows = n // p
    me = dist.get_rank(group)
    dst, cls, val = edge_contributions(u, v, w, Y, Wv)
    b_row, b_cls, b_val, dropped = _bucket_by_owner(dst, cls, val, rows, p,
                                                    cap)
    del dst, cls, val

    def bucket_dense(c):
        return _scatter_rows(rows, K, b_row[c], b_cls[c], b_val[c],
                             w.device)

    # the reference's direction: rank i sends to i - 1, so rank i folds in
    # what i + 1 has gathered so far
    to = dist.get_global_rank(group, (me - 1) % p)
    frm = dist.get_global_rank(group, (me + 1) % p)
    acc = bucket_dense((me + 1) % p)
    for t in range(1, p):
        got = torch.empty_like(acc)
        ops = [dist.P2POp(dist.isend, acc, to, group),
               dist.P2POp(dist.irecv, got, frm, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        acc = got + bucket_dense((me + t + 1) % p)
    dist.all_reduce(dropped, group=group)
    return acc, dropped


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def prebucket_host(graph, p: int, capacity_factor=None):
    """One-time ingestion pass: route every directed contribution to its
    destination's row-owner bucket.  Returns (b_dst_local, b_srcnode,
    b_weight, n_pad), the arrays of shape (p_shards, p_owners, cap):
    give rank i its [i] slab.  The class and value resolution stays per
    iteration."""
    if capacity_factor is None:
        capacity_factor = exact_capacity_factor(graph, p)
    n_pad = pad_rows(graph.n, p)
    s_pad = pad_rows(graph.s, p)
    g = graph.pad_to(s_pad)
    rows = n_pad // p
    per = s_pad // p
    cap = int(np.ceil(2 * per / p * capacity_factor)) + 8
    b_dst = np.zeros((p, p, cap), np.int32)
    b_src = np.zeros((p, p, cap), np.int32)
    b_w = np.zeros((p, p, cap), np.float32)
    for shard in range(p):
        sl = slice(shard * per, (shard + 1) * per)
        dst = np.concatenate([g.u[sl], g.v[sl]])
        src = np.concatenate([g.v[sl], g.u[sl]])   # label donor
        w = np.concatenate([g.w[sl], g.w[sl]])
        owner = dst // rows
        order = np.argsort(owner, kind="stable")
        dst, src, w, owner = dst[order], src[order], w[order], owner[order]
        # each owner's run is contiguous after the sort: its bucket is the
        # run's prefix, copied as one slice
        ends = np.searchsorted(owner, np.arange(p + 1))
        for o in range(p):
            a, b = ends[o], ends[o + 1]
            if b - a > cap:
                raise ValueError("prebucket overflow; raise "
                                 "capacity_factor")
            b_dst[shard, o, :b - a] = dst[a:b] - o * rows
            b_src[shard, o, :b - a] = src[a:b]
            b_w[shard, o, :b - a] = w[a:b]
    return b_dst, b_src, b_w, n_pad


def gee_a2a_steady(b_dst, b_src, b_w, Y, *, K: int, n_pad: int,
                   mesh: DeviceMesh):
    """Per-iteration embed from pre-bucketed contributions (no sort).

    b_* are this rank's (p, cap) slab of `prebucket_host`'s arrays, as
    tensors on the rank's device; Y (n_pad,) int32 labels there.
    Returns (this rank's (n_pad / p, K) row shard, dropped = 0)."""
    p = mesh.size()
    Wv = make_w(Y, K)
    return _body_a2a_prebucketed(b_dst, b_src, b_w, Y, Wv, K=K, n=n_pad,
                                 p=p, group=mesh.get_group(AXIS))


def gee_sharded(u, v, w, Y, *, K: int, n: int, mesh: DeviceMesh,
                mode: str = "ring", capacity_factor: float = 2.0,
                laplacian: bool = False):
    """Distributed GEE on this rank's edge slice.

    u, v, w: (s_local,) tensors on the rank's device, the same length
    on every rank (pad first: `Graph.pad_to`).  Y: (n,) int32 labels,
    the whole of them, with n divisible by the mesh size for the
    row-sharded modes.  Returns (Z, dropped), dropped summed over ranks:
      replicated          -> the full Z (n, K)
      others              -> this rank's row shard (n / p, K)
    """
    p = mesh.size()
    group = mesh.get_group(AXIS)
    w = w.to(torch.float32)
    if laplacian:
        # the global degrees: this slice's, summed over ranks
        deg = torch.zeros(n, dtype=torch.float32, device=w.device)
        add_in_order(deg, u, w)
        add_in_order(deg, v, w)
        dist.all_reduce(deg, group=group)
        scale = torch.rsqrt(torch.clamp_min(deg, 1.0))
        w = w * scale[u.long()] * scale[v.long()]
    Wv = make_w(Y, K)
    s_local = u.shape[0]
    cap = int(np.ceil(2 * s_local / p * capacity_factor)) + 8
    if mode == "replicated":
        return _body_replicated(u, v, w, Y, Wv, K=K, n=n, group=group)
    if mode not in ("reduce_scatter", "a2a", "ring"):
        raise ValueError(f"unknown mode {mode!r}")
    if n % p:
        raise ValueError(f"{mode} needs n ({n}) divisible by the mesh "
                         f"size ({p})")
    if mode == "reduce_scatter":
        return _body_reduce_scatter(u, v, w, Y, Wv, K=K, n=n, p=p,
                                    group=group)
    body = _body_a2a if mode == "a2a" else _body_ring
    return body(u, v, w, Y, Wv, K=K, n=n, p=p, cap=cap, group=group)


def gather_rows(Zs: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The full (p * rows, K) Z from every rank's row shard."""
    out = torch.empty((mesh.size() * Zs.shape[0], Zs.shape[1]),
                      dtype=Zs.dtype, device=Zs.device)
    _all_gather(out, Zs.contiguous(), group=mesh.get_group(AXIS))
    return out


def exact_capacity_factor(graph, p: int) -> float:
    """Capacity factor that guarantees zero drops, measured from the
    actual per-(shard, owner) bucket histogram in one O(s) host pass:
    the skew-robust answer to what Ligra got from work stealing (power
    law hubs concentrate contributions on one row owner)."""
    from repro_torch.graph.partition import owner_histogram
    hist = owner_histogram(graph, p)
    s_pad = pad_rows(graph.s, p)
    mean_bucket = max(2 * (s_pad // p) / p, 1.0)
    return float(hist.max()) / mean_bucket + 0.05


def edge_slice(graph, p: int, rank: int):
    """Rank `rank`'s (u, v, w) numpy slice of the edges padded to a
    multiple of p."""
    s_pad = pad_rows(graph.s, p)
    g = graph.pad_to(s_pad)
    per = s_pad // p
    sl = slice(rank * per, (rank + 1) * per)
    return g.u[sl], g.v[sl], g.w[sl]


def gee_distributed(graph, Y, *, K: int, mode: str = "ring",
                    mesh: Optional[DeviceMesh] = None,
                    capacity_factor=None, laplacian: bool = False):
    """Host wrapper, called on every rank with the same graph: pads the
    edges and rows, runs this rank's slice, gathers the row shards.

    capacity_factor None -> the exact (zero-drop) factor measured from
    the owner histogram.  Returns (Z (n, K) numpy, dropped count), the
    same on every rank."""
    mesh = mesh if mesh is not None else edge_mesh()
    p, rank = mesh.size(), mesh.get_local_rank()
    dev = mesh_device(mesh)
    if capacity_factor is None:
        capacity_factor = exact_capacity_factor(graph, p)
    n_pad = pad_rows(graph.n, p)
    u, v, w = (torch.as_tensor(a, device=dev)
               for a in edge_slice(graph, p, rank))
    Y_pad = np.full(n_pad, -1, np.int32)
    Y_pad[:graph.n] = Y
    Z, dropped = gee_sharded(u, v, w, torch.as_tensor(Y_pad, device=dev),
                             K=K, n=n_pad, mesh=mesh, mode=mode,
                             capacity_factor=capacity_factor,
                             laplacian=laplacian)
    if mode != "replicated":
        Z = gather_rows(Z, mesh)
    return Z[:graph.n].cpu().numpy(), int(dropped)
