"""One rank's costs of a traced step: the port's `cost_analysis()` and
`memory_analysis()`.

`Recorder` is a `TorchDispatchMode` pushed above the dry run's
`FakeTensorMode`.  It sees every op that reaches a rank's tensors:

  * DTensor-level ops (any argument a DTensor) are passed on uncounted
    (`NotImplemented`: DTensor then runs the op on its local tensors,
    which this mode sees);
  * DTensor's sharding propagation and redistribution planning run with
    the modes off (`_patch_dtensor`): the fake ops it runs on global
    shapes to infer an output's metadata are not this rank's work;
  * every other op is a local op of this rank and is counted:
      - flops: `torch.utils.flop_counter`'s formulas, which cover the
        matrix products, convolutions and fused attention, not
        elementwise ops;
      - bytes: each input tensor read once and each output written
        once, for every op that is not a view (eager, unfused: XLA's
        "bytes accessed" of a fused program is smaller);
      - collectives: DTensor's `_c10d_functional.*` ops (and its
        `_dtensor.shard_dim_alltoall`, taken in the GPU mesh's form, one
        all-to-all, where the fake mesh's CPU tensors would fall back to
        an all-gather) and the `c10d.*` ops `dist.*` issues
        (`core/distributed.py`), each with
        its result's bytes and its group's size (`roofline.
        parse_collectives` turns the trace into per-kind wire bytes);
      - memory: the bytes of every storage an op creates, live until it
        is freed; `peak_bytes` is the most alive at once.

Nothing is counted twice: a DTensor op is never counted, its local op
once.  Under a fake process group every collective returns at once.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.distributed.distributed_c10d as c10d
from torch.distributed.tensor import DTensor, _redistribute, placement_types
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    # a point-to-point exchange counts once, at the receiving end
    "recv_": "collective-permute",
}

def _outside_modes(fn):
    def wrapped(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    wrapped.__wrapped__ = fn
    return wrapped


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-dim all-to-all as a GPU mesh runs it (one
    `all_to_all`), where a CPU mesh would gather the whole tensor and
    keep a chunk."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim,
        funcol._resolve_group_name((mesh, mesh_dim)))


def _patch_dtensor():
    """While recording:

    * DTensor's own bookkeeping (sharding propagation, redistribution
      planning, a strided shard's index arithmetic) runs with the
      dispatch modes off: its metadata ops then use a fake mode of its
      own and are not this rank's work, and the small index tensors it
      computes with stay real (under the dry run's FakeTensorMode they
      could not be read);
    * a shard-dim all-to-all takes the GPU mesh's form (the fake mesh's
      tensors lie on the CPU, where DTensor would all-gather instead).

    Only plain functions are wrapped; a name a torch version lacks is
    skipped.  Returns the undo."""
    targets = [(ShardingPropagator, n) for n in (
        "propagate", "_propagate_tensor_meta_non_cached")] + [
        (_redistribute, n) for n in ("_gen_transform_infos",
                                     "_gen_transform_infos_non_cached")]
    strided = getattr(placement_types, "_StridedShard", None)
    targets += [(strided, "local_shard_size_and_offset")]
    targets = [(o, n) for o, n in targets
               if o is not None and isinstance(o.__dict__.get(n),
                                               type(_outside_modes))]
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    for obj, name, fn in saved:
        setattr(obj, name, _outside_modes(fn))
    if hasattr(placement_types, "shard_dim_alltoall") and hasattr(
            torch.ops._dtensor, "shard_dim_alltoall"):
        saved.append((placement_types, "shard_dim_alltoall",
                      placement_types.shard_dim_alltoall))
        placement_types.shard_dim_alltoall = _alltoall

    def undo():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return undo


def _group_size(args) -> int:
    for a in tree_leaves(args):
        if isinstance(a, torch.ScriptObject):
            try:
                return int(dist.ProcessGroup.unbox(a).size())
            except (RuntimeError, AttributeError, TypeError):
                continue            # a ReduceOp, not a group
        if isinstance(a, str):
            try:
                return int(c10d._resolve_process_group(a).size())
            except (RuntimeError, ValueError, KeyError, AttributeError):
                continue
    return 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_of(func, args, out):
    """(kind, result bytes, group size) of a collective op, else None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    kind = _COLL_OPS.get(func._opname)
    if kind is None:
        return None
    # the functional ops return their result; the c10d ops write it
    # into their first argument
    res = args[0] if ns == "c10d" else out
    nbytes = sum(_nbytes(t) for t in tree_leaves(res)
                 if isinstance(t, torch.Tensor))
    return kind, nbytes, _group_size(args)


def _allocates_only(func) -> bool:
    """An op that reads and writes no data (an allocation, a query)."""
    return func.namespace == "prim" or "empty" in func._opname


class Recorder(TorchDispatchMode):
    """Counts one rank's local ops while active (see the module doc).

    After the run: `flops`, `bytes`, `collectives` (a list of {"kind",
    "op", "bytes", "group"}), `peak_bytes` (the most bytes of storages
    created while recording alive at once), `live_bytes` (those alive
    now), `ops` (a Counter of op names)."""

    def __init__(self):
        super().__init__()
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.ops = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakValueDictionary()
        self._undo = None

    def __enter__(self):
        self._undo = _patch_dtensor()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._undo()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if self._seen.get(key) is st:
            return
        try:
            self._seen[key] = st
        except TypeError:            # a storage that takes no weakref
            return
        # the tensor's own bytes: a fake op may return a view of a
        # larger scratch storage (DTensor's fake all-to-all does)
        n = min(st.nbytes(), _nbytes(t))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.ops[str(func)] += 1
        coll = collective_of(func, args, out)
        if coll is not None:
            kind, nbytes, group = coll
            self.collectives.append({"kind": kind, "op": str(func),
                                     "bytes": nbytes, "group": group})
        elif func.overloadpacket in self._flops:
            self.flops += self._flops[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if coll is None and not func.is_view and not _allocates_only(func):
            ins = {id(t): t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins.values())
            self.bytes += sum(_nbytes(t) for t in outs)
        if not func.is_view:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out
