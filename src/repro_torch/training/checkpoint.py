"""Fault-tolerant checkpointing: atomic, async, resumable (the port of
`repro.training.checkpoint`, with its on-disk layout).

Layout:  <dir>/step_<N>/arrays.npz + meta.json, plus <dir>/LATEST
pointing at the newest COMPLETE checkpoint.  Writes go to a tmp dir
that is os.replace()'d into place, and LATEST is updated last, so a
process dying mid-write never corrupts the restore path.

Leaves are numbered a0, a1, ... in `jax.tree_util`'s order (`trees`:
dict keys sorted at every level, a `ParamTree` as a dict,
`AdamWState` as (step, m, v)), so each package restores the other's
checkpoint of ``(params, opt_state)``.  Tensors are written as numpy
arrays of their dtype, except bfloat16 (numpy has none), written as
float32 (exact) and restored into the bfloat16 of the tree it is
restored into; a Python int or float is written as the reference's
0-d int32 / float32.

`AsyncCheckpointer` moves serialization off the training thread: save()
copies the tree's tensors to host memory (blocking only for that copy),
and a worker thread writes the npz.  wait() drains before exit.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.trees import describe, flatten, unflatten


def _to_host(x):
    """A leaf as the numpy array that is written: a copy, so that an
    in-place update after an async save cannot reach it."""
    if torch.is_tensor(x):
        dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.detach().to(device="cpu", dtype=dt, copy=True).numpy()
    if isinstance(x, bool):
        return np.asarray(x)
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if isinstance(x, float):
        return np.asarray(x, np.float32)
    return np.asarray(x)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_meta: Optional[dict] = None) -> str:
    """Blocking atomic save. Returns the checkpoint path."""
    leaves, treedef = flatten(tree)
    return _write(directory, step, [_to_host(x) for x in leaves], treedef,
                  extra_meta)


def _write(directory, step, arrays, treedef, extra_meta) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": x for i, x in enumerate(arrays)})
    meta = {"step": step, "num_leaves": len(arrays),
            "treedef": describe(treedef), "time": time.time()}
    meta.update(extra_meta or {})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # LATEST updated last => always points at a complete checkpoint
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def _restore_leaf(like, arr):
    if torch.is_tensor(like):
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=like.device, dtype=like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return arr


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None):
    """Restore into the structure of `tree_like`. Returns (tree, step).

    Each tensor leaf comes back as a new tensor in its like's dtype and
    on its like's device; a `ParamTree` comes back as a new one (without
    gradient: call `requires_grad_`).  Leaves are read and moved one at
    a time."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    leaves, treedef = flatten(tree_like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"model wants {len(leaves)}")
        restored = []
        for i, want in enumerate(leaves):
            got = data[f"a{i}"]
            if tuple(np.shape(want)) != tuple(got.shape):
                raise ValueError(f"leaf a{i}: checkpoint shape "
                                 f"{tuple(got.shape)}, model wants "
                                 f"{tuple(np.shape(want))}")
            restored.append(_restore_leaf(want, got))
    return unflatten(treedef, restored), step


def prune_old(directory: str, keep: int = 3) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (one in flight at a time)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, arrays, treedef, meta = item
            try:
                _write(self.directory, step, arrays, treedef, meta)
                prune_old(self.directory, self.keep)
            except Exception as e:   # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        if self._err:
            raise self._err
        leaves, treedef = flatten(tree)
        arrays = [_to_host(x) for x in leaves]          # D2H now
        self._q.put((step, arrays, treedef, meta))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)
