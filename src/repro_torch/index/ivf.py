"""IVFIndex: per-shard inverted lists over owned embedding rows.

The port of `repro.index.ivf.IVFIndex`.  One index covers one shard's
row-normalized slice ``Zn`` (owned, K) at global rows ``[row_offset,
row_offset + owned)``.  The quantizer is the (K, K) matrix of class
centroids the engine computes; every row goes to the cell of its
highest cosine score against the normalized centroids, ties to the
lowest cell.  The scores are `kernels.query_fused.row_scores`, a
fixed-order K-term sum per (row, centroid), not a matrix product, so a
row's cell does not depend on which other rows share its batch: an
assignment made for a delta's few rows equals the one a full build
makes.

Member lists are sorted int64 local row ids on the host.  Sorted lists
keep the scan's tie order (ascending global id), so merging the per-cell
top-k lists of any set of cells that covers every row gives the exact
scan's answer bit for bit.

Delta maintenance re-assigns exactly the rows an edge batch touched,
against the centroids fixed at build time (`update_rows`); a fresh build
under the same centroids gives the same memberships.  Centroid drift is
the engine's business: it counts moved rows and re-quantizes past a
threshold.

Each cell's gathered rows (on the shard's device) are cached, keyed by
the identity of the shard's Zn tensor: any write replaces that tensor
and so drops the cache.  The per-cell scan is the plain blocked scan
`serving.queries.topk_cosine_ids`, as the reference's is plain jnp.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.query_fused import row_scores
from repro_torch.serving import queries as Q

#: default number of probed cells for ``mode="ivf"`` queries (the
#: reference's: recall@10 >= 0.9 on community graphs at about 2/K of the
#: rows scanned)
DEFAULT_NPROBE = 2


class IVFIndex:
    """Inverted label-cell lists over one shard's owned rows."""

    def __init__(self, *, K: int, row_offset: int = 0):
        self.K = int(K)
        self.row_offset = int(row_offset)
        #: quantizer centroids (K, K) float32, fixed between builds
        self.centroids: Optional[np.ndarray] = None
        self._cn: Optional[torch.Tensor] = None   # normalized centroids
        self.assign: Optional[np.ndarray] = None  # (owned,) cell ids
        self._members: list = [np.zeros(0, np.int64)
                               for _ in range(self.K)]
        self.owned = 0
        #: rows that changed cell since the last build (the engine's
        #: re-quantization signal)
        self.moved_rows = 0
        self.builds = 0
        self.updates = 0
        self._zn_ref = None                # identity key of the cache
        self._cells_cache: dict = {}

    # -- quantization ------------------------------------------------------

    def _assign_cells(self, Zn: torch.Tensor,
                      rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Nearest-centroid cell per row: the argmax of its fixed-order
        scores against the normalized centroids, ties to the lowest cell
        (int32 numpy)."""
        sub = Zn if rows is None else Zn[torch.as_tensor(
            rows, device=Zn.device).long()]
        if sub.shape[0] == 0:
            return np.zeros(0, np.int32)
        s = row_scores(sub, self._cn.to(sub.device))
        return torch.argmax(s, dim=1).to(torch.int32).cpu().numpy().copy()

    def build(self, Zn: Optional[torch.Tensor], centroids) -> None:
        """Quantize every owned row under `centroids`.  A class with no
        labelled node has an all-zero centroid, which normalizes to zero
        (never NaN): it wins no row and its cell stays empty."""
        t0 = obs.tick()
        self.centroids = np.array(centroids, np.float32)
        if self.centroids.shape != (self.K, self.K):
            raise ValueError(f"centroids have shape {self.centroids.shape},"
                             f" expected ({self.K}, {self.K})")
        dev = Zn.device if Zn is not None else torch.device("cpu")
        self._cn = Q.normalize_rows(torch.as_tensor(self.centroids,
                                                    device=dev))
        self.owned = int(Zn.shape[0]) if Zn is not None else 0
        self.assign = (self._assign_cells(Zn) if self.owned
                       else np.zeros(0, np.int32))
        self._members = [np.nonzero(self.assign == c)[0].astype(np.int64)
                         for c in range(self.K)]   # sorted ids
        self.moved_rows = 0
        self.builds += 1
        self._drop_cache()
        if obs.enabled():
            obs.observe("repro_index_build_seconds", obs.tock(t0))
            obs.counter("repro_index_builds_total")

    def update_rows(self, Zn: torch.Tensor, local_rows) -> int:
        """Re-assign exactly `local_rows` (the rows an edge batch
        touched) against the build-time centroids; returns how many
        changed cell.  O(batch) assignments and a sorted splice per
        affected cell (a binary search and one copy of its list)."""
        if self.assign is None:
            raise RuntimeError("IVFIndex.update_rows before build()")
        t0 = obs.tick()
        rows = np.unique(np.asarray(local_rows, np.int64))
        if rows.size and (rows[0] < 0 or rows[-1] >= self.owned):
            raise IndexError(f"local rows outside [0, {self.owned})")
        moved = 0
        if rows.size:
            new = self._assign_cells(Zn, rows)
            old = self.assign[rows]
            changed = new != old
            moved = int(changed.sum())
            if moved:
                mrows, mold, mnew = rows[changed], old[changed], \
                    new[changed]
                # sorted splices by binary search (`mrows` is sorted and
                # holds each row once): the reference's setdiff1d /
                # union1d give the same lists but sort whole cells
                for c in np.unique(mold):
                    m = self._members[c]
                    self._members[c] = np.delete(
                        m, np.searchsorted(m, mrows[mold == c]))
                for c in np.unique(mnew):
                    m, add = self._members[c], mrows[mnew == c]
                    self._members[c] = np.insert(
                        m, np.searchsorted(m, add), add)
                self.assign[rows] = new
                self.moved_rows += moved
        self.updates += 1
        self._drop_cache()                 # Zn changed under the delta
        if obs.enabled():
            obs.observe("repro_index_update_seconds", obs.tock(t0))
            obs.counter("repro_index_updates_total")
            if moved:
                obs.counter("repro_index_moved_rows_total", moved)
        return moved

    @property
    def churn(self) -> float:
        """Fraction of owned rows that changed cell since the last
        build."""
        return self.moved_rows / max(self.owned, 1)

    def cell_sizes(self) -> np.ndarray:
        """Rows per cell (K,), summing to `owned`."""
        return np.array([m.shape[0] for m in self._members], np.int64)

    # -- query -------------------------------------------------------------

    def _drop_cache(self) -> None:
        self._zn_ref = None
        self._cells_cache.clear()

    def _cell_matrix(self, Zn: torch.Tensor, c: int):
        """(rows on Zn's device, global ids int32) of cell `c`, gathered
        once per Zn tensor."""
        if self._zn_ref is not Zn:
            self._zn_ref = Zn
            self._cells_cache.clear()
        hit = self._cells_cache.get(c)
        if hit is None:
            rows = self._members[c]
            hit = (Zn[torch.as_tensor(rows, device=Zn.device)],
                   (rows + self.row_offset).astype(np.int32))
            self._cells_cache[c] = hit
        return hit

    def topk(self, Zn: torch.Tensor, q: torch.Tensor, qnodes, probe, *,
             k: int, block_rows: int = 1 << 14):
        """Exact top-k of unit-norm queries `q` against this shard's rows
        in the probed cells.

        `probe` is the engine's (nq, nprobe) cell choice, shared by all
        shards.  Returns ``(idx (nq, k) int32, val (nq, k) float32,
        rows_scanned)`` as numpy, global ids in ``(-score, id)`` order,
        -1 / -inf where fewer than k rows were probed."""
        qnodes = np.asarray(qnodes, np.int32)
        probe = np.asarray(probe)
        nq = int(q.shape[0])
        vals = np.full((nq, k), -np.inf, np.float32)
        idxs = np.full((nq, k), -1, np.int32)
        scanned = 0
        for c in np.unique(probe):
            if c < 0 or not self._members[c].size:
                continue                   # empty cell: nothing to score
            qsel = np.nonzero((probe == c).any(axis=1))[0]
            Zc, ids = self._cell_matrix(Zn, int(c))
            pi, pv = Q.topk_cosine_ids(
                Zc, ids, q[torch.as_tensor(qsel, device=q.device)],
                qnodes[qsel], k=k, block_rows=block_rows)
            scanned += int(self._members[c].size) * int(qsel.size)
            mi, mv = Q.merge_topk([idxs[qsel], pi], [vals[qsel], pv], k=k)
            idxs[qsel], vals[qsel] = mi, mv
        return idxs, vals, scanned
