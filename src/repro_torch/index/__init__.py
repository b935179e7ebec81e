"""repro_torch.index — the IVF index over a served embedding (the port
of `repro.index`).

GEE rows gather around their class centroids, so the centroids are a
free coarse quantizer: `IVFIndex` (`ivf.py`) assigns every owned row of
a shard to its nearest centroid and keeps one sorted member list per
cell; a query scores only the `nprobe` cells nearest it.  Probing all K
cells partitions the rows, and every top-k orders candidates by
``(-score, ascending global id)`` with one fixed-order score, so
``nprobe = K`` is the exact scan bit for bit.  The engine owns the
shared centroids and the churn-gated re-quantization
(`ServingEngine.query_topk(mode="ivf")`).
"""
from repro_torch.index.ivf import DEFAULT_NPROBE, IVFIndex

__all__ = ["DEFAULT_NPROBE", "IVFIndex"]
