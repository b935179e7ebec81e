"""EncoderConfig: everything about *what* to compute, and the tuning
knobs that never change the answer.

The port of `repro.encoder.config.EncoderConfig`.  The Pallas
`interpret` switch has no meaning in the port and is left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Configuration for :class:`repro_torch.encoder.Embedder`.

    Math-level options (change Z):
      K           number of classes / embedding dimension.
      laplacian   Laplacian scaling w' = w/sqrt(deg_u*deg_v), applied
                  once at plan time.
      dtype       output dtype of ``transform``; Z is accumulated in
                  float32.

    Refinement (``Embedder.refine``):
      refine_iters   embed -> k-means -> reassign rounds.
      kmeans_iters   k-means steps per round.

    Row partitioning:
      row_partition  (lo, hi) global row range this Embedder OWNS, or
                  None for the full embedding.  The plan buckets the
                  contributions by owned destination, Z_ holds only the
                  (hi - lo, K) owned rows; labels and node ids stay
                  global.

    Backend tuning (never change Z):
      backend     registry name or "auto" (resolved at plan time).
      tile_n      the scatter kernel's tile (rows per thread block).
      edge_block  the reference's packing granule, kept so the fields
                  mirror the reference's; the cuda backend's row-offset
                  layout has no blocks and ignores it.
      chunk_size           streaming chunk length.
      capacity_factor      the distributed modes' bucket padding; None
                  measures the exact zero-drop factor from the owner
                  histogram (cached in the plan).
    """

    K: int
    laplacian: bool = False
    dtype: str = "float32"
    backend: str = "auto"
    row_partition: Optional[Tuple[int, int]] = None
    # refinement
    refine_iters: int = 10
    kmeans_iters: int = 3
    # cuda kernel geometry (edge_block: ignored, see above)
    tile_n: int = 256
    edge_block: int = 512
    # streaming
    chunk_size: int = 1 << 20
    # distributed
    capacity_factor: Optional[float] = None

    def __post_init__(self) -> None:
        if self.K < 1:
            raise ValueError(f"K must be >= 1, got {self.K}")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if self.tile_n < 1 or self.edge_block < 1:
            raise ValueError("tile_n and edge_block must be >= 1")
        if self.row_partition is not None:
            try:
                lo, hi = self.row_partition
            except (TypeError, ValueError):
                raise ValueError(
                    f"row_partition must be a (lo, hi) pair, got "
                    f"{self.row_partition!r}") from None
            if not (0 <= int(lo) < int(hi)):
                raise ValueError(
                    f"row_partition needs 0 <= lo < hi, got ({lo}, {hi})")
            object.__setattr__(self, "row_partition",
                               (int(lo), int(hi)))
