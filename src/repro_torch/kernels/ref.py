"""Plain PyTorch oracles for the GEE kernels (the allclose ground truth)."""
from __future__ import annotations

import torch

from repro_torch.core.gee import edge_contributions, make_w


def gee_scatter_ref(dst, cls, val, n: int, K: int) -> torch.Tensor:
    """Segment-sum oracle for the gee_scatter kernel."""
    Z = torch.zeros((n, K), dtype=torch.float32, device=dst.device)
    return Z.index_put_((dst.long(), cls.long()), val.to(torch.float32),
                        accumulate=True)


def gee_ref(u, v, w, Y, n: int, K: int) -> torch.Tensor:
    Wv = make_w(Y, K)
    dst, cls, val = edge_contributions(u, v, w.to(torch.float32), Y, Wv)
    return gee_scatter_ref(dst, cls, val, n, K)
