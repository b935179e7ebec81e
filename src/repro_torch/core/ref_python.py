"""Host oracles for GEE (own copy of `repro.core.ref_python`).

* ``gee_python``  — Algorithm 1 taken literally: a serial Python loop.
* ``gee_numpy``   — vectorized ``np.add.at`` scatter; the `numpy`
  backend and the host oracle every other backend is checked against.

Label convention Y in {-1 unknown, 0..K-1}.
"""
from __future__ import annotations

import numpy as np


def make_w(Y: np.ndarray, K: int) -> np.ndarray:
    """Per-node projection value: 1/count(class(Y)) for labeled, else 0
    (computed in float64, then rounded to float32)."""
    counts = np.bincount(Y[Y >= 0], minlength=K).astype(np.float64)
    inv = np.where(counts > 0, 1.0 / np.maximum(counts, 1), 0.0)
    w = np.where(Y >= 0, inv[np.maximum(Y, 0)], 0.0)
    return w.astype(np.float32)


def gee_python(u, v, w, Y, K: int, n: int) -> np.ndarray:
    """Algorithm 1, literal serial loop (slow on purpose)."""
    Wv = make_w(np.asarray(Y), K)
    Z = np.zeros((n, K), np.float64)
    for i in range(len(u)):
        ui, vi, wi = int(u[i]), int(v[i]), float(w[i])
        yv, yu = int(Y[vi]), int(Y[ui])
        if yv >= 0:
            Z[ui, yv] += Wv[vi] * wi
        if yu >= 0:
            Z[vi, yu] += Wv[ui] * wi
    return Z.astype(np.float32)


def gee_numpy(u, v, w, Y, K: int, n: int) -> np.ndarray:
    """Vectorized single-pass scatter."""
    Y = np.asarray(Y)
    Wv = make_w(Y, K)
    Z = np.zeros((n, K), np.float32)
    yv, yu = Y[v], Y[u]
    mv, mu = yv >= 0, yu >= 0
    np.add.at(Z, (u[mv], yv[mv]), Wv[v[mv]] * w[mv])
    np.add.at(Z, (v[mu], yu[mu]), Wv[u[mu]] * w[mu])
    return Z


def gee_numpy_owned(rows, src, w, Y, Wv, K: int, n_local: int
                    ) -> np.ndarray:
    """Owned-rows scatter over pre-bucketed (local row, global source,
    weight) contributions, with the caller's projection weights Wv."""
    Y = np.asarray(Y)
    Wv = np.asarray(Wv, np.float32)
    Z = np.zeros((n_local, K), np.float32)
    ys = Y[src]
    m = ys >= 0
    np.add.at(Z, (rows[m], ys[m]), Wv[src[m]] * w[m])
    return Z
