# NOTE: no XLA_FLAGS here by design — smoke tests and benches must see
# the real single CPU device; only launch/dryrun.py (and explicit
# subprocess tests) request 512 placeholder devices.
import os
import zlib

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (subprocess compile / "
        "crash-recovery / fuzz) tests — excluded from the CI fast "
        "lane (`make test-fast`), run by the slow lane")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (repro_torch kernels); "
        "skips without one")
    # Hermetic tests: the encoder's PERSISTENT plan-cache tier would
    # otherwise write to the user's real cache dir and make identity-
    # tier counter assertions order-dependent.  Tests that exercise the
    # persistent tier opt back in with explicit plan_cache dirs (or set
    # the env var themselves in subprocesses).
    os.environ["REPRO_PLAN_CACHE"] = "off"
    # Same hermeticity for observability: never append test spans to a
    # user's JSONL trace sink (tests that exercise the sink point it at
    # tmp_path via obs.configure).
    os.environ.pop("REPRO_OBS_TRACE", None)


@pytest.fixture
def rng(request):
    """THE test-suite RNG seeding path: a reproducible per-test stream.

    The seed is derived from the test's stable node id (file + class +
    name + params), so every test gets an independent stream that is
    identical across runs and workers — no global seeding, no
    order-dependence, and two tests can never accidentally share a
    stream.  Tests that must replay the *same* stream twice inside one
    test body should fork with ``rng.spawn()`` or draw arrays once and
    reuse them."""
    return np.random.default_rng(
        zlib.adler32(request.node.nodeid.encode()))


def topk_equivalent(idx_a, val_a, idx_b, val_b, atol=1e-5):
    """Assert two top-k answers agree, tie-tolerantly BY SCORE.

    NOTE: the serving kernels themselves are now bit-stable — every
    top-k surface in `repro.serving.queries` breaks score ties by
    ascending global id, so sharded / single-host / IVF answers from
    the SAME Z can (and in the engine tests do) use plain
    `np.array_equal`.  This fixture remains for cross-implementation
    comparisons where the *scores* differ in float low bits (different
    reduction orders: delta-folded vs rebuilt Z, gee vs gee_streaming),
    which can legitimately reorder near-tied candidates:

    * the (row-wise descending) score vectors match everywhere;
    * every slot separated from BOTH neighbors by more than `atol` —
      where the winning candidate is uniquely determined — carries the
      same index (this catches right-score/wrong-id stamping bugs that
      a score-only comparison would miss).

    The LAST slot is never index-checked: it can tie with the (k+1)-th
    candidate, which is invisible in the output."""
    val_a, val_b = np.asarray(val_a), np.asarray(val_b)
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    np.testing.assert_allclose(val_a, val_b, atol=atol)
    with np.errstate(invalid="ignore"):      # -inf pads diff to nan
        gap = (val_a[:, :-1] - val_a[:, 1:]) > atol   # nan -> tied
    no_tie = np.ones(idx_a.shape, bool)
    no_tie[:, 1:] &= gap
    no_tie[:, :-1] &= gap
    no_tie[:, -1] = False
    np.testing.assert_array_equal(idx_a[no_tie], idx_b[no_tie])


@pytest.fixture(name="assert_topk_equivalent")
def _assert_topk_equivalent():
    """The shared tie-tolerant top-k assertion (see `topk_equivalent`)."""
    return topk_equivalent
