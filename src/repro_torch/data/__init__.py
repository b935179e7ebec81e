"""Data pipeline: deterministic host-sharded synthetic streams (the
port's numpy-only copy of `repro.data`)."""
