"""Persistent cross-process plan cache: tier 2 of `Embedder.plan`.

The port of `repro.encoder.plan_cache`.  Tier 1 (in `Embedder`) matches
plans by array identity and dies with the process.  This tier stores
each plan's **host half** (`Backend.plan_host`: for the cuda backend
the row-offset layout's arrays, for the owned-rows plans the bucketed
contributions, Laplacian weights where they are an artifact) on disk,
keyed on

    (package, graph fingerprint, backend name, backend plan_version,
     config fields, backend cache context)

so a fresh process skips the host half and goes straight to
`Backend.plan_finalize` (the uploads).

The port's backend names (numpy, torch, cuda, streaming) share two with
the reference's, and its host arrays differ, so every entry's metadata
carries ``"package": "repro_torch"`` and the default directory has a
name of its own: the two packages pointed at one directory never read
each other's entries.

Location: ``$REPRO_PLAN_CACHE`` if set (the values ``0 / off / none /
disable(d)`` or empty disable the tier), else
``$XDG_CACHE_HOME/repro-gee-torch/plans`` (``~/.cache/...``).

Robustness contract (the reference's, tested):
  * writes are atomic (tmp file + os.replace): a crashed writer never
    leaves a partial entry visible;
  * entries are versioned (format + per-backend plan_version) and
    self-describing: a stale entry is a miss and is rebuilt;
  * a corrupt entry (truncated, garbage) is deleted and rebuilt: the
    cache can cost a rebuild, never a wrong answer;
  * a hit is verified against the request's full metadata, so a key
    collision is a miss;
  * ``max_entries=`` / ``max_bytes=`` (or ``REPRO_PLAN_CACHE_MAX_ENTRIES``
    / ``REPRO_PLAN_CACHE_MAX_BYTES`` for the default cache) evict the
    least recently used entries after each store; a hit touches the
    entry's mtime, so recency lives in the file system.

``python -m repro_torch.encoder.plan_cache --stats|--clear`` inspects or
wipes the directory from the shell.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from repro_torch import obs

FORMAT_VERSION = 1
PACKAGE = "repro_torch"
_META_KEY = "__meta__"
_OFF_VALUES = ("", "0", "off", "none", "disable", "disabled")


def config_token(config) -> str:
    """Canonical string of the config fields a plan depends on.  The
    `backend` field is left out (the resolved backend NAME is its own
    key component, so "auto" and the name it resolves to share
    entries); `row_partition` is in it, so a resharded deployment never
    hits another slice's plan."""
    d = {k: v for k, v in asdict(config).items() if k != "backend"}
    return json.dumps(d, sort_keys=True)


class PlanDiskCache:
    """Content-addressed npz store for plan host halves.

    `max_entries` / `max_bytes` (None = unbounded) cap the directory;
    a store that pushes it over evicts the least recently used entries
    (`last_used` = file mtime, refreshed on every hit)."""

    def __init__(self, root, *, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.root = Path(root)
        self.max_entries = max_entries
        self.max_bytes = max_bytes

    # -- keying -----------------------------------------------------------

    def describe(self, fingerprint: str, backend, config, *,
                 mesh=None) -> Dict[str, Any]:
        """The full metadata a cached entry must match to be served."""
        return {"format": FORMAT_VERSION,
                "package": PACKAGE,
                "fingerprint": fingerprint,
                "backend": backend.name,
                "plan_version": backend.plan_version,
                "config": config_token(config),
                "context": backend.cache_context(mesh=mesh)}

    @staticmethod
    def key(meta: Dict[str, Any]) -> str:
        blob = json.dumps(meta, sort_keys=True).encode()
        return hashlib.blake2b(blob, digest_size=16).hexdigest()

    def path(self, meta: Dict[str, Any]) -> Path:
        return self.root / (self.key(meta) + ".npz")

    # -- load / store -----------------------------------------------------

    def load(self, meta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The stored host dict, or None (miss, stale or corrupt).  A
        corrupt entry is deleted so the rebuild's store replaces it."""
        path = self.path(meta)
        if not path.exists():
            return None
        try:
            with np.load(path, allow_pickle=False) as d:
                stored = json.loads(str(d[_META_KEY][()]))
                if stored != meta:
                    obs.counter("repro_encoder_plan_cache_total",
                                event="stale")
                    return None                       # stale / collision
                host = {k: d[k] for k in d.files if k != _META_KEY}
            try:
                os.utime(path)          # refresh last_used for the LRU
            except OSError:
                pass
            return host
        except Exception:
            obs.counter("repro_encoder_plan_cache_total", event="corrupt")
            try:
                path.unlink()
            except OSError:
                pass
            return None

    def store(self, meta: Dict[str, Any], host: Dict[str, Any]) -> bool:
        """Atomically persist `host` under `meta`'s key.  Best-effort: an
        unwritable directory never breaks an embedding."""
        path = self.path(meta)
        tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            with open(tmp, "wb") as f:
                np.savez(f, **{_META_KEY: np.asarray(json.dumps(meta))},
                         **host)
            os.replace(tmp, path)
            self.evict()
            return True
        except Exception:
            try:
                tmp.unlink()
            except OSError:
                pass
            return False

    # -- maintenance ------------------------------------------------------

    def entries(self) -> list[Path]:
        if not self.root.is_dir():
            return []
        return sorted(self.root.glob("*.npz"))

    def evict(self) -> int:
        """Drop least recently used entries until the directory fits
        `max_entries` / `max_bytes`; returns how many went.  Races with
        other processes and unwritable directories are ignored."""
        if self.max_entries is None and self.max_bytes is None:
            return 0
        stats = []
        for p in self.entries():
            try:
                st = p.stat()
                stats.append((st.st_mtime, p.name, st.st_size, p))
            except OSError:
                continue
        stats.sort()                    # oldest last_used first
        total = sum(s[2] for s in stats)
        removed = 0
        while stats and (
                (self.max_entries is not None
                 and len(stats) > self.max_entries)
                or (self.max_bytes is not None
                    and total > self.max_bytes)):
            _, _, size, path = stats.pop(0)
            try:
                path.unlink()
                removed += 1
            except OSError:
                pass
            total -= size
        if removed:
            obs.counter("repro_encoder_plan_cache_total", removed,
                        event="evict")
        return removed

    def stats(self) -> Dict[str, Any]:
        """Directory summary for the CLI and observability."""
        entries = []
        for p in self.entries():
            try:
                st = p.stat()
                entries.append((st.st_mtime, st.st_size))
            except OSError:
                continue
        now = time.time()
        return {"root": str(self.root),
                "entries": len(entries),
                "bytes": sum(s for _, s in entries),
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "oldest_idle_s": (now - min(m for m, _ in entries)
                                  if entries else 0.0),
                "newest_idle_s": (now - max(m for m, _ in entries)
                                  if entries else 0.0)}

    def clear(self) -> int:
        """Delete every entry; returns how many were removed."""
        removed = 0
        for p in self.entries():
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
        return removed


def _env_limit(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return None
    try:
        val = int(raw)
    except ValueError:
        return None
    return val if val > 0 else None


def default_cache() -> Optional[PlanDiskCache]:
    """The process-wide default cache from the environment (None: the
    persistent tier is off)."""
    limits = {"max_entries": _env_limit("REPRO_PLAN_CACHE_MAX_ENTRIES"),
              "max_bytes": _env_limit("REPRO_PLAN_CACHE_MAX_BYTES")}
    env = os.environ.get("REPRO_PLAN_CACHE")
    if env is not None:
        if env.strip().lower() in _OFF_VALUES:
            return None
        return PlanDiskCache(env, **limits)
    base = os.environ.get("XDG_CACHE_HOME") or (Path.home() / ".cache")
    return PlanDiskCache(Path(base) / "repro-gee-torch" / "plans", **limits)


def resolve_cache(plan_cache) -> Optional[PlanDiskCache]:
    """An Embedder's `plan_cache` argument as a cache or None: "auto"
    (the default cache), None or False (off), a path, or a
    PlanDiskCache."""
    if isinstance(plan_cache, str) and plan_cache == "auto":
        return default_cache()
    if plan_cache is None or plan_cache is False:
        return None
    if isinstance(plan_cache, (str, os.PathLike)):
        return PlanDiskCache(plan_cache)
    return plan_cache


def main(argv=None) -> int:
    """CLI: inspect or clear the persistent plan cache.

        python -m repro_torch.encoder.plan_cache --stats
        python -m repro_torch.encoder.plan_cache --clear
        python -m repro_torch.encoder.plan_cache --dir /path --stats
    """
    ap = argparse.ArgumentParser(
        prog="repro_torch.encoder.plan_cache",
        description="Inspect or clear the persistent GEE plan cache.")
    ap.add_argument("--dir", default=None,
                    help="cache directory (default: the resolved "
                         "REPRO_PLAN_CACHE / XDG location)")
    ap.add_argument("--stats", action="store_true",
                    help="print entry count / bytes / idle ages "
                         "(the default action)")
    ap.add_argument("--clear", action="store_true",
                    help="delete every cached entry")
    args = ap.parse_args(argv)
    cache = (PlanDiskCache(args.dir) if args.dir is not None
             else default_cache())
    if cache is None:
        print("plan cache disabled (REPRO_PLAN_CACHE="
              f"{os.environ.get('REPRO_PLAN_CACHE')!r})")
        return 1
    if args.clear:
        print(f"cleared {cache.clear()} entr(y|ies) from {cache.root}")
    if args.stats or not args.clear:
        st = cache.stats()
        print(f"root:        {st['root']}")
        print(f"entries:     {st['entries']}")
        print(f"bytes:       {st['bytes']:,}")
        print(f"limits:      max_entries={st['max_entries']} "
              f"max_bytes={st['max_bytes']}")
        if st["entries"]:
            print(f"oldest idle: {st['oldest_idle_s']:.0f}s   "
                  f"newest idle: {st['newest_idle_s']:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
