"""Transport error taxonomy (the port of `repro.transport.errors`).

The hierarchy encodes the router's failure-routing policy, not just
"what broke":

* `TransportError` — the connection/protocol layer failed (refused,
  reset, torn frame, timeout).  For **idempotent reads** the client
  retries with jittered backoff and a fresh connection; for writes it
  surfaces immediately — a dead owner must error loudly, never
  silently re-apply a mutation.
* `FrameError` — a frame failed its length/CRC discipline (torn or
  bit-flipped bytes).  Always connection-fatal: the stream position is
  unknowable after a bad frame, so the client drops the socket and
  (for idempotent calls) re-establishes.
* `CallTimeout` — the per-call deadline expired.  A `TransportError`,
  so reads retry; the request MAY still execute on the server, which
  is exactly why only idempotent methods opt in.
* `RemoteCallError` — the wire worked; the remote handler raised
  something we don't map back to a builtin.  Never retried (the
  failure is deterministic).
* `ReplicaLagError` — a version-pinned read reached a replica that has
  not yet applied the pinned version (or lacks the index the read
  needs).  Not a fault: the router falls back to the owner and surfaces
  the lag through `engine.health()`.
"""
from __future__ import annotations


class TransportError(ConnectionError):
    """Connection/protocol-level failure (retryable for idempotent reads)."""


class FrameError(TransportError):
    """A length/CRC-framed message failed its framing discipline."""


class CallTimeout(TransportError):
    """The per-call deadline expired before a response frame arrived."""


class RemoteCallError(RuntimeError):
    """The remote handler raised; carries the remote type and message."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype
        self.message = message


class ReplicaLagError(RuntimeError):
    """A version-pinned read outran the replica's applied WAL position."""

    def __init__(self, message: str, *, have: int = -1, want: int = -1):
        super().__init__(message)
        self.have = int(have)
        self.want = int(want)


#: wire name -> exception class for errors that must survive the RPC
#: boundary with their TYPE intact (the engine's routing logic branches
#: on them: IndexError = bad node ids, ReplicaLagError = fall back to
#: the owner, ...).  Anything else comes back as RemoteCallError.
WIRE_EXCEPTIONS = {
    "IndexError": IndexError,
    "KeyError": KeyError,
    "ValueError": ValueError,
    "TypeError": TypeError,
    "RuntimeError": RuntimeError,
    "AssertionError": AssertionError,
    "NotImplementedError": NotImplementedError,
    "ReplicaLagError": ReplicaLagError,
}


def to_wire_error(exc: BaseException) -> tuple[str, str]:
    """(etype, message) for the response frame."""
    return type(exc).__name__, str(exc)


def from_wire_error(etype: str, message: str) -> BaseException:
    cls = WIRE_EXCEPTIONS.get(etype)
    if cls is None:
        return RemoteCallError(etype, message)
    return cls(message)
