"""Wire format: length-prefixed CRC frames + a self-describing codec.

The port of `repro.transport.framing`: the frames and the codec's bytes
are the reference's, object for object, so a port process and a
reference process speak to each other.  The frame discipline is the
WAL's (`repro_torch.serving.wal`), applied to a socket instead of a log
file:

    [u32 payload_len][u32 crc32(payload)][payload]

A short read or a CRC mismatch raises `FrameError` — after a torn
frame the stream position is meaningless, so framing errors are always
connection-fatal (the RPC client drops the socket and reconnects).
`MAX_FRAME` bounds a single message so a corrupted length prefix
cannot make the reader allocate unbounded memory.

The payload codec (`pack_obj`/`unpack_obj`) is a small tagged binary
encoding for exactly the types RPC messages need — None, bool, int,
float, str, bytes, list, tuple, dict (str keys), and **numpy arrays**
(dtype + shape + raw row-major bytes, zero-copy on decode via
`np.frombuffer`).  No pickle anywhere: a worker can never be made to
execute code by a corrupted or malicious peer, and the format is
stable across Python versions.  Tensors cross as numpy: a torch
tensor is refused (TypeError, as any other unencodable type), so a
caller converts it with ``.cpu().numpy()`` where it chooses to.
"""
from __future__ import annotations

import socket
import struct
import zlib
from typing import Any

import numpy as np

from repro_torch.transport.errors import FrameError

_HEADER = struct.Struct("<II")           # payload_len, crc32 (WAL's framing)
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

#: hard per-frame ceiling (512 MiB): a flipped length prefix must not
#: turn into an unbounded allocation
MAX_FRAME = 512 << 20

_T_NONE, _T_TRUE, _T_FALSE = b"N", b"T", b"F"
_T_INT, _T_FLOAT, _T_STR, _T_BYTES = b"i", b"f", b"s", b"b"
_T_LIST, _T_TUPLE, _T_DICT, _T_ARRAY = b"l", b"t", b"d", b"a"


# -- object codec ------------------------------------------------------------

def _pack_into(out: bytearray, obj: Any) -> None:
    if obj is None:
        out += _T_NONE
    elif obj is True:
        out += _T_TRUE
    elif obj is False:
        out += _T_FALSE
    elif isinstance(obj, (int, np.integer)):
        out += _T_INT
        out += _I64.pack(int(obj))
    elif isinstance(obj, (float, np.floating)):
        out += _T_FLOAT
        out += _F64.pack(float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _T_STR
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(obj, bytes):
        out += _T_BYTES
        out += _U32.pack(len(obj))
        out += obj
    elif isinstance(obj, np.ndarray):
        # ascontiguousarray promotes 0-d to (1,); reshape back so the
        # decoder reproduces the exact shape
        a = np.ascontiguousarray(obj).reshape(obj.shape)
        dt = a.dtype.str.encode("ascii")     # e.g. b'<f4' (endian-stamped)
        out += _T_ARRAY
        out += _U32.pack(len(dt))
        out += dt
        out += _U32.pack(a.ndim)
        for dim in a.shape:
            out += _I64.pack(dim)
        raw = a.tobytes()
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        out += _T_LIST if isinstance(obj, list) else _T_TUPLE
        out += _U32.pack(len(obj))
        for item in obj:
            _pack_into(out, item)
    elif isinstance(obj, dict):
        out += _T_DICT
        out += _U32.pack(len(obj))
        for key, val in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"dict keys must be str, got {type(key)!r}")
            raw = key.encode("utf-8")
            out += _U32.pack(len(raw))
            out += raw
            _pack_into(out, val)
    else:
        raise TypeError(f"cannot encode {type(obj)!r} for transport")


def pack_obj(obj: Any) -> bytes:
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, k: int) -> bytes:
        end = self.off + k
        if end > len(self.buf):
            raise FrameError("truncated payload inside a valid frame")
        chunk = self.buf[self.off:end]
        self.off = end
        return chunk


def _unpack_from(r: _Reader) -> Any:
    tag = r.take(1)
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return _I64.unpack(r.take(8))[0]
    if tag == _T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == _T_STR:
        return r.take(_U32.unpack(r.take(4))[0]).decode("utf-8")
    if tag == _T_BYTES:
        return r.take(_U32.unpack(r.take(4))[0])
    if tag == _T_ARRAY:
        dt = np.dtype(r.take(_U32.unpack(r.take(4))[0]).decode("ascii"))
        ndim = _U32.unpack(r.take(4))[0]
        shape = tuple(_I64.unpack(r.take(8))[0] for _ in range(ndim))
        nbytes = _U32.unpack(r.take(4))[0]
        expect = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if nbytes != expect:
            raise FrameError("array byte length disagrees with shape")
        return np.frombuffer(r.take(nbytes), dt).reshape(shape)
    if tag in (_T_LIST, _T_TUPLE):
        count = _U32.unpack(r.take(4))[0]
        items = [_unpack_from(r) for _ in range(count)]
        return items if tag == _T_LIST else tuple(items)
    if tag == _T_DICT:
        count = _U32.unpack(r.take(4))[0]
        out = {}
        for _ in range(count):
            key = r.take(_U32.unpack(r.take(4))[0]).decode("utf-8")
            out[key] = _unpack_from(r)
        return out
    raise FrameError(f"unknown codec tag {tag!r}")


def unpack_obj(buf: bytes) -> Any:
    r = _Reader(buf)
    try:
        obj = _unpack_from(r)
    except FrameError:
        raise
    except (ValueError, TypeError, OverflowError, struct.error) as e:
        # corrupted bytes must surface as the framing discipline's
        # error (connection-fatal), never leak a decoder internal
        raise FrameError(f"malformed payload: {e}") from e
    if r.off != len(buf):
        raise FrameError(f"{len(buf) - r.off} trailing bytes after payload")
    return obj


# -- socket framing ----------------------------------------------------------

def recv_exact(sock: socket.socket, k: int) -> bytes:
    """Read exactly k bytes or raise FrameError (EOF mid-message =
    a torn frame; the peer died or the stream is corrupt)."""
    chunks = []
    got = 0
    while got < k:
        chunk = sock.recv(min(k - got, 1 << 20))
        if not chunk:
            raise FrameError(f"connection closed mid-frame "
                             f"({got}/{k} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, payload: bytes) -> int:
    """Write one [len][crc][payload] frame; returns bytes on the wire."""
    if len(payload) > MAX_FRAME:
        raise FrameError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME ({MAX_FRAME})")
    header = _HEADER.pack(len(payload), zlib.crc32(payload))
    sock.sendall(header + payload)
    return len(header) + len(payload)


def recv_frame(sock: socket.socket) -> bytes:
    """Read one frame; length/CRC failures raise FrameError (the
    connection is unusable afterwards — same discipline as a torn WAL
    tail, except a socket cannot be truncated, only abandoned)."""
    header = recv_exact(sock, _HEADER.size)
    length, crc = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise FrameError(f"frame length {length} exceeds MAX_FRAME")
    payload = recv_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise FrameError("frame CRC mismatch")
    return payload


def send_msg(sock: socket.socket, obj: Any) -> int:
    return send_frame(sock, pack_obj(obj))


def recv_msg(sock: socket.socket) -> Any:
    return unpack_obj(recv_frame(sock))
