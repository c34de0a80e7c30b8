"""Wire format shared by the SQL server and client: length-prefixed JSON.

One frame = a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON. JSON because every result row is scalars (ids,
labels, margins); length-prefixing because it needs no escaping, works on
any stream transport, and lets both sides read exactly one message
without a streaming parser.

Requests (client -> server), one object per frame:

  {"op": "query",   "sql": "<';'-separated statements>"}
  {"op": "execute", "name": "<prepared name>", "params": [..]}
  {"op": "ping"}
  {"op": "metrics"}
  {"op": "close"}

Responses (server -> client), one object per frame:

  {"ok": true,  "results": [{"columns": [...], "rows": [[...], ...],
                             "epoch": E, "plan": "...", "tiers": [...],
                             "elapsed_us": T, "phases": {"parse": ..}}],
   "session": S, "elapsed_us": T}
  {"ok": true,  "metrics": {"counters": .., "gauges": .., "histograms": ..,
                            "collectors": .., "epoch": E}, "session": S}
  {"ok": false, "error": "...", "error_type": "SqlError|..."}

`epoch` is the committed WAL batch index the statement was pinned at —
the snapshot version a reader observed, the post-commit index for DML.
`metrics` is the executor's unified telemetry snapshot (the same payload
`SHOW METRICS` flattens); per-result `elapsed_us`/`phases` come from the
statement's span tree, so the wire, EXPLAIN ANALYZE, and the REPL footer
all report one per-phase breakdown.
"""
from __future__ import annotations

import json
import struct

import numpy as np

# A result frame is bounded by LIMIT/row-count, not by n; 64 MiB is far
# above any legitimate frame and fails fast on a desynced stream.
MAX_FRAME = 64 * 1024 * 1024
_LEN = struct.Struct(">I")


class WireError(RuntimeError):
    pass


def _default(o):
    """JSON fallback for the numpy scalars engine rows carry."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def encode_frame(obj) -> bytes:
    payload = json.dumps(obj, default=_default,
                         separators=(",", ":")).encode()
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame of {len(payload)} bytes exceeds "
                        f"MAX_FRAME = {MAX_FRAME}")
    return _LEN.pack(len(payload)) + payload


def decode_payload(payload: bytes):
    return json.loads(payload.decode())


def frame_length(header: bytes) -> int:
    """Validate + decode the 4-byte length prefix."""
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME = "
                        f"{MAX_FRAME} (desynced stream?)")
    return length


def recv_frame(sock):
    """Blocking read of one frame from a socket (client side); returns the
    decoded object or None on clean EOF at a frame boundary."""
    header = _recv_exact(sock, _LEN.size, eof_ok=True)
    if header is None:
        return None
    payload = _recv_exact(sock, frame_length(header))
    return decode_payload(payload)


def send_frame(sock, obj):
    sock.sendall(encode_frame(obj))


def _recv_exact(sock, n: int, *, eof_ok: bool = False):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise WireError(f"connection closed mid-frame "
                            f"({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)
