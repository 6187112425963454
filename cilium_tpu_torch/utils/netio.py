"""Shared socket byte-exact IO.

A whole copy of ``cilium_tpu/utils/netio.py``.

One definition of the exact-read loop used by every TCP surface
(kvstore transport, verdict service) — linear-time via a preallocated
bytearray + recv_into, not O(n^2) bytes concatenation.
"""

from __future__ import annotations

import socket
import time
from typing import Optional


def teardown_http_conn(conn) -> None:
    """Kill a (possibly streaming) http.client.HTTPConnection without
    blocking, PERMANENTLY: close() drains any open chunked response
    first, which blocks forever on a live stream — shutdown() the raw
    socket so the drain reads EOF instantly.  auto_open is cleared
    because http.client otherwise silently RECONNECTS on the next
    request over a closed conn, resurrecting a socket its killer can
    no longer reach (the racing user gets NotConnected instead).
    Safe on a never-connected conn."""
    conn.auto_open = 0
    sock = getattr(conn, "sock", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    try:
        conn.close()
    except OSError:
        pass


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on EOF or socket error."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except OSError:
            return None
        if r == 0:
            return None
        got += r
    return bytes(buf)


def recv_exact_within(sock: socket.socket, n: int,
                      timeout: float) -> Optional[bytes]:
    """``recv_exact`` under an OVERALL deadline (not per-chunk: a
    peer trickling one byte per interval must still hit the budget).
    The socket's previous timeout is restored afterwards.  None on
    EOF, error, or deadline expiry."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    deadline = time.monotonic() + timeout
    try:
        old = sock.gettimeout()
    except OSError:
        return None
    try:
        while got < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                sock.settimeout(remaining)
                r = sock.recv_into(view[got:], n - got)
            except OSError:
                return None
            if r == 0:
                return None
            got += r
        return bytes(buf)
    finally:
        try:
            sock.settimeout(old)
        except OSError:
            pass
