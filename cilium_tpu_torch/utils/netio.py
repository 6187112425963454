"""Byte-exact socket reads of the verdict service.

Copy of ``recv_exact`` and ``recv_exact_within`` from
``cilium_tpu/utils/netio.py``: linear-time reads into a preallocated
buffer with ``recv_into``.
"""

from __future__ import annotations

import socket
import time
from typing import Optional


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
