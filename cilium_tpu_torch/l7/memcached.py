"""Memcached parser with command/key ACLs.

A whole copy of ``cilium_tpu/l7/memcached.py``.

Reference: proxylib/memcached/ — parses both the text protocol
(``get key``, ``set key flags exp bytes\\r\\ndata\\r\\n`` …) and the
binary protocol (24-byte header, magic 0x80 request / 0x81 response),
enforcing rules of the form {command, key} with prefix matching;
denied text requests get an injected ``SERVER_ERROR`` line, denied
binary requests an error-status response. Partial frames carry across
on_data chunks via the proxy's re-presented buffer (no internal state).

Fresh implementation from the public memcached protocol description;
rule semantics mirror the reference's fields.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from .parser import (DROP, ERROR, INJECT, MORE, PASS, Connection,
                     OpResult, Parser, REGISTRY)

# Commands followed by a data block of <bytes> + CRLF.
STORAGE_COMMANDS = {"set", "add", "replace", "append", "prepend", "cas"}
RETRIEVAL_COMMANDS = {"get", "gets", "gat", "gats"}
KEYLESS_COMMANDS = {"stats", "flush_all", "version", "verbosity", "quit"}
OTHER_KEY_COMMANDS = {"delete", "incr", "decr", "touch"}

DENY_TEXT = b"SERVER_ERROR access denied by policy\r\n"

BINARY_REQUEST_MAGIC = 0x80
BINARY_HEADER_LEN = 24
# binary opcode -> text command family (memcached binary spec).
# Quiet (suppressed-response) variants MUST map to the same family as
# their loud counterparts — omitting them lets a client bypass the
# whole ACL with e.g. SetQ (reference: proxylib/memcached/parser.go
# MemcacheOpCodeMap maps 0x11-0x1A alongside 0x00-0x10).
BINARY_OPCODES = {
    0x00: "get", 0x01: "set", 0x02: "add", 0x03: "replace",
    0x04: "delete", 0x05: "incr", 0x06: "decr", 0x07: "quit",
    0x08: "flush_all", 0x09: "get", 0x0A: "noop", 0x0B: "version",
    0x0C: "get", 0x0D: "get", 0x0E: "append", 0x0F: "prepend",
    0x10: "stats",
    0x11: "set", 0x12: "add", 0x13: "replace", 0x14: "delete",
    0x15: "incr", 0x16: "decr", 0x17: "quit", 0x18: "flush_all",
    0x19: "append", 0x1A: "prepend",
    0x1C: "touch", 0x1D: "gat", 0x1E: "gat",
}
STATUS_ACCESS_DENIED = 0x08  # "Authentication error" family


def _key_matches(rule_key: str, key: str) -> bool:
    if rule_key in ("", "*"):
        return True
    if rule_key.endswith("*"):
        return key.startswith(rule_key[:-1])
    return key == rule_key


def rule_allows(rules, command: str, keys: List[str]) -> bool:
    """{command, key} match: every key of the request must be allowed
    by some rule (reference: per-key enforcement on multi-get)."""
    if not rules:
        return True
    field_dicts = [rule.as_dict() for rule in rules]

    def one(key: str) -> bool:
        for fields in field_dicts:
            want_cmd = fields.get("command", "")
            if want_cmd and want_cmd != command:
                continue
            if _key_matches(fields.get("key", ""), key):
                return True
        return False

    if not keys:
        return one("")
    return all(one(k) for k in keys)


def deny_binary_frame(opcode: int, opaque: int) -> bytes:
    """Binary error response with access-denied status."""
    body = b"access denied by policy"
    return struct.pack(">BBHBBHIIQ", 0x81, opcode, 0, 0, 0,
                       STATUS_ACCESS_DENIED, len(body), opaque, 0) + body


class MemcachedParser(Parser):
    """Text + binary memcached ACL parser."""

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[OpResult]:
        if reply:
            return [PASS(len(data))] if data else []
        ops: List[OpResult] = []
        pos = 0
        while pos < len(data):
            if data[pos] == BINARY_REQUEST_MAGIC:
                res, consumed = self._binary_frame(data[pos:])
            else:
                res, consumed = self._text_frame(data[pos:], end_stream)
            ops.extend(res)
            if consumed == 0:
                break
            pos += consumed
        return ops

    # ------------------------------------------------------------- text

    def _text_frame(self, data: bytes,
                    end_stream: bool) -> Tuple[List[OpResult], int]:
        nl = data.find(b"\r\n")
        if nl < 0:
            if end_stream:
                return [DROP(len(data))], len(data)
            return [MORE(1)], 0
        line = data[:nl]
        parts = line.decode("latin1").split()
        if not parts:
            return [PASS(nl + 2)], nl + 2
        command = parts[0].lower()
        frame_len = nl + 2
        keys: List[str] = []
        if command in STORAGE_COMMANDS:
            # set <key> <flags> <exptime> <bytes> [noreply]
            if len(parts) < 5:
                return [ERROR()], 0
            try:
                nbytes = int(parts[4])
            except ValueError:
                return [ERROR()], 0
            # negative sizes desync the stream; cap like the binary
            # path so a hostile <bytes> can't demand GBs of buffering
            if nbytes < 0 or nbytes > (1 << 24):
                return [ERROR()], 0
            total = frame_len + nbytes + 2  # data block + CRLF
            if len(data) < total:
                return [MORE(total - len(data))], 0
            frame_len = total
            keys = [parts[1]]
        elif command in RETRIEVAL_COMMANDS:
            keys = parts[1:] if command in ("get", "gets") else parts[2:]
        elif command in OTHER_KEY_COMMANDS:
            keys = parts[1:2]
        elif command not in KEYLESS_COMMANDS:
            # Unknown command (e.g. meta commands mg/ms): when rules
            # exist we cannot key-check it OR know its payload length,
            # so dropping just the line would desync the stream (the
            # payload re-parses as commands).  Fail the parse — the
            # proxy resets the connection (proxylib parse-error
            # semantics).  Without rules, pass best-effort.
            if self.connection.l7_rules:
                return [ERROR()], 0
            return [PASS(frame_len)], frame_len
        if rule_allows(self.connection.l7_rules, command, keys):
            return [PASS(frame_len)], frame_len
        return [DROP(frame_len), INJECT(DENY_TEXT)], frame_len

    # ----------------------------------------------------------- binary

    def _binary_frame(self, data: bytes) -> Tuple[List[OpResult], int]:
        if len(data) < BINARY_HEADER_LEN:
            return [MORE(BINARY_HEADER_LEN - len(data))], 0
        (magic, opcode, key_len, extras_len, _dtype, _vbucket,
         body_len, opaque, _cas) = struct.unpack(">BBHBBHIIQ",
                                                 data[:BINARY_HEADER_LEN])
        total = BINARY_HEADER_LEN + body_len
        if body_len > (1 << 24) or key_len + extras_len > body_len:
            return [ERROR()], 0
        if len(data) < total:
            return [MORE(total - len(data))], 0
        command = BINARY_OPCODES.get(opcode, "")
        key_start = BINARY_HEADER_LEN + extras_len
        key = data[key_start:key_start + key_len].decode("latin1")
        keys = [key] if key else []
        if not command and self.connection.l7_rules:
            # Unmapped opcode with rules present: fail closed (an
            # unknown mutation opcode must not slip past the ACL).
            return [DROP(total),
                    INJECT(deny_binary_frame(opcode, opaque))], total
        if not command or rule_allows(self.connection.l7_rules,
                                      command, keys):
            return [PASS(total)], total
        return [DROP(total), INJECT(deny_binary_frame(opcode, opaque))], \
            total


REGISTRY.register("memcache", MemcachedParser)
REGISTRY.register("memcached", MemcachedParser)
