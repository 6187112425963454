"""Cassandra CQL parser with per-query table ACLs.

A whole copy of ``cilium_tpu/l7/cassandra.py``.

Reference: proxylib/cassandra/cassandraparser.go — parses the CQL
binary protocol (9-byte frame header: version, flags, stream id,
opcode, length), extracts the query action and target table from QUERY/
PREPARE/BATCH frames, and enforces rules of the form
{query_action, query_table}; denied requests are dropped and an
Unauthorized ERROR frame is injected back to the client so drivers fail
cleanly. State (partial frames) carries across on_data chunks.

This is a fresh implementation of the wire format from the public CQL
spec; rule semantics mirror the reference's fields.
"""

from __future__ import annotations

import hashlib
import re
import struct
from typing import Dict, List, Optional, Tuple

from .parser import (DROP, ERROR, INJECT, MORE, PASS, Connection, OpResult,
                     Parser, REGISTRY)

HEADER_LEN = 9

# CQL opcodes (request direction).
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_OPTIONS = 0x05
OP_QUERY = 0x07
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_BATCH = 0x0D

OPCODE_NAMES = {
    OP_STARTUP: "startup", OP_OPTIONS: "options", OP_QUERY: "query",
    OP_PREPARE: "prepare", OP_EXECUTE: "execute",
    OP_REGISTER: "register", OP_BATCH: "batch",
}

# Query actions whose target table is enforced (cassandraparser.go's
# action table — SELECT/INSERT/UPDATE/DELETE plus DDL).
_ACTION_RE = re.compile(
    r"^\s*(select|insert|update|delete|create|drop|alter|truncate|use)\b",
    re.IGNORECASE | re.DOTALL)
_TABLE_RES = {
    "select": re.compile(r"\bfrom\s+([\w\.\"]+)", re.I),
    "insert": re.compile(r"\binto\s+([\w\.\"]+)", re.I),
    "update": re.compile(r"^\s*update\s+([\w\.\"]+)", re.I),
    "delete": re.compile(r"\bfrom\s+([\w\.\"]+)", re.I),
    "truncate": re.compile(r"^\s*truncate\s+(?:table\s+)?([\w\.\"]+)",
                           re.I),
    "use": re.compile(r"^\s*use\s+([\w\.\"]+)", re.I),
}

UNAUTHORIZED_CODE = 0x2100  # CQL Unauthorized error


_COMMENT_RE = re.compile(r"^(\s*(/\*.*?\*/|--[^\n]*\n|//[^\n]*\n))*",
                         re.DOTALL)


def strip_comments(query: str) -> str:
    """Remove leading CQL comments so '/**/SELECT ...' cannot hide its
    action from the ACL (the comment-bypass the reference's parser
    explicitly guards against)."""
    return _COMMENT_RE.sub("", query, count=1)


def parse_query(query: str) -> Tuple[str, str]:
    """CQL text -> (action, table) ('' when not applicable)."""
    query = strip_comments(query)
    m = _ACTION_RE.match(query)
    if not m:
        return "", ""
    action = m.group(1).lower()
    rx = _TABLE_RES.get(action)
    if rx is None:
        return action, ""
    tm = rx.search(query)
    table = tm.group(1).strip('"').lower() if tm else ""
    return action, table


def _table_matches(rule_table: str, table: str) -> bool:
    if rule_table in ("", "*"):
        return True
    if rule_table.endswith("*"):
        return table.startswith(rule_table[:-1])
    return table == rule_table


def rule_allows(rules, action: str, table: str) -> bool:
    """{query_action, query_table} rule match (empty set allows —
    parser-level default, like proxylib policy maps)."""
    if not rules:
        return True
    for rule in rules:
        fields = rule.as_dict()
        want_action = fields.get("query_action", "")
        if want_action and want_action.lower() != action:
            continue
        if _table_matches(fields.get("query_table", "").lower(), table):
            return True
    return False


def parse_batch_statements(body: bytes
                           ) -> Optional[List[Tuple[int, object]]]:
    """Walk an OP_BATCH body: [(0, query_str) | (1, prepared_id)].

    Layout (CQL spec): [type u8][n u16] then per statement:
    [kind u8] + (kind 0: [long string] | kind 1: [short bytes id]),
    followed by [n_values u16] values each as [bytes] (i32 len + data).
    Returns None on malformed input (the caller fails closed — a batch
    we cannot parse must not bypass the ACL)."""
    try:
        off = 0
        _btype = body[off]; off += 1
        (n,) = struct.unpack_from(">H", body, off); off += 2
        out: List[Tuple[int, object]] = []
        for _ in range(n):
            kind = body[off]; off += 1
            if kind == 0:
                (qlen,) = struct.unpack_from(">i", body, off); off += 4
                if qlen < 0 or off + qlen > len(body):
                    return None
                out.append((0, body[off:off + qlen]
                            .decode("utf-8", "replace")))
                off += qlen
            elif kind == 1:
                (idlen,) = struct.unpack_from(">H", body, off); off += 2
                if off + idlen > len(body):
                    return None
                out.append((1, body[off:off + idlen]))
                off += idlen
            else:
                return None
            (n_values,) = struct.unpack_from(">H", body, off); off += 2
            for _ in range(n_values):
                (vlen,) = struct.unpack_from(">i", body, off); off += 4
                if vlen > 0:
                    if off + vlen > len(body):
                        return None
                    off += vlen
                # vlen < 0 == null value: no bytes follow
        return out
    except (IndexError, struct.error):
        return None


def unauthorized_frame(version: int, stream: int, msg: str) -> bytes:
    """An ERROR(Unauthorized) response frame the client driver will
    surface (cassandraparser.go's injected access-denied reply)."""
    body = struct.pack(">i", UNAUTHORIZED_CODE)
    m = msg.encode()
    body += struct.pack(">H", len(m)) + m
    header = struct.pack(">BBhBi", (version & 0x7F) | 0x80, 0,
                         stream, OP_ERROR, len(body))
    return header + body


def prepared_id(query: str) -> bytes:
    """Cassandra's prepared-statement id is the MD5 of the query text
    (server-global and deterministic), so the proxy can precompute it
    at PREPARE time and enforce the same ACL at EXECUTE time —
    otherwise EXECUTE of a statement prepared by a more-privileged
    client bypasses the policy."""
    return hashlib.md5(query.encode()).digest()


class CassandraParser(Parser):
    """Frame segmentation + per-QUERY ACL (fail closed: statements the
    parser cannot attribute to an action are denied when rules exist)."""

    def __init__(self, connection):
        super().__init__(connection)
        # prepared id -> (action, table) learned from allowed PREPAREs
        self._prepared: Dict[bytes, Tuple[str, str]] = {}

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[OpResult]:
        ops: List[OpResult] = []
        off = 0
        while off < len(data):
            avail = len(data) - off
            if avail < HEADER_LEN:
                ops.append(MORE(HEADER_LEN - avail))
                break
            version, _flags, stream, opcode, length = struct.unpack(
                ">BBhBi", data[off:off + HEADER_LEN])
            if length < 0 or length > (1 << 28):  # spec frame cap 256MB
                ops.append(ERROR())
                break
            frame_len = HEADER_LEN + length
            if avail < frame_len:
                ops.append(MORE(frame_len - avail))
                break
            if reply:
                ops.append(PASS(frame_len))
                off += frame_len
                continue
            ops.extend(self._request_frame(
                version & 0x7F, stream, opcode,
                data[off + HEADER_LEN:off + frame_len], frame_len))
            off += frame_len
        return ops

    def _request_frame(self, version: int, stream: int, opcode: int,
                       body: bytes, frame_len: int) -> List[OpResult]:
        conn = self.connection

        def deny(msg: str) -> List[OpResult]:
            return [DROP(frame_len),
                    INJECT(unauthorized_frame(version, stream, msg))]

        def check(action: str, table: str) -> bool:
            return rule_allows(conn.l7_rules, action, table)

        unrestricted = not conn.l7_rules

        if opcode in (OP_QUERY, OP_PREPARE):
            query = None
            if len(body) >= 4:
                (qlen,) = struct.unpack(">i", body[:4])
                if 0 <= qlen <= len(body) - 4:
                    query = body[4:4 + qlen].decode("utf-8", "replace")
            if query is None:
                return deny("Malformed query frame denied")
            action, table = parse_query(query)
            if not action and not unrestricted:
                # statements we cannot attribute fail closed — the
                # comment-prefix bypass the reference guards against
                return deny("Unparseable statement denied by policy")
            if action and not check(action, table):
                return deny(f"Request on table [{table}] denied "
                            f"by policy")
            if opcode == OP_PREPARE:
                self._prepared[prepared_id(query)] = (action, table)
            return [PASS(frame_len)]

        if opcode == OP_EXECUTE:
            if unrestricted:
                return [PASS(frame_len)]
            # [short bytes] prepared id leads the body
            if len(body) < 2:
                return deny("Malformed execute frame denied")
            (idlen,) = struct.unpack(">H", body[:2])
            pid = body[2:2 + idlen]
            known = self._prepared.get(pid)
            if known is None:
                # prepared ids are server-global: executing an id this
                # connection never prepared would bypass the ACL
                return deny("Execute of unknown prepared statement "
                            "denied by policy")
            action, table = known
            if action and not check(action, table):
                return deny(f"Request on table [{table}] denied "
                            f"by policy")
            return [PASS(frame_len)]

        if opcode == OP_BATCH:
            # every statement in the batch must pass the ACL; a batch
            # we cannot parse fails closed (otherwise it would be an
            # ACL bypass wrapper)
            stmts = parse_batch_statements(body)
            if stmts is None:
                return deny("Unparseable batch denied")
            for kind, value in stmts:
                if kind == 1:
                    known = self._prepared.get(value)
                    if known is None and not unrestricted:
                        return deny("Batch execute of unknown prepared "
                                    "statement denied by policy")
                    b_action, b_table = known or ("", "")
                else:
                    b_action, b_table = parse_query(value)
                    if not b_action and not unrestricted:
                        return deny("Unparseable batch statement denied "
                                    "by policy")
                if b_action and not check(b_action, b_table):
                    return deny(f"Batch request on table [{b_table}] "
                                f"denied by policy")
            return [PASS(frame_len)]

        # connection-level ops (startup/options/register/auth) and
        # unknown opcodes pass: they carry no data access
        return [PASS(frame_len)]


REGISTRY.register("cassandra", CassandraParser)
