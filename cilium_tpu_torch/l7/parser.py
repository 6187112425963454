"""Pluggable L7 parser framework — the proxylib analog.

Reference: proxylib/ — a parser registry (parserfactory.go), per-
connection parser instances, and the OnNewConnection/OnData streaming
contract (proxylib/proxylib.go:57,98): the proxy feeds byte chunks; the
parser segments them into frames and returns a sequence of operations
(PASS n / DROP n / MORE n / INJECT bytes / ERROR), with policy checked
per frame against the connection's rule set.

State carries across OnData calls — this is the framework's long-
sequence dimension; frame boundaries never align with chunk boundaries.

Copy of ``cilium_tpu/l7/parser.py`` without ``VerdictBatcher``, the
asyncio bridge the socket proxy submits frames through, which waits for
the socket proxy.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..policy.api import PortRuleL7


class Op(enum.Enum):
    PASS = "pass"      # forward n bytes
    DROP = "drop"      # discard n bytes
    MORE = "more"      # need n more bytes before a decision
    INJECT = "inject"  # insert bytes into the stream
    ERROR = "error"


@dataclass
class OpResult:
    op: Op
    n: int = 0
    data: bytes = b""


PASS = lambda n: OpResult(Op.PASS, n)
DROP = lambda n: OpResult(Op.DROP, n)
MORE = lambda n: OpResult(Op.MORE, n)
INJECT = lambda data: OpResult(Op.INJECT, len(data), data)
ERROR = lambda: OpResult(Op.ERROR)


class Parser:
    """Base parser: subclass and implement on_data.

    Reference contract: proxylib/proxylib/parserfactory.go Parser iface.
    """

    def __init__(self, connection: "Connection"):
        self.connection = connection

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[OpResult]:
        raise NotImplementedError


@dataclass
class Connection:
    """Per-connection context (proxylib/proxylib/connection.go)."""

    conn_id: int
    proto: str
    ingress: bool
    src_identity: int
    dst_identity: int
    src_addr: str = ""
    dst_addr: str = ""
    policy_name: str = ""
    l7_rules: List[PortRuleL7] = field(default_factory=list)
    parser: Optional[Parser] = None

    def matches(self, fields: Dict[str, str]) -> bool:
        """Key/value policy match for generic parsers
        (proxylib/proxylib/policymap.go): allowed iff any rule's fields
        are a subset of the frame's fields; empty rule set allows."""
        if not self.l7_rules:
            return True
        for rule in self.l7_rules:
            if all(fields.get(k) == v for k, v in rule.fields):
                return True
        return False


class ParserRegistry:
    """Name -> parser factory (proxylib parserfactory registry)."""

    def __init__(self):
        self._factories: Dict[str, Callable[[Connection], Parser]] = {}
        self._lock = threading.Lock()

    def register(self, proto: str,
                 factory: Callable[[Connection], Parser]) -> None:
        with self._lock:
            self._factories[proto] = factory

    def get(self, proto: str) -> Optional[Callable[[Connection], Parser]]:
        with self._lock:
            return self._factories.get(proto)

    def protocols(self) -> List[str]:
        with self._lock:
            return sorted(self._factories)


REGISTRY = ParserRegistry()


class Instance:
    """A proxylib instance: owns live connections
    (proxylib/proxylib/instance.go; cgo OnNewConnection proxylib.go:57,
    OnData :98, Close :112)."""

    def __init__(self, registry: ParserRegistry = REGISTRY,
                 access_logger: Optional[Callable[[Dict], None]] = None):
        self.registry = registry
        self._conns: Dict[int, Connection] = {}
        self._lock = threading.Lock()
        self.access_logger = access_logger

    def on_new_connection(self, proto: str, conn_id: int, ingress: bool,
                          src_id: int, dst_id: int, src_addr: str = "",
                          dst_addr: str = "", policy_name: str = "",
                          l7_rules: Optional[Sequence[PortRuleL7]] = None
                          ) -> bool:
        factory = self.registry.get(proto)
        if factory is None:
            return False
        conn = Connection(conn_id=conn_id, proto=proto, ingress=ingress,
                          src_identity=src_id, dst_identity=dst_id,
                          src_addr=src_addr, dst_addr=dst_addr,
                          policy_name=policy_name,
                          l7_rules=list(l7_rules or []))
        conn.parser = factory(conn)
        with self._lock:
            self._conns[conn_id] = conn
        return True

    def on_data(self, conn_id: int, reply: bool, end_stream: bool,
                data: bytes) -> List[OpResult]:
        with self._lock:
            conn = self._conns.get(conn_id)
        if conn is None or conn.parser is None:
            return [ERROR()]
        ops = conn.parser.on_data(reply, end_stream, data)
        if self.access_logger:
            for op in ops:
                if op.op in (Op.PASS, Op.DROP):
                    self.access_logger({
                        "conn_id": conn_id, "proto": conn.proto,
                        "verdict": op.op.value, "bytes": op.n,
                        "src_identity": conn.src_identity,
                        "dst_identity": conn.dst_identity})
        return ops

    def close(self, conn_id: int) -> None:
        with self._lock:
            self._conns.pop(conn_id, None)

    def __len__(self):
        with self._lock:
            return len(self._conns)


# --- bundled parsers --------------------------------------------------------

class LineParser(Parser):
    """Newline-framed request parser with key/value policy — the analog
    of proxylib's demo r2d2 parser (proxylib/testparsers): frame = one
    line ``verb args...\\n``; policy fields: {"cmd": verb}.

    Contract: ``data`` is the full unacknowledged buffer (the proxy
    re-presents unconsumed bytes after a MORE), so the parser holds no
    internal buffer — the proxylib OnData convention.
    """

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[OpResult]:
        if reply:
            return [PASS(len(data))]
        ops: List[OpResult] = []
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                ops.append(DROP(len(data) - pos) if end_stream else MORE(1))
                break
            verb = data[pos:nl].split(b" ", 1)[0].decode("latin1")
            frame_len = nl + 1 - pos
            if self.connection.matches({"cmd": verb}):
                ops.append(PASS(frame_len))
            else:
                ops.append(DROP(frame_len))
            pos = nl + 1
        return ops


class BlockParser(Parser):
    """Length-prefixed frame parser (4-byte ASCII length + payload) with
    pass/drop decided by the first payload byte — a scripted test parser
    in the spirit of proxylib's blockparser harness. Same no-internal-
    buffer contract as LineParser."""

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[OpResult]:
        ops: List[OpResult] = []
        pos = 0
        while pos < len(data):
            avail = len(data) - pos
            if avail < 4:
                ops.append(MORE(4 - avail))
                break
            try:
                n = int(data[pos:pos + 4])
            except ValueError:
                return [ERROR()]
            if avail < 4 + n:
                ops.append(MORE(4 + n - avail))
                break
            payload = data[pos + 4:pos + 4 + n]
            decision = PASS if (n == 0 or payload[:1] != b"D") else DROP
            ops.append(decision(4 + n))
            pos += 4 + n
        return ops


REGISTRY.register("line", LineParser)
REGISTRY.register("block", BlockParser)
