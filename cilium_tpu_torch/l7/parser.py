"""Pluggable L7 parser framework — the proxylib analog.

Reference: proxylib/ — a parser registry (parserfactory.go), per-
connection parser instances, and the OnNewConnection/OnData streaming
contract (proxylib/proxylib.go:57,98): the proxy feeds byte chunks; the
parser segments them into frames and returns a sequence of operations
(PASS n / DROP n / MORE n / INJECT bytes / ERROR), with policy checked
per frame against the connection's rule set.

State carries across OnData calls — this is the framework's long-
sequence dimension; frame boundaries never align with chunk boundaries.

A whole copy of ``cilium_tpu/l7/parser.py``; its ``VerdictBatcher`` is
the asyncio bridge the socket proxy submits frames through into the
shared serving core (``datapath/serving.ContinuousDispatcher``).
"""

from __future__ import annotations

import asyncio
import enum
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


# --- batched verdicts -------------------------------------------------------

class VerdictBatcher:
    """Micro-batches concurrent per-frame policy checks into batched
    engine dispatches — the live-proxy batch path, now an asyncio
    facade over the SHARED continuous micro-batching core
    (datapath/serving.ContinuousDispatcher), the same machinery the
    verdict service and direct engine callers dispatch through.

    A proxy serving many connections issues one ``check_one`` per
    frame, paying a full device round trip each; this coalesces frames
    that arrive within a short window (plus everything that queues
    while a batch is in flight) into one batched engine call on the
    core's dispatcher thread, so the event loop keeps accepting and
    buffering the NEXT window while the current batch computes.

    ``check_batch`` is any Sequence[item] -> Sequence[bool] (e.g.
    ``HTTPPolicyEngine.check``).  Engines that expose
    ``dispatch_split()`` (HTTP/DNS) go further: ``dispatch_split=
    (dispatch, finalize)`` launches the device match with NO sync at
    dispatch time and defers the one blocking transfer to the core's
    *complete* stage — host encode of window N+1 overlaps window N's
    device walk (the l7/http.py ``check_pipelined`` overlap, run
    continuously).  Failures fail closed: every frame in a batch whose
    dispatch or completion raised is denied — the guarantee the shared
    dispatcher extends to every serving caller.
    """

    def __init__(self, check_batch: Callable[[Sequence], Sequence],
                 max_batch: int = 512, max_wait: float = 0.001,
                 dispatch_split: "Optional[Tuple[Callable, Callable]]"
                 = None, name: str = "l7",
                 max_pending: "Optional[int]" = None,
                 deadline_s: "Optional[float]" = None):
        from ..datapath.serving import ContinuousDispatcher
        self.check_batch = check_batch
        self.max_batch = max_batch
        self.max_wait = max_wait
        # admission control: frames queued past deadline_s are shed
        # fail-closed by the core, and check() pushes back (immediate
        # deny) while the lane is above its overload watermark instead
        # of queuing yet more work behind a saturated device
        self.deadline_s = deadline_s
        if dispatch_split is not None:
            dispatch_fn, finalize_fn = dispatch_split

            def launch(items, total):
                return dispatch_fn(items)   # async device dispatch

            def finalize(handle, weights):
                return [bool(v)
                        for v in finalize_fn(handle, len(weights))]
        else:
            def launch(items, total):
                return items                # host handle; work below

            def finalize(handle, weights):
                return [bool(v) for v in self.check_batch(handle)]

        self._core = ContinuousDispatcher(
            launch, finalize, deny=lambda item: False,
            max_batch=max_batch, window=max_wait, lane=name,
            max_pending=max_pending, default_deadline=deadline_s)

    @property
    def overloaded(self) -> bool:
        return self._core.overloaded

    async def check(self, item) -> bool:
        """Queue one frame; resolves with its verdict (False on a
        failed batch — fail closed).  While the lane is overloaded
        (admission high-watermark), pushes back immediately with a
        deny instead of queuing — the L7 proxy's slow-down signal."""
        if self._core.overloaded:
            return False
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        ticket = self._core.submit(item)

        def _resolved(t, _loop=loop, _fut=fut):
            _loop.call_soon_threadsafe(self._deliver, _fut, t)

        ticket.add_done_callback(_resolved)
        return await fut

    @staticmethod
    def _deliver(fut: asyncio.Future, ticket) -> None:
        if not fut.done():
            fut.set_result(bool(ticket.value))

    # observability passthrough (the pre-merge counter names)
    @property
    def batches(self) -> int:
        return self._core.batches

    @property
    def checked(self) -> int:
        return self._core.items_total

    @property
    def max_batch_seen(self) -> int:
        return self._core.max_batch_seen

    @property
    def errors(self) -> int:
        return self._core.errors

    def close(self) -> None:
        self._core.close()

    def stats(self) -> Dict:
        return {"batches": self.batches, "checked": self.checked,
                "max_batch": self.max_batch_seen, "errors": self.errors,
                "mean_batch": round(self.checked / self.batches, 2)
                if self.batches else 0.0}


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
