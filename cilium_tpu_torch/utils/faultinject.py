"""Device-lane and transport fault injection.

Copy of ``cilium_tpu/utils/faultinject.py``:

- ``DeviceLaneFault`` / ``DeviceFaultInjector``: the chaos hand of the
  serving supervisor (``datapath/supervisor.py``), consulted around
  every launch and finalize, so a test can raise on the Nth dispatch,
  hang a finalize past the watchdog deadline, or run
  transient-then-heal scripts against the real dispatcher loop.
- ``FaultProxy``: a plain TCP relay between a client and a real
  server.  Injects connection resets (``reset_all``), refused
  connections (``refuse_connections``), blackholes (``pause`` holds
  new connections dark until ``resume``), per-chunk latency
  (``delay_s``), and — the ambiguous-mutation window —
  ``drop_response_once(pattern)``: the next request whose bytes
  contain ``pattern`` is delivered to the server, but its reply is
  swallowed and the connection reset, so the op was APPLIED while the
  client saw only a dead socket.
- ``FaultySocket``: wraps one ``socket.socket`` for in-process shims:
  added delay, partial writes (fragmented wire pattern, total delivery
  preserved), reset after N sent bytes, and a stall gate.
- ``ControlPlaneFaultInjector``: drives one ``FaultProxy`` per
  control-plane peer (the kvstore, the apiserver) for the outage
  guard's chaos tests.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


class DeviceLaneFault(RuntimeError):
    """An injected (or classified) device-lane failure.  ``fatal``
    steers the supervisor's breaker: fatal trips it immediately,
    transient counts toward the consecutive-failure threshold."""

    def __init__(self, msg: str = "injected device fault",
                 fatal: bool = False):
        super().__init__(msg)
        self.fatal = fatal


class DeviceFaultInjector:
    """Scriptable device-lane fault hook.

    Install via ``DeviceSupervisor.install_fault_hook(injector)``; the
    supervisor then calls :meth:`on_launch` before every device launch
    and :meth:`on_finalize` inside the watchdogged finalize worker.
    Each armed step fires once per matching call, in order:

    - ``fail_launch(times, fatal)`` — raise DeviceLaneFault on the
      next ``times`` launches;
    - ``fail_finalize(times, fatal)`` — same, at finalize;
    - ``hang_finalize(seconds, times)`` — sleep inside finalize so the
      supervisor's watchdog deadline fires (the hung ``complete`` sync
      of a wedged device path);
    - ``script([...])`` — explicit (stage, action, arg) sequences for
      transient-then-heal choreography;
    - ``heal()`` — disarm everything.
    """

    def __init__(self, shard: Optional[int] = None):
        self._mu = threading.Lock()
        self._launch: deque = deque()    # ("raise", fatal)
        self._finalize: deque = deque()  # ("raise", fatal)|("hang", s)
        self.launches = 0
        self.finalizes = 0
        self.injected = 0
        # shard scope: set by DeviceSupervisor.install_fault_hook when
        # installed on a shard-scoped lane — the injector's faults land
        # on exactly that shard's launches, nobody else's
        self.shard = shard

    # ------------------------------------------------------- arming

    def fail_launch(self, times: int = 1, fatal: bool = False,
                    msg: str = "injected launch fault") -> None:
        with self._mu:
            for _ in range(times):
                self._launch.append(("raise", fatal, msg))

    def fail_finalize(self, times: int = 1, fatal: bool = False,
                      msg: str = "injected finalize fault") -> None:
        with self._mu:
            for _ in range(times):
                self._finalize.append(("raise", fatal, msg))

    def hang_finalize(self, seconds: float, times: int = 1) -> None:
        with self._mu:
            for _ in range(times):
                self._finalize.append(("hang", seconds, "hang"))

    def script(self, steps) -> None:
        """Explicit choreography: steps are ("launch"|"finalize",
        "raise"|"hang"|"ok", arg) — "ok" consumes one call without
        injecting (spacing for transient-then-heal sequences)."""
        with self._mu:
            for stage, action, arg in steps:
                q = self._launch if stage == "launch" else self._finalize
                q.append((action, arg, f"scripted {action}"))

    def heal(self) -> None:
        with self._mu:
            self._launch.clear()
            self._finalize.clear()

    @property
    def armed(self) -> bool:
        with self._mu:
            return bool(self._launch or self._finalize)

    # ------------------------------------------- supervisor hook API

    def on_launch(self) -> None:
        with self._mu:
            self.launches += 1
            step = self._launch.popleft() if self._launch else None
        self._apply(step)

    def on_finalize(self) -> None:
        with self._mu:
            self.finalizes += 1
            step = self._finalize.popleft() if self._finalize else None
        self._apply(step)

    def _apply(self, step) -> None:
        if step is None:
            return
        action, arg, msg = step
        if action == "ok":
            return
        self.injected += 1
        if action == "hang":
            time.sleep(float(arg))
            return
        raise DeviceLaneFault(msg, fatal=bool(arg))


class FaultySocket:
    """Delegating socket wrapper with injectable faults."""

    def __init__(self, sock: socket.socket, *, delay_s: float = 0.0,
                 partial_write: int = 0, reset_after_bytes: int = 0,
                 stall: Optional[threading.Event] = None):
        self._sock = sock
        self.delay_s = delay_s
        self.partial_write = partial_write  # max bytes per wire write
        self.reset_after_bytes = reset_after_bytes
        self.stall = stall  # while set, IO blocks
        self.bytes_sent = 0

    def _fault_gate(self) -> None:
        if self.stall is not None:
            while self.stall.is_set():
                time.sleep(0.005)
        if self.delay_s:
            time.sleep(self.delay_s)

    def _count_send(self, n: int) -> None:
        self.bytes_sent += n
        if self.reset_after_bytes and \
                self.bytes_sent >= self.reset_after_bytes:
            try:
                self._sock.close()
            except OSError:
                pass
            raise ConnectionResetError("faultinject: reset after "
                                       f"{self.bytes_sent} bytes")

    def send(self, data) -> int:
        self._fault_gate()
        if self.partial_write:
            data = data[:self.partial_write]
        n = self._sock.send(data)
        self._count_send(n)
        return n

    def sendall(self, data) -> None:
        mv = memoryview(bytes(data))
        step = self.partial_write or max(1, len(mv))
        off = 0
        while off < len(mv):
            self._fault_gate()
            chunk = mv[off:off + step]
            self._sock.sendall(chunk)
            off += len(chunk)
            self._count_send(len(chunk))

    def recv(self, bufsize: int, *flags) -> bytes:
        self._fault_gate()
        return self._sock.recv(bufsize, *flags)

    def recv_into(self, buffer, nbytes: int = 0, *flags) -> int:
        self._fault_gate()
        return self._sock.recv_into(buffer, nbytes, *flags)

    def __getattr__(self, name):
        return getattr(self._sock, name)


class FaultProxy:
    """TCP relay with scriptable failure injection; ``start()`` binds
    an ephemeral port and accepts until ``close()``."""

    def __init__(self, target_host: str, target_port: int,
                 host: str = "127.0.0.1"):
        self._target: Tuple[str, int] = (target_host, int(target_port))
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, 0))
        self._lsock.listen(16)
        self.host = host
        self.port = self._lsock.getsockname()[1]
        self.delay_s = 0.0
        self.refuse_connections = False
        self.connections_total = 0
        self.resets_injected = 0
        self._gate = threading.Event()  # cleared => blackhole new conns
        self._gate.set()
        self._mu = threading.Lock()
        self._drop_pattern: Optional[bytes] = None
        self._pairs: list = []
        self._closed = threading.Event()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="faultproxy")

    # ------------------------------------------------------- controls

    def pause(self) -> None:
        """Blackhole: accept new connections but forward nothing until
        ``resume()`` (the blind-window half of a partition)."""
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()

    def reset_all(self) -> None:
        """Hard-kill every live relayed connection."""
        with self._mu:
            pairs = list(self._pairs)
        for pair in pairs:
            self._kill(pair)

    def drop_response_once(self, pattern: bytes) -> None:
        """Arm a one-shot reply drop: the next client->server chunk
        containing ``pattern`` is forwarded, then the connection is
        reset the moment the server's reply arrives — the op applied,
        the reply lost (the verify-on-retry window)."""
        with self._mu:
            self._drop_pattern = pattern

    # ------------------------------------------------------ lifecycle

    def start(self) -> "FaultProxy":
        self._accept.start()
        return self

    def close(self) -> None:
        self._closed.set()
        self._gate.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        self.reset_all()

    # ------------------------------------------------------- plumbing

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                client, _ = self._lsock.accept()
            except OSError:
                return
            self.connections_total += 1
            if self.refuse_connections:
                try:
                    client.close()
                except OSError:
                    pass
                continue
            threading.Thread(target=self._serve, args=(client,),
                             daemon=True).start()

    def _serve(self, client: socket.socket) -> None:
        while not self._gate.wait(0.05):
            if self._closed.is_set():
                client.close()
                return
        try:
            server = socket.create_connection(self._target, timeout=5.0)
        except OSError:
            try:
                client.close()
            except OSError:
                pass
            return
        pair = {"c": client, "s": server, "drop": False}
        with self._mu:
            self._pairs.append(pair)
        threading.Thread(target=self._pump, args=(client, server, pair,
                                                  True),
                         daemon=True).start()
        threading.Thread(target=self._pump, args=(server, client, pair,
                                                  False),
                         daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket, pair,
              c2s: bool) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                while not self._gate.wait(0.05):
                    if self._closed.is_set():
                        return
                if self.delay_s:
                    time.sleep(self.delay_s)
                if c2s:
                    with self._mu:
                        if self._drop_pattern is not None and \
                                self._drop_pattern in data:
                            self._drop_pattern = None
                            pair["drop"] = True
                elif pair["drop"]:
                    # the reply exists => the server applied the
                    # request; swallow it and reset — the client is
                    # left in the ambiguous-mutation window
                    self.resets_injected += 1
                    self._kill(pair)
                    return
                dst.sendall(data)
        except OSError:
            pass
        finally:
            self._kill(pair)

    def _kill(self, pair) -> None:
        for end in (pair["c"], pair["s"]):
            try:
                end.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                end.close()
            except OSError:
                pass
        with self._mu:
            if pair in self._pairs:
                self._pairs.remove(pair)


class ControlPlaneFaultInjector:
    """The CONTROL-plane chaos hand (the etcd/apiserver twin of
    ``DeviceFaultInjector``): drives one ``FaultProxy`` per
    control-plane peer — the kvstore (etcd) and the apiserver — so a
    chaos test can blackhole, partition, or flap exactly the planes the
    outage guard (kvstore/outage.py) and the reflector breaker
    (k8s/client.py) must absorb, plus expire server-side leases to
    force the lease-grace repair path.

    - ``blackhole(plane)``: connections accepted but forwarded nowhere
      (the dark-partition half: in-flight requests hang to their
      deadlines); live streams are reset so watch readers see the cut.
    - ``partition(plane)``: connections actively refused (fast-fail
      RST partition) + live streams reset.
    - ``heal(plane)``: forward again.
    - ``flap(plane, cycles, period)``: partition/heal cycles on a
      background thread (breaker-cadence chaos).
    - ``expire_leases()``: invoke the server-side lease expirer (e.g.
      ``MiniEtcd.expire_leases``) — the long-outage scenario where the
      server reaped every lease-backed key.
    """

    PLANES = ("etcd", "apiserver")

    def __init__(self, etcd: Optional[FaultProxy] = None,
                 apiserver: Optional[FaultProxy] = None,
                 lease_expirer: Optional[Callable[[], int]] = None):
        self._proxies: Dict[str, FaultProxy] = {}
        if etcd is not None:
            self._proxies["etcd"] = etcd
        if apiserver is not None:
            self._proxies["apiserver"] = apiserver
        self._lease_expirer = lease_expirer
        self._mu = threading.Lock()
        self._flapper: Optional[threading.Thread] = None
        self._flap_stop = threading.Event()
        self.faults: List[Tuple[str, str]] = []  # (plane, action) log

    def proxy(self, plane: str) -> FaultProxy:
        return self._proxies[plane]

    def _each(self, plane: Optional[str]):
        if plane is None:
            return list(self._proxies.items())
        return [(plane, self._proxies[plane])]

    def _log(self, plane: str, action: str) -> None:
        with self._mu:
            self.faults.append((plane, action))

    # ------------------------------------------------------- faults

    def blackhole(self, plane: str = "etcd") -> None:
        for name, proxy in self._each(plane):
            proxy.pause()
            proxy.reset_all()
            self._log(name, "blackhole")

    def partition(self, plane: str = "etcd") -> None:
        for name, proxy in self._each(plane):
            proxy.refuse_connections = True
            proxy.reset_all()
            self._log(name, "partition")

    def heal(self, plane: Optional[str] = None) -> None:
        for name, proxy in self._each(plane):
            proxy.refuse_connections = False
            proxy.resume()
            self._log(name, "heal")

    def flap(self, plane: str = "etcd", cycles: int = 3,
             period_s: float = 0.2) -> threading.Thread:
        """Partition/heal ``cycles`` times, ``period_s`` per half
        cycle, on a background thread (returned for joining)."""
        self._flap_stop.clear()

        def run():
            for _ in range(cycles):
                if self._flap_stop.is_set():
                    break
                self.partition(plane)
                if self._flap_stop.wait(period_s):
                    break
                self.heal(plane)
                if self._flap_stop.wait(period_s):
                    break
            self.heal(plane)

        self._flapper = threading.Thread(target=run, daemon=True,
                                         name="cp-flapper")
        self._flapper.start()
        return self._flapper

    def expire_leases(self) -> int:
        if self._lease_expirer is None:
            raise RuntimeError("no lease expirer wired")
        self._log("etcd", "expire-leases")
        return int(self._lease_expirer())

    # ---------------------------------------------------- lifecycle

    def stats(self) -> Dict:
        with self._mu:
            return {"faults": list(self.faults),
                    "planes": sorted(self._proxies)}

    def close(self) -> None:
        self._flap_stop.set()
        if self._flapper is not None:
            self._flapper.join(timeout=5)
        self.heal()
