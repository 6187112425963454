"""Standalone kvstore server entrypoint.

A copy of ``cilium_tpu/kvstore/serve.py`` under the port's module name.

``python -m cilium_tpu_torch.kvstore.serve [port]`` — the single-binary store
a cluster of agents points at (the etcd role in the reference's
deployment, daemon flag --kvstore; here: Daemon(kvstore_backend=
RemoteBackend(host, port))).
"""

from __future__ import annotations

import signal
import sys
import threading

from .server import DEFAULT_PORT, KVStoreServer


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    port = int(argv[0]) if argv else DEFAULT_PORT
    host = argv[1] if len(argv) > 1 else "0.0.0.0"
    srv = KVStoreServer(host=host, port=port).start()
    print(f"kvstore server listening on {srv.address}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
