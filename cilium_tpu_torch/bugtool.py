"""State archive collector for debugging.

Reference: bugtool/ — ``cilium-bugtool`` snapshots agent state (status,
policy, endpoints, maps, metrics, logs) into a tar archive an operator
can attach to a bug report. Here the collectors read the in-process
daemon; each lands as one JSON/text member in a tar.gz.

Port of ``cilium_tpu/bugtool.py``: the same members under the same
names.  Without ``out_path`` the archive goes to the temporary directory
(``tempfile.gettempdir()``, which follows ``TMPDIR``), where the
reference writes to ``/tmp``.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
import tempfile
import time
from typing import Callable, Dict, Optional

from .observability.slo import slo_tracker


def _collectors(daemon) -> Dict[str, Callable[[], object]]:
    out = {
        "status.json": daemon.status,
        "policy.json": daemon.policy_get,
        "endpoints.json": lambda: [ep.model()
                                   for ep in daemon.endpoints.endpoints()],
        "identities.json": daemon.identity_list,
        "ipcache.json": lambda: [
            {"prefix": p.prefix, "identity": p.identity,
             "source": p.source, "host-ip": p.host_ip}
            for p in daemon.ipcache.dump()],
        "monitor-stats.json": daemon.monitor.stats,
        "controllers.json": daemon.controllers.status_model,
        "config.json": lambda: {"options": daemon.config.opts.dump(),
                                "cluster": daemon.config.cluster_name},
        "datapath.json": lambda: {
            "revision": daemon.datapath.revision,
            "conntrack-slots": daemon.datapath.ct.slots,
            "services": len(daemon.datapath.lb),
            "prefilter": daemon.datapath.prefilter.dump()[0]},
        "metrics.txt": daemon.metrics_text,
        # runtime self-telemetry (observability/): the span-trace
        # buffer, device-table pressure, policy propagation and the
        # host pipeline-stage breakdown — one archive answers "what
        # was the agent doing"
        "traces.json": daemon.traces,
        "map-pressure.json": lambda: daemon.datapath.map_pressure(
            daemon.config.map_pressure_warn),
        "compile-telemetry.json": lambda: {
            "propagation": daemon.propagation.report(50)},
        "pipeline.json": daemon.pipeline_report,
        # verdict provenance (datapath provenance + drift audit): the
        # compiler-correctness verdict, the heaviest denied keys, and
        # the last replay an operator ran — "was this verdict right,
        # and which compiled entry made it"
        "provenance.json": lambda: {
            "enabled": daemon.datapath.provenance_enabled,
            "drift-audit": daemon.drift_report(),
            "top-dropped-rules": daemon.monitor.top_dropped_rules(20),
            "last-replay": daemon.last_replay_report()},
        # the incident flight recorder: the ordered degraded-condition
        # timeline — "what happened, when, on which shard" — plus the
        # serving SLO tier's latency/burn snapshot
        "flight-recorder.json": lambda: daemon.flight_events(
            limit=500),
        "slo.json": slo_tracker.snapshot,
    }
    if getattr(daemon, "hubble", None) is not None:
        # flow observability state (hubble/): the recent flow ring, the
        # on-device aggregation table's stats + counters, and the
        # relay's per-peer health — what an operator needs to judge
        # "why is this flow (not) visible"
        out["hubble-flows.json"] = \
            lambda: daemon.hubble.get_flows(limit=500)
        out["hubble-aggregation.json"] = lambda: {
            "stats": daemon.datapath.flow_stats(),
            "flows": daemon.datapath.flow_snapshot(1024)}
        if daemon.hubble_relay is not None:
            out["hubble-relay.json"] = daemon.hubble_relay.node_health
    return out


def _remote_collectors(client) -> Dict[str, Callable[[], object]]:
    return {
        "status.json": lambda: client.get("/healthz"),
        "policy.json": lambda: client.get("/policy"),
        "endpoints.json": lambda: client.get("/endpoint"),
        "identities.json": lambda: client.get("/identity"),
        "services.json": lambda: client.get("/service"),
        "prefilter.json": lambda: client.get("/prefilter"),
        "monitor-stats.json": lambda: client.get("/monitor/stats"),
        "config.json": lambda: client.get("/config"),
        "metrics.txt": lambda: client.get("/metrics", raw=True),
        "hubble-flows.json": lambda: client.get("/flows?n=500"),
        "hubble-stats.json":
        lambda: client.get("/flows/stats?aggregated=true"),
        "traces.json": lambda: client.get("/debug/traces"),
        "pipeline.json": lambda: client.get("/debug/pipeline"),
        "flight-recorder.json":
        lambda: client.get("/debug/events?n=500"),
        "provenance.json":
        lambda: (client.get("/healthz") or {}).get("provenance"),
    }


def _write_archive(collectors: Dict[str, Callable[[], object]],
                   out_path: Optional[str]) -> str:
    ts = time.strftime("%Y%m%d-%H%M%S")
    path = out_path or os.path.join(tempfile.gettempdir(),
                                    f"cilium-tpu-bugtool-{ts}.tar.gz")
    with tarfile.open(path, "w:gz") as tar:
        for name, fn in collectors.items():
            try:
                data = fn()
                if isinstance(data, str):
                    blob = data.encode()
                else:
                    blob = json.dumps(data, indent=1, sort_keys=True,
                                      default=str).encode()
            # capture, don't abort — incl. SystemExit, which the REST
            # Client raises on API errors
            except (Exception, SystemExit) as exc:
                blob = f"collector failed: {exc!r}".encode()
                name += ".failed"
            info = tarfile.TarInfo(name=f"cilium-tpu-bugtool-{ts}/{name}")
            info.size = len(blob)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(blob))
    return path


def collect_remote(client, out_path: Optional[str] = None) -> str:
    """Archive agent state over the REST API (the CLI path)."""
    return _write_archive(_remote_collectors(client), out_path)


def collect(daemon, out_path: Optional[str] = None) -> str:
    """Write the archive from an in-process daemon; returns its path.

    Collector failures are captured into the archive instead of
    aborting it (bugtool keeps going on partial failures)."""
    return _write_archive(_collectors(daemon), out_path)
