"""The ``cilium-tpu`` CLI.

Mirrors the reference's ``cilium`` command families (cilium/cmd/, 75
commands) against the REST API: policy {get,import,delete,trace,
validate,wait}, endpoint {list,get,config,labels,delete,log,
regenerate,healthz}, identity {list,get}, service {list,update,
delete}, prefilter {list,update,delete}, monitor (--type/--drops/
--socket), status, config, metrics, node, map {list,get}, version,
debuginfo, kvstore {get,set,delete}, cleanup, bugtool,
migrate-state, plus the container front ends (cni, docker-plugin).

Run the agent itself with ``python -m cilium_tpu_torch.cli agent``
(add --verdict-port to expose the batch verdict service).

A copy of ``cilium_tpu/cli.py`` over the port's agent.  ``agent`` takes
``--device`` (default ``cuda``; without a card it raises) and
``--dataplane-shards N`` (``DaemonConfig.dataplane_shards``: N shard
engines, all on ``--device``); ``--k8s-api-server URL`` list/watches an
apiserver into the agent (``k8s.client.K8sTransport`` over a
``K8sWatcher``) and ``--docker-socket PATH`` follows dockerd's container
events (``runtime_watch.DockerEventWatcher``), as the reference's agent
does.  A verdict service that fails to start stops the agent (the
reference runs on without it).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional

DEFAULT_API = "http://127.0.0.1:9234"


class APIError(SystemExit):
    """Typed agent-API failure.  Subclasses SystemExit so bare CLI use
    still exits non-zero with the message on stderr (SystemExit's
    ``code`` stays the message — do NOT store the HTTP status there, or
    an uncaught error would become the process exit status).
    Programmatic callers (docker plugin, CNI) read ``.status`` to tell
    a 404 from a 5xx or from a transport failure (status is None when
    the agent was unreachable)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class Client:
    """Tiny REST client (pkg/client analog)."""

    def __init__(self, base_url: str = DEFAULT_API):
        self.base_url = base_url.rstrip("/")

    def request(self, method: str, path: str, body=None,
                raw: bool = False, raw_body: Optional[bytes] = None,
                timeout: float = 30):
        data = raw_body if raw_body is not None else \
            (None if body is None else json.dumps(body).encode())
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            payload = e.read()
            try:
                msg = json.loads(payload).get("error", payload.decode())
            except ValueError:
                msg = payload.decode(errors="replace")
            raise APIError(f"API error {e.code}: {msg}", status=e.code)
        except urllib.error.URLError as e:
            raise APIError(
                f"cannot reach agent at {self.base_url}: {e.reason}")
        if raw:
            return payload.decode()
        return json.loads(payload) if payload else None

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def put(self, path, body=None):
        return self.request("PUT", path, body)

    def post(self, path, body=None):
        return self.request("POST", path, body)

    def patch(self, path, body=None):
        return self.request("PATCH", path, body)

    def delete(self, path, body=None):
        return self.request("DELETE", path, body)


def _print_json(obj) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True))


def _follow_sleep(interval: float, drained: bool) -> None:
    """Pace a follow-mode poll loop.  A busy emitter must NOT turn
    the follower into a hot spin: when the last poll returned events
    the next one fires sooner, but still floored at a fraction of
    --interval so an always-busy ring costs bounded CPU instead of a
    zero-sleep tight loop against the agent API."""
    time.sleep(interval if drained else max(0.02, interval / 20.0))


# ------------------------------------------------------------- subcommands

def cmd_status(c: Client, args) -> int:
    st = c.get("/healthz")
    if args.json:
        _print_json(st)
        return 0
    kv = st["kvstore"]
    print(f"KVStore:       {kv['state']} ({kv['backend']})")
    if kv.get("mode") and kv["mode"] != "ok":
        # the control plane is down: the agent is pinning
        # last-known-good state and journaling mutations for replay
        print(f"KVStore:       {kv['mode'].upper()}: pinned "
              f"last-known-good (staleness "
              f"{kv.get('staleness-seconds', 0)}s, journal "
              f"{kv.get('journal-depth', 0)} queued, breaker "
              f"{kv.get('breaker')}, "
              f"{kv.get('local-identities', 0)} local identities)")
    elif kv.get("staleness-seconds", 0) > 0:
        print(f"KVStore:       STALE: {kv['staleness-seconds']}s since "
              f"last successful op "
              f"({kv.get('consecutive-failures', 0)} consecutive "
              f"failures, breaker {kv.get('breaker')})")
    print(f"Policy:        revision {st['policy']['revision']}, "
          f"{st['policy']['rules']} rules")
    eps = st["endpoints"]
    states = " ".join(f"{k}={v}" for k, v in
                      sorted(eps.get("by-state", {}).items()))
    print(f"Endpoints:     {eps['total']} ({states})")
    print(f"Identities:    {st['identities']}")
    print(f"IPCache:       {st['ipcache']} entries")
    print(f"Nodes:         {st['nodes']} peers")
    print(f"Proxy:         {st['proxy']['redirects']} redirects")
    for cm in st.get("clustermesh", []):
        ready = "ready" if cm["ready"] else "connecting"
        print(f"ClusterMesh:   {cm['name']} (id {cm['cluster-id']}): "
              f"{ready}, {cm['num-nodes']} nodes")
    bad = [ctl for ctl in st.get("controllers", [])
           if ctl["consecutive-failure-count"] > 0]
    print(f"Controllers:   {len(st.get('controllers', []))} "
          f"({len(bad)} failing)")
    ch = st.get("controller-health") or {}
    if ch.get("failing"):
        # the loud top-level signal: a reconcile loop is wedged
        print(f"Controllers:   {ch['status']}")
        for f in ch["failing"]:
            print(f"Controllers:     {f['name']}: "
                  f"{f['consecutive-failures']}x — {f['last-error']}")
    tr = st.get("transports")
    if tr:
        open_breakers = [n for n, s in tr.get("breakers", {}).items()
                         if s != "closed"]
        print(f"Transports:    {tr['retries']} retries, "
              f"{tr['verify-on-retry']} verified, "
              f"{tr['watch-relists']} relists, "
              f"{len(open_breakers)} breakers open")
    dp_state = st.get("dataplane") or {}
    geom = dp_state.get("geometry")
    if geom:
        print(f"Dataplane:     sharded (dp={geom['dp']}, "
              f"ep={geom['ep']}, {geom['devices']} devices)")
    if dp_state.get("mode", "ok") != "ok":
        # the loudest line status can carry: the device lane is down
        # and traffic is being served fail-static from the host oracle
        print(f"Dataplane:     {dp_state.get('status')}")
    mp = st.get("map-pressure") or {}
    for warning in mp.get("warnings", []):
        print(f"MapPressure:   WARNING {warning}")
    da = (st.get("provenance") or {}).get("drift-audit") or {}
    if da.get("status") == "FAILING":
        print(f"DriftAudit:    FAILING — {da.get('divergences', '?')} "
              f"divergence(s) between compiled tables and the host "
              f"policy oracle (see /debuginfo provenance)")
    if getattr(args, "verbose", False):
        # self-telemetry detail (the status --verbose surface):
        # per-map fill, tracer health, recent policy-propagation
        # delays
        for name, m in sorted(mp.get("maps", {}).items()):
            if m.get("pressure") is not None:
                print(f"Map:           {name:14s} "
                      f"{m['occupied']}/{m['capacity']} "
                      f"({m['pressure'] * 100:.1f}%)")
            else:
                print(f"Map:           {name:14s} "
                      f"{m['occupied']} entries")
        # sharded dataplane: per-shard occupancy of the bounded
        # tables (CT/policy/flows) — the shard-local view the warn
        # threshold is applied to
        for shard, rep in sorted((mp.get("shards") or {}).items()):
            for name, m in sorted((rep.get("maps") or {}).items()):
                if m.get("pressure") is not None:
                    print(f"Map[s{shard}]:       {name:14s} "
                          f"{m['occupied']}/{m['capacity']} "
                          f"({m['pressure'] * 100:.1f}%)")
        tel = st.get("telemetry") or {}
        tracing = tel.get("tracing") or {}
        if tracing:
            state = "on" if tracing.get("enabled") else "off"
            print(f"Tracing:       {state}, "
                  f"{tracing.get('buffered', 0)}/"
                  f"{tracing.get('capacity', 0)} spans buffered")
        for rec in tel.get("propagation") or []:
            delay = rec.get("first-verdict-delay-s")
            state = f"{delay * 1000:.1f}ms to first verdict" \
                if delay is not None else "awaiting first verdict"
            print(f"PolicyRev:     r{rec['revision']} "
                  f"({rec['rules']} rules): {state}")
        prov = st.get("provenance") or {}
        if da and da.get("status") != "FAILING":
            print(f"DriftAudit:    {da.get('status')} "
                  f"({da.get('checked', 0)} tuples, "
                  f"{da.get('sc-checked', 0)} label cross-checks)")
        for rec in prov.get("top-dropped-rules") or []:
            print(f"TopDropped:    {rec['rule']} "
                  f"({rec['packets']} packets)")
        # serving SLO tier: the cilium-tpu-top-style one-shot snapshot
        # (per-lane latency percentiles, deadline-budget burn, queue
        # flight sample) — observability/slo.py
        slo = st.get("slo") or {}
        lanes = slo.get("lanes") or {}
        if lanes:
            print(f"SLO:           objective "
                  f"{slo.get('objective-ms', 0)}ms, error budget "
                  f"{slo.get('error-budget', 0)}")
            print(f"SLO:           {'LANE':<14} {'SHARD':>5} "
                  f"{'REQS':>9} {'P50us':>9} {'P99us':>9} "
                  f"{'BREACH':>7} {'BURN':>7} {'QUEUE':>7} "
                  f"{'INFL':>5}")
            for name, row in sorted(lanes.items()):
                q = row.get("queue") or {}
                shard = "-" if row.get("shard") is None \
                    else str(row["shard"])
                print(f"SLO:           {name:<14} {shard:>5} "
                      f"{row['requests']:>9} {row['p50-us']:>9.1f} "
                      f"{row['p99-us']:>9.1f} {row['breaches']:>7} "
                      f"{row['burn-rate']:>7.2f} "
                      f"{q.get('pending', 0):>7} "
                      f"{q.get('inflight', 0):>5}")
        fr = st.get("flight-recorder") or {}
        if fr.get("ringed"):
            print(f"FlightRec:     {fr['ringed']} event(s) buffered "
                  f"(seq {fr['seq']}, {fr.get('evicted', 0)} "
                  f"evicted) — `cilium-tpu events` replays the "
                  f"timeline")
    return 0


def cmd_policy(c: Client, args) -> int:
    if args.policy_cmd == "get":
        _print_json(c.get("/policy"))
    elif args.policy_cmd == "import":
        text = sys.stdin.read() if args.file == "-" else \
            open(args.file).read()
        # validate client-side first for a friendly error
        from .policy.jsonio import rules_from_json
        rules_from_json(text)
        out = c.request("PUT", "/policy", raw_body=text.encode())
        print(f"Revision: {out['revision']}")
    elif args.policy_cmd == "delete":
        path = "/policy"
        if args.labels:
            from urllib.parse import urlencode
            path += "?" + urlencode([("labels", l) for l in args.labels])
        out = c.delete(path)
        print(f"Revision: {out['revision']} ({out['deleted']} deleted)")
    elif args.policy_cmd == "trace":
        if args.replay:
            # provenance replay: through the REAL compiled device
            # tables, not the host label simulation
            if args.endpoint is None:
                print("policy trace --replay requires --endpoint",
                      file=sys.stderr)
                return 2
            if args.identity is None and not args.src:
                print("policy trace --replay requires --identity or "
                      "--src labels", file=sys.stderr)
                return 2
            body = {"endpoint": args.endpoint,
                    "dport": int((args.dport or ["0"])[0]),
                    "proto": args.proto,
                    "direction": args.direction}
            if args.identity is not None:
                body["identity"] = args.identity
            else:
                body["labels"] = args.src
            out = c.post("/policy/trace", body)
            for line in out["explanation"]:
                print(line)
            verdict = out["device"]["verdict"]
            print(f"Final verdict: "
                  f"{'DENIED' if verdict < 0 else 'ALLOWED'}"
                  + (f" (proxy {verdict})" if verdict > 0 else ""))
            if out["drift"]:
                print("DRIFT: device tables diverge from the host "
                      "oracle — compiler bug", file=sys.stderr)
                return 2
            return 0 if verdict >= 0 else 1
        if not args.src or not args.dst:
            print("policy trace requires --src and --dst "
                  "(or --replay)", file=sys.stderr)
            return 2
        out = c.post("/policy/resolve", {
            "from": args.src, "to": args.dst,
            "dports": [int(p) for p in args.dport or []],
            "verbose": args.verbose})
        print(out["trace"])
        print(f"Final verdict: {out['verdict'].upper()}")
        return 0 if out["verdict"] == "allowed" else 1
    elif args.policy_cmd == "validate":
        # cilium policy validate: parse + sanitize locally, no import
        from .policy.jsonio import rules_from_json
        text = sys.stdin.read() if args.file == "-" else \
            open(args.file).read()
        rules = rules_from_json(text)
        for r in rules:
            r.sanitize()
        print(f"Valid: {len(rules)} rule(s)")
    elif args.policy_cmd == "wait":
        # cilium policy wait: block until every endpoint realized the
        # revision (policy_wait.go)
        # the transport deadline must outlive the server-side wait
        out = c.request("POST", "/policy/wait",
                        {"revision": args.revision,
                         "timeout": args.timeout},
                        timeout=args.timeout + 10)
        state = "realized" if out["realized"] else "TIMED OUT"
        print(f"Revision {out['revision']}: {state}")
        return 0 if out["realized"] else 1
    return 0


def cmd_node(c: Client, args) -> int:
    nodes = c.get("/node")
    if args.json:
        _print_json(nodes)
        return 0
    for n in nodes:
        addrs = ",".join(a.get("IP", "") for a in
                         (n.get("IPAddresses") or []))
        print(f"{n.get('Name','?'):30s} {addrs:20s} "
              f"{n.get('IPv4AllocCIDR') or '-'}")
    return 0


def cmd_map(c: Client, args) -> int:
    """cilium map list / cilium bpf <map> list analogs: device-table
    inventory and entry dumps."""
    if args.map_cmd == "list":
        _print_json(c.get("/map"))
    elif args.map_cmd == "get":
        _print_json(c.get(f"/map/{args.name}?n={args.n}"))
    return 0


def cmd_version(c: Client, args) -> int:
    from . import __version__ as v
    print(f"Client: cilium-tpu {v}")
    try:
        st = c.get("/healthz")
        feats = st.get("features", {})
        print(f"Daemon: cilium-tpu {st.get('version', 'unknown')} "
              f"(backend {feats.get('backend', '?')}, "
              f"uptime {st.get('uptime-seconds', 0):.0f}s)")
    except Exception as e:  # noqa: BLE001 — client-only mode
        print(f"Daemon: unreachable ({e})")
    return 0


def cmd_endpoint(c: Client, args) -> int:
    if args.endpoint_cmd == "list":
        eps = c.get("/endpoint")
        fmt = "{:<8} {:<12} {:<16} {:<10} {:<24} {}"
        print(fmt.format("ID", "STATE", "IPv4", "IDENTITY",
                         "CONTAINER", "LABELS"))
        for ep in eps:
            print(fmt.format(
                ep["id"], ep["state"], ep["addressing"]["ipv4"] or "-",
                ep["identity"]["id"], ep["container-name"] or "-",
                ",".join(ep["labels"])))
    elif args.endpoint_cmd == "get":
        _print_json(c.get(f"/endpoint/{args.id}"))
    elif args.endpoint_cmd == "delete":
        c.delete(f"/endpoint/{args.id}")
        print(f"Endpoint {args.id} deleted")
    elif args.endpoint_cmd == "config":
        changes = {}
        for kv in args.options or []:
            k, _, v = kv.partition("=")
            changes[k] = v
        if not changes:
            ep = c.get(f"/endpoint/{args.id}")
            _print_json(ep)
        else:
            out = c.patch(f"/endpoint/{args.id}/config", changes)
            print(f"Changed {out['changed']} option(s)")
    elif args.endpoint_cmd == "labels":
        out = c.patch(f"/endpoint/{args.id}", {"labels": args.labels})
        print("Labels updated" if out.get("ok") else "No change")
    elif args.endpoint_cmd == "log":
        # cilium endpoint log: the state-transition ring
        for e in c.get(f"/endpoint/{args.id}/log"):
            ts = time.strftime("%H:%M:%S",
                               time.localtime(e["timestamp"]))
            msg = f" ({e['message']})" if e.get("message") else ""
            print(f"{ts}  {e['state']}{msg}")
    elif args.endpoint_cmd == "regenerate":
        out = c.post(f"/endpoint/{args.id}/regenerate")
        print("Regeneration queued" if out.get("queued")
              else "Already queued")
    elif args.endpoint_cmd == "healthz":
        out = c.get(f"/endpoint/{args.id}/healthz")
        _print_json(out)
        return 0 if out.get("healthy") else 1
    return 0


def cmd_identity(c: Client, args) -> int:
    if args.identity_cmd == "list":
        idents = c.get("/identity")
        print(f"{'ID':<12} LABELS")
        for i in idents:
            print(f"{i['id']:<12} {','.join(i['labels'])}")
    elif args.identity_cmd == "get":
        _print_json(c.get(f"/identity/{args.id}"))
    return 0


def cmd_service(c: Client, args) -> int:
    if args.service_cmd == "list":
        svcs = c.get("/service")
        print(f"{'FRONTEND':<24} BACKENDS")
        for s in svcs:
            front = f"{s['vip']}:{s['port']}"
            backs = ", ".join(f"{b['ip']}:{b['port']}"
                              for b in s["backends"])
            print(f"{front:<24} {backs}")
    elif args.service_cmd == "update":
        backends = []
        for b in args.backends:
            ip, _, port = b.rpartition(":")
            backends.append({"ip": ip, "port": int(port)})
        vip, _, port = args.frontend.rpartition(":")
        c.put("/service", {"vip": vip, "port": int(port),
                           "backends": backends})
        print("Service updated")
    elif args.service_cmd == "delete":
        vip, _, port = args.frontend.rpartition(":")
        c.delete("/service", {"vip": vip, "port": int(port)})
        print("Service deleted")
    return 0


def cmd_prefilter(c: Client, args) -> int:
    if args.prefilter_cmd == "list":
        out = c.get("/prefilter")
        print(f"Revision: {out['revision']}")
        for cidr in out["cidrs"]:
            print(cidr)
    elif args.prefilter_cmd == "update":
        out = c.patch("/prefilter", {"cidrs": args.cidrs})
        print(f"Revision: {out['revision']}")
    elif args.prefilter_cmd == "delete":
        out = c.delete("/prefilter", {"cidrs": args.cidrs})
        print(f"Revision: {out['revision']}")
    return 0


def cmd_monitor(c: Client, args) -> int:
    if args.stats:
        _print_json(c.get("/monitor/stats"))
        return 0
    if args.socket:
        # true subscriber stream from a separate process: no polling,
        # no dedupe needed — the server pushes each sample once
        if args.type:
            print("monitor: --type applies to the polling mode only "
                  "(the socket stream is unfiltered)", file=sys.stderr)
            return 2
        from .monitor import monitor_follow
        host, sep, port = args.socket.rpartition(":")
        if not sep or not port.isdigit():
            print(f"monitor: --socket expects host:port, got "
                  f"{args.socket!r}", file=sys.stderr)
            return 2
        for e in monitor_follow(int(port), host=host or "127.0.0.1",
                                replay=args.replay,
                                drops_only=args.drops):
            print(e["message"], flush=True)
        return 0
    # cursor-based polling: the ring hands out monotonic sequence
    # numbers, so the follower resumes from ?since=<seq> — no dedupe
    # set, no silent gap when >n events land between polls (the next
    # poll picks up exactly where the cursor left off)
    cursor = 0
    kind_q = f"&kind={args.type}" if args.type else ""
    try:
        while True:
            events = c.get(
                f"/monitor?n=200&since={cursor}&drops="
                f"{'true' if args.drops else 'false'}{kind_q}")
            for e in events:
                cursor = max(cursor, e.get("seq", 0))
                print(e["message"])
            if not args.follow:
                return 0
            _follow_sleep(args.interval, not events)
    except KeyboardInterrupt:
        return 0


def cmd_hubble(c: Client, args) -> int:
    """``cilium hubble observe`` / ``hubble stats`` — the flow
    observability surface (hubble CLI analog) over /flows."""
    from urllib.parse import urlencode
    if args.hubble_cmd == "stats":
        path = "/flows/stats"
        if getattr(args, "aggregated", False):
            path += "?aggregated=true"
        _print_json(c.get(path))
        return 0

    params = []
    for key in ("verdict", "drop_reason", "tier", "proto",
                "l7_protocol", "l7_method", "l7_path", "node"):
        v = getattr(args, key, None)
        if v:
            params.append((key, v))
    for key in ("identity", "src_identity", "dst_identity", "endpoint",
                "dport", "l7_status", "shard"):
        v = getattr(args, key, None)
        if v is not None:
            params.append((key, str(v)))
    if args.federated:
        params.append(("federated", "true"))
    cursor = args.since

    def fetch():
        qs = list(params) + [("since", str(cursor)), ("n", str(args.n))]
        return c.get("/flows?" + urlencode(qs))

    try:
        while True:
            out = fetch()
            flows = out.get("flows", [])
            for f in flows:
                cursor = max(cursor, f.get("seq", 0))
            if args.json:
                for f in flows:
                    print(json.dumps(f, sort_keys=True))
            else:
                from .hubble.flow import flow_from_dict
                for f in flows:
                    ts = time.strftime(
                        "%H:%M:%S", time.localtime(f.get("timestamp", 0)))
                    node = f.get("node", "")
                    print(f"{ts} [{node}] "
                          f"{flow_from_dict(f).describe()}")
            if args.federated and out.get("partial"):
                degraded = [n["name"] for n in out.get("nodes", [])
                            if n["status"] != "ok"]
                # sharded peers: a degraded dataplane shard is flagged
                # fail-open per shard (its FAIL-STATIC flows are still
                # in the answer, marked as such)
                for n_ in out.get("nodes", []):
                    for s in n_.get("shards") or []:
                        if s.get("status") != "ok":
                            degraded.append(
                                f"{n_['name']}/shard{s['shard']}"
                                f"({s['status']})")
                print(f"(partial result: {', '.join(degraded)} "
                      "unavailable or degraded)", file=sys.stderr)
            if not args.follow:
                return 0
            _follow_sleep(args.interval, not flows)
    except KeyboardInterrupt:
        return 0


def cmd_events(c: Client, args) -> int:
    """``cilium-tpu events`` — replay the incident flight recorder's
    ordered degraded-condition timeline (GET /debug/events), cursor-
    paginated like ``monitor``/``hubble observe``."""
    from urllib.parse import urlencode
    cursor = args.since
    try:
        while True:
            params = [("since", str(cursor)), ("n", str(args.n))]
            if args.type:
                params.append(("type", args.type))
            if args.shard is not None:
                params.append(("shard", str(args.shard)))
            out = c.get("/debug/events?" + urlencode(params))
            events = out.get("events", [])
            for e in events:
                cursor = max(cursor, e.get("seq", 0))
                if args.json:
                    print(json.dumps(e, sort_keys=True))
                    continue
                ts = time.strftime(
                    "%H:%M:%S", time.localtime(e.get("timestamp", 0)))
                where = f"[shard {e['shard']}] " \
                    if e.get("shard") is not None else ""
                attrs = " ".join(
                    f"{k}={v}" for k, v in
                    sorted((e.get("attrs") or {}).items()))
                line = f"#{e['seq']} {ts} {where}{e['type']}"
                if e.get("detail"):
                    line += f": {e['detail']}"
                if attrs:
                    line += f" ({attrs})"
                if e.get("trace-id"):
                    line += f" trace={e['trace-id']}"
                print(line)
            if not args.follow:
                if not events and not args.json:
                    stats = out.get("stats") or {}
                    print(f"(no events after seq {args.since}; "
                          f"{stats.get('ringed', 0)} buffered, "
                          f"{stats.get('evicted', 0)} evicted)")
                return 0
            _follow_sleep(args.interval, not events)
    except KeyboardInterrupt:
        return 0


def cmd_trace(c: Client, args) -> int:
    """``cilium-tpu trace`` — the span-trace surface over
    /debug/traces: recent trace summaries, or one rendered span tree
    by trace id / policy revision."""
    if args.id or args.revision is not None:
        q = f"?id={args.id}" if args.id else \
            f"?revision={args.revision}"
        tree = c.get(f"/debug/traces{q}")
        if args.json:
            _print_json(tree)
            return 0

        def render(node, depth):
            dur = node.get("duration-s") or 0.0
            attrs = " ".join(
                f"{k}={v}" for k, v in
                sorted((node.get("attrs") or {}).items()))
            print(f"{'  ' * depth}{node['name']:<40s} "
                  f"{dur * 1000:10.3f}ms  {attrs}")
            for child in node.get("children", []):
                render(child, depth + 1)

        print(f"Trace {tree['trace-id']}:")
        for root in tree.get("spans", []):
            render(root, 1)
        return 0
    out = c.get(f"/debug/traces?n={args.n}")
    if args.json:
        _print_json(out)
        return 0
    print(f"{'TRACE':<14} {'ROOT':<36} {'SPANS':>5} "
          f"{'DURATION':>12}")
    for t in out.get("traces", []):
        print(f"{t['trace-id']:<14} {t['root']:<36} "
              f"{t['spans']:>5} {t['duration-s'] * 1000:>10.3f}ms")
    ts = out.get("tracer") or {}
    print(f"({'enabled' if ts.get('enabled') else 'disabled'}, "
          f"{ts.get('buffered', 0)}/{ts.get('capacity', 0)} spans "
          f"buffered, {ts.get('dropped', 0)} evicted)")
    return 0


def cmd_threat(c: Client, args) -> int:
    """``cilium-tpu threat`` — the inline threat-scoring plane:
    status (mode/thresholds/model/verdicts), config (thresholds +
    shadow/enforce flips, a live leaf write on the daemon), train
    (fit from the aggregated flow plane + hot-swap push)."""
    if args.threat_cmd == "status":
        out = c.get("/threat")
        if args.json:
            _print_json(out)
            return 0
        mode = out.get("mode", "off")
        print(f"Threat scoring:  {mode}")
        if mode == "off":
            return 0
        if out.get("status"):
            print(f"  {out['status']}")
        model = out.get("model") or {}
        cfg = model.get("config") or {}
        print(f"  model:      gen {cfg.get('generation')}, "
              f"{model.get('features')}x{model.get('hidden')} "
              f"({model.get('resident-bytes')} bytes)")
        print(f"  thresholds: drop>={cfg.get('drop-score')} "
              f"redirect>={cfg.get('redirect-score')} "
              f"ratelimit>={cfg.get('ratelimit-score')} "
              f"(0 = arm off)")
        print(f"  bucket:     rate {cfg.get('rate-per-s')}/s "
              f"burst {cfg.get('burst')}")
        v = out.get("verdicts") or {}
        print("  verdicts:   " + " ".join(
            f"{k}={v.get(k, 0)}" for k in
            ("scored", "rate-limited", "redirected", "dropped")))
        return 0
    if args.threat_cmd == "config":
        changes = {}
        if args.mode:
            changes["mode"] = args.mode
        for field in ("drop_score", "redirect_score",
                      "ratelimit_score", "redirect_port", "burst"):
            val = getattr(args, field)
            if val is not None:
                changes[field] = val
        if args.rate_per_s is not None:
            changes["rate_per_s"] = args.rate_per_s
        if not changes:
            print("nothing to change (see --help)")
            return 1
        _print_json(c.post("/threat/config", changes))
        return 0
    # train
    _print_json(c.post("/threat/train",
                       {"max_flows": args.max_flows}))
    return 0


def cmd_top(c: Client, args) -> int:
    """``cilium-tpu top`` — mesh-wide traffic analytics decoded from
    the device-resident sketches (GET /analytics/top): talkers
    (heavy-hitter identities by bytes/packets/drops), scanners
    (distinct-dport fan-out per identity, scan suspects flagged),
    spreaders (distinct-flow cardinality per identity)."""
    from urllib.parse import urlencode
    qs = urlencode({"view": args.view, "n": str(args.n),
                    "metric": args.metric})
    out = c.get(f"/analytics/top?{qs}")
    if args.json:
        _print_json(out)
        return 0
    entries = out.get("entries", [])
    view = out.get("view", args.view)
    if view == "scanners":
        print(f"{'IDENTITY':<12} {'DPORTS':>8} {'PACKETS':>10}  FLAG")
        for e in entries:
            flag = "SCAN-SUSPECT" if e.get("suspect") else "-"
            print(f"{e['identity']:<12} {e['dports']:>8} "
                  f"{e['packets']:>10}  {flag}")
    elif view == "spreaders":
        print(f"{'IDENTITY':<12} {'FLOWS':>10}")
        for e in entries:
            print(f"{e['identity']:<12} {e['flows']:>10}")
    else:  # talkers
        metric = out.get("metric", args.metric)
        print(f"{'IDENTITY':<12} {metric.upper():>14}")
        for e in entries:
            print(f"{e['identity']:<12} {e['count']:>14}")
    if not entries:
        print("(no traffic decoded in the quiesced epoch)")
    if out.get("partial"):
        bad = sorted(k for k, s in (out.get("shards") or {}).items()
                     if s.get("status") != "ok")
        # fail-open: the remaining shards still answered, but this
        # top-K is missing the degraded shards' traffic — say so
        # loudly instead of presenting a partial decode as the truth
        print(f"(PARTIAL result: analytics shard(s) "
              f"{', '.join(bad)} unreadable — their traffic is "
              f"missing from this view)", file=sys.stderr)
    return 0


def cmd_config(c: Client, args) -> int:
    if not args.options:
        _print_json(c.get("/config"))
        return 0
    changes = {}
    for kv in args.options:
        k, _, v = kv.partition("=")
        changes[k] = v
    out = c.patch("/config", changes)
    print(f"Changed {out['changed']} option(s)")
    return 0


def cmd_metrics(c: Client, args) -> int:
    print(c.get("/metrics", raw=True), end="")
    return 0


def cmd_migrate_state(c: Client, args) -> int:
    """Standalone state migration (bpf/cilium-map-migrate.c analog:
    run around an agent upgrade, before the new agent restores)."""
    from .migrate import CHECKPOINT_VERSION, migrate_state_dir
    migrated, current, skipped = migrate_state_dir(
        args.state_dir, keep_backup=not args.no_backup)
    print(f"migrated {migrated} checkpoint(s) to "
          f"v{CHECKPOINT_VERSION}; {current} already current")
    if skipped:
        print(f"SKIPPED {len(skipped)} unmigratable checkpoint(s): "
              f"{', '.join(skipped)}", file=sys.stderr)
        return 1
    return 0


def cmd_debuginfo(c: Client, args) -> int:
    """cilium debuginfo (cilium/cmd/debuginfo.go): one aggregate
    snapshot of agent state."""
    _print_json(c.get("/debuginfo"))
    return 0


def cmd_kvstore(c: Client, args) -> int:
    """cilium kvstore get/set/delete (cilium/cmd/kvstore_*.go),
    routed through the agent's kvstore connection."""
    from urllib.parse import quote
    key = quote(args.key, safe="/")  # spaces/?/# must not split the URL
    if args.kvstore_cmd == "get":
        suffix = "?prefix=true" if args.recursive else ""
        _print_json(c.get(f"/kvstore/{key}{suffix}"))
    elif args.kvstore_cmd == "set":
        _print_json(c.put(f"/kvstore/{key}", {"value": args.value}))
    elif args.kvstore_cmd == "delete":
        suffix = "?prefix=true" if args.recursive else ""
        _print_json(c.request("DELETE", f"/kvstore/{key}{suffix}"))
    return 0


def cmd_cleanup(c: Client, args) -> int:
    """cilium cleanup (cilium/cmd/cleanup.go): remove persisted agent
    state (endpoint checkpoints) from the state directory.  Local
    operation; requires -f like the reference."""
    import os
    import shutil
    if not args.force:
        print("cleanup removes all persisted endpoint state; "
              "re-run with -f/--force to proceed")
        return 1
    state = args.state_dir
    removed = 0
    if os.path.isdir(state):
        for fname in sorted(os.listdir(state)):
            if (fname.startswith("ep_") and fname.endswith(".json")) \
                    or fname == "ct_state.npz":
                os.unlink(os.path.join(state, fname))
                removed += 1
        if args.all:
            shutil.rmtree(state, ignore_errors=True)
    print(f"removed {removed} checkpoint file(s) from {state}")
    return 0


def cmd_bugtool(c: Client, args) -> int:
    from .bugtool import collect_remote
    path = collect_remote(c, args.output or None)
    print(f"Archive written: {path}")
    return 0


def cmd_cni(c: Client, args) -> int:
    import os
    from . import cni
    os.environ.setdefault("CILIUM_TPU_API", c.base_url)
    os.environ["CNI_COMMAND"] = args.cni_cmd.upper()
    if args.container_id:
        os.environ["CNI_CONTAINERID"] = args.container_id
    return cni.main()


def cmd_docker_plugin(c: Client, args) -> int:
    from . import docker_plugin
    return docker_plugin.main(["--api", c.base_url,
                               "--listen-port", str(args.listen_port)])


def cmd_agent(args) -> int:
    """Run the agent + API server in the foreground."""
    from .daemon import Daemon
    from .daemon.rest import APIServer
    from .kvstore.backend import close_client, setup_client
    from .utils.option import DaemonConfig

    cfg = DaemonConfig(cluster_name=args.cluster_name,
                       cluster_id=args.cluster_id,
                       state_dir=args.state_dir,
                       dataplane_shards=getattr(args, "dataplane_shards",
                                                0),
                       ct_checkpoint_interval_s=getattr(
                           args, "ct_checkpoint_interval", 10.0))
    kv = None
    if args.kvstore and args.kvstore != "none":
        # --kvstore-opt port=2379 lease_ttl=15 ... (daemon/main.go
        # --kvstore-opt analog); numeric values coerce so backend
        # constructors get real ints/floats
        opts = {}
        for item in getattr(args, "kvstore_opt", None) or []:
            k, sep, v = item.partition("=")
            if not sep or not k or not v:
                raise SystemExit(
                    f"--kvstore-opt {item!r}: expected key=value")
            try:
                opts[k] = int(v)
            except ValueError:
                try:
                    opts[k] = float(v)
                except ValueError:
                    opts[k] = v
        try:
            kv = setup_client(args.kvstore, **opts)
        except KeyError:
            raise SystemExit(f"unknown kvstore backend "
                             f"{args.kvstore!r}")
        except TypeError as e:
            raise SystemExit(f"bad --kvstore-opt for "
                             f"{args.kvstore!r}: {e}")
    d = Daemon(config=cfg, kvstore_backend=kv, node_name=args.node_name,
               device=args.device)
    restored = d.restore_endpoints()
    server = APIServer(d, port=args.api_port).start()
    docker_watcher = None
    if getattr(args, "docker_socket", ""):
        # real dockerd events client (pkg/workloads/docker.go analog)
        from .runtime_watch import (DockerClient, DockerEventWatcher,
                                    WorkloadWatcher)
        docker_watcher = DockerEventWatcher(
            DockerClient(args.docker_socket),
            WorkloadWatcher(d, ipam=d.ipam)).start()
    k8s_transport = k8s_watcher = None
    if getattr(args, "k8s_api_server", ""):
        # real list/watch informers against an apiserver
        # (daemon/k8s_watcher.go EnableK8sWatcher analog)
        from .k8s.client import K8sTransport
        from .k8s.watcher import K8sWatcher
        k8s_watcher = K8sWatcher(d)
        k8s_transport = K8sTransport(k8s_watcher,
                                     args.k8s_api_server).start()

    def stop_integrations():
        if docker_watcher is not None:
            docker_watcher.stop()
        if k8s_transport is not None:
            k8s_transport.stop()
            k8s_watcher.stop()

    vsvc = None
    if getattr(args, "verdict_port", 0):
        # the daemon->TPU verdict-service RPC hop: remote ingest
        # points ship header batches here (verdict_service.py)
        from .verdict_service import VerdictService
        secret = None
        if getattr(args, "verdict_secret_file", ""):
            # config errors are startup errors: a missing or empty
            # secret file must stop the agent with a clear message,
            # never degrade into an unauthenticated service
            try:
                with open(args.verdict_secret_file, "rb") as f:
                    secret = f.read().strip()
            except OSError as e:
                raise SystemExit(f"--verdict-secret-file: {e}")
            if not secret:
                raise SystemExit(f"--verdict-secret-file "
                                 f"{args.verdict_secret_file!r} is "
                                 f"empty")
        try:
            vsvc = VerdictService(d.datapath,
                                  host=getattr(args, "verdict_host",
                                               "127.0.0.1"),
                                  port=args.verdict_port,
                                  secret=secret).start()
        except (ValueError, RuntimeError, OSError) as e:
            # a bad config, a failed native build or a port in use: the
            # agent stops rather than serve without the device lane the
            # flag asked for
            stop_integrations()
            server.shutdown()
            d.shutdown()
            close_client()
            raise SystemExit(f"verdict service failed to start: {e}")
    print(f"cilium-tpu agent up: api={server.base_url} "
          f"restored={restored} endpoints" +
          (f" verdict-service=:{vsvc.port}" if vsvc else ""))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop_integrations()
        if vsvc is not None:
            vsvc.shutdown()
        server.shutdown()
        # the agent closes the store's client it was given;
        # close_client drops the process-global reference to it (a
        # second close of a closed client does nothing)
        d.shutdown()
        close_client()
    return 0


# ------------------------------------------------------------------ parser

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cilium-tpu",
        description="TPU-native policy enforcement framework CLI")
    p.add_argument("--api", default=DEFAULT_API,
                   help="agent API base URL")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("status", help="agent health and state")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("-v", "--verbose", action="store_true",
                    help="include map pressure, JIT/compile telemetry "
                         "and policy-propagation delays")

    pol = sub.add_parser("policy", help="policy management")
    pol_sub = pol.add_subparsers(dest="policy_cmd", required=True)
    pol_sub.add_parser("get")
    imp = pol_sub.add_parser("import")
    imp.add_argument("file", help="rules JSON file, or - for stdin")
    dele = pol_sub.add_parser("delete")
    dele.add_argument("--labels", nargs="*", default=[])
    tr = pol_sub.add_parser("trace")
    tr.add_argument("--src", nargs="+", default=[])
    tr.add_argument("--dst", nargs="+", default=[])
    tr.add_argument("--dport", nargs="*")
    tr.add_argument("-v", "--verbose", action="store_true")
    tr.add_argument("--replay", action="store_true",
                    help="replay through the REAL compiled device "
                         "tables (verdict provenance) instead of the "
                         "host label simulation")
    tr.add_argument("--endpoint", type=int, default=None,
                    help="with --replay: local endpoint id")
    tr.add_argument("--identity", type=int, default=None,
                    help="with --replay: peer security identity "
                         "(or resolve --src labels)")
    tr.add_argument("--proto", type=int, default=6,
                    help="with --replay: L4 protocol number")
    tr.add_argument("--direction", default="egress",
                    choices=["ingress", "egress"])
    val = pol_sub.add_parser("validate",
                             help="parse + sanitize locally, no import")
    val.add_argument("file", help="rules JSON file, or - for stdin")
    pw = pol_sub.add_parser("wait",
                            help="block until a revision is realized")
    pw.add_argument("--revision", type=int, default=None)
    pw.add_argument("--timeout", type=float, default=30.0)

    nd = sub.add_parser("node", help="cluster node list")
    nd.add_argument("--json", action="store_true")

    mp = sub.add_parser("map",
                        help="device table inventory + entry dumps "
                             "(bpf map list analogs)")
    mp_sub = mp.add_subparsers(dest="map_cmd", required=True)
    mp_sub.add_parser("list")
    mg = mp_sub.add_parser("get")
    mg.add_argument("name",
                    help="ipcache|ipcache6|ct|ct6|tunnel|lb|lb6|"
                         "prefilter")
    mg.add_argument("-n", type=int, default=4096)

    sub.add_parser("version", help="client + daemon version")

    ep = sub.add_parser("endpoint", help="endpoint management")
    ep_sub = ep.add_subparsers(dest="endpoint_cmd", required=True)
    ep_sub.add_parser("list")
    for name in ("get", "delete", "log", "regenerate", "healthz"):
        e = ep_sub.add_parser(name)
        e.add_argument("id", type=int)
    e = ep_sub.add_parser("config")
    e.add_argument("id", type=int)
    e.add_argument("options", nargs="*", help="Option=value")
    e = ep_sub.add_parser("labels")
    e.add_argument("id", type=int)
    e.add_argument("labels", nargs="+")

    idp = sub.add_parser("identity", help="security identities")
    id_sub = idp.add_subparsers(dest="identity_cmd", required=True)
    id_sub.add_parser("list")
    g = id_sub.add_parser("get")
    g.add_argument("id", type=int)

    svc = sub.add_parser("service", help="service load balancing")
    svc_sub = svc.add_subparsers(dest="service_cmd", required=True)
    svc_sub.add_parser("list")
    up = svc_sub.add_parser("update")
    up.add_argument("--frontend", required=True, help="VIP:port")
    up.add_argument("--backends", nargs="+", required=True,
                    help="ip:port ...")
    de = svc_sub.add_parser("delete")
    de.add_argument("--frontend", required=True)

    pf = sub.add_parser("prefilter", help="XDP-prefilter analog CIDRs")
    pf_sub = pf.add_subparsers(dest="prefilter_cmd", required=True)
    pf_sub.add_parser("list")
    for name in ("update", "delete"):
        u = pf_sub.add_parser(name)
        u.add_argument("cidrs", nargs="+")

    mon = sub.add_parser("monitor", help="datapath event monitor")
    mon.add_argument("--drops", action="store_true")
    mon.add_argument("--type", default="",
                     choices=["", "agent", "l7", "datapath"],
                     help="event family filter (cilium monitor --type)")
    mon.add_argument("--stats", action="store_true")
    mon.add_argument("-f", "--follow", action="store_true")
    mon.add_argument("--interval", type=float, default=1.0)
    mon.add_argument("--socket", default="",
                     help="host:port of the agent's monitor stream "
                          "(cross-process follow, monitor/main.go "
                          "subscriber analog)")
    mon.add_argument("--replay", type=int, default=0,
                     help="with --socket: replay the last N ring "
                          "samples before following")

    hb = sub.add_parser("hubble",
                        help="flow observability (hubble CLI analog)")
    hb_sub = hb.add_subparsers(dest="hubble_cmd", required=True)
    ob = hb_sub.add_parser("observe", help="query/follow flow records")
    ob.add_argument("--verdict", default="",
                    help="FORWARDED | DROPPED | REDIRECTED")
    ob.add_argument("--drop-reason", dest="drop_reason", default="",
                    help="drop reason name or code")
    ob.add_argument("--tier", default="",
                    help="provenance decision tier (prefilter|"
                         "ct-established|l3-allow|l4-rule|l7-redirect"
                         "|deny|lb) or code")
    ob.add_argument("--identity", type=int, default=None,
                    help="match src OR dst identity")
    ob.add_argument("--src-identity", dest="src_identity", type=int,
                    default=None)
    ob.add_argument("--dst-identity", dest="dst_identity", type=int,
                    default=None)
    ob.add_argument("--endpoint", type=int, default=None)
    ob.add_argument("--dport", type=int, default=None)
    ob.add_argument("--proto", default="", help="tcp|udp|icmp|number")
    ob.add_argument("--l7-protocol", dest="l7_protocol", default="",
                    help="http|dns|kafka|parser name")
    ob.add_argument("--l7-method", dest="l7_method", default="")
    ob.add_argument("--l7-path", dest="l7_path", default="",
                    help="path prefix")
    ob.add_argument("--l7-status", dest="l7_status", type=int,
                    default=None, help="HTTP status / DNS rcode")
    ob.add_argument("--node", default="")
    ob.add_argument("--since", type=int, default=0,
                    help="resume from this sequence cursor")
    ob.add_argument("-n", type=int, default=100)
    ob.add_argument("-f", "--follow", action="store_true")
    ob.add_argument("--interval", type=float, default=1.0)
    ob.add_argument("--federated", action="store_true",
                    help="fan out to every relay peer "
                         "(partial results flagged per node AND per "
                         "local dataplane shard)")
    ob.add_argument("--shard", type=int, default=None,
                    help="sharded daemons: only this dataplane "
                         "shard's flows")
    ob.add_argument("--json", action="store_true")
    hs = hb_sub.add_parser("stats",
                           help="observer/aggregation/relay health "
                                "(mesh-wide on sharded daemons)")
    hs.add_argument("--aggregated", action="store_true",
                    help="include the on-device per-flow counters")

    thr = sub.add_parser("threat",
                         help="inline per-packet threat scoring "
                              "(Taurus-style anomaly verdict plane)")
    thr_sub = thr.add_subparsers(dest="threat_cmd", required=True)
    ts = thr_sub.add_parser("status",
                            help="mode, thresholds, model generation, "
                                 "verdict accounting")
    ts.add_argument("--json", action="store_true")
    tc = thr_sub.add_parser(
        "config", help="threshold + shadow/enforce updates (a live "
                       "leaf write on the daemon; mode flips ring "
                       "the flight recorder)")
    tc.add_argument("--mode", choices=("shadow", "enforce"),
                    default="")
    tc.add_argument("--drop-score", dest="drop_score", type=int,
                    default=None, help="score >= this drops (0 = off)")
    tc.add_argument("--redirect-score", dest="redirect_score",
                    type=int, default=None)
    tc.add_argument("--ratelimit-score", dest="ratelimit_score",
                    type=int, default=None)
    tc.add_argument("--redirect-port", dest="redirect_port", type=int,
                    default=None)
    tc.add_argument("--rate-per-s", dest="rate_per_s", type=float,
                    default=None, help="token-bucket refill rate")
    tc.add_argument("--burst", type=int, default=None,
                    help="token-bucket capacity")
    tt = thr_sub.add_parser(
        "train", help="fit from the aggregated flow plane and "
                      "hot-swap the weights (zero repacks)")
    tt.add_argument("--max-flows", dest="max_flows", type=int,
                    default=4096)

    top = sub.add_parser("top",
                         help="device-resident traffic analytics: "
                              "heavy-hitter / scan / cardinality "
                              "views (/analytics/top)")
    top.add_argument("view", nargs="?", default="talkers",
                     choices=["talkers", "scanners", "spreaders"],
                     help="talkers = identities by sketch count, "
                          "scanners = distinct-dport fan-out, "
                          "spreaders = distinct-flow cardinality")
    top.add_argument("-n", type=int, default=10)
    top.add_argument("--metric", default="bytes",
                     choices=["bytes", "packets", "drops"],
                     help="talkers ranking metric")
    top.add_argument("--json", action="store_true")

    cfgp = sub.add_parser("config", help="daemon options")
    cfgp.add_argument("options", nargs="*", help="Option=value")

    sub.add_parser("metrics", help="Prometheus metrics dump")

    ev = sub.add_parser("events",
                        help="incident flight recorder: the ordered "
                             "degraded-condition timeline "
                             "(/debug/events)")
    ev.add_argument("--since", type=int, default=0,
                    help="resume from this sequence cursor")
    ev.add_argument("--type", default="",
                    help="one event type only (e.g. "
                         "dataplane-degraded, kvstore-recovered)")
    ev.add_argument("--shard", type=int, default=None,
                    help="one dataplane shard's events only")
    ev.add_argument("-n", type=int, default=200)
    ev.add_argument("-f", "--follow", action="store_true")
    ev.add_argument("--interval", type=float, default=1.0)
    ev.add_argument("--json", action="store_true")

    trp = sub.add_parser("trace",
                         help="control-plane span traces "
                              "(/debug/traces)")
    trp.add_argument("--id", default="",
                     help="show one trace's span tree")
    trp.add_argument("--revision", type=int, default=None,
                     help="show the span tree of a policy revision's "
                          "propagation")
    trp.add_argument("-n", type=int, default=50,
                     help="trace summaries to list")
    trp.add_argument("--json", action="store_true")

    ms = sub.add_parser("migrate-state",
                        help="upgrade endpoint checkpoints across "
                             "agent versions (cilium-map-migrate "
                             "analog)")
    ms.add_argument("state_dir")
    ms.add_argument("--no-backup", action="store_true")

    bt = sub.add_parser("bugtool", help="archive agent state for a bug report")
    bt.add_argument("-o", "--output", default="")

    cn = sub.add_parser("cni", help="CNI plugin entry (ADD/DEL/VERSION)")
    cn.add_argument("cni_cmd", choices=["add", "del", "version"])
    cn.add_argument("--container-id", default="")

    dp = sub.add_parser("docker-plugin",
                        help="serve the docker libnetwork remote driver")
    dp.add_argument("--listen-port", type=int, default=9235)

    sub.add_parser("debuginfo", help="aggregate agent state snapshot")

    kvp = sub.add_parser("kvstore", help="kvstore access via the agent")
    kv_sub = kvp.add_subparsers(dest="kvstore_cmd", required=True)
    g = kv_sub.add_parser("get")
    g.add_argument("key")
    g.add_argument("--recursive", action="store_true")
    s = kv_sub.add_parser("set")
    s.add_argument("key")
    s.add_argument("value")
    de = kv_sub.add_parser("delete")
    de.add_argument("key")
    de.add_argument("--recursive", action="store_true")

    cl = sub.add_parser("cleanup", help="remove persisted agent state")
    cl.add_argument("-f", "--force", action="store_true")
    cl.add_argument("--all", action="store_true",
                    help="remove the whole state dir")
    cl.add_argument("--state-dir", default="/var/run/cilium_tpu")

    ag = sub.add_parser("agent", help="run the agent")
    ag.add_argument("--api-port", type=int, default=9234)
    ag.add_argument("--device", default="cuda",
                    help="torch device the agent's tables and state "
                         "live on (cuda raises without a card)")
    ag.add_argument("--dataplane-shards", type=int, default=0,
                    help="shard the verdict dataplane into this many "
                         "endpoint shards, each its own fault domain, "
                         "all on --device (0 or 1: one engine)")
    ag.add_argument("--verdict-port", type=int, default=0,
                    help="serve the batch verdict service on this "
                         "port (0 = disabled)")
    ag.add_argument("--verdict-host", default="127.0.0.1",
                    help="verdict service bind address; non-loopback "
                         "requires --verdict-secret-file")
    ag.add_argument("--verdict-secret-file", default="",
                    help="file holding the shared secret for verdict-"
                         "service peer authentication (HMAC "
                         "challenge-response)")
    ag.add_argument("--kvstore", default="none",
                    help="none | in-memory | remote | etcd")
    ag.add_argument("--kvstore-opt", action="append", default=[],
                    help="backend option key=value (repeatable), "
                         "e.g. --kvstore-opt port=2379")
    ag.add_argument("--cluster-name", default="default")
    ag.add_argument("--cluster-id", type=int, default=0)
    ag.add_argument("--node-name", default="node-local")
    ag.add_argument("--state-dir", default="")
    ag.add_argument("--ct-checkpoint-interval", type=float, default=10.0,
                    help="seconds between CT snapshots to state-dir "
                         "(0 = only at clean shutdown)")
    ag.add_argument("--k8s-api-server", default="",
                    help="apiserver base URL to list/watch (informer "
                         "transport; empty = no k8s)")
    ag.add_argument("--docker-socket", default="",
                    help="dockerd unix socket to watch container "
                         "events on (empty = no docker runtime)")
    return p


COMMANDS = {
    "status": cmd_status, "policy": cmd_policy, "endpoint": cmd_endpoint,
    "identity": cmd_identity, "service": cmd_service,
    "prefilter": cmd_prefilter, "monitor": cmd_monitor,
    "hubble": cmd_hubble, "threat": cmd_threat, "top": cmd_top,
    "config": cmd_config, "metrics": cmd_metrics,
    "trace": cmd_trace, "events": cmd_events,
    "bugtool": cmd_bugtool, "cni": cmd_cni,
    "docker-plugin": cmd_docker_plugin,
    "debuginfo": cmd_debuginfo, "kvstore": cmd_kvstore,
    "cleanup": cmd_cleanup,
    "migrate-state": cmd_migrate_state,
    "node": cmd_node, "map": cmd_map, "version": cmd_version,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "agent":
        return cmd_agent(args)
    return COMMANDS[args.cmd](Client(args.api), args)


if __name__ == "__main__":
    sys.exit(main())
