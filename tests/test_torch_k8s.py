"""The Kubernetes integration: the JAX package's ``k8s`` vs the port's.

The same CiliumNetworkPolicy, NetworkPolicy, Service, Endpoints, Pod,
Node, Namespace and Ingress dicts go through both packages.  Parsing is
compared rule by rule (``rule_to_dict`` of each package, plus what each
selector matches); ``translate_to_services`` by the CIDR sets it leaves.
Each event script drives one JAX ``Daemon`` and one port
``Daemon(device="cpu")`` through a ``K8sWatcher`` of its own package,
and the agents must then agree exactly: endpoints and identities, the
realized map states, the repository, the ipcache, the services, the
tunnel map and the device tables built from them, the watcher's own
bookkeeping and the CNP node status (timestamps aside).  The scripts
mirror the cases of ``tests/test_k8s.py`` and
``tests/test_aux_subsystems.py:229-294``.
"""

import copy
import time

import pytest

from cilium_tpu import k8s as ref_k8s
from cilium_tpu.daemon import Daemon as RefDaemon
from cilium_tpu.labels import LabelArray as RefLabelArray
from cilium_tpu.policy import api as ref_api
from cilium_tpu.policy import jsonio as ref_jsonio
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig

from cilium_tpu_torch import k8s
from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.labels import LabelArray
from cilium_tpu_torch.policy import api
from cilium_tpu_torch.policy import jsonio
from cilium_tpu_torch.utils.option import DaemonConfig

WAIT_S = 60.0

REF = dict(k8s=ref_k8s, api=ref_api, jsonio=ref_jsonio,
           LabelArray=RefLabelArray,
           agent=lambda: RefDaemon(config=RefDaemonConfig(state_dir="")))
PORT = dict(k8s=k8s, api=api, jsonio=jsonio, LabelArray=LabelArray,
            agent=lambda: Daemon(config=DaemonConfig(state_dir=""),
                                 device="cpu"))

NS = "io.kubernetes.pod.namespace"

CNP = {
    "apiVersion": "cilium.io/v2", "kind": "CiliumNetworkPolicy",
    "metadata": {"name": "web-policy", "namespace": "prod"},
    "spec": {
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [
            {"fromEndpoints": [{"matchLabels": {"app": "client"}}],
             "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}]}]},
        ],
    },
}

NP = {
    "apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
    "metadata": {"name": "db-np", "namespace": "prod"},
    "spec": {
        "podSelector": {"matchLabels": {"role": "db"}},
        "ingress": [
            {"from": [{"podSelector": {"matchLabels": {"role": "api"}}},
                      {"ipBlock": {"cidr": "172.17.0.0/16",
                                   "except": ["172.17.1.0/24"]}}],
             "ports": [{"port": 5432, "protocol": "TCP"}]},
        ],
    },
}

NP_EXPR = {
    "metadata": {"name": "expr-np", "namespace": "prod"},
    "spec": {
        "podSelector": {},
        "ingress": [{"from": [{"podSelector": {"matchExpressions": [
            {"key": "role", "operator": "In",
             "values": ["frontend", "edge"]}]}}]}],
    },
}

NP_NS_EGRESS = {
    "metadata": {"name": "ns-np", "namespace": "dev"},
    "spec": {
        "podSelector": {"matchLabels": {"app": "api"}},
        "ingress": [{"from": [{"namespaceSelector": {
            "matchLabels": {"env": "production"},
            "matchExpressions": [{"key": "tier", "operator": "NotIn",
                                  "values": ["edge"]}]},
            "podSelector": {"matchLabels": {"app": "web"}}}]}],
        "egress": [{"to": [{"ipBlock": {"cidr": "10.40.0.0/16"}},
                           {"namespaceSelector": {}}],
                    "ports": [{"port": 443, "protocol": "TCP"},
                              {"protocol": "UDP"}]}],
    },
}

CNP_SPECS = {"metadata": {"name": "m", "namespace": "x"},
             "specs": [CNP["spec"], {
                 "endpointSelector": {"matchLabels": {
                     f"k8s:{NS}": "other", "app": "pinned"}},
                 "egress": [{"toEndpoints": [{"matchLabels": {
                     "app": "db"}}],
                     "toPorts": [{"ports": [{"port": "5432",
                                             "protocol": "TCP"}]}]}]}]}

CNP_SERVICES = {
    "metadata": {"name": "svc-egress", "namespace": "prod"},
    "spec": {
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "egress": [{"toServices": [
            {"k8sService": {"serviceName": "db", "namespace": "prod"}},
            {"k8sService": {"serviceName": "cache",
                            "namespace": "prod"}}]}],
    },
}

BAD_CNP = {"metadata": {"name": "bad", "namespace": "prod"},
           "spec": {"endpointSelector": {"matchLabels": {"a": "b"}},
                    "ingress": [{"fromCIDR": ["not-a-cidr"]}]}}

# label sets each parsed selector is asked about
PROBES = [
    ["k8s:app=web", f"k8s:{NS}=prod"],
    ["k8s:app=web", f"k8s:{NS}=dev"],
    ["k8s:app=client", f"k8s:{NS}=prod"],
    ["k8s:role=api", f"k8s:{NS}=prod"],
    ["k8s:role=db", f"k8s:{NS}=prod"],
    ["k8s:role=frontend", f"k8s:{NS}=prod"],
    ["k8s:role=backend", f"k8s:{NS}=prod"],
    ["k8s:app=web", f"k8s:{NS}=x",
     "k8s:io.cilium.k8s.namespace.labels.env=production"],
    ["k8s:app=web", f"k8s:{NS}=dev",
     "k8s:io.cilium.k8s.namespace.labels.env=production",
     "k8s:io.cilium.k8s.namespace.labels.tier=edge"],
    ["k8s:app=api", f"k8s:{NS}=dev"],
    ["k8s:app=pinned", f"k8s:{NS}=other"],
    ["k8s:app=db", f"k8s:{NS}=x"],
]


def _selectors(rule):
    out = [rule.endpoint_selector]
    for ing in rule.ingress:
        out += list(ing.from_endpoints) + list(ing.from_requires)
    for eg in rule.egress:
        out += list(eg.to_endpoints) + list(eg.to_requires)
    return out


def rule_model(pkg, rule):
    """A rule as data: its JSON form with the generated CIDR flags, each
    selector's requirements, and which probe label sets it matches."""
    probes = [pkg["LabelArray"].parse_select(*p) for p in PROBES]
    return (pkg["jsonio"].rule_to_dict(rule),
            [sorted((r.key, r.operator.value, tuple(r.values))
                    for r in s.requirements) for s in _selectors(rule)],
            [[s.matches(p) for p in probes] for s in _selectors(rule)])


def parse_both(kind, obj):
    out = []
    for pkg in (REF, PORT):
        parse = getattr(pkg["k8s"], kind)
        try:
            out.append([rule_model(pkg, r)
                        for r in parse(copy.deepcopy(obj))])
        except pkg["api"].PolicyError as e:
            out.append(("PolicyError", str(e)))
    return out


@pytest.mark.parametrize("kind,obj", [
    ("parse_cnp", CNP), ("parse_cnp", CNP_SPECS),
    ("parse_cnp", CNP_SERVICES),
    ("parse_cnp", {"metadata": {"name": "n"}}),
    ("parse_cnp", {"spec": CNP["spec"], "metadata": {}}),
    ("parse_cnp", BAD_CNP),
    ("parse_network_policy", NP), ("parse_network_policy", NP_EXPR),
    ("parse_network_policy", NP_NS_EGRESS),
    ("parse_network_policy", {"metadata": {"name": "empty"}}),
], ids=["cnp", "cnp-specs", "cnp-services", "cnp-no-spec", "cnp-no-name",
        "cnp-bad-cidr", "np", "np-expressions", "np-namespaces-egress",
        "np-empty"])
def test_parsed_rules_match(kind, obj):
    ref, port = parse_both(kind, obj)
    assert port == ref


def test_translate_to_services_matches():
    """Generated CIDRs replace this service's old backends only, other
    services' entries stay, and a user CIDR is never touched."""
    out = []
    for pkg in (REF, PORT):
        a = pkg["api"]
        rule = pkg["k8s"].parse_cnp(copy.deepcopy(CNP_SERVICES))[0]
        rule.egress[0].to_cidr_set = [a.CIDRRule(cidr="10.0.0.0/8")]
        tr = pkg["k8s"].translate_to_services
        steps = [tr([rule], "db", "prod", ["10.0.0.5", "10.0.0.6"]),
                 tr([rule], "cache", "prod", ["10.0.0.6", "fd00::7"]),
                 tr([rule], "db", "prod", ["10.0.0.7"],
                    old_backend_ips=["10.0.0.5", "10.0.0.6"]),
                 tr([rule], "other", "prod", ["1.2.3.4"]),
                 tr([rule], "db", "dev", ["1.2.3.5"])]
        out.append((steps, [(c.cidr, c.generated)
                            for c in rule.egress[0].to_cidr_set]))
    assert out[1] == out[0]
    assert out[1][0] == [1, 1, 1, 0, 0]


# ------------------------------------------------------- watcher scripts

def ep(ep_id, ip, name, *labels):
    return ("ep", ep_id, ip, name, list(labels))


def ev(kind, action, obj):
    return ("ev", kind, action, obj)


def svc(name, vip, *ports, ns="prod"):
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"clusterIP": vip, "ports": list(ports)}}


def endpoints(name, *ips, ns="prod"):
    return {"metadata": {"name": name, "namespace": ns},
            "subsets": [{"addresses": [{"ip": ip} for ip in ips]}]}


def pod(name, ip, labels, ns="prod", host_ip="192.168.3.1", **spec):
    return {"metadata": {"name": name, "namespace": ns,
                         "labels": labels},
            "spec": spec, "status": {"podIP": ip, "hostIP": host_ip}}


def node(name, cidr, ip):
    return {"metadata": {"name": name}, "spec": {"podCIDR": cidr},
            "status": {"addresses": [{"type": "InternalIP",
                                      "address": ip}]}}


def ingress(name, service, port, ns="prod"):
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"backend": {"serviceName": service,
                                 "servicePort": port}}}


ENDPOINTS = [
    ep(1, "10.30.1.5", "prod/web-1", "k8s:app=web", f"k8s:{NS}=prod"),
    ep(2, "10.30.1.6", "prod/client-1", "k8s:app=client",
       f"k8s:{NS}=prod"),
    ep(3, "10.30.1.7", "prod/db-1", "k8s:role=db", f"k8s:{NS}=prod",
       "container:runtime=docker"),
]

SCRIPTS = {
    "policy": ENDPOINTS + [
        ev("cnp", "added", CNP), ev("cnp", "modified", CNP),
        ev("networkpolicy", "added", NP),
        ev("networkpolicy", "added", NP_EXPR),
        ev("cnp", "added", BAD_CNP),
        ev("cnp", "added", CNP_SPECS),
        ev("cnp", "deleted", CNP),
        ev("networkpolicy", "deleted", NP_EXPR),
    ],
    "services": ENDPOINTS + [
        ev("endpoints", "added", endpoints("db", "10.0.0.5")),
        ev("service", "added", svc("db", "10.96.0.10", {"port": 5432})),
        ev("service", "added", svc("web", "10.96.0.2",
                                   {"port": 80, "targetPort": "http"})),
        ev("endpoints", "added", endpoints("web", "10.0.0.3")),
        ev("service", "added", svc(
            "multi", "10.96.0.40", {"port": 80, "targetPort": 8080},
            {"port": 443, "targetPort": 8443})),
        ev("endpoints", "added", endpoints("multi", "10.30.2.1",
                                           "10.30.2.2")),
        ev("service", "modified", svc("multi", "10.96.0.40",
                                      {"port": 80, "targetPort": 8080})),
        ev("service", "added", svc("hs", "None", {"port": 9042})),
        ev("endpoints", "added", endpoints("hs", "10.30.2.9")),
        ev("service", "deleted", svc("db", "10.96.0.10",
                                     {"port": 5432})),
        ev("service", "deleted", svc("hs", "None", {"port": 9042})),
    ],
    "toservices": ENDPOINTS + [
        ev("endpoints", "added", endpoints("db", "10.0.0.8")),
        ev("cnp", "added", CNP_SERVICES),
        ev("endpoints", "added", endpoints("db", "10.0.0.9")),
        ev("endpoints", "added", endpoints("cache", "10.0.0.9",
                                           "10.0.0.10")),
        ev("endpoints", "modified", endpoints("db", "10.0.0.11")),
        ev("endpoints", "deleted", endpoints("cache")),
        ev("cnp", "modified", CNP_SERVICES),
    ],
    "pods": ENDPOINTS + [
        ev("pod", "added", pod("web-9", "10.30.9.5", {"app": "web"})),
        ev("pod", "added", pod("hostpod", "192.168.3.1", {},
                               hostNetwork=True)),
        ev("pod", "modified", pod("web-9", "10.30.9.99",
                                  {"app": "web"})),
        ev("pod", "modified", pod("web-1", "10.30.1.5",
                                  {"app": "web", "tier": "gold"})),
        ev("pod", "modified", pod("db-1", "10.30.1.7",
                                  {"role": "db", "v": "2"})),
        ev("pod", "added", pod("pending", "", {"app": "x"})),
        ev("pod", "deleted", pod("web-9", "10.30.9.99", {})),
        ev("pod", "deleted", pod("ghost", "10.30.9.77", {})),
        ev("cnp", "added", CNP),
    ],
    "nodes": ENDPOINTS + [
        ev("node", "added", node("worker-2", "10.31.0.0/24",
                                 "192.168.3.2")),
        ev("node", "added", node("worker-3", "10.31.1.0/24",
                                 "192.168.3.3")),
        ev("node", "modified", node("worker-3", "10.31.1.0/24",
                                    "192.168.3.4")),
        ev("node", "deleted", {"metadata": {"name": "worker-2"}}),
    ],
    "namespaces": ENDPOINTS + [
        ep(4, "10.30.1.8", "dev/api-1", "k8s:app=api", f"k8s:{NS}=dev"),
        ev("networkpolicy", "added", NP_NS_EGRESS),
        ev("namespace", "added", {"metadata": {
            "name": "prod", "labels": {"env": "production"}}}),
        ev("namespace", "modified", {"metadata": {
            "name": "prod", "labels": {"env": "production"}}}),
        ev("namespace", "modified", {"metadata": {
            "name": "prod", "labels": {"env": "production",
                                       "tier": "core"}}}),
        ev("pod", "modified", pod("web-1", "10.30.1.5",
                                  {"app": "web", "v": "2"})),
        ev("namespace", "deleted", {"metadata": {"name": "prod"}}),
    ],
    "ingress": ENDPOINTS + [
        ev("service", "added", svc("web", "10.96.0.20",
                                   {"port": 80, "targetPort": 8080})),
        ev("ingress", "added", ingress("ing", "web", 80)),
        ev("endpoints", "added", endpoints("web", "10.30.2.1")),
        ev("ingress", "modified", ingress("ing", "web", 81)),
        ev("ingress", "added", ingress("ing2", "", 80)),
        ev("ingress", "added", ingress("ing3", "web", "named")),
        ev("service", "deleted", svc("web", "10.96.0.20",
                                     {"port": 80, "targetPort": 8080})),
        ev("service", "added", svc("api", "10.96.0.21", {"port": 90})),
        ev("ingress", "added", ingress("ing4", "api", 90)),
        ev("ingress", "deleted", ingress("ing4", "api", 90)),
    ],
}


def _wait(fn, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


def _idle(d) -> bool:
    """No regeneration or LPM reload pending or running."""
    return not (d._regen_trigger._pending_reasons or
                d._lpm_trigger._pending_reasons) and \
        d.endpoints.wait_for_quiesce(0.05)


def settled_state(pkg, d, w):
    """The agent's state once nothing moves: every endpoint at the
    revision, the debounced regeneration and LPM triggers drained (an
    identity change regenerates without a new revision), the CNP status
    worker done, and two readings 0.2 s apart equal."""
    assert d.wait_for_policy_revision(timeout=WAIT_S)
    assert _wait(lambda: all(
        st["enforcing"] or not st["ok"]
        for nodes in list(w.cnp_status.values())
        for st in list(nodes.values())))
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if _idle(d) and d.datapath.ipcache_prefixes == \
                d.ipcache.to_lpm_prefix_families()[0]:
            first = agent_state(pkg, d, w)
            time.sleep(0.2)
            if _idle(d) and agent_state(pkg, d, w) == first:
                return first
        time.sleep(0.02)
    raise AssertionError("the agent did not settle")


def agent_state(pkg, d, w):
    """Everything the watcher's events reach, as plain data."""
    services = sorted(
        (s.vip, s.port, s.proto,
         tuple(sorted((b.addr, b.port) for b in s.backends)))
        for s in d.datapath.lb.services())
    return dict(
        endpoints=sorted(
            (e.id, e.ipv4, e.state, e.policy_revision,
             e.security_identity, e.container_name,
             tuple(str(l) for l in e.labels.to_array()))
            for e in d.endpoints.endpoints()),
        realized={e.id: sorted(
            ((k.identity, k.dest_port, k.nexthdr, k.direction),
             v.proxy_port) for k, v in e.realized.items())
            for e in d.endpoints.endpoints()},
        identities=d.identity_list(),
        rules=[pkg["jsonio"].rule_to_dict(r) for r in d.repo.rules],
        revision=d.repo.revision,
        ipcache=sorted((p.prefix, p.identity, p.source, p.host_ip)
                       for p in d.ipcache.dump()),
        services=services,
        tunnel=(dict(d.datapath.tunnel_prefixes),
                dict(d.node_manager.tunnel_map)),
        maps={name: d.datapath.map_dump(name)
              for name in ("ipcache", "tunnel", "lb")},
        watcher=(w.events_processed, dict(w.events_by_kind),
                 dict(w._services), dict(w._endpoints),
                 dict(w._ingresses), dict(w._ingress_ports),
                 dict(w._pod_ips), dict(w._ns_labels)),
        cnp_status={k: {n: {f: v for f, v in st.items()
                            if f != "lastUpdated"}
                        for n, st in nodes.items()}
                    for k, nodes in w.cnp_status.items()})


def run_script(pkg, steps):
    d = pkg["agent"]()
    w = pkg["k8s"].K8sWatcher(d, ingress_host_ip="192.0.2.1")
    try:
        apply_steps(d, w, steps)
        return settled_state(pkg, d, w)
    finally:
        w.stop()
        d.shutdown()


def apply_steps(d, w, steps):
    """``steps`` into agent ``d`` and its watcher ``w``, one at a time,
    each settled before the next."""
    for step in steps:
        if step[0] == "ep":
            _, ep_id, ip, name, labels = step
            d.endpoint_create(ep_id, ipv4=ip, container_name=name,
                              labels=labels)
        else:
            _, kind, action, obj = step
            handler = getattr(w, w._HANDLERS[kind])
            handler(action, copy.deepcopy(obj))
        # endpoints regenerate asynchronously and take the identities
        # that exist when they run; quiet between events so both agents
        # see the same ones
        assert d.wait_for_policy_revision(timeout=WAIT_S)
        assert _wait(lambda: _idle(d))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_watcher_driven_agents_match(script):
    ref = run_script(REF, SCRIPTS[script])
    port = run_script(PORT, SCRIPTS[script])
    for key in ref:
        assert port[key] == ref[key], key
    assert port["watcher"][0] == len(
        [s for s in SCRIPTS[script] if s[0] == "ev"])


def test_pod_ips_enter_the_ipcache_unmanaged():
    """A pod IP maps to the reserved unmanaged identity until an
    endpoint claims it, and the claim wins over the k8s entry, in both
    packages alike."""
    from cilium_tpu.identity import RESERVED_UNMANAGED as REF_UNMANAGED

    from cilium_tpu_torch.identity import RESERVED_UNMANAGED
    assert RESERVED_UNMANAGED == REF_UNMANAGED
    before = [ev("pod", "added", pod("web-9", "10.30.9.5", {"app": "w"})),
              ev("pod", "added", pod("pending", "", {"app": "x"}))]
    after = before + [ep(9, "10.30.9.5", "prod/web-9", "k8s:app=w")]
    states = {}
    for name, steps in (("before", before), ("after", after)):
        ref, port = run_script(REF, steps), run_script(PORT, steps)
        assert port["ipcache"] == ref["ipcache"]
        states[name] = {p.split("/")[0]: (ident, src)
                        for p, ident, src, _h in port["ipcache"]}
    assert states["before"]["10.30.9.5"] == (RESERVED_UNMANAGED, "k8s")
    assert "" not in states["before"]
    ident, src = states["after"]["10.30.9.5"]
    assert ident >= 256 and src != "k8s"


def test_cnp_status_reports_enforcing_and_errors():
    state = run_script(PORT, SCRIPTS["policy"])
    st = state["cnp_status"]
    assert ("prod", "web-policy") not in st  # deleted
    node = next(iter(st[("prod", "bad")]))
    assert st[("prod", "bad")][node]["ok"] is False
    assert "error" in st[("prod", "bad")][node]
    assert st[("x", "m")][node]["ok"] and st[("x", "m")][node]["enforcing"]


def test_a_later_pods_identity_waits_for_a_policy_trigger():
    """A fault both packages share (ROADMAP §3): the local identity
    allocator regenerates nothing when an identity appears, so a pod
    built before a later pod's identity exists does not allow it until a
    ``trigger_policy_updates`` round.  Kubelet's order (policy, then the
    pods one by one) leaves web without its client in both packages
    alike; the round brings the client in, in both alike."""
    steps = [ev("cnp", "added", CNP), ENDPOINTS[0], ENDPOINTS[1]]
    states = []
    for pkg in (REF, PORT):
        d = pkg["agent"]()
        w = pkg["k8s"].K8sWatcher(d, ingress_host_ip="192.0.2.1")
        try:
            apply_steps(d, w, steps)
            before = settled_state(pkg, d, w)
            d.trigger_policy_updates("identity-change")
            after = settled_state(pkg, d, w)
            states.append((before, after))
        finally:
            w.stop()
            d.shutdown()
    (ref_before, ref_after), (before, after) = states
    for key in ref_before:
        assert before[key] == ref_before[key], key
        assert after[key] == ref_after[key], key
    client = next(e[4] for e in after["endpoints"] if e[0] == 2)
    allowed = lambda st: {k for k, _v in st["realized"][1]  # noqa: E731
                          if k[0] == client and k[1] == 80}
    assert not allowed(before)
    assert allowed(after)


# ------------------------------------------------ the informer-side queue

ENQUEUED = [
    ("pod", "added", pod("a", "10.30.5.1", {"app": "a"}), "5"),
    ("pod", "modified", pod("a", "10.30.5.2", {"app": "a"}), "5"),
    ("pod", "modified", pod("a", "10.30.5.3", {"app": "a"}), "4"),
    ("pod", "modified", pod("a", "10.30.5.4", {"app": "a"}), "7"),
    ("service", "added", svc("s", "10.96.1.1", {"port": 80}), "8"),
    ("endpoints", "add", endpoints("s", "10.30.5.4"), "9"),
    ("endpoints", "modify", endpoints("s", "10.30.5.4"), "9"),
    ("pod", "added", pod("b", "10.30.5.9", {"app": "b"}), "opaque"),
    ("pod", "added", pod("b", "10.30.5.9", {"app": "b"}), "opaque"),
    ("pod", "delete", pod("a", "10.30.5.4", {"app": "a"}), "10"),
    ("pod", "added", pod("a", "10.30.5.5", {"app": "a"}), "3"),
    ("node", "added", node("w", "10.31.9.0/24", "192.168.9.9"), "11"),
    ("cnp", "added", CNP, "12"),
]


def test_enqueued_events_dedup_and_apply_alike():
    """``enqueue_event``: per-kind FunctionQueues, stale or equal
    resourceVersions dropped, opaque ones passed, deletes forgetting the
    version; the same verdicts on every event and the same end state."""
    out = []
    for pkg in (REF, PORT):
        d = pkg["agent"]()
        w = pkg["k8s"].K8sWatcher(d)
        try:
            accepted = []
            for kind, action, obj, rv in ENQUEUED:
                obj = copy.deepcopy(obj)
                obj["metadata"]["resourceVersion"] = rv
                accepted.append(w.enqueue_event(kind, action, obj))
                # one kind's queue at a time: the order across kinds
                # then matches the script's
                assert w.wait_idle(WAIT_S)
            out.append((accepted, settled_state(pkg, d, w)))
        finally:
            w.stop()
            d.shutdown()
        with pytest.raises(RuntimeError):
            w.enqueue_event("pod", "added", pod("c", "10.30.5.8", {}))
    assert out[1][0] == out[0][0]
    assert out[1][0] == [True, False, False, True, True, True, False,
                         True, True, True, True, True, True]
    for key in out[0][1]:
        assert out[1][1][key] == out[0][1][key], key


def test_stop_ends_the_cnp_status_worker():
    """The port's watcher stops its CNP status worker (the reference
    leaves that thread running for the process's life)."""
    d = PORT["agent"]()
    w = k8s.K8sWatcher(d)
    try:
        w.on_cnp("added", copy.deepcopy(CNP))
        worker = w._status_thread
        assert worker is not None and worker.is_alive()
        w.stop()
        assert not worker.is_alive()
        w.on_cnp("added", copy.deepcopy(CNP_SPECS))  # no new worker
        assert w._status_thread is worker
    finally:
        w.stop()
        d.shutdown()
