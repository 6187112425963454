"""Rule resolution: the JAX package's host control plane vs the port's copy.

Labels, identities, the JSON rule text, the repository's decisions and
resolutions with their traces, the desired map state and its diff, the
error paths, the proxy's redirects (and the L7 fast programs built from
them), the ipcache with its CIDR identities and LPM listener, and the
parser framework: the same inputs through ``cilium_tpu`` and
``cilium_tpu_torch`` give equal results (tolerance 0: every comparison
is equality).  Rules cross between the packages as the JSON text users
import (``policy/jsonio``).
"""

import json

import numpy as np
import pytest

from cilium_tpu import identity as ref_identity
from cilium_tpu import labels as ref_labels
from cilium_tpu import proxy as ref_proxy
from cilium_tpu.compiler import lpm as ref_lpm
from cilium_tpu.ipcache import cidr as ref_cidr
from cilium_tpu.ipcache import ipcache as ref_ipcache
from cilium_tpu.ipcache import listener as ref_listener
from cilium_tpu.l7 import fast as ref_fast
from cilium_tpu.l7 import http as ref_http
from cilium_tpu.l7 import kafka as ref_kafka
from cilium_tpu.l7 import parser as ref_parser
from cilium_tpu.policy import api as ref_api
from cilium_tpu.policy import jsonio as ref_jsonio
from cilium_tpu.policy import l3 as ref_l3
from cilium_tpu.policy import mapstate as ref_mapstate
from cilium_tpu.policy import repository as ref_repository
from cilium_tpu.policy import trace as ref_trace

from cilium_tpu_torch import convert, identity, labels, proxy
from cilium_tpu_torch.compiler import lpm
from cilium_tpu_torch.ipcache import cidr, ipcache, listener
from cilium_tpu_torch.l7 import fast, http, kafka, parser
from cilium_tpu_torch.policy import api, jsonio, l3, mapstate, repository
from cilium_tpu_torch.policy import trace
from cilium_tpu_torch.workloads import policy_state

from test_policygen_matrix import (APPS, PORTS, STRANGER_PORT,
                                   _gen_egress_rules, _gen_rules)

PKGS = {"ref": dict(labels=ref_labels, identity=ref_identity,
                    api=ref_api, jsonio=ref_jsonio, l3=ref_l3,
                    mapstate=ref_mapstate, repository=ref_repository,
                    trace=ref_trace, proxy=ref_proxy,
                    ipcache=ref_ipcache, cidr=ref_cidr, http=ref_http,
                    kafka=ref_kafka, parser=ref_parser),
        "port": dict(labels=labels, identity=identity, api=api,
                     jsonio=jsonio, l3=l3, mapstate=mapstate,
                     repository=repository, trace=trace, proxy=proxy,
                     ipcache=ipcache, cidr=cidr, http=http, kafka=kafka,
                     parser=parser)}

LABEL_TEXTS = ["k8s:app=web", "app=db", "$host", "reserved:world",
               "container:io.kubernetes.pod.name=x=y", "k8s:tier",
               "cidr:10-0-0-0-8", "any:role=front", "reserved:=health",
               "mesos:io.x.y=z", ":", ""]
CIDRS = ["10.0.0.0/8", "192.168.3.0/24", "172.16.5.7/32", "0.0.0.0/0",
         "2001:db8::/48", "fd00::1/128"]


def _rules(pkg, text):
    return PKGS[pkg]["jsonio"].rules_from_json(text)


def _repo(pkg, text):
    repo = PKGS[pkg]["repository"].Repository()
    repo.add_list(_rules(pkg, text))
    return repo


def _labels_model(m, texts):
    arr = m.LabelArray.parse(*texts)
    lbls = m.Labels.from_model(texts)
    return {"array": [(str(l), l.extended_key, l.sort_key(),
                       l.is_reserved()) for l in arr],
            "select": [str(l) for l in m.LabelArray.parse_select(*texts)],
            "sorted": repr(arr.sorted()), "model": arr.get_model(),
            "has": [arr.has(k) for k in ("any.app", "k8s.app", "any.tier",
                                         "reserved.host", "cidr.x")],
            "get": [arr.get(k) for k in ("any.app", "k8s.tier")],
            "contains": arr.contains(m.LabelArray.parse(*texts[:2])),
            "list": lbls.sorted_list(), "sha": lbls.sha256_sum(),
            "labels_model": lbls.get_model(),
            "cidr": [(repr(m.get_cidr_labels(c)),
                      str(m.ip_to_cidr_label(c))) for c in CIDRS]}


def test_labels_match_reference():
    assert _labels_model(labels, LABEL_TEXTS) == \
        _labels_model(ref_labels, LABEL_TEXTS)


def _identity_sequence(m, cluster_id):
    events = []
    alloc = m.LocalIdentityAllocator(
        cluster_id=cluster_id,
        on_change=lambda kind, ident: events.append((kind, ident.id)))
    lbl = PKGS["port" if m is identity else "ref"]["labels"]
    sets = [lbl.Labels.from_model([f"k8s:app=a{i % 5}", f"k8s:n={i % 3}"])
            for i in range(12)]
    sets.append(lbl.Labels.from_model(["reserved:host"]))
    out = []
    held = []
    for s in sets:
        ident, new = alloc.allocate(s)
        held.append(ident)
        out.append(("alloc", ident.id, new, ident.labels_sha256))
    for ident in held[::2] + held[:3]:
        out.append(("release", ident.id, alloc.release(ident)))
    again, new = alloc.allocate(sets[0])
    out.append(("again", again.id, new))
    out.append(("refcount", sorted(alloc._refcount.items())))
    out.append(("lookup", [getattr(alloc.lookup_by_id(i), "id", None)
                           for i in (1, 2, 5, 256, 257, 300,
                                     (cluster_id << 16) | 257)]))
    out.append(("by_labels", [getattr(alloc.lookup_by_labels(s), "id",
                                      None) for s in sets]))
    cache = m.IdentityCache.snapshot(alloc)
    out.append(("cache", {k: [str(l) for l in v] for k, v in cache.items()}))
    out.append(("reserved", [m.get_reserved_id(n) for n in
                             ("host", "world", "health", "init",
                              "unmanaged", "nope")],
                [m.is_reserved_identity(i) for i in (0, 1, 5, 255, 256)],
                [getattr(m.look_up_reserved_identity(i), "id", None)
                 for i in range(7)]))
    out.append(("len", len(alloc), events))
    return out


@pytest.mark.parametrize("cluster_id", [0, 5])
def test_identity_allocation_sequence_matches_reference(cluster_id):
    assert _identity_sequence(identity, cluster_id) == \
        _identity_sequence(ref_identity, cluster_id)


EVERY_FIELD = [
    {"endpointSelector": {"matchLabels": {"app": "web"},
                          "matchExpressions": [
                              {"key": "k8s:tier", "operator": "NotIn",
                               "values": ["db"]},
                              {"key": "env", "operator": "Exists"}]},
     "description": "every field",
     "labels": ["k8s:rule=all", "unspec:owner=me"],
     "ingress": [{"fromEndpoints": [{"matchLabels": {"k8s:app": "api"}}],
                  "toPorts": [{"ports": [{"port": "80",
                                          "protocol": "TCP"}],
                               "rules": {"http": [
                                   {"method": "GET", "path": "/a/.*",
                                    "host": "x.io",
                                    "headers": ["X-Y 1"]}]}}]},
                 {"fromRequires": [{"matchLabels": {"k8s:tier": "t"}}]},
                 {"fromCIDR": ["10.0.0.0/8"]},
                 {"fromCIDRSet": [{"cidr": "192.168.0.0/16",
                                   "except": ["192.168.1.0/24"]}]},
                 {"fromEntities": ["world", "host"],
                  "toPorts": [{"ports": [{"port": "9092",
                                          "protocol": "TCP"}],
                               "rules": {"kafka": [
                                   {"role": "consume", "topic": "t1"}]}}]}],
     "egress": [{"toEndpoints": [{}], "toPorts": [
         {"ports": [{"port": "53", "protocol": "UDP"},
                    {"port": "53", "protocol": "ANY"}]}]},
                {"toCIDR": ["172.16.0.0/12"],
                 "toPorts": [{"ports": [{"port": "443"}]}]},
                {"toCIDRSet": [{"cidr": "10.1.0.0/16",
                                "except": ["10.1.2.0/24"]}]},
                {"toFQDNs": [{"matchName": "a.example.com"},
                             {"matchPattern": "*.svc"}]},
                {"toServices": [{"k8sService": {"serviceName": "s",
                                                "namespace": "n"}}]},
                {"toEntities": ["cluster"]},
                {"toRequires": [{"matchLabels": {"k8s:tier": "x"}}]},
                {"toEndpoints": [{"matchLabels": {"app": "x"}}],
                 "toPorts": [{"ports": [{"port": "7000", "protocol": "TCP"}],
                              "rules": {"l7proto": "line",
                                        "l7": [{"cmd": "READ"}]}}]}]}]


@pytest.mark.parametrize("case", ["every-field", "policy-state"])
def test_rule_json_written_back_byte_equal(case):
    """The reference's ``rules_to_json``, read by the port's
    ``rules_from_json``, writes back byte for byte, and the same the
    other way round."""
    text = json.dumps(EVERY_FIELD) if case == "every-field" \
        else policy_state(300, 8, 8, 8, seed=4).rules_json
    ref_text = ref_jsonio.rules_to_json(ref_jsonio.rules_from_json(text))
    port_rules = jsonio.rules_from_json(ref_text)
    assert jsonio.rules_to_json(port_rules) == ref_text
    back = ref_jsonio.rules_from_json(jsonio.rules_to_json(port_rules))
    assert ref_jsonio.rules_to_json(back) == ref_text
    for r_ref, r_port in zip(ref_jsonio.rules_from_json(text), port_rules):
        assert repr(r_port) == repr(r_ref)
    assert [repr(r) for r in _repo("port", ref_text).to_model()] == \
        [repr(r) for r in _repo("ref", ref_text).to_model()]


def _l4_model(l4map):
    return {key: (f.port, f.protocol, f.u8proto,
                  [repr(s) for s in f.endpoints], f.l7_parser,
                  sorted((repr(s), repr(r))
                         for s, r in f.l7_rules_per_ep.items()),
                  f.ingress, [repr(l) for l in f.derived_from_rules],
                  f.allows_all_at_l3(), f.is_redirect())
            for key, f in l4map.items()}


def _cidr_model(pol):
    return [(sorted((k, [repr(l) for l in v.derived_from_rules])
                    for k, v in m.map.items()),
             sorted(m.ipv4_prefixes.items()), sorted(m.ipv6_prefixes.items()))
            for m in (pol.ingress, pol.egress)] + [pol.to_bpf_data()]


def _decisions(pkg, text, egress):
    """Every (src app, dst app, port) flow: the repository's decisions,
    L4 and CIDR resolutions and traced verdict texts."""
    m = PKGS[pkg]
    repo = _repo(pkg, text)
    out = []
    for src in APPS:
        for dst in APPS:
            frm = m["labels"].LabelArray.parse_select(f"app={src}")
            to = m["labels"].LabelArray.parse_select(f"app={dst}")
            for port in PORTS + [STRANGER_PORT]:
                ports = [m["trace"].Port(port, "TCP")]
                ctx = m["trace"].SearchContext(from_labels=frm,
                                               to_labels=to, dports=ports)
                traced = m["trace"].traced_context(frm, to, ports,
                                                   verbose=True)
                if egress:
                    row = (repo.can_reach_egress(ctx),
                           repo.allows_egress(ctx),
                           repo.allows_egress_label_access(ctx),
                           repo.allows_egress(traced))
                else:
                    row = (repo.can_reach_ingress(ctx),
                           repo.allows_ingress(ctx),
                           repo.allows_ingress_label_access(ctx),
                           repo.allows_ingress(traced))
                out.append((src, dst, port, [int(d) for d in row],
                            traced.trace_output()))
            ctx = m["trace"].SearchContext(from_labels=frm, to_labels=to)
            out.append(("l4", _l4_model(repo.resolve_l4_ingress_policy(ctx)),
                        _l4_model(repo.resolve_l4_egress_policy(ctx)),
                        _cidr_model(repo.resolve_cidr_policy(ctx))))
        pol = repo.resolve_l4_policy(m["trace"].SearchContext(
            to_labels=m["labels"].LabelArray.parse_select(f"app={src}"),
            from_labels=m["labels"].LabelArray.parse_select(f"app={src}")))
        out.append(("policy", _l4_model(pol.ingress), _l4_model(pol.egress),
                    pol.has_redirect(), pol.requires_conntrack()))
    return out


@pytest.mark.parametrize("egress", [False, True],
                         ids=["ingress", "egress"])
@pytest.mark.parametrize("seed", [1, 7, 23])
def test_repository_decisions_match_reference(seed, egress):
    """``tests/test_policygen_matrix.py``'s generators (the reference's
    rule objects, handed over as JSON): can_reach, allows, label access,
    the traced verdict text, L4 and CIDR resolution, all equal."""
    rng = np.random.default_rng(seed)
    rules = _gen_egress_rules(rng) if egress else _gen_rules(rng)[0]
    text = ref_jsonio.rules_to_json(rules)
    got = _decisions("port", text, egress)
    assert got == _decisions("ref", text, egress)
    assert any(row[3][1] == 1 for row in got if len(row) == 5)


def _map_states(pkg, text, n_endpoints=6, n_peers=8):
    """Desired map state of each endpoint of a ``policy_state`` rule set
    over its identities, redirects numbered from the proxy id, then the
    diff from each endpoint's state to the next one's."""
    m = PKGS[pkg]
    st = policy_state(150, n_endpoints, n_peers, 8, seed=3)
    repo = _repo(pkg, st.rules_json if text is None else text)
    alloc = m["identity"].LocalIdentityAllocator()
    work = [l for _, _, l in st.endpoints] + [l for _, l in st.peers]
    for lbl in work:
        alloc.allocate(m["labels"].Labels.from_model(list(lbl)))
    for c in st.cidrs:
        alloc.allocate(m["labels"].Labels.from_labels(
            m["labels"].get_cidr_labels(c)))
    cache = m["identity"].IdentityCache.snapshot(alloc)

    def redirect_port(flt):
        return 10000 + sum(map(ord, m["proxy"].proxy_id(
            7, flt.ingress, flt.protocol, flt.port))) % 997

    states = []
    for i, (_, _, lbl) in enumerate(st.endpoints):
        cfg = m["mapstate"].EndpointPolicyConfig(
            always_allow_localhost=i % 2 == 0, host_allows_world=i % 3 == 0,
            egress_enforcement=i != 4)
        states.append(m["mapstate"].compute_desired_policy_map_state(
            repo, cache, m["labels"].LabelArray.parse(*lbl),
            redirect_port_for=redirect_port, config=cfg))
    key = lambda k: (k.identity, k.dest_port, k.nexthdr, k.direction)  # noqa
    sets = [sorted((key(k), v.proxy_port) for k, v in s.items())
            for s in states]
    diffs = []
    for a, b in zip(states, states[1:]):
        adds, deletes = m["mapstate"].diff_map_state(a, b)
        diffs.append((sorted((key(k), v.proxy_port) for k, v in adds),
                      sorted(key(k) for k in deletes)))
    sec = m["mapstate"].get_security_identities(
        cache, m["api"].EndpointSelector.parse("app=web"))
    return sets, diffs, sec, [key(m["mapstate"].LOCALHOST_KEY),
                              key(m["mapstate"].WORLD_KEY)]


def test_map_state_and_diff_match_reference():
    got = _map_states("port", None)
    assert got == _map_states("ref", None)
    sets = got[0]
    assert all(len(s) > 20 for s in sets)
    assert any(p > 0 for s in sets for _, p in s)


def test_allows_and_map_state_diverge_as_in_reference():
    """A fromRequires rule, an L3-only rule and an L7 rule on one
    endpoint: ``allows_ingress`` denies a peer that the map state
    redirects (the reference's wildcard L3 -> L7 merge drops the
    requirement).  Both packages give the same two answers."""
    rules = json.dumps([
        {"endpointSelector": {"matchLabels": {"k8s:app": "e"}},
         "ingress": [{"fromEndpoints": [{"matchLabels": {"k8s:app": "x"}}],
                      "toPorts": [{"ports": [{"port": "80",
                                              "protocol": "TCP"}],
                                   "rules": {"http": [{"method": "GET"}]}}]}]},
        {"endpointSelector": {"matchLabels": {"k8s:app": "e"}},
         "ingress": [{"fromRequires": [{"matchLabels": {"k8s:tier": "t"}}]}]},
        {"endpointSelector": {"matchLabels": {"k8s:app": "e"}},
         "ingress": [{"fromEndpoints": [{"matchLabels": {"k8s:app": "r"}}]}]}])
    out = {}
    for pkg, m in PKGS.items():
        repo = _repo(pkg, rules)
        ep = m["labels"].LabelArray.parse("k8s:app=e")
        peer = m["labels"].LabelArray.parse("k8s:app=r", "k8s:tier=u")
        allows = repo.allows_ingress(m["trace"].SearchContext(
            from_labels=peer, to_labels=ep,
            dports=[m["trace"].Port(80, "TCP")]))
        st = m["mapstate"].compute_desired_policy_map_state(
            repo, {300: peer}, ep, redirect_port_for=lambda f: 10000)
        out[pkg] = (int(allows), sorted(
            ((k.identity, k.dest_port, k.nexthdr), v.proxy_port)
            for k, v in st.items()))
    assert out["port"] == out["ref"]
    assert out["port"][0] == int(api.Decision.DENIED)
    assert ((300, 80, 6), 10000) in out["port"][1]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class name is compared
        return type(e).__name__, str(e)
    return None


def _error_paths(pkg):
    m = PKGS[pkg]
    a = m["api"]
    out = [_error(lambda: m["jsonio"].rules_from_json("{}")),
           _error(lambda: m["jsonio"].rules_from_json("3")),
           _error(lambda: a.Rule(endpoint_selector=None).sanitize())]
    # L7 parser conflict on one port, found when resolving
    conflict = json.dumps([
        {"endpointSelector": {"matchLabels": {"app": "e"}},
         "ingress": [{"toPorts": [{"ports": [{"port": "80",
                                              "protocol": "TCP"}],
                                   "rules": {"http": [{}]}}]}]},
        {"endpointSelector": {"matchLabels": {"app": "e"}},
         "ingress": [{"toPorts": [{"ports": [{"port": "80",
                                              "protocol": "TCP"}],
                                   "rules": {"kafka": [{"topic": "t"}]}}]}]}])
    repo = _repo(pkg, conflict)
    out.append(_error(lambda: repo.resolve_l4_ingress_policy(
        m["trace"].SearchContext(
            to_labels=m["labels"].LabelArray.parse_select("app=e")))))
    # map overflow: more keys than one endpoint's policy map holds
    wide = json.dumps([{"endpointSelector": {"matchLabels": {"app": "e"}},
                        "ingress": [{"fromEndpoints": [
                            {"matchLabels": {"app": "p"}}],
                            "toPorts": [{"ports": [
                                {"port": str(p), "protocol": "TCP"}
                                for p in range(q, q + 10)]}]}]}
                       for q in range(1, 101, 10)])
    cache = {256 + i: m["labels"].LabelArray.parse("k8s:app=p", f"k8s:n={i}")
             for i in range(170)}
    out.append(_error(lambda: m["mapstate"].compute_desired_policy_map_state(
        _repo(pkg, wide), cache, m["labels"].LabelArray.parse("k8s:app=e"))))
    # CIDR prefix-length limits: in a rule, and in a resolved policy
    many = [f"10.0.0.0/{p}" for p in range(0, 33)] + \
        [f"fd00::/{p}" for p in range(100, 110)]
    out.append(_error(lambda: m["jsonio"].rules_from_json(json.dumps(
        [{"endpointSelector": {}, "egress": [{"toCIDR": many}]}]))[0]
        .sanitize()))
    pol = m["l3"].CIDRPolicy()
    for i, c in enumerate(f"fd00::/{p}" for p in range(1, 60)):
        pol.egress.insert(c, m["labels"].LabelArray())
    out.append(_error(pol.validate))
    out.append(_error(lambda: a.PortProtocol(port="70000").sanitize()))
    out.append(_error(lambda: m["mapstate"].PolicyKey(dest_port=1 << 16)))
    return out


def test_error_paths_raise_on_both_sides():
    got, want = _error_paths("port"), _error_paths("ref")
    # the port's PolicyKey raises ValueError where the reference asserts
    assert got[-1][0] == "ValueError" and want[-1][0] == "AssertionError"
    assert got[:-1] == want[:-1]
    assert all(e is not None for e in got)


def _filters(pkg, text, ep_labels):
    m = PKGS[pkg]
    repo = _repo(pkg, text)
    lbl = m["labels"].LabelArray.parse(*ep_labels)
    ing = repo.resolve_l4_ingress_policy(m["trace"].SearchContext(
        to_labels=lbl))
    eg = repo.resolve_l4_egress_policy(m["trace"].SearchContext(
        from_labels=lbl))
    return [f for f in list(ing.values()) + list(eg.values())
            if f.is_redirect()]


PROXY_RULES = json.dumps([
    {"endpointSelector": {"matchLabels": {"k8s:app": "web"}},
     "ingress": [{"toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                               "rules": {"http": [
                                   {"method": "GET", "path": "/public/.*"},
                                   {"method": "POST", "path": "/api/v1"}]}}]},
                 {"fromEndpoints": [{"matchLabels": {"k8s:app": "db"}}],
                  "toPorts": [{"ports": [{"port": "8080",
                                          "protocol": "TCP"}],
                               "rules": {"http": [{"path": "/x"}]}}]},
                 {"toPorts": [{"ports": [{"port": "9092",
                                          "protocol": "TCP"}],
                               "rules": {"kafka": [
                                   {"role": "consume",
                                    "topic": "events"}]}}]}],
     "egress": [{"toPorts": [{"ports": [{"port": "443",
                                         "protocol": "TCP"}],
                              "rules": {"http": [
                                  {"method": "GET", "host": "api\\.io"}]}}]},
                {"toPorts": [{"ports": [{"port": "8443",
                                         "protocol": "TCP"}],
                              "rules": {"http": [
                                  {"headers": ["X-T 1"]}]}}]}]}])


def _proxy_run(pkg, **kw):
    m = PKGS[pkg]
    mgr = m["proxy"].ProxyManager(port_min=15000, port_max=15009, **kw)
    changes = []
    mgr.on_change = lambda: changes.append(len(mgr))
    flts = _filters(pkg, PROXY_RULES, ("k8s:app=web",))
    out = []
    for ep in (7, 9):
        for f in flts:
            r = mgr.create_or_update_redirect(f, ep)
            out.append((r.id, r.proxy_port, r.parser_type, r.to_port,
                        r.ingress, r.endpoint_id))
    out.append(("full", _error(lambda: mgr.create_or_update_redirect(
        flts[0], 11))))
    out.append(("remove", mgr.remove_redirect(
        m["proxy"].proxy_id(7, True, "TCP", 80)),
        mgr.remove_redirect("nope")))
    r = mgr.create_or_update_redirect(flts[0], 11)
    out.append((r.id, r.proxy_port))
    out.append(("ids", sorted((r.id, r.proxy_port)
                              for r in mgr.redirects()), len(mgr), changes))
    web = m["labels"].LabelArray.parse("k8s:app=db")
    reqs = [m["http"].HTTPRequest(method=meth, path=path, host=host)
            for meth, path, host in [("GET", "/public/a", ""),
                                     ("POST", "/api/v1", ""),
                                     ("GET", "/x", ""), ("PUT", "/", "")]]
    for rid in (m["proxy"].proxy_id(9, True, "TCP", 80),
                m["proxy"].proxy_id(9, True, "TCP", 8080)):
        out.append(("http", rid, [bool(v) for v in mgr.check_http(
            mgr.get(rid), web, reqs)]))
    kreq = [m["kafka"].KafkaRequest(api_key=k, api_version=0,
                                    correlation_id=i, client_id="c",
                                    topics=[t])
            for i, (k, t) in enumerate(((1, "events"), (0, "events"),
                                        (1, "other")))]
    out.append(("kafka", [bool(v) for v in mgr.check_kafka(
        mgr.get(m["proxy"].proxy_id(9, True, "TCP", 9092)), web, kreq)]))
    out.append(("log", [(e.proxy_id, e.l7_protocol, e.verdict, e.info)
                        for e in mgr.access_log.tail(20)]))
    return out, mgr


def test_proxy_redirects_match_reference():
    """Redirect ids and ports (allocation, exhaustion of a small range,
    reuse after a removal), the HTTP and Kafka checks and the access
    log."""
    got, _ = _proxy_run("port", device="cpu")
    want, _ = _proxy_run("ref")
    assert got == want
    assert got[-1][1] and ("full", ("RuntimeError",
                                    "proxy port range exhausted")) in got


def test_fast_programs_from_real_redirects_match_reference():
    """``l7/fast.programs_from_redirects`` over the port's own
    ``ProxyManager`` redirects builds the programs the reference builds
    from its ``ProxyManager`` on the same rules."""
    _, mgr = _proxy_run("port", device="cpu")
    _, ref_mgr = _proxy_run("ref")
    got = fast.programs_from_redirects(mgr.redirects(), window=64)
    want = convert.l7_programs_from_jax(ref_fast.programs_from_redirects(
        ref_mgr.redirects(), window=64))
    for f in ("flat", "cmap", "accept", "starts", "pmask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.k, got.c1, got.window, got.port_to_prog, got.protocols,
            got.states, got.specs) == \
        (want.k, want.c1, want.window, want.port_to_prog, want.protocols,
         want.states, want.specs)
    assert len(got.port_to_prog) >= 3


def _ipcache_run(pkg):
    m = PKGS[pkg]
    ic, cm = m["ipcache"], m["cidr"]
    cache = ic.IPCache()
    seen = []
    cache.add_listener(lambda mod, pair, old: seen.append(
        (mod, pair.prefix, pair.identity, pair.source, old)))
    out = [cache.upsert("10.1.0.5", 300, ic.SOURCE_KVSTORE),
           cache.upsert("10.1.0.5", 301, ic.SOURCE_K8S),
           cache.upsert("10.1.0.5", 302, ic.SOURCE_AGENT_LOCAL),
           cache.upsert("10.1.0.5", 302, ic.SOURCE_AGENT_LOCAL),
           cache.upsert("fd00::5", 303, ic.SOURCE_KVSTORE, host_ip="1.2.3.4"),
           cache.upsert("10.2.0.0/16", 304, ic.SOURCE_CUSTOM_RESOURCE),
           _error(lambda: cache.upsert("10.3.0.1", 1, "bogus")),
           cache.delete("10.1.0.5", ic.SOURCE_KVSTORE),
           cache.delete("10.9.9.9", ic.SOURCE_KVSTORE)]
    alloc = m["identity"].LocalIdentityAllocator()
    held = cm.allocate_cidr_identities(
        alloc, cache, ["10.2.0.0/16", "172.16.0.0/12", "192.168.1.7",
                       "2001:db8::/32"])
    again = cm.allocate_cidr_identities(alloc, cache, ["172.16.0.0/12"])
    out.append(sorted((p, i.id) for p, i in held.items()))
    out.append(cm.release_cidr_identities(alloc, cache, again))
    out.append(cm.release_cidr_identities(alloc, cache, held))
    out.append([(p.prefix, p.identity, p.source, p.host_ip, p.metadata)
                for p in cache.dump()])
    out.append(cache.to_lpm_prefix_families())
    out.append([cache.lookup_longest_prefix(a) for a in
                ("10.1.0.5", "10.2.3.4", "172.20.0.1", "fd00::5", "8.8.8.8")])
    out.append([cache.lookup_by_ip(a) for a in ("10.1.0.5", "10.2.0.0/16")])
    out.append(cache.lookup_by_identity(302))
    late = []
    cache.add_listener(lambda *a: late.append(a[1].prefix))
    out.append((seen, sorted(late), len(cache)))
    return out


def test_ipcache_and_cidr_identities_match_reference():
    assert _ipcache_run("port") == _ipcache_run("ref")


def test_lpm_listener_recompiles_as_reference():
    """``DatapathLPMListener``: the debounced recompile after ipcache
    churn hands the port's ``compile_lpm`` output, equal to the
    reference's, to the swap callback; threads stop in ``finally``."""
    got = {}
    for pkg, lst, compiled_mod in (("port", listener, lpm),
                                   ("ref", ref_listener, ref_lpm)):
        cache = PKGS[pkg]["ipcache"].IPCache()
        swaps = []
        lis = lst.DatapathLPMListener(cache, swaps.append)
        try:
            for i in range(20):
                cache.upsert(f"10.{i}.0.0/16", 400 + i,
                             PKGS[pkg]["ipcache"].SOURCE_KVSTORE)
            cache.upsert("10.3.4.5", 999, PKGS[pkg]["ipcache"].SOURCE_K8S)
            assert lis.flush(timeout=10.0)
            last = swaps[-1]
        finally:
            lis.shutdown()
        got[pkg] = {k: np.asarray(v) for k, v in vars(last).items()
                    if isinstance(v, np.ndarray)}
        got[pkg]["meta"] = (last.slots, last.max_probe)
        assert lis.generation >= 1
    assert got["port"].keys() == got["ref"].keys()
    for k in got["port"]:
        np.testing.assert_array_equal(got["port"][k], got["ref"][k])


def _parser_run(pkg):
    m = PKGS[pkg]["parser"]
    api_m = PKGS[pkg]["api"]
    log = []
    inst = m.Instance(access_logger=log.append)
    out = [inst.on_new_connection("line", 1, True, 5, 6, l7_rules=[
        api_m.PortRuleL7.from_dict({"cmd": "READ"})]),
           inst.on_new_connection("block", 2, False, 7, 8),
           inst.on_new_connection("nope", 3, True, 0, 0)]
    for conn, chunks in ((1, [b"READ a\nWRITE b\nREA", b"READ c\n"]),
                         (2, [b"0003DXY0002", b"ok0000", b"00x1"])):
        for c in chunks:
            out.append([(o.op.value, o.n, o.data) for o in
                        inst.on_data(conn, False, False, c)])
    out.append([(o.op.value, o.n) for o in inst.on_data(1, True, False,
                                                          b"reply")])
    out.append([(o.op.value, o.n) for o in inst.on_data(9, False, False,
                                                          b"x")])
    inst.close(1)
    out.append((len(inst), log))
    return out


def test_parser_framework_matches_reference():
    assert _parser_run("port") == _parser_run("ref")
