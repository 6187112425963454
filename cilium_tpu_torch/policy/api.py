"""User-facing policy rule model: selectors, L3/L4/L7 rules, validation.

A whole copy of ``cilium_tpu/policy/api.py``.

Semantics follow the reference's ``pkg/policy/api`` (rule.go, ingress.go,
egress.go, l4.go, http.go, kafka.go, l7.go, cidr.go, entity.go, fqdn.go,
selector.go, rule_validation.go). The rule model is the *spec*; evaluation
lives in ``policy/repository.py`` and compilation to tensors in
``compiler/``.
"""

from __future__ import annotations

import enum
import ipaddress
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .. import labels as lbl
from ..labels import Label, LabelArray, Labels


class PolicyError(ValueError):
    """A rule failed sanitization."""


# ---------------------------------------------------------------------------
# Decision (reference: pkg/policy/api/decision.go)
# ---------------------------------------------------------------------------

class Decision(enum.IntEnum):
    UNDECIDED = 0
    ALLOWED = 1
    DENIED = 2

    def __str__(self):
        return {0: "undecided", 1: "allowed", 2: "denied"}[int(self)]


# ---------------------------------------------------------------------------
# L4 protocol (reference: pkg/policy/api/l4.go, pkg/u8proto)
# ---------------------------------------------------------------------------

PROTO_ANY = "ANY"
PROTO_TCP = "TCP"
PROTO_UDP = "UDP"

U8PROTO = {PROTO_ANY: 0, PROTO_TCP: 6, PROTO_UDP: 17, "ICMP": 1, "ICMPV6": 58}
U8PROTO_NAMES = {v: k for k, v in U8PROTO.items()}


def parse_l4_proto(proto: str) -> str:
    """Normalize a protocol name ('' -> ANY). Reference: l4.go ParseL4Proto."""
    if proto == "":
        return PROTO_ANY
    up = proto.upper()
    if up not in (PROTO_ANY, PROTO_TCP, PROTO_UDP):
        raise PolicyError(f"invalid protocol {proto!r}, must be { {'TCP','UDP','ANY'} }")
    return up


# ---------------------------------------------------------------------------
# EndpointSelector (reference: pkg/policy/api/selector.go)
# ---------------------------------------------------------------------------

class Operator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"


@dataclass(frozen=True)
class Requirement:
    """One k8s-style LabelSelectorRequirement over *extended* keys."""

    key: str
    operator: Operator
    values: Tuple[str, ...] = ()

    def matches(self, arr: LabelArray) -> bool:
        present = arr.has(self.key)
        if self.operator == Operator.EXISTS:
            return present
        if self.operator == Operator.DOES_NOT_EXIST:
            return not present
        if self.operator == Operator.IN:
            return present and arr.get(self.key) in self.values
        if self.operator == Operator.NOT_IN:
            return (not present) or arr.get(self.key) not in self.values
        return False


def _extended_key_from(raw: str) -> str:
    """Encode a selector key with its source prefix.

    Reference: pkg/labels/labels.go:433 (GetExtendedKeyFrom): a key without
    a known ``source.`` or ``source:`` prefix gets the ``any.`` wildcard.
    """
    for sep in (":", "."):
        idx = raw.find(sep)
        if idx > 0:
            src = raw[:idx]
            if src in (lbl.SOURCE_ANY, lbl.SOURCE_K8S, lbl.SOURCE_CONTAINER,
                       lbl.SOURCE_RESERVED, lbl.SOURCE_CIDR, lbl.SOURCE_MESOS,
                       lbl.SOURCE_UNSPEC):
                key = raw[idx + 1:]
                if src == lbl.SOURCE_UNSPEC:
                    src = lbl.SOURCE_ANY
                return src + lbl.PATH_DELIMITER + key
    return lbl.ANY_PREFIX + raw


class EndpointSelector:
    """Label selector with cached requirements for fast ``matches()``.

    Keys in ``match_labels``/``match_expressions`` are *extended* keys
    (``source.key``); plain keys get the ``any.`` wildcard source.
    Reference: pkg/policy/api/selector.go:34.
    """

    __slots__ = ("match_labels", "requirements", "_key")

    def __init__(self,
                 match_labels: Optional[Dict[str, str]] = None,
                 match_expressions: Optional[Sequence[Requirement]] = None,
                 _raw_keys: bool = False):
        ml: Dict[str, str] = {}
        for k, v in (match_labels or {}).items():
            ml[k if _raw_keys else _extended_key_from(k)] = v
        reqs: List[Requirement] = [
            Requirement(key=r.key if _raw_keys else _extended_key_from(r.key),
                        operator=r.operator, values=tuple(r.values))
            for r in (match_expressions or [])
        ]
        reqs.extend(Requirement(key=k, operator=Operator.IN, values=(v,))
                    for k, v in sorted(ml.items()))
        self.match_labels = ml
        self.requirements: Tuple[Requirement, ...] = tuple(reqs)
        self._key = (tuple(sorted(ml.items())),
                     tuple((r.key, r.operator, r.values)
                           for r in self.requirements))

    @classmethod
    def from_labels(cls, *labels_: Label) -> "EndpointSelector":
        """Reference: selector.go:180 NewESFromLabels."""
        ml = {l.extended_key: l.value for l in labels_}
        return cls(match_labels=ml, _raw_keys=True)

    @classmethod
    def parse(cls, *label_strs: str) -> "EndpointSelector":
        return cls.from_labels(*(lbl.parse_select_label(s) for s in label_strs))

    def matches(self, arr: LabelArray) -> bool:
        return all(r.matches(arr) for r in self.requirements)

    def is_wildcard(self) -> bool:
        return len(self.requirements) == 0

    def has_key_prefix(self, prefix: str) -> bool:
        return any(r.key.startswith(prefix) for r in self.requirements)

    def sanitize(self) -> None:
        for r in self.requirements:
            if r.operator in (Operator.IN, Operator.NOT_IN) and not r.values:
                raise PolicyError(
                    f"operator {r.operator} requires values for key {r.key}")

    def to_model(self) -> Dict:
        d: Dict = {}
        if self.match_labels:
            d["matchLabels"] = dict(self.match_labels)
        exprs = [r for r in self.requirements
                 if not (r.operator == Operator.IN and r.key in self.match_labels
                         and r.values == (self.match_labels[r.key],))]
        if exprs:
            d["matchExpressions"] = [
                {"key": r.key, "operator": r.operator.value,
                 "values": list(r.values)} for r in exprs]
        return d

    def __eq__(self, other):
        return isinstance(other, EndpointSelector) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return f"EndpointSelector({json.dumps(self.to_model(), sort_keys=True)})"


# Wildcard selector matches all endpoints (reference: selector.go:225).
WILDCARD_SELECTOR = EndpointSelector()


def reserved_selector(name: str) -> EndpointSelector:
    return EndpointSelector.from_labels(lbl.reserved_label(name))


RESERVED_ENDPOINT_SELECTORS = {
    lbl.ID_NAME_HOST: reserved_selector(lbl.ID_NAME_HOST),
    lbl.ID_NAME_WORLD: reserved_selector(lbl.ID_NAME_WORLD),
}


class EndpointSelectorSlice(list):
    """Reference: selector.go EndpointSelectorSlice."""

    def matches(self, arr: LabelArray) -> bool:
        return any(sel.matches(arr) for sel in self)

    def selects_all(self) -> bool:
        """Empty slice or a wildcard member selects all endpoints
        (reference: selector.go:365-377 SelectsAllEndpoints)."""
        if len(self) == 0:
            return True
        return any(sel.is_wildcard() for sel in self)


# ---------------------------------------------------------------------------
# Entities (reference: pkg/policy/api/entity.go)
# ---------------------------------------------------------------------------

ENTITY_ALL = "all"
ENTITY_WORLD = "world"
ENTITY_CLUSTER = "cluster"
ENTITY_HOST = "host"
ENTITY_INIT = "init"

# k8s cluster-name policy label (reference: pkg/k8s/apis/cilium.io —
# PolicyLabelCluster "io.cilium.k8s.policy.cluster").
POLICY_LABEL_CLUSTER = "io.cilium.k8s.policy.cluster"

ENTITY_SELECTOR_MAPPING: Dict[str, EndpointSelectorSlice] = {
    ENTITY_ALL: EndpointSelectorSlice([WILDCARD_SELECTOR]),
    ENTITY_WORLD: EndpointSelectorSlice([reserved_selector(lbl.ID_NAME_WORLD)]),
    ENTITY_HOST: EndpointSelectorSlice([reserved_selector(lbl.ID_NAME_HOST)]),
    ENTITY_INIT: EndpointSelectorSlice([reserved_selector(lbl.ID_NAME_INIT)]),
    ENTITY_CLUSTER: EndpointSelectorSlice(),
}


def init_entities(cluster_name: str) -> None:
    """Populate the cluster entity at runtime (reference: entity.go
    InitEntities)."""
    ENTITY_SELECTOR_MAPPING[ENTITY_CLUSTER] = EndpointSelectorSlice([
        reserved_selector(lbl.ID_NAME_HOST),
        reserved_selector(lbl.ID_NAME_INIT),
        reserved_selector(lbl.ID_NAME_UNMANAGED),
        EndpointSelector.from_labels(
            Label(key=POLICY_LABEL_CLUSTER, value=cluster_name,
                  source=lbl.SOURCE_K8S)),
    ])


init_entities("default")


def entities_as_selectors(entities: Sequence[str]) -> EndpointSelectorSlice:
    out = EndpointSelectorSlice()
    for e in entities:
        out.extend(ENTITY_SELECTOR_MAPPING.get(e, []))
    return out


# ---------------------------------------------------------------------------
# CIDR (reference: pkg/policy/api/cidr.go, pkg/ip)
# ---------------------------------------------------------------------------

CIDR_MATCH_ALL = ("0.0.0.0/0", "::/0")


def cidr_matches_all(cidr: str) -> bool:
    return cidr in CIDR_MATCH_ALL


@dataclass(frozen=True)
class CIDRRule:
    """A CIDR prefix with carved-out exception subnets.

    Reference: pkg/policy/api/cidr.go:43 (CIDRRule).
    """

    cidr: str
    except_cidrs: Tuple[str, ...] = ()
    generated: bool = False

    def sanitize(self) -> int:
        plen = sanitize_cidr(self.cidr)
        outer = ipaddress.ip_network(self.cidr, strict=False)
        for exc in self.except_cidrs:
            inner = ipaddress.ip_network(exc, strict=False)
            if inner.version != outer.version or not _net_contains(outer, inner):
                raise PolicyError(
                    f"except CIDR {exc} is not contained in {self.cidr}")
        return plen


def _net_contains(outer, inner) -> bool:
    return (int(outer.network_address) & int(outer.netmask)) == \
        (int(inner.network_address) & int(outer.netmask)) and \
        inner.prefixlen >= outer.prefixlen


def sanitize_cidr(cidr: str) -> int:
    """Validate a CIDR string, returning its prefix length.

    Reference: rule_validation.go (CIDR.sanitize).
    """
    try:
        net = ipaddress.ip_network(cidr, strict=False)
    except ValueError as e:
        raise PolicyError(f"unable to parse CIDR {cidr!r}: {e}") from e
    return net.prefixlen


def remove_cidrs(allow: Sequence[str], remove: Sequence[str]) -> List[str]:
    """Minimal CIDR set covering ``allow`` minus ``remove``.

    Reference: pkg/ip (RemoveCIDRs) via address_exclude.
    """
    nets = [ipaddress.ip_network(a, strict=False) for a in allow]
    for r in remove:
        rnet = ipaddress.ip_network(r, strict=False)
        new: List = []
        for n in nets:
            if n.version != rnet.version or not n.overlaps(rnet):
                new.append(n)
            elif _net_contains(rnet, n):
                continue  # fully excluded
            else:
                new.extend(n.address_exclude(rnet))
        nets = new
    return [str(n) for n in sorted(nets, key=lambda n: (n.version, int(n.network_address), n.prefixlen))]


def compute_resultant_cidr_set(rules: Sequence[CIDRRule]) -> List[str]:
    """Expand CIDRRules (cidr minus exceptions) to a flat CIDR list.

    Reference: cidr.go ComputeResultantCIDRSet.
    """
    out: List[str] = []
    for r in rules:
        out.extend(remove_cidrs([r.cidr], list(r.except_cidrs)))
    return out


def cidrs_as_selectors(cidrs: Sequence[str]) -> EndpointSelectorSlice:
    """CIDR strings -> label selectors over generated cidr: labels.

    Reference: cidr.go GetAsEndpointSelectors — an all-matching CIDR also
    adds the reserved:world selector (once).
    """
    out = EndpointSelectorSlice()
    world_added = False
    for c in cidrs:
        if cidr_matches_all(c) and not world_added:
            world_added = True
            out.append(RESERVED_ENDPOINT_SELECTORS[lbl.ID_NAME_WORLD])
        out.append(EndpointSelector.from_labels(lbl.ip_to_cidr_label(c)))
    return out


# ---------------------------------------------------------------------------
# L7 rules (reference: http.go, kafka.go, l7.go)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PortRuleHTTP:
    """HTTP request match: POSIX regexes on path/method/host + header set.

    Reference: pkg/policy/api/http.go:28.
    """

    path: str = ""
    method: str = ""
    host: str = ""
    headers: Tuple[str, ...] = ()

    def sanitize(self) -> None:
        for pattern in (self.path, self.method, self.host):
            if pattern:
                try:
                    re.compile(pattern)
                except re.error as e:
                    raise PolicyError(f"invalid regex {pattern!r}: {e}") from e

    def exists(self, rules: Iterable["PortRuleHTTP"]) -> bool:
        return any(self == r for r in rules)

    def matches(self, method: str, path: str, host: str = "",
                headers: Optional[Dict[str, str]] = None) -> bool:
        """Anchored-regex request match (reference: http.go Matches — the
        Envoy HeaderMatcher regexes are full-string anchored)."""
        if self.method and not re.fullmatch(self.method, method):
            return False
        if self.path and not re.fullmatch(self.path, path):
            return False
        if self.host and not re.fullmatch(self.host, host):
            return False
        for h in self.headers:
            name, sep, want = h.partition(" ")
            got = (headers or {}).get(name.lower())
            if got is None:
                return False
            if sep and want and got != want:
                return False
        return True


# Kafka API keys (reference: kafka.go:110-187).
KAFKA_API_KEY_MAP: Dict[str, int] = {
    "produce": 0, "fetch": 1, "offsets": 2, "metadata": 3, "leaderandisr": 4,
    "stopreplica": 5, "updatemetadata": 6, "controlledshutdown": 7,
    "offsetcommit": 8, "offsetfetch": 9, "findcoordinator": 10,
    "joingroup": 11, "heartbeat": 12, "leavegroup": 13, "syncgroup": 14,
    "describegroups": 15, "listgroups": 16, "saslhandshake": 17,
    "apiversions": 18, "createtopics": 19, "deletetopics": 20,
    "deleterecords": 21, "initproducerid": 22, "offsetforleaderepoch": 23,
    "addpartitionstotxn": 24, "addoffsetstotxn": 25, "endtxn": 26,
    "writetxnmarkers": 27, "txnoffsetcommit": 28, "describeacls": 29,
    "createacls": 30, "deleteacls": 31, "describeconfigs": 32,
    "alterconfigs": 33,
}
KAFKA_REVERSE_API_KEY_MAP = {v: k for k, v in KAFKA_API_KEY_MAP.items()}

KAFKA_PRODUCE_ROLE = "produce"
KAFKA_CONSUME_ROLE = "consume"

# Role expansion (reference: kafka.go:273-293 MapRoleToAPIKey).
_PRODUCE_KEYS = (0, 3, 18)  # produce, metadata, apiversions
_CONSUME_KEYS = (1, 2, 3, 8, 9, 10, 11, 12, 13, 14, 18)

KAFKA_MAX_TOPIC_LEN = 255
_TOPIC_RE = re.compile(r"^[a-zA-Z0-9\._\-]+$")

# API keys whose requests carry topics (reference: kafka.go:108-133 +
# pkg/kafka request parsing).
KAFKA_TOPIC_API_KEYS = frozenset(
    [0, 1, 2, 3, 4, 5, 6, 8, 9, 19, 20, 21, 23, 24, 27, 28, 34, 35, 37])


@dataclass(frozen=True)
class PortRuleKafka:
    """Kafka message match. Reference: pkg/policy/api/kafka.go:26."""

    role: str = ""
    api_key: str = ""
    api_version: str = ""
    client_id: str = ""
    topic: str = ""

    def sanitize(self) -> "PortRuleKafka":
        if self.role and self.api_key:
            raise PolicyError(
                f"cannot set both Role {self.role!r} and APIKey {self.api_key!r}")
        if self.api_key and self.api_key.lower() not in KAFKA_API_KEY_MAP:
            raise PolicyError(f"invalid Kafka APIKey {self.api_key!r}")
        if self.role and self.role.lower() not in (KAFKA_PRODUCE_ROLE,
                                                   KAFKA_CONSUME_ROLE):
            raise PolicyError(f"invalid Kafka Role {self.role!r}")
        if self.api_version:
            try:
                v = int(self.api_version)
            except ValueError:
                raise PolicyError(f"invalid Kafka APIVersion {self.api_version!r}")
            if not 0 <= v < 2 ** 15:
                raise PolicyError(f"invalid Kafka APIVersion {self.api_version!r}")
        if self.topic:
            if len(self.topic) > KAFKA_MAX_TOPIC_LEN:
                raise PolicyError(f"kafka topic exceeds {KAFKA_MAX_TOPIC_LEN} chars")
            if not _TOPIC_RE.match(self.topic):
                raise PolicyError(f"invalid Kafka topic {self.topic!r}")
        return self

    @property
    def api_keys_int(self) -> Tuple[int, ...]:
        """Expanded allowed API keys ((-1,)==all).
        Reference: kafka.go apiKeyInt + MapRoleToAPIKey."""
        if self.api_key:
            return (KAFKA_API_KEY_MAP[self.api_key.lower()],)
        if self.role:
            return _PRODUCE_KEYS if self.role.lower() == KAFKA_PRODUCE_ROLE \
                else _CONSUME_KEYS
        return ()

    def exists(self, rules: Iterable["PortRuleKafka"]) -> bool:
        return any(self == r for r in rules)

    def matches_api_key(self, api_key: int) -> bool:
        allowed = self.api_keys_int
        return not allowed or api_key in allowed

    def matches_api_version(self, version: int) -> bool:
        return not self.api_version or int(self.api_version) == version

    def matches_client_id(self, client_id: str) -> bool:
        return not self.client_id or self.client_id == client_id

    def matches_topic(self, topic: str) -> bool:
        return not self.topic or self.topic == topic


@dataclass(frozen=True)
class PortRuleL7:
    """Generic key/value rule for custom parsers (reference: api/l7.go)."""

    fields: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "PortRuleL7":
        return cls(fields=tuple(sorted(d.items())))

    def as_dict(self) -> Dict[str, str]:
        return dict(self.fields)

    def exists(self, rules: Iterable["PortRuleL7"]) -> bool:
        return any(self == r for r in rules)


@dataclass
class L7Rules:
    """Union of L7 rule types — exactly one kind may be set.

    Reference: pkg/policy/api/l4.go:64.
    """

    http: List[PortRuleHTTP] = field(default_factory=list)
    kafka: List[PortRuleKafka] = field(default_factory=list)
    l7proto: str = ""
    l7: List[PortRuleL7] = field(default_factory=list)

    def __len__(self):
        return len(self.http) + len(self.kafka) + len(self.l7)

    def is_empty(self) -> bool:
        return len(self) == 0 and not self.l7proto

    def sanitize(self) -> None:
        kinds = sum([bool(self.http), bool(self.kafka),
                     bool(self.l7proto or self.l7)])
        if kinds > 1:
            raise PolicyError("multiple L7 rule kinds in one L7Rules")
        if self.l7 and not self.l7proto:
            raise PolicyError("L7 rules require l7proto")
        for h in self.http:
            h.sanitize()
        for k in self.kafka:
            k.sanitize()

    def copy(self) -> "L7Rules":
        return L7Rules(http=list(self.http), kafka=list(self.kafka),
                       l7proto=self.l7proto, l7=list(self.l7))


# ---------------------------------------------------------------------------
# L4 port rules (reference: l4.go)
# ---------------------------------------------------------------------------

MAX_PORTS = 40  # reference: rule_validation.go:27


@dataclass(frozen=True)
class PortProtocol:
    """An L4 port + optional protocol (reference: l4.go:26)."""

    port: str
    protocol: str = PROTO_ANY

    def sanitize(self) -> "PortProtocol":
        proto = parse_l4_proto(self.protocol)
        try:
            p = int(self.port)
        except ValueError:
            raise PolicyError(f"unable to parse port {self.port!r}")
        if not 0 <= p <= 65535:
            raise PolicyError(f"port {p} out of range")
        return PortProtocol(port=str(p), protocol=proto)


@dataclass
class PortRule:
    """Port/protocol list + optional L7 rules (reference: l4.go:44)."""

    ports: List[PortProtocol] = field(default_factory=list)
    rules: Optional[L7Rules] = None

    def sanitize(self, ingress: bool) -> None:
        if len(self.ports) > MAX_PORTS:
            raise PolicyError(f"too many ports {len(self.ports)}/{MAX_PORTS}")
        self.ports = [p.sanitize() for p in self.ports]
        if self.rules is not None and not self.rules.is_empty():
            # L7 restrictions are enforced by the TCP proxy path only
            # (reference: rule_validation.go:324).
            for p in self.ports:
                if p.protocol != PROTO_TCP:
                    raise PolicyError(
                        f"L7 rules can only apply exclusively to TCP, "
                        f"not {p.protocol}")
        if self.rules is not None:
            self.rules.sanitize()


# ---------------------------------------------------------------------------
# FQDN (reference: fqdn.go + pkg/fqdn matchpattern)
# ---------------------------------------------------------------------------

# Linear-time pattern (no nested quantifiers — a crafted name must not be
# able to trigger catastrophic backtracking in policy validation).
_FQDN_RE = re.compile(r"^[-a-zA-Z0-9_*]+(\.[-a-zA-Z0-9_*]+)*\.?$")


@dataclass(frozen=True)
class FQDNSelector:
    """DNS-name egress selector.

    The reference @v1.2 ships matchName (api/fqdn.go); matchPattern
    (``*.cilium.io``) followed shortly after and is part of the FQDN
    capability surface, so both are supported.
    """

    match_name: str = ""
    match_pattern: str = ""

    def sanitize(self) -> None:
        if not self.match_name and not self.match_pattern:
            raise PolicyError("FQDNSelector needs matchName or matchPattern")
        for s in (self.match_name, self.match_pattern):
            if s and not _FQDN_RE.match(s):
                raise PolicyError(f"invalid FQDN selector {s!r}")
        if self.match_name and "*" in self.match_name:
            raise PolicyError("matchName may not contain wildcards")

    def to_regex(self) -> str:
        """Lower to an anchored regex over dotted lowercase names."""
        src = self.match_pattern or self.match_name
        src = src.lower().rstrip(".")
        out = []
        for ch in src:
            if ch == "*":
                out.append("[-a-z0-9_]*")
            elif ch in ".+()[]{}^$|\\?":
                out.append("\\" + ch)
            else:
                out.append(ch)
        return "".join(out)

    def matches(self, name: str) -> bool:
        return re.fullmatch(self.to_regex(), name.lower().rstrip(".")) is not None


# ---------------------------------------------------------------------------
# Service selectors (reference: service.go)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class K8sServiceNamespace:
    service_name: str = ""
    namespace: str = ""


@dataclass(frozen=True)
class K8sServiceSelectorNamespace:
    selector: EndpointSelector = field(default_factory=EndpointSelector)
    namespace: str = ""


@dataclass(frozen=True)
class Service:
    k8s_service: Optional[K8sServiceNamespace] = None
    k8s_service_selector: Optional[K8sServiceSelectorNamespace] = None


# ---------------------------------------------------------------------------
# Ingress / Egress / Rule (reference: ingress.go, egress.go, rule.go)
# ---------------------------------------------------------------------------

@dataclass
class IngressRule:
    """Reference: pkg/policy/api/ingress.go:35."""

    from_endpoints: List[EndpointSelector] = field(default_factory=list)
    from_requires: List[EndpointSelector] = field(default_factory=list)
    to_ports: List[PortRule] = field(default_factory=list)
    from_cidr: List[str] = field(default_factory=list)
    from_cidr_set: List[CIDRRule] = field(default_factory=list)
    from_entities: List[str] = field(default_factory=list)

    def get_source_endpoint_selectors(self) -> EndpointSelectorSlice:
        """All L3 source selectors: endpoints + CIDR labels + entities.

        Reference: ingress.go GetSourceEndpointSelectors.
        """
        out = EndpointSelectorSlice(self.from_endpoints)
        out.extend(cidrs_as_selectors(self.from_cidr))
        out.extend(cidrs_as_selectors(
            compute_resultant_cidr_set(self.from_cidr_set)))
        out.extend(entities_as_selectors(self.from_entities))
        return out

    def sanitize(self) -> None:
        # L3 member exclusivity (reference: rule_validation.go:71-95).
        members = {
            "FromEndpoints": len(self.from_endpoints),
            "FromCIDR": len(self.from_cidr),
            "FromCIDRSet": len(self.from_cidr_set),
            "FromEntities": len(self.from_entities),
        }
        l4_support = {"FromEndpoints": True, "FromCIDR": False,
                      "FromCIDRSet": False, "FromEntities": True}
        _check_l3_members(members, l4_support, bool(self.to_ports))
        for es in self.from_endpoints + self.from_requires:
            es.sanitize()
        for pr in self.to_ports:
            pr.sanitize(ingress=True)
        plens = set()
        for c in self.from_cidr:
            plens.add(sanitize_cidr(c))
        for cr in self.from_cidr_set:
            plens.add(cr.sanitize())
        for e in self.from_entities:
            if e not in ENTITY_SELECTOR_MAPPING:
                raise PolicyError(f"unsupported entity: {e}")
        if len(plens) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyError(
                f"too many ingress CIDR prefix lengths "
                f"{len(plens)}/{MAX_CIDR_PREFIX_LENGTHS}")


@dataclass
class EgressRule:
    """Reference: pkg/policy/api/egress.go:28."""

    to_endpoints: List[EndpointSelector] = field(default_factory=list)
    to_requires: List[EndpointSelector] = field(default_factory=list)
    to_ports: List[PortRule] = field(default_factory=list)
    to_cidr: List[str] = field(default_factory=list)
    to_cidr_set: List[CIDRRule] = field(default_factory=list)
    to_entities: List[str] = field(default_factory=list)
    to_services: List[Service] = field(default_factory=list)
    to_fqdns: List[FQDNSelector] = field(default_factory=list)

    def get_destination_endpoint_selectors(self) -> EndpointSelectorSlice:
        out = EndpointSelectorSlice(self.to_endpoints)
        out.extend(cidrs_as_selectors(self.to_cidr))
        out.extend(cidrs_as_selectors(
            compute_resultant_cidr_set(self.to_cidr_set)))
        out.extend(entities_as_selectors(self.to_entities))
        return out

    def sanitize(self) -> None:
        members = {
            "ToEndpoints": len(self.to_endpoints),
            "ToCIDR": len(self.to_cidr),
            # generated entries are injected by ToServices/ToFQDNs
            # translation and legitimately coexist with their source
            # member (rule_translate.go / fqdn inject paths)
            "ToCIDRSet": len([c for c in self.to_cidr_set
                              if not c.generated]),
            "ToEntities": len(self.to_entities),
            "ToServices": len(self.to_services),
            "ToFQDNs": len(self.to_fqdns),
        }
        l4_support = {k: True for k in members}
        _check_l3_members(members, l4_support, bool(self.to_ports))
        for es in self.to_endpoints + self.to_requires:
            es.sanitize()
        for pr in self.to_ports:
            pr.sanitize(ingress=False)
        plens = set()
        for c in self.to_cidr:
            plens.add(sanitize_cidr(c))
        for cr in self.to_cidr_set:
            plens.add(cr.sanitize())
        for e in self.to_entities:
            if e not in ENTITY_SELECTOR_MAPPING:
                raise PolicyError(f"unsupported entity: {e}")
        for f in self.to_fqdns:
            f.sanitize()
        if len(plens) > MAX_CIDR_PREFIX_LENGTHS:
            raise PolicyError(
                f"too many egress CIDR prefix lengths "
                f"{len(plens)}/{MAX_CIDR_PREFIX_LENGTHS}")


MAX_CIDR_PREFIX_LENGTHS = 40  # reference: rule_validation.go:29


def _check_l3_members(members: Dict[str, int], l4_support: Dict[str, bool],
                      has_ports: bool) -> None:
    keys = list(members)
    for m1 in keys:
        for m2 in keys:
            if m1 != m2 and members[m1] > 0 and members[m2] > 0:
                raise PolicyError(f"combining {m1} and {m2} is not supported")
    for m in keys:
        if members[m] > 0 and has_ports and not l4_support[m]:
            raise PolicyError(f"combining {m} and ToPorts is not supported")


# Source of auto-generated labels that users may not submit
# (reference: pkg/labels — LabelSourceCiliumGenerated).
SOURCE_CILIUM_GENERATED = "cilium-generated"


@dataclass
class Rule:
    """One policy rule (reference: pkg/policy/api/rule.go:32)."""

    endpoint_selector: EndpointSelector
    ingress: List[IngressRule] = field(default_factory=list)
    egress: List[EgressRule] = field(default_factory=list)
    labels: LabelArray = field(default_factory=LabelArray)
    description: str = ""

    def sanitize(self) -> "Rule":
        for l in self.labels:
            if l.source == SOURCE_CILIUM_GENERATED:
                raise PolicyError("rule labels cannot have cilium-generated source")
        if self.endpoint_selector is None:
            raise PolicyError("rule cannot have nil EndpointSelector")
        self.endpoint_selector.sanitize()
        for i in self.ingress:
            i.sanitize()
        for e in self.egress:
            e.sanitize()
        return self
