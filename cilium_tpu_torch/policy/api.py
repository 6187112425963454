"""The L7 parts of the user-facing policy rule model.

Copy of the parts of ``cilium_tpu/policy/api.py`` that the L7 engines
take (reference: pkg/policy/api http.go, kafka.go, fqdn.go):
``PortRuleHTTP``, ``PortRuleKafka`` with ``KAFKA_API_KEY_MAP``, and
``FQDNSelector``, each with its ``sanitize`` and matchers.  Selectors,
L3/L4 rules and rule resolution are not part of the port yet.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple


class PolicyError(ValueError):
    """A rule failed sanitization."""


# ---------------------------------------------------------------------------
# L7 rules (reference: http.go, kafka.go)
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
