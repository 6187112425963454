"""Kafka L7 policy: wire-protocol request parsing + ACL matching.

Host copy of ``cilium_tpu/l7/kafka.py`` (numpy only; it puts no work on
the device).  Semantics follow the reference's in-agent Kafka proxy
(pkg/proxy/kafka.go + pkg/kafka/policy.go:144-224): a request is allowed
iff every topic it names is allowed by some matching rule (topicless
requests need any one matching rule); a rule matches when its api-key
set (role-expanded), api-version, client-id and topic constraints hold.

The parser handles the classic request header (size, api_key,
api_version, correlation_id, client_id) and extracts topic lists for the
topic-carrying request kinds at their v0/v1 wire layouts (produce,
fetch, offsets, metadata, offset-commit/fetch); unrecognized bodies
parse as topicless, still subject to api-key/client-id rules.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..policy.api import KAFKA_API_KEY_MAP, PortRuleKafka

PRODUCE, FETCH, OFFSETS, METADATA = 0, 1, 2, 3
OFFSET_COMMIT, OFFSET_FETCH = 8, 9


class KafkaParseError(ValueError):
    pass


@dataclass
class KafkaRequest:
    """Parsed request header + extracted topics (pkg/kafka RequestMessage)."""

    api_key: int
    api_version: int
    correlation_id: int
    client_id: str
    topics: List[str] = field(default_factory=list)
    raw: bytes = b""


def _string(buf: bytes, off: int) -> Tuple[Optional[str], int]:
    if off + 2 > len(buf):
        raise KafkaParseError("truncated string length")
    (n,) = struct.unpack_from(">h", buf, off)
    off += 2
    if n < 0:
        return None, off
    if off + n > len(buf):
        raise KafkaParseError("truncated string body")
    return buf[off:off + n].decode("utf-8", "replace"), off + n


def _array_len(buf: bytes, off: int) -> Tuple[int, int]:
    if off + 4 > len(buf):
        raise KafkaParseError("truncated array length")
    (n,) = struct.unpack_from(">i", buf, off)
    return max(n, 0), off + 4


def parse_kafka_request(data: bytes) -> KafkaRequest:
    """Parse one size-prefixed Kafka request frame."""
    if len(data) < 4:
        raise KafkaParseError("short frame")
    (size,) = struct.unpack_from(">i", data, 0)
    if size < 8 or len(data) < 4 + size:
        raise KafkaParseError("truncated frame")
    buf = data[4:4 + size]
    api_key, api_version, corr = struct.unpack_from(">hhi", buf, 0)
    client_id, off = _string(buf, 8)
    req = KafkaRequest(api_key=api_key, api_version=api_version,
                       correlation_id=corr, client_id=client_id or "",
                       raw=data[:4 + size])
    try:
        req.topics = _extract_topics(buf, off, api_key, api_version)
    except KafkaParseError:
        req.topics = []
    return req


def _extract_topics(buf: bytes, off: int, key: int, version: int
                    ) -> List[str]:
    topics: List[str] = []
    if key == METADATA:
        n, off = _array_len(buf, off)
        for _ in range(n):
            t, off = _string(buf, off)
            if t:
                topics.append(t)
    elif key == PRODUCE:
        if version >= 3:        # transactional_id nullable string
            _, off = _string(buf, off)
        off += 6                # acks int16 + timeout int32
        n, off = _array_len(buf, off)
        for _ in range(n):
            t, off = _string(buf, off)
            if t:
                topics.append(t)
            break               # partition payloads follow; first is enough
    elif key in (FETCH, OFFSETS):
        off += 12 if key == FETCH else 4   # replica/max_wait/min_bytes
        n, off = _array_len(buf, off)
        for _ in range(n):
            t, off = _string(buf, off)
            if t:
                topics.append(t)
            break
    elif key in (OFFSET_COMMIT, OFFSET_FETCH):
        _, off = _string(buf, off)          # group id
        n, off = _array_len(buf, off)
        for _ in range(n):
            t, off = _string(buf, off)
            if t:
                topics.append(t)
            break
    return topics


class KafkaPolicyEngine:
    """One compiled Kafka rule set (one redirect's ACLs)."""

    def __init__(self, rules: Sequence[PortRuleKafka]):
        self.rules = [r.sanitize() for r in rules]
        # Columnar rule tables for the vectorized batch path: each rule
        # becomes (allowed-api-key set as a 64-bit mask over keys 0..63,
        # version, client-id index, topic index).  String fields intern
        # through _sym so request-side comparisons are integer ==.
        self._sym: dict = {"": -1}
        sym = self._intern
        self._r_keymask = np.array(
            [self._key_mask(r.api_keys_int) for r in self.rules], np.uint64)
        self._r_anykey = np.array(
            [not r.api_keys_int for r in self.rules], bool)
        self._r_version = np.array(
            [int(r.api_version) if r.api_version else -1
             for r in self.rules], np.int64)
        self._r_client = np.array(
            [sym(r.client_id) for r in self.rules], np.int64)
        self._r_topic = np.array(
            [sym(r.topic) for r in self.rules], np.int64)

    def _intern(self, s: str) -> int:
        if s not in self._sym:
            self._sym[s] = len(self._sym) - 1
        return self._sym[s]

    @staticmethod
    def _key_mask(keys) -> int:
        if not keys:
            return (1 << 64) - 1        # empty == all keys allowed
        m = 0
        for k in keys:
            m |= 1 << (k & 63)
        return m

    def _rule_matches(self, req: KafkaRequest, rule: PortRuleKafka) -> bool:
        """pkg/kafka/policy.go:144 ruleMatches."""
        if not rule.matches_api_key(req.api_key):
            return False
        if not rule.matches_api_version(req.api_version):
            return False
        if rule.topic == "" and rule.client_id == "":
            return True
        return rule.matches_client_id(req.client_id) if rule.client_id \
            else True

    def allows(self, req: KafkaRequest) -> bool:
        """pkg/kafka/policy.go:200 MatchesRule: all topics must be
        covered; topicless rules cover any request they match."""
        if not self.rules:
            return True  # wildcarded redirect: L7 allow-all
        remaining = set(req.topics)
        for rule in self.rules:
            if rule.topic == "" or not req.topics:
                if self._rule_matches(req, rule):
                    return True
            elif rule.topic in remaining:
                if self._rule_matches(req, rule):
                    remaining.discard(rule.topic)
                    if not remaining:
                        return True
        return False

    def check(self, requests: Sequence[KafkaRequest]) -> List[bool]:
        """Batched verdicts.

        Vectorized over the batch for requests with <=1 topic (the wire
        parser extracts at most one topic per request, so this is the
        proxy's whole traffic); multi-topic requests — possible when
        callers construct KafkaRequest directly — take the exact
        all-topics-covered scalar path (pkg/kafka/policy.go:200)."""
        if not self.rules:
            return [True] * len(requests)
        n = len(requests)
        multi = [i for i, r in enumerate(requests) if len(r.topics) > 1]
        sym = self._sym
        api_key = np.fromiter((r.api_key for r in requests), np.int64, n)
        version = np.fromiter((r.api_version for r in requests),
                              np.int64, n)
        # unknown client/topic strings map to -2: matches no rule value,
        # and never collides with the -1 "unset" rule sentinel
        client = np.fromiter((sym.get(r.client_id, -2) for r in requests),
                             np.int64, n)
        # empty-STRING topic is still a topic (scalar path keeps it in
        # `remaining`): encode as -3 so it matches no rule topic and is
        # never confused with the -1 "request has no topics" case
        topic = np.fromiter(
            ((-3 if r.topics[0] == "" else sym.get(r.topics[0], -2))
             if r.topics else -1 for r in requests), np.int64, n)
        has_topic = topic != -1

        in_range = (api_key >= 0) & (api_key < 64)
        key_ok = self._r_anykey[None, :] | (
            in_range[:, None] &
            (((self._r_keymask[None, :] >>
               (api_key[:, None].clip(0, 63).astype(np.uint64))) & 1) != 0))
        ver_ok = (self._r_version[None, :] == -1) | \
            (self._r_version[None, :] == version[:, None])
        cli_ok = (self._r_client[None, :] == -1) | \
            (self._r_client[None, :] == client[:, None])
        # topicless rules cover anything; any rule covers a topicless
        # request; else the (single) topic must equal the rule's
        cover = (self._r_topic[None, :] == -1) | \
            (~has_topic[:, None]) | \
            (self._r_topic[None, :] == topic[:, None])
        out = (key_ok & ver_ok & cli_ok & cover).any(axis=1)
        for i in multi:
            out[i] = self.allows(requests[i])
        return out.tolist()
