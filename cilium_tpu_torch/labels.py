"""Label model: sources, parsing, extended keys, sorted arrays, identity hash.

A whole copy of ``cilium_tpu/labels.py``.

Semantics follow the reference's ``pkg/labels`` (labels.go, array.go,
cidr.go, filter.go): a label is ``(key, value, source)``; its *extended key*
encodes the source as ``source.key`` (with the special wildcard source
``any``); a set of labels has a deterministic sorted string form whose
SHA-256 is the security-identity key.
"""

from __future__ import annotations

import hashlib
import ipaddress
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PATH_DELIMITER = "."

# Special label names (reference: pkg/labels/labels.go:31-57)
ID_NAME_ALL = "all"
ID_NAME_HOST = "host"
ID_NAME_WORLD = "world"
ID_NAME_CLUSTER = "cluster"
ID_NAME_HEALTH = "health"
ID_NAME_INIT = "init"
ID_NAME_UNMANAGED = "unmanaged"
ID_NAME_UNKNOWN = "unknown"

# Label sources (reference: pkg/labels/labels.go:128-156)
SOURCE_UNSPEC = "unspec"
SOURCE_ANY = "any"
SOURCE_K8S = "k8s"
SOURCE_MESOS = "mesos"
SOURCE_CONTAINER = "container"
SOURCE_RESERVED = "reserved"
SOURCE_CIDR = "cidr"

ANY_PREFIX = SOURCE_ANY + PATH_DELIMITER
RESERVED_PREFIX = SOURCE_RESERVED + PATH_DELIMITER


@dataclass(frozen=True)
class Label:
    """A single label ``source:key=value``.

    Reference: pkg/labels/labels.go (struct Label).
    """

    key: str
    value: str = ""
    source: str = SOURCE_UNSPEC

    def __post_init__(self):
        if self.source == "":
            object.__setattr__(self, "source", SOURCE_UNSPEC)

    @property
    def extended_key(self) -> str:
        """Key with the source encoded; unspec maps to the wildcard source.

        Reference: pkg/labels/labels.go:418 (GetExtendedKey).
        """
        src = self.source
        if src == SOURCE_UNSPEC or src == "":
            src = SOURCE_ANY
        return src + PATH_DELIMITER + self.key

    def is_reserved(self) -> bool:
        return self.source == SOURCE_RESERVED

    def matches_extended_key(self, ext_key: str) -> bool:
        """True if this label is named by ``ext_key`` (``any.`` matches all
        sources)."""
        if ext_key.startswith(ANY_PREFIX):
            return self.key == ext_key[len(ANY_PREFIX):]
        return self.extended_key == ext_key

    def __str__(self) -> str:
        if self.value:
            return f"{self.source}:{self.key}={self.value}"
        return f"{self.source}:{self.key}"

    def sort_key(self) -> Tuple[str, str, str]:
        return (self.source, self.key, self.value)


def parse_label(text: str) -> Label:
    """Parse ``source:key=value`` (source and value optional).

    Reference: pkg/labels/labels.go (ParseLabel). A ``$`` prefix is the
    shorthand for the reserved source (``$host`` == ``reserved:host``).
    """
    source = SOURCE_UNSPEC
    if text.startswith("$"):
        text = RESERVED_PREFIX.replace(".", ":") + text[1:]
    # Split source on the first ':' that appears before any '='.
    eq = text.find("=")
    colon = text.find(":")
    if colon >= 0 and (eq < 0 or colon < eq):
        source, text = text[:colon] or SOURCE_UNSPEC, text[colon + 1:]
    eq = text.find("=")
    if eq < 0:
        key, value = text, ""
    else:
        key, value = text[:eq], text[eq + 1:]
    if source == SOURCE_RESERVED and key == "" and value != "":
        # "reserved:=host" edge: treat value as key
        key, value = value, ""
    return Label(key=key, value=value, source=source)


def parse_select_label(text: str) -> Label:
    """Parse a label used for *selecting* (unspec source becomes ``any``).

    Reference: pkg/labels/labels.go (ParseSelectLabel).
    """
    lbl = parse_label(text)
    if lbl.source == SOURCE_UNSPEC:
        return Label(key=lbl.key, value=lbl.value, source=SOURCE_ANY)
    return lbl


class LabelArray(tuple):
    """An immutable set-like array of labels (reference: pkg/labels/array.go)."""

    def __new__(cls, labels: Iterable[Label] = ()):
        return super().__new__(cls, tuple(labels))

    @classmethod
    def parse(cls, *labels: str) -> "LabelArray":
        return cls(parse_label(s) for s in labels)

    @classmethod
    def parse_select(cls, *labels: str) -> "LabelArray":
        return cls(parse_select_label(s) for s in labels)

    def has(self, ext_key: str) -> bool:
        """True if any label's extended key matches (``any.`` wildcard aware).

        Reference: pkg/labels/array.go:92 (Has).
        """
        return any(l.matches_extended_key(ext_key) for l in self)

    def get(self, ext_key: str) -> str:
        """Value of the label named by ``ext_key`` ('' if absent).

        Reference: pkg/labels/array.go:114 (Get).
        """
        for l in self:
            if l.matches_extended_key(ext_key):
                return l.value
        return ""

    def contains(self, needed: "LabelArray") -> bool:
        """True if every needed label is present (source+key+value equal).

        Reference: pkg/labels/array.go:58 (Contains).
        """
        return all(n in self for n in needed)

    def sorted(self) -> "LabelArray":
        return LabelArray(sorted(self, key=Label.sort_key))

    def get_model(self) -> List[str]:
        return [str(l) for l in self]

    def __repr__(self) -> str:
        return "LabelArray[" + ", ".join(str(l) for l in self) + "]"


class Labels(dict):
    """Mutable map key->Label (reference: pkg/labels/labels.go type Labels)."""

    @classmethod
    def from_model(cls, model: Sequence[str]) -> "Labels":
        lbls = cls()
        for s in model:
            l = parse_label(s)
            lbls[l.key] = l
        return lbls

    @classmethod
    def from_labels(cls, labels: Iterable[Label]) -> "Labels":
        lbls = cls()
        for l in labels:
            lbls[l.key] = l
        return lbls

    def to_array(self) -> LabelArray:
        return LabelArray(sorted(self.values(), key=Label.sort_key))

    def sorted_list(self) -> bytes:
        """Deterministic serialized form used as the identity key.

        Reference: pkg/labels/labels.go (SortedList): sorted by source
        then key, ``source:key=value;`` concatenated.
        """
        parts = []
        for l in sorted(self.values(), key=Label.sort_key):
            parts.append(f"{l.source}:{l.key}={l.value};")
        return "".join(parts).encode()

    def sha256_sum(self) -> str:
        """SHA-256 of the sorted list (reference uses SHA-512/256; a stable
        strong hash is what matters, not the exact algorithm)."""
        return hashlib.sha256(self.sorted_list()).hexdigest()

    def get_model(self) -> List[str]:
        return [str(l) for l in sorted(self.values(), key=Label.sort_key)]

    def equals(self, other: "Labels") -> bool:
        return self.sorted_list() == other.sorted_list()


# --- reserved label helpers -------------------------------------------------

def reserved_label(name: str) -> Label:
    return Label(key=name, value="", source=SOURCE_RESERVED)


LABEL_HOST = reserved_label(ID_NAME_HOST)
LABEL_WORLD = reserved_label(ID_NAME_WORLD)
LABEL_HEALTH = reserved_label(ID_NAME_HEALTH)
LABEL_INIT = reserved_label(ID_NAME_INIT)
LABEL_UNMANAGED = reserved_label(ID_NAME_UNMANAGED)
LABEL_ALL = reserved_label(ID_NAME_ALL)


# --- CIDR labels ------------------------------------------------------------

def _cidr_label_string(net: ipaddress._BaseNetwork) -> str:
    # Label keys may not contain ':' or '/'; encode like the reference
    # (pkg/labels/cidr.go): dots/colons to '-', prefix with 'cidr:'.
    s = str(net.network_address)
    s = s.replace(":", "-").replace(".", "-")
    return f"{s}--{net.prefixlen}" if net.version == 6 else f"{s}-{net.prefixlen}"


def get_cidr_labels(cidr: str) -> LabelArray:
    """Expand a CIDR into one label per covering prefix plus world.

    Reference: pkg/labels/cidr.go (GetCIDRLabels): a /24 yields labels for
    /0../24 so a broader policy CIDR selects the narrower identity.
    """
    net = ipaddress.ip_network(cidr, strict=False)
    out: List[Label] = []
    for plen in range(net.prefixlen + 1):
        covering = ipaddress.ip_network(f"{net.network_address}/{plen}",
                                        strict=False)
        out.append(Label(key=_cidr_label_string(covering), source=SOURCE_CIDR))
    out.append(LABEL_WORLD)
    return LabelArray(out)


def _mask_int(plen: int, version: int) -> int:
    bits = 32 if version == 4 else 128
    if plen == 0:
        return 0
    return ((1 << plen) - 1) << (bits - plen)


def ip_to_cidr_label(ip_str: str) -> Label:
    net = ipaddress.ip_network(ip_str, strict=False)
    return Label(key=_cidr_label_string(net), source=SOURCE_CIDR)
