"""Configuration: the runtime-mutable option maps.

Copy of the option maps of ``cilium_tpu/utils/option.py``: the option
specs, ``IntOptions`` and the daemon/endpoint option library.  The
static ``DaemonConfig`` and ``parse_option_value`` wait for the daemon.

Reference: pkg/option — ``DaemonConfig`` (flags bound in
daemon/main.go:169-343) plus mutable ``IntOptions`` maps with a spec
library (dependencies between options, verify hooks) and per-endpoint
override; option changes trigger endpoint regeneration
(``applyOptsLocked``), surfaced as PATCH /config and
PATCH /endpoint/{id}/config (api/v1/openapi.yaml:41,189).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

OPTION_DISABLED = 0
OPTION_ENABLED = 1


@dataclass
class OptionSpec:
    """One mutable option's metadata (option.go Option)."""

    name: str
    description: str = ""
    # options that must be enabled for this one (option.go Requires)
    requires: List[str] = field(default_factory=list)
    immutable: bool = False
    verify: Optional[Callable[[int], None]] = None  # raises on bad value


# The daemon/endpoint mutable-option library (reference:
# pkg/option/config.go specs; datapath ones become engine switches here).
SPEC_DEBUG = OptionSpec("Debug", "Enable debugging trace statements")
SPEC_DROP_NOTIFY = OptionSpec("DropNotification",
                              "Enable drop notifications")
SPEC_TRACE_NOTIFY = OptionSpec("TraceNotification",
                               "Enable trace notifications")
SPEC_POLICY_VERDICT_NOTIFY = OptionSpec(
    "PolicyVerdictNotification", "Enable policy-verdict notifications")
SPEC_CONNTRACK_ACCOUNTING = OptionSpec(
    "ConntrackAccounting", "Enable per-CT packet/byte counters",
    requires=["Conntrack"])
SPEC_CONNTRACK = OptionSpec("Conntrack", "Enable stateful connection tracking")
SPEC_POLICY = OptionSpec("Policy", "Enable policy enforcement")
SPEC_INGRESS_POLICY = OptionSpec("IngressPolicy",
                                 "Enable ingress policy enforcement")
SPEC_EGRESS_POLICY = OptionSpec("EgressPolicy",
                                "Enable egress policy enforcement")

DAEMON_OPTION_LIBRARY: Dict[str, OptionSpec] = {
    s.name: s for s in [
        SPEC_DEBUG, SPEC_DROP_NOTIFY, SPEC_TRACE_NOTIFY,
        SPEC_POLICY_VERDICT_NOTIFY, SPEC_CONNTRACK,
        SPEC_CONNTRACK_ACCOUNTING, SPEC_POLICY, SPEC_INGRESS_POLICY,
        SPEC_EGRESS_POLICY,
    ]
}


class IntOptions:
    """A mutable option map with spec-driven validation.

    Reference: pkg/option/option.go IntOptions (ApplyValidated, dependency
    resolution when enabling an option that Requires others, change
    callbacks used to kick regeneration).
    """

    def __init__(self, library: Optional[Dict[str, OptionSpec]] = None,
                 defaults: Optional[Dict[str, int]] = None):
        self.library = library or DAEMON_OPTION_LIBRARY
        self._lock = threading.RLock()
        self._opts: Dict[str, int] = dict(defaults or {})

    def get(self, name: str) -> int:
        with self._lock:
            return self._opts.get(name, OPTION_DISABLED)

    def is_enabled(self, name: str) -> bool:
        return self.get(name) > 0

    def _validate_one(self, name: str, value: int) -> OptionSpec:
        spec = self.library.get(name)
        if spec is None:
            raise KeyError(f"unknown option {name!r}")
        if spec.immutable:
            raise ValueError(f"option {name!r} is immutable")
        if spec.verify:
            spec.verify(value)
        return spec

    def _requires_closure(self, name: str, seen: set) -> None:
        if name in seen:
            return
        seen.add(name)
        spec = self.library.get(name)
        if spec is None:
            raise KeyError(f"unknown option {name!r} (required dependency)")
        for dep in spec.requires:
            self._requires_closure(dep, seen)

    def _dependents_closure(self, name: str, seen: set) -> None:
        if name in seen:
            return
        seen.add(name)
        for other, spec in self.library.items():
            if name in spec.requires:
                self._dependents_closure(other, seen)

    def apply_validated(self, changes: Dict[str, int],
                        changed: Optional[Callable[[str, int], None]] = None
                        ) -> int:
        """Apply a set of option changes. Enabling an option enables its
        ``requires`` closure; disabling one disables dependents
        (option.go ApplyValidated/enable/disable). The full closure is
        validated before anything mutates: all-or-nothing, and the
        immutable/verify guards cover cascaded options too. Returns the
        number of options whose value actually changed."""
        n_changed = 0
        with self._lock:
            enable_closure: set = set()
            disable_closure: set = set()
            for name, value in changes.items():
                self._validate_one(name, value)
                if value > 0:
                    self._requires_closure(name, enable_closure)
                else:
                    self._dependents_closure(name, disable_closure)
            for name in enable_closure:
                if name not in changes:
                    self._validate_one(name, OPTION_ENABLED)
            for name in disable_closure:
                if name not in changes:
                    self._validate_one(name, OPTION_DISABLED)
            for name, value in changes.items():
                if value > 0:
                    n_changed += self._enable(name, value, changed)
                else:
                    n_changed += self._disable(name, changed)
        return n_changed

    def _enable(self, name, value, changed) -> int:
        n = 0
        spec = self.library[name]
        for dep in spec.requires:
            if self._opts.get(dep, 0) <= 0:
                n += self._enable(dep, OPTION_ENABLED, changed)
        if self._opts.get(name, 0) != value:
            self._opts[name] = value
            n += 1
            if changed:
                changed(name, value)
        return n

    def _disable(self, name, changed) -> int:
        n = 0
        if self._opts.get(name, 0) != 0:
            self._opts[name] = 0
            n += 1
            if changed:
                changed(name, 0)
        # cascade: disable options that Require this one
        for other, spec in self.library.items():
            if name in spec.requires and self._opts.get(other, 0) > 0:
                n += self._disable(other, changed)
        return n

    def dump(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._opts)

    def fork(self) -> "IntOptions":
        """Copy for per-endpoint override (endpoint opts start from the
        daemon's, then diverge)."""
        with self._lock:
            return IntOptions(self.library, dict(self._opts))
