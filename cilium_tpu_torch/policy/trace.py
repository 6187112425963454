"""SearchContext: the policy query context + verdict trace explanations.

A whole copy of ``cilium_tpu/policy/trace.py``.

Reference: pkg/policy/policy.go:39-101 (SearchContext, PolicyTrace).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..labels import LabelArray

TRACE_DISABLED = 0
TRACE_ENABLED = 1
TRACE_VERBOSE = 2

# Aliases for a friendlier import surface.
TraceDisabled = TRACE_DISABLED
TraceEnabled = TRACE_ENABLED
TraceVerbose = TRACE_VERBOSE


@dataclass(frozen=True)
class Port:
    """A destination port in a query (reference: api/models.Port)."""

    port: int
    protocol: str = "ANY"


@dataclass
class SearchContext:
    """Context for a policy query: who talks to whom on which ports.

    Reference: pkg/policy/policy.go:64.
    """

    from_labels: LabelArray = field(default_factory=LabelArray)
    to_labels: LabelArray = field(default_factory=LabelArray)
    dports: List[Port] = field(default_factory=list)
    trace: int = TRACE_DISABLED
    depth: int = 0
    logging: Optional[io.StringIO] = None

    def policy_trace(self, fmt: str, *args) -> None:
        if self.trace in (TRACE_ENABLED, TRACE_VERBOSE) and self.logging is not None:
            pad = " " * (self.depth * 2)
            msg = (fmt % args) if args else fmt
            self.logging.write(pad + msg)

    def policy_trace_verbose(self, fmt: str, *args) -> None:
        if self.trace == TRACE_VERBOSE and self.logging is not None:
            msg = (fmt % args) if args else fmt
            self.logging.write(msg)

    def trace_output(self) -> str:
        return self.logging.getvalue() if self.logging is not None else ""

    def __str__(self) -> str:
        from_s = ", ".join(str(l) for l in self.from_labels)
        to_s = ", ".join(str(l) for l in self.to_labels)
        ret = f"From: [{from_s}] => To: [{to_s}]"
        if self.dports:
            ports = ", ".join(f"{p.port}/{p.protocol}" for p in self.dports)
            ret += f" Ports: [{ports}]"
        return ret


def traced_context(from_labels: LabelArray, to_labels: LabelArray,
                   dports: Optional[List[Port]] = None,
                   verbose: bool = False) -> SearchContext:
    """Convenience: a SearchContext that records its trace."""
    return SearchContext(
        from_labels=from_labels, to_labels=to_labels,
        dports=list(dports or []),
        trace=TRACE_VERBOSE if verbose else TRACE_ENABLED,
        logging=io.StringIO())
