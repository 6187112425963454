"""Datapath event codes (drop reasons, trace points) and provenance tiers.

Copy of the constants of ``cilium_tpu/datapath/events.py`` (reference:
bpf/lib/common.h DROP_* codes, bpf/lib/{drop,trace}.h notifications).
The batched step emits one event code per packet; with provenance on it
also emits the decision tier that produced the verdict.
"""

from __future__ import annotations

# Forwarding outcomes (positive trace points).
TRACE_TO_LXC = 0        # delivered to local endpoint
TRACE_TO_PROXY = 1      # redirected to proxy
TRACE_TO_HOST = 2
TRACE_TO_STACK = 3
TRACE_TO_OVERLAY = 4    # encapped to remote node
ICMP6_NS_REPLY = 5      # answered in-datapath (icmp6.h), v6 only
ICMP6_ECHO_REPLY = 6

# Drop reasons (negative codes, mirroring DROP_* semantics).
DROP_POLICY = -130          # common.h DROP_POLICY analog
DROP_FRAG_NOSUPPORT = -131
DROP_CT_INVALID_HDR = -132
DROP_PREFILTER = -133       # XDP prefilter (bpf_xdp.c check_filters)
DROP_POLICY_L7 = -134
DROP_INVALID = -135
DROP_UNKNOWN_TARGET = -136  # icmp6.h ACTION_UNKNOWN_ICMP6_NS analog
DROP_THREAT = -137          # inline threat scoring (threat/stage.py)

DROP_NAMES = {
    DROP_POLICY: "Policy denied (L3/L4)",
    DROP_FRAG_NOSUPPORT: "Fragmented packet not supported",
    DROP_CT_INVALID_HDR: "Invalid connection tracking header",
    DROP_PREFILTER: "Prefilter denied",
    DROP_POLICY_L7: "Policy denied (L7)",
    DROP_INVALID: "Invalid packet",
    DROP_UNKNOWN_TARGET: "Unknown ICMPv6 ND target",
    DROP_THREAT: "Threat score denied (inline ML)",
}

TRACE_NAMES = {
    TRACE_TO_LXC: "to-endpoint",
    TRACE_TO_PROXY: "to-proxy",
    TRACE_TO_HOST: "to-host",
    TRACE_TO_STACK: "to-stack",
    TRACE_TO_OVERLAY: "to-overlay",
    ICMP6_NS_REPLY: "icmp6-ns-reply",
    ICMP6_ECHO_REPLY: "icmp6-echo-reply",
}


def event_name(code: int) -> str:
    """Human name for any event code (drop reason or trace point)."""
    return DROP_NAMES.get(code) or TRACE_NAMES.get(code) or \
        f"code {code}"


# Provenance decision tiers: which stage of the step produced the final
# verdict (the __policy_can_access fallback chain plus the stages that
# short-circuit around it).
TIER_NONE = 0            # provenance disabled / not applicable
TIER_PREFILTER = 1       # XDP prefilter deny
TIER_CT_ESTABLISHED = 2  # verdict replayed from the CT entry
TIER_L3_ALLOW = 3        # L3-only key (identity, 0, 0, dir)
TIER_L4_RULE = 4         # exact or L4-wildcard key, plain allow
TIER_L7_REDIRECT = 5     # matched key carries a proxy port
TIER_DENY = 6            # no key matched (policy/fragment drop)
TIER_LB = 7              # local service tier (ICMPv6 responder, v6 only)
# On-device L7 fast verdicts (pipeline._l7_fast_stage): the matched key
# carried a proxy port, but its rule set is first-bytes-decidable and the
# payload window decided inline; truncated or absent payloads keep
# TIER_L7_REDIRECT.
TIER_L7_FAST_ALLOW = 8   # DFA matched: allowed inline
TIER_L7_FAST_DENY = 9    # DFA refused: denied inline (DROP_POLICY_L7)
# Inline threat scoring (threat/stage.py) overrode an allow-or-redirect
# verdict in enforce mode; shadow scoring never re-tiers.
TIER_THREAT_DROP = 10       # score >= drop threshold -> DROP_THREAT
TIER_THREAT_RATELIMIT = 11  # rate-limit arm: bucket dry + prand drop
TIER_THREAT_REDIRECT = 12   # score >= redirect threshold -> proxy

TIER_NAMES = {
    TIER_NONE: "none",
    TIER_PREFILTER: "prefilter",
    TIER_CT_ESTABLISHED: "ct-established",
    TIER_L3_ALLOW: "l3-allow",
    TIER_L4_RULE: "l4-rule",
    TIER_L7_REDIRECT: "l7-redirect",
    TIER_DENY: "deny",
    TIER_LB: "lb",
    TIER_L7_FAST_ALLOW: "l7-fast-allow",
    TIER_L7_FAST_DENY: "l7-fast-deny",
    TIER_THREAT_DROP: "threat-drop",
    TIER_THREAT_RATELIMIT: "threat-ratelimit",
    TIER_THREAT_REDIRECT: "threat-redirect",
}


def tier_name(code: int) -> str:
    """Human name for a provenance decision-tier code."""
    return TIER_NAMES.get(code, f"tier {code}")


def format_rule(decoded) -> str:
    """Compact one-line form of a decoded policymap entry (the label
    value the provenance metrics and monitor samples carry); '' for
    None (no entry decided)."""
    if decoded is None:
        return ""
    direction = "ingress" if decoded["direction"] == 0 else "egress"
    s = (f"identity={decoded['identity']},dport={decoded['dport']},"
         f"proto={decoded['proto']},{direction}")
    if decoded.get("proxy-port"):
        s += f",proxy={decoded['proxy-port']}"
    return s


def format_denied_key(identity: int, dport: int, proto: int) -> str:
    """The queried tuple a DENY verdict failed to match — the 'rule
    key' drops aggregate under (no compiled entry decided them)."""
    return f"deny:identity={identity},dport={dport},proto={proto}"
