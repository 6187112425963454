"""Runtime self-telemetry: the agent watching itself.

Copies of the ``cilium_tpu/observability`` modules:

- ``tracer``      — bounded in-memory span tracing with explicit context
                    propagation, served at /debug/traces;
- ``propagation`` — policy-propagation latency: every revision's path
                    import -> compile -> device apply -> first verdict;
- ``stages``      — host-timed pipeline stage slices and blocking
                    boundaries (``pipeline_report()``), and the
                    program's ``dp:`` ranges on the profiler's clock
                    (``span``, ``host_span``);
- ``pressure``    — map-pressure gauges and warning thresholds for every
                    device table;
- ``events``      — the incident flight recorder of degraded-condition
                    transitions, served at /debug/events;
- ``slo``         — the serving SLO tier: per-lane latency objectives,
                    burn rates and queue-depth samples.
"""

from .tracer import Span, SpanContext, Tracer, tracer
from .propagation import (POLICY_IMPLEMENTATION_DELAY,
                          PolicyPropagationTracker)
from .stages import (PIPELINE_STAGE_SECONDS, host_span, pipeline_report,
                     record_stage, span)
from .pressure import MAP_PRESSURE, compute_pressure
from .events import EVENT_TYPES, FlightEvent, FlightRecorder, recorder
from .slo import SLOTracker, slo_tracker

__all__ = [
    "Span", "SpanContext", "Tracer", "tracer",
    "POLICY_IMPLEMENTATION_DELAY", "PolicyPropagationTracker",
    "PIPELINE_STAGE_SECONDS", "host_span", "pipeline_report",
    "record_stage", "span",
    "MAP_PRESSURE", "compute_pressure",
    "EVENT_TYPES", "FlightEvent", "FlightRecorder", "recorder",
    "SLOTracker", "slo_tracker",
]
