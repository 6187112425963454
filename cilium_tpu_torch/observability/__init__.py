"""Runtime self-telemetry of the serving tier.

Copies of the ``cilium_tpu/observability`` modules the serving path
writes to:

- ``stages``   — host-timed pipeline stage slices and blocking
                 boundaries (``pipeline_report()``);
- ``slo``      — the serving SLO tier: per-lane latency objectives,
                 burn rates and queue-depth samples;
- ``events``   — the incident flight recorder of supervisor and
                 overload transitions;
- ``jitstats`` — first-call-per-geometry accounting of the engine's
                 entry points.
"""
