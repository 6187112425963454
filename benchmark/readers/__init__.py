"""Per-layer metric readers, one module each, found by the ``reader``
name of a metric file (``benchmark/metrics/<metric>.json``).

``read(trace, spec, run)`` takes the run's ``trace.DeviceTrace`` of the
traced span, the metric's spec and the run's facts (``batch`` rows a
batch, ``lane_width`` or None, ``dispatch_ms`` host times of the
untraced calls, ``kind`` of the card) and returns a number, or None
where the run has nothing to read: the harness then leaves the metric
out of the result line.
"""
