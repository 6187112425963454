"""Device ms a batch of the activities launched with the program's span
``spec["span"]`` innermost (``benchmark/spans.py``): its self time.
None where the program has no such span."""

from ..spans import SpanTrace


def read(trace, spec, run):
    spans = SpanTrace.of(trace)
    return None if spans is None else spans.device_ms(spec["span"])
