"""Device idle ms a batch while the program's span ``spec["span"]`` was
open on the harness's main thread, each gap cut to the span's open
intervals (``benchmark/spans.py``).  None where the program has no such
span."""

from ..spans import SpanTrace


def read(trace, spec, run):
    spans = SpanTrace.of(trace)
    return None if spans is None else spans.idle_ms(spec["span"])
