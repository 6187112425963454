"""Host ms a batch inside the program's span ``spec["span"]`` on the
harness's main thread, the ``spec["part"]`` of it: ``runtime`` inside
CUDA runtime or driver calls, ``self`` the rest (``benchmark/spans.py``).
None where the program has no such span."""

from ..spans import SpanTrace


def read(trace, spec, run):
    spans = SpanTrace.of(trace)
    return None if spans is None else spans.host_ms(spec["span"],
                                                    spec["part"])
