"""Percent of the traced span's wall in which a kernel, copy or fill
ran on the card; None where nothing ran on it."""


def read(trace, spec, run):
    busy, w = trace.busy_s(), trace.window_s
    return 100.0 * busy / w if busy > 0 and w > 0 else None
