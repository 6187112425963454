"""Kernels a batch over the traced span."""


def read(trace, spec, run):
    n = trace.kernels()
    return n / trace.batches if n else None
