"""Device ms a batch of the copies whose name holds ``spec["copy"]``
(``HtoD``: the batch and its payload lane onto the card)."""


def read(trace, spec, run):
    return trace.copy_ms(spec["copy"])
