"""Device ms a batch of the activities launched inside one stage's
functions (``spec["stage"]``)."""


def read(trace, spec, run):
    return trace.stage_ms(spec["stage"])
