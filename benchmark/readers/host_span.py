"""Mean host wall ms of one call into the program (``process_packed``),
over the window's calls made while the profiler was off."""


def read(trace, spec, run):
    ms = run["dispatch_ms"]
    return sum(ms) / len(ms) if ms else None
