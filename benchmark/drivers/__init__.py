"""Drivers, one module each, found by the ``driver`` name of a traffic
file: how a run's window drives the system.  ``run(ctx)`` takes a
``harness.RunContext`` and returns a ``harness.Outcome``."""
