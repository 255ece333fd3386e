"""Fault tolerance (port of ``repro.ft``): ABFT integrity checks, atomic
checkpoints, the step watchdog."""
