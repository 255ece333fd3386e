"""Shared pieces of the benchmark harness: spec lookup, load generation,
trace reading, cell runs."""
