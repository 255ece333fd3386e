"""Chip-side tools that set the benchmark's numbers: the knee sweep and
the readings of the check's limits. The benchmark's own runs use neither."""
