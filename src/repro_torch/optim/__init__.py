"""Optimizer of the port (port of ``repro.optim``): AdamW with optional
int8 block-quantized moments."""
