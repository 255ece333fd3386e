"""LM assembly over the layer zoo (port of ``repro.models``)."""
