"""Input pipeline of the port (port of ``repro.data``)."""
