"""Train and eval steps of the port (port of ``repro.train``)."""
