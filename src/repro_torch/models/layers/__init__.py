"""Layer zoo of the port: attention and common primitives."""
