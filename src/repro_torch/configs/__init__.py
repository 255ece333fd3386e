"""Architecture configs + the (arch x shape) cell registry (copies of
``repro.configs``: plain data)."""
