"""Plain references, one module per kind of configuration (``reference`` in its file)."""
