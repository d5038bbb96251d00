"""Systems under test, one module per kind of configuration (``system`` in its file)."""
