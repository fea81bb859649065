"""CPU tests of the benchmark (card tests carry the ``cuda`` marker)."""
