"""One reader per metric: ``read(run)`` returns its value, or None where
the run holds nothing to read."""
