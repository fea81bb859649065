"""Traffic generators; each mix file names one (``generator``)."""
