"""See the ``repro`` package for the reference of each module."""
