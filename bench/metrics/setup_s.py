"""Seconds from the start of the process to the opening of the window:
imports, weights, engine, kernel builds, graph captures and the ramp."""


def read(run):
    return run.setup_s
