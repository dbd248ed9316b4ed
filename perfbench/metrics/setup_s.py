"""Seconds from the start of the process to the start of the window:
imports, the graph's generation and build, kernel libraries, the
tuner's probes, the warm-up."""


def read(run):
    return run.setup_s
