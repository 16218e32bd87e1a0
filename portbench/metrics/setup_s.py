"""Seconds from the process's start to the window's first request: imports,
the device's context, loading (or building) the kernels, the inputs, the
layout, the searcher or scanner and the warm-up requests."""


def read(run):
    return run.setup_s
