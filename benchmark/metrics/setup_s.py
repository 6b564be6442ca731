"""Seconds from the process's start to the window's first call."""


def read(r):
    return None if r.trace is not None else r.setup_s
