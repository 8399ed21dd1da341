"""Seconds from the start of the process to the start of the window."""


def read(observed):
    return observed.setup_s
