"""Seconds an assembly of the read file takes: the window, from its start to
the end of its last assembly, over the assemblies it completed."""


def read(observed):
    return observed.window_s / len(observed.assemblies)
