"""Mean seconds an assembly spends in ``FastAssembler.load`` (the harness's
own span around it: the program has none there)."""


def read(observed):
    return sum(a.load_s for a in observed.assemblies) / len(observed.assemblies)
