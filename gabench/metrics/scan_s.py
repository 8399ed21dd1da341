"""Mean seconds an assembly spends in the program's ``scan`` phase
(``PhaseStats.wall_s``); None where the path has no such phase."""


def read(observed):
    return observed.mean_wall("scan")
