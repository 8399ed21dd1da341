"""Mean seconds an assembly spends building the unitig links and pointer
jumping (``PhaseStats.wall_s`` ``links`` + ``jump``)."""


def read(observed):
    return observed.mean_wall("links", "jump")
