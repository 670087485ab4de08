"""setup_s (end to end, host clock): from the start of ``run.py`` to the
window's start: imports, the card, the scene from the seed, the
``Simulation``, the first step (and in a checkout's first run the kernels'
build), the traffic's warm-up."""


def read(run):
    return run.setup_s
