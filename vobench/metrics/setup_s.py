"""From process start to the window's first call: imports, the kernels'
build or load, the ring rendered on the card, the program's state and the
warm-up."""


def read(run):
    return run.window.setup_s
